"""Bisimulation launcher of the port: run Build_Bisim on a generated or
saved graph, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.bisim --generator powerlaw \
        --nodes 100000 --edges 400000 --k 10 --mode sorted

Flags, defaults and output lines are those of `repro.launch.bisim`'s build
(its maintenance subcommands, out-of-core and distributed engines arrive
with their slices).  ``--trace PATH`` writes a Chrome-trace JSON and prints
the phase table, with the ``build.dispatch`` / ``build.sync`` counts.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..core import build_bisim
from ..graph import generators as gen
from ..graph.storage import Graph
from ..obs import MetricsReport, write_chrome_trace
from ..obs import tracer as obs


def make_graph(args) -> Graph:
    if args.graph:
        return Graph.load(args.graph)
    if args.generator == "random":
        return gen.random_graph(args.nodes, args.edges, 4, 3, seed=args.seed)
    if args.generator == "powerlaw":
        return gen.powerlaw_graph(args.nodes, args.edges, 4, 3,
                                  seed=args.seed)
    if args.generator == "structured":
        return gen.structured_graph(args.nodes // 3, seed=args.seed)
    if args.generator == "dag":
        return gen.random_dag(args.nodes, args.edges, 4, 3, seed=args.seed)
    if args.generator == "dbest":
        return gen.kary_tree(4, 9)
    if args.generator == "dworst":
        return gen.complete_graph(args.nodes)
    raise SystemExit(f"unknown generator {args.generator}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.bisim")
    ap.add_argument("--graph", default=None, help="path to saved .npz graph")
    ap.add_argument("--generator", default="powerlaw")
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--edges", type=int, default=400_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--mode", default="sorted",
                    choices=["sorted", "dedup_hash", "multiset"])
    ap.add_argument("--no-early-stop", action="store_true")
    ap.add_argument("--sync-every", type=int, default=None, metavar="N",
                    help="force the STAGED build, draining convergence "
                         "scalars every N iterations; default is the fused "
                         "route (count its syncs with --trace)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "to PATH and print the aggregated phase table")
    ap.add_argument("--out", default=None,
                    help="save pid history as .npz (one stacked 'pids' "
                         "array)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the build runs (default: the card; cpu "
                         "runs the plain-PyTorch route)")
    return ap


def run_build(args, g: Graph):
    """The build the launcher runs; returns (result, wall seconds), the
    wall time ending after the device finished."""
    kwargs = dict(mode=args.mode, early_stop=not args.no_early_stop,
                  device=args.device)
    if args.sync_every is not None:
        kwargs.update(fused=False, sync_every=args.sync_every)
    t0 = time.perf_counter()
    with obs.span("launch.build", engine="single", k=args.k,
                  mode=args.mode):
        res = build_bisim(g, args.k, **kwargs)
        if args.device == "cuda":
            torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def report(args, res, dt: float) -> None:
    print(f"k={args.k} mode={args.mode} single")
    for st in res.stats:
        print(f"  iter {st.iteration:2d}: {st.num_partitions:9d} blocks "
              f"{st.seconds * 1e3:9.1f} ms  sortedB={st.bytes_sorted} "
              f"scannedB={st.bytes_scanned}")
    print(f"total {dt:.2f}s; converged_at={res.converged_at}")
    if args.out:
        np.savez_compressed(args.out, pids=res.pids)
        print(f"saved pid history to {args.out}")


def _dispatch(args) -> None:
    resolve_device(args.device)  # raise before generating a graph
    g = make_graph(args)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges")
    res, dt = run_build(args, g)
    report(args, res, dt)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if not args.trace:
        _dispatch(args)
        return
    tracer = obs.Tracer()
    with obs.tracing(tracer):
        _dispatch(args)
    write_chrome_trace(tracer, args.trace)
    print(f"trace: {args.trace} ({len(tracer.spans)} spans, "
          f"{len(tracer.events)} events)")
    print(MetricsReport.from_tracer(tracer).format())


if __name__ == "__main__":
    main()
