"""Bisimulation launcher of the port: run Build_Bisim (in memory, or
out-of-core with ``--oocore``) on a generated or saved graph, on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.bisim --generator powerlaw \
        --nodes 100000 --edges 400000 --k 10 --mode sorted
    PYTHONPATH=src python -m repro_torch.launch.bisim --oocore \
        --chunk-edges 65536 --generator structured --nodes 300000

Flags, defaults and output lines are those of `repro.launch.bisim`'s
builds (its maintenance subcommands and distributed engine arrive with
their slices).  ``--checkpoint --workdir DIR`` makes the out-of-core build
write a per-level checkpoint; ``--resume`` continues a killed build from
the last finished level.  ``--trace PATH`` writes a Chrome-trace JSON and
prints the phase table, with the ``build.dispatch`` / ``build.sync``
counts.
"""
from __future__ import annotations

import argparse
import time
import zipfile

import numpy as np
import torch

from .. import resolve_device
from ..core import build_bisim
from ..exmem import build_bisim_oocore
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
    ap.add_argument("--oocore", action="store_true",
                    help="disk-resident streamed build (repro_torch.exmem)")
    ap.add_argument("--chunk-edges", type=int, default=1 << 16,
                    help="oocore: E_t chunk rows (memory budget)")
    ap.add_argument("--chunk-nodes", type=int, default=None,
                    help="oocore: N_t chunk rows (default: --chunk-edges)")
    ap.add_argument("--spill-threshold", type=int, default=1 << 20,
                    help="oocore: SigStore entries resident before spill")
    ap.add_argument("--workdir", default=None,
                    help="oocore: spill directory (default: a tempdir)")
    ap.add_argument("--io-threads", type=int, default=1,
                    help="oocore: async I/O pipeline threads (prefetch "
                         "readers / streaming writers / run saves); "
                         "0 = fully synchronous")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="oocore: chunks buffered ahead per stream")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="oocore: disable the async I/O pipeline "
                         "(same as --io-threads 0)")
    ap.add_argument("--checkpoint", action="store_true",
                    help="oocore build: write a per-level checkpoint to "
                         "--workdir (required)")
    ap.add_argument("--resume", action="store_true",
                    help="oocore build: resume a checkpointed build from "
                         "the last finished level (implies --checkpoint)")
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


def _engine(args) -> str:
    return "oocore" if args.oocore else "single"


def run_build(args, g: Graph):
    """The build the launcher runs; returns (result, wall seconds), the
    wall time ending after the device finished."""
    kwargs = dict(mode=args.mode, early_stop=not args.no_early_stop,
                  device=args.device)
    if args.oocore:
        build = build_bisim_oocore
        kwargs.update(
            chunk_edges=args.chunk_edges, chunk_nodes=args.chunk_nodes,
            workdir=args.workdir, spill_threshold=args.spill_threshold,
            io_threads=0 if args.no_prefetch else args.io_threads,
            prefetch_depth=args.prefetch_depth,
            checkpoint=args.checkpoint or args.resume, resume=args.resume)
    else:
        build = build_bisim
        if args.sync_every is not None:
            kwargs.update(fused=False, sync_every=args.sync_every)
    t0 = time.perf_counter()
    with obs.span("launch.build", engine=_engine(args), k=args.k,
                  mode=args.mode):
        res = build(g, args.k, **kwargs)
        if args.device == "cuda":
            torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def report(args, res, dt: float) -> None:
    print(f"k={args.k} mode={args.mode} {_engine(args)}")
    for st in res.stats:
        print(f"  iter {st.iteration:2d}: {st.num_partitions:9d} blocks "
              f"{st.seconds * 1e3:9.1f} ms  sortedB={st.bytes_sorted} "
              f"scannedB={st.bytes_scanned}")
    print(f"total {dt:.2f}s; converged_at={res.converged_at}")
    if args.oocore:
        print(MetricsReport.format_io(res.io.as_dict()))
        line = MetricsReport.format_overlap(
            res.aio.as_dict() if res.aio is not None else None,
            sum(s.seconds for s in res.stats))
        if line is not None:
            print(line)
        if args.workdir:
            print(f"workdir: {res.workdir}")
    if args.out:
        if args.oocore:
            # an .npz is a zip of .npy members: copy the per-level pid
            # files straight in, never materializing the (k+1) x N
            # history the out-of-core engine exists to avoid
            with zipfile.ZipFile(args.out, "w", zipfile.ZIP_DEFLATED) as zf:
                for j, p in enumerate(res.pid_paths):
                    zf.write(p, arcname=f"pids_{j}.npy")
        else:
            np.savez_compressed(args.out, pids=res.pids)
        print(f"saved pid history to {args.out}")


def _dispatch(args) -> None:
    resolve_device(args.device)  # raise before generating a graph
    g = make_graph(args)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges")
    res, dt = run_build(args, g)
    report(args, res, dt)
    if args.oocore and not args.workdir:
        res.cleanup()  # tempdir workdir: don't strand the spilled tables


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
