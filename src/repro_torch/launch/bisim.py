"""Bisimulation launcher of the port: run Build_Bisim (in memory, or
out-of-core with ``--oocore``) on a generated or saved graph, on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.bisim --generator powerlaw \
        --nodes 100000 --edges 400000 --k 10 --mode sorted
    PYTHONPATH=src python -m repro_torch.launch.bisim --oocore \
        --chunk-edges 65536 --generator structured --nodes 300000

The ``add-edges`` / ``delete-node`` / ``compact`` subcommands apply one
update to the built partition through `BisimMaintainer` (in memory, or
over the disk-resident `exmem.OocBackend` with ``--oocore``) and print
the reference's per-level report; ``--oocore`` adds the update's
``IOStats`` delta.  ``--wal --workdir DIR`` logs the update to the
write-ahead log and snapshots afterwards; ``recover`` reopens such a
workdir (the checksum-verified snapshot plus the committed log):

    PYTHONPATH=src python -m repro_torch.launch.bisim --nodes 1000000 \
        --edges 8000000 --k 10 add-edges --count 1000
    PYTHONPATH=src python -m repro_torch.launch.bisim --oocore --wal \
        --workdir /tmp/maint --k 4 add-edges --count 1000
    PYTHONPATH=src python -m repro_torch.launch.bisim --oocore \
        --workdir /tmp/maint recover

Flags, defaults and output lines are those of `repro.launch.bisim`'s
builds and maintenance subcommands (its quotient and streaming
subcommands and its distributed engine arrive with their slices:
``materialize``, ``query`` and ``serve-updates`` raise).  Propagation
runs on the device by default (``--device-maintenance``, the reference's
opt-in); ``--host-maintenance`` asks for the numpy host path.
``--checkpoint --workdir DIR`` makes the out-of-core build write a
per-level checkpoint; ``--resume`` continues a killed build from the
last finished level.  ``--trace PATH`` writes a Chrome-trace JSON and
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
from ..core import BisimMaintainer, build_bisim
from ..exmem import OocBackend, build_bisim_oocore
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


# the reference's subcommands that arrive with later slices, and the
# ROADMAP.md queue 1 item that brings each
_LATER = {"materialize": 3, "query": 3, "serve-updates": 4}


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
    ap.add_argument("--wal", action="store_true",
                    help="oocore maintenance: write-ahead-log every "
                         "update and snapshot the backend afterwards "
                         "(requires --workdir)")
    ap.add_argument("--wal-group", type=int, default=1,
                    help="oocore maintenance: WAL group-commit size "
                         "(records per fsync; at most group-1 "
                         "acknowledged updates can be lost)")
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
    prop = ap.add_mutually_exclusive_group()
    prop.add_argument("--device-maintenance", dest="device_maintenance",
                      action="store_true", default=True,
                      help="maintenance subcommands: propagate updates on "
                           "--device (the default; bit-identical to the "
                           "host path)")
    prop.add_argument("--host-maintenance", dest="device_maintenance",
                      action="store_false",
                      help="maintenance subcommands: propagate on the "
                           "numpy host path")
    sub = ap.add_subparsers(
        dest="cmd",
        metavar="{add-edges,delete-node,compact,recover,materialize,"
                "query,serve-updates}",
        help="apply one update through BisimMaintainer (in memory, or "
             "OocBackend with --oocore), or recover a crashed --wal "
             "workdir; materialize, query and serve-updates arrive with "
             "later slices")
    ap_add = sub.add_parser("add-edges",
                            help="insert edges and propagate (Alg. 4)")
    ap_add.add_argument("--count", type=int, default=1,
                        help="number of random edges to insert")
    ap_add.add_argument("--edge", action="append", default=[],
                        metavar="S:L:T",
                        help="explicit src:elabel:dst edge (repeatable; "
                             "overrides --count)")
    ap_del = sub.add_parser("delete-node",
                            help="DELETE_NODE: drop incident edges, "
                                 "tombstone the row")
    ap_del.add_argument("--nid", type=int, required=True)
    ap_cmp = sub.add_parser("compact",
                            help="drop tombstoned rows, remap ids densely")
    ap_cmp.add_argument("--delete-nodes", default="", metavar="I,J,...",
                        help="tombstone these nodes first")
    sub.add_parser("recover",
                   help="re-open a crashed --wal workdir: restore the last "
                        "snapshot (checksum-verified) and replay the "
                        "committed WAL tail")
    for name in _LATER:
        sub.add_parser(name, help="not ported yet")
    return ap


def _io_threads(args) -> int:
    return 0 if args.no_prefetch else args.io_threads


def _report_overlap(aio_stats, compute_s: float) -> None:
    line = MetricsReport.format_overlap(
        aio_stats.as_dict() if aio_stats is not None else None, compute_s)
    if line is not None:
        print(line)


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
            io_threads=_io_threads(args),
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
        _report_overlap(res.aio, sum(s.seconds for s in res.stats))
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


def draw_edges(args, num_nodes: int, rng):
    """The edges ``add-edges`` inserts: the explicit ``--edge`` triples,
    else ``--count`` random ones from ``rng`` (the reference's draws)."""
    if args.edge:
        triples = [tuple(int(x) for x in e.split(":")) for e in args.edge]
        return tuple(np.array(c, dtype=np.int32) for c in zip(*triples))
    src = rng.integers(0, num_nodes, args.count).astype(np.int32)
    dst = rng.integers(0, num_nodes, args.count).astype(np.int32)
    lab = rng.integers(0, 4, args.count).astype(np.int32)
    return src, lab, dst


def report_update(rep, dt: float, m) -> None:
    """The reference's per-level lines of one update."""
    if rep is not None:
        path = "device" if rep.device else "host"
        for j, (chk, chg, part, sec) in enumerate(zip(
                rep.nodes_checked, rep.nodes_changed,
                rep.partitions_touched, rep.level_seconds), start=1):
            print(f"  level {j:2d}: checked={chk} changed={chg} "
                  f"partitions_touched={part} "
                  f"{path}_ms={sec * 1e3:.2f}")
        if rep.rebuilt:
            print("  rebuilt (rebuild_threshold heuristic fired)")
    print(f"update: {dt * 1e3:.1f} ms; "
          f"partitions@k={len(np.unique(m.pid()))}")


def run_recover(args) -> None:
    """Re-open a crashed --wal workdir: verified snapshot + WAL replay."""
    if not (args.oocore and args.workdir):
        raise SystemExit("recover needs --oocore and --workdir")
    t0 = time.perf_counter()
    backend, state = OocBackend.restore(
        args.workdir, io_threads=_io_threads(args),
        prefetch_depth=args.prefetch_depth, device=args.device)
    m = BisimMaintainer.restore(backend, state,
                                device_propagation=args.device_maintenance)
    dt = time.perf_counter() - t0
    print(f"recovered: k={m.k} mode={m.mode} "
          f"nodes={backend.num_nodes} tombstones={m.num_tombstones} "
          f"wal_lsn={state['wal_lsn']} in {dt:.2f}s")
    print(MetricsReport.format_io(
        backend.io.as_dict(), label="recovery io",
        fields=["sort_cost", "scan_cost", "sort_bytes", "scan_bytes"]))
    _report_overlap(backend.aio.stats, dt)
    print(f"partitions@k={len(np.unique(m.pid()))}")
    print(f"workdir: {backend.workdir}")


def run_maintenance(args, g: Graph) -> None:
    """Build the partition, apply one update subcommand, report it."""
    if args.wal and not (args.oocore and args.workdir):
        raise SystemExit("--wal needs --oocore and --workdir (a tempdir "
                         "workdir would be deleted on exit, defeating "
                         "the point of durability)")
    t0 = time.perf_counter()
    if args.oocore:
        backend = OocBackend(
            g, chunk_edges=args.chunk_edges, chunk_nodes=args.chunk_nodes,
            spill_threshold=args.spill_threshold, workdir=args.workdir,
            io_threads=_io_threads(args), prefetch_depth=args.prefetch_depth,
            wal=args.wal, wal_group=args.wal_group, device=args.device)
        m = BisimMaintainer(backend, args.k, mode=args.mode,
                            device_propagation=args.device_maintenance,
                            wal=args.wal)
    else:
        backend = None
        m = BisimMaintainer(g, args.k, mode=args.mode, device=args.device,
                            device_propagation=args.device_maintenance)
    engine = "oocore" if args.oocore else "in-memory"
    prop = "device" if m.device_propagation else "host"
    print(f"initial build ({engine}, k={args.k}, mode={args.mode}, "
          f"propagation={prop}): {time.perf_counter() - t0:.2f}s")
    io0 = backend.io.to_dict() if backend is not None else None
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    if args.cmd == "add-edges":
        src, lab, dst = draw_edges(args, m.backend.num_nodes, rng)
        rep = m.add_edges(src, lab, dst)
        print(f"add-edges: {src.shape[0]} edges")
    elif args.cmd == "delete-node":
        rep = m.delete_node(args.nid)
        print(f"delete-node {args.nid}: tombstones={m.num_tombstones}")
    else:  # compact
        rep = None
        for nid in (int(x) for x in args.delete_nodes.split(",") if x):
            m.delete_node(nid)
        remap = m.compact()
        print(f"compact: dropped {int((remap < 0).sum())} rows -> "
              f"{m.backend.num_nodes} nodes, {m.backend.num_edges} edges")
    dt = time.perf_counter() - t0
    report_update(rep, dt, m)
    if args.wal:
        t0 = time.perf_counter()
        with obs.span("launch.snapshot"):
            m.snapshot()
        print(f"snapshot: {time.perf_counter() - t0:.2f}s "
              f"(wal truncated to lsn {backend._wal.committed_lsn})")
    if backend is not None:
        io1 = backend.io.to_dict()
        delta = {key: io1[key] - io0[key] for key in io1}
        print(MetricsReport.format_io(
            delta, label="io delta",
            fields=["sort_cost", "scan_cost", "sort_bytes", "scan_bytes",
                    "merge_passes", "spills"]))
        _report_overlap(backend.aio.stats, dt)
        if args.workdir:
            print(f"workdir: {backend.workdir}")
        else:
            backend.close()


def _dispatch(args) -> None:
    resolve_device(args.device)  # raise before generating a graph
    if args.cmd in _LATER:
        raise SystemExit(
            f"{args.cmd} is not ported yet: it arrives with ROADMAP.md "
            f"queue 1 item {_LATER[args.cmd]}")
    if args.cmd == "recover":
        with obs.span("launch.recover"):
            run_recover(args)  # no graph: state comes from the workdir
        return
    g = make_graph(args)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges")
    if args.cmd:
        with obs.span("launch.update", cmd=args.cmd):
            run_maintenance(args, g)
        return
    res, dt = run_build(args, g)
    report(args, res, dt)
    if args.oocore and not args.workdir:
        res.cleanup()  # tempdir workdir: don't strand the spilled tables


def main(argv=None) -> None:
    ap = build_parser()
    # the subcommands of later slices take the reference's flags, which
    # this parser does not know: _dispatch names their slice instead
    args, rest = ap.parse_known_args(argv)
    if rest and args.cmd not in _LATER:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
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
