"""Bisimulation launcher of the port: run Build_Bisim (in memory,
distributed over a process group with ``--distributed``, or out-of-core
with ``--oocore``) on a generated or saved graph, on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.bisim --generator powerlaw \
        --nodes 100000 --edges 400000 --k 10 --mode sorted
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.bisim --distributed \
        --ranking bucketed --generator structured --nodes 50000
    PYTHONPATH=src python -m repro_torch.launch.bisim --oocore \
        --chunk-edges 65536 --generator structured --nodes 300000

``--distributed`` starts the process group from torchrun's or Slurm's
variables (`launch.cluster.init_cluster`; without them, one rank in this
process) and runs `core.build_bisim_distributed` on every rank; only
rank 0 prints and writes ``--out``.  ``--dist-backend`` (the port's own
flag) is ``nccl`` on the card and ``gloo`` with ``--device cpu``; gloo on
the card lets several ranks share one card.

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

Quotient serving (`repro_torch.quotient`): ``materialize`` persists the
per-level quotient graphs and extents, ``query`` answers structural
queries over them on the card (optionally absorbing update batches
live), and ``serve-updates`` runs the streaming maintenance service
(`exmem.StreamingMaintenanceService`) over ``--oocore --wal --workdir``:

    PYTHONPATH=src python -m repro_torch.launch.bisim --generator \
        structured --nodes 9000 --k 5 materialize --quotient-dir /tmp/q
    PYTHONPATH=src python -m repro_torch.launch.bisim --generator \
        structured --nodes 9000 --k 5 query --path 0:1 --point 7 --update 8
    PYTHONPATH=src python -m repro_torch.launch.bisim --nodes 200000 \
        --edges 1000000 --oocore --wal --workdir /tmp/s serve-updates \
        --kill-at-op 120

Flags, defaults and output lines are those of `repro.launch.bisim`'s
builds (single, distributed and out-of-core), maintenance, quotient and
streaming subcommands.  Propagation runs on the device by
default (``--device-maintenance``, the reference's opt-in);
``--host-maintenance`` asks for the numpy host path.  ``--checkpoint
--workdir DIR`` makes the out-of-core build write a per-level
checkpoint; ``--resume`` continues a killed build from the last
finished level.  ``--trace PATH`` writes a Chrome-trace JSON and prints
the phase table, with the ``build.dispatch`` / ``build.sync`` counts; on
a card each iteration's line adds its level's device ms (``build.level``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import tempfile
import time
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..core import BisimMaintainer, build_bisim, build_bisim_distributed
from ..exmem import (OocBackend, StreamConfig, StreamingMaintenanceService,
                     build_bisim_oocore, replay_open_loop, synthesize_ops)
from ..exmem.runs import IOStats
from ..graph import generators as gen
from ..graph.storage import Graph
from ..obs import MetricsReport, write_chrome_trace
from ..obs import tracer as obs
from .cluster import BACKENDS, init_cluster


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
    # one engine per session: the distributed builder has no out-of-core
    # tables (and no maintenance backend), so the flags cannot combine
    engine = ap.add_mutually_exclusive_group()
    engine.add_argument("--distributed", action="store_true",
                        help="Algorithm 1 over a torch.distributed process "
                             "group (torchrun's or Slurm's ranks; else "
                             "one rank)")
    engine.add_argument("--oocore", action="store_true",
                        help="disk-resident streamed build "
                             "(repro_torch.exmem)")
    ap.add_argument("--ranking", default="allgather",
                    choices=["allgather", "bucketed"])
    ap.add_argument("--dist-backend", default=None, choices=BACKENDS,
                    help="--distributed: the process group's backend "
                         "(default: nccl on the card, gloo with --device "
                         "cpu; gloo on the card lets ranks share it)")
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
                    help="where the build, propagation and query waves "
                         "run (default: the card; cpu runs the "
                         "plain-PyTorch route)")
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
             "OocBackend with --oocore), recover a crashed --wal "
             "workdir, materialize/query the quotient artifact, or run "
             "the streaming maintenance service")
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
    ap_mat = sub.add_parser("materialize",
                            help="build the partition and persist the "
                                 "per-level quotient graphs + extents")
    ap_mat.add_argument("--quotient-dir", required=True,
                        help="artifact directory (overwritten)")
    ap_qry = sub.add_parser(
        "query", help="serve structural queries over the quotient on "
                      "--device: load an existing --quotient-dir "
                      "read-only, or build + materialize first; --update "
                      "absorbs random inserts through the live service "
                      "between queries")
    ap_qry.add_argument("--quotient-dir", default=None,
                        help="load this artifact read-only (no --update) "
                             "instead of building one")
    ap_qry.add_argument("--path", action="append", default=[],
                        metavar="L:L:...",
                        help="label-path query, colon-separated edge "
                             "labels (repeatable)")
    ap_qry.add_argument("--level", type=int, default=None,
                        help="quotient level to answer at (default: "
                             "path length)")
    ap_qry.add_argument("--point", action="append", default=[], type=int,
                        metavar="NID",
                        help="pId/block-size lookup for this node "
                             "(repeatable)")
    ap_qry.add_argument("--update", type=int, default=0, metavar="N",
                        help="apply N random edge inserts through the "
                             "live QuotientService, then re-query at "
                             "the new epoch")
    ap_qry.add_argument("--batch", type=int, default=64,
                        help="engine wave width (fixed slots per wave)")
    ap_srv = sub.add_parser(
        "serve-updates", help="streaming maintenance service: replay an "
                              "open-loop stream of mixed ops through the "
                              "WAL'd ingest loop (batched apply, "
                              "compaction/snapshot cadence, live quotient "
                              "index within a staleness bound); requires "
                              "--oocore --wal --workdir")
    ap_srv.add_argument("--ops", type=int, default=200,
                        help="synthesized stream length (mixed "
                             "insert/delete/add-node ops)")
    ap_srv.add_argument("--rate", type=float, default=0.0,
                        help="arrival rate in ops/sec (0 = closed-loop, "
                             "as fast as the service absorbs)")
    ap_srv.add_argument("--batch-ops", type=int, default=32,
                        help="apply the pending batch at this many ops")
    ap_srv.add_argument("--batch-deadline-ms", type=float, default=50.0,
                        help="... or when the oldest pending op is this "
                             "old")
    ap_srv.add_argument("--snapshot-every", type=int, default=8,
                        help="snapshot cadence in applied batches "
                             "(0 = only the final close snapshot)")
    ap_srv.add_argument("--staleness-batches", type=int, default=1,
                        help="absorb the quotient index after this many "
                             "applied batches (the staleness bound)")
    ap_srv.add_argument("--compact-threshold", type=float, default=0.25,
                        help="tombstone fraction that schedules a WAL'd "
                             "compact op (0 disables; forced to 0 with "
                             "--kill-at-op for bit-identical recovery)")
    ap_srv.add_argument("--async-wal", action="store_true",
                        help="run WAL group-commit fsync rounds on the "
                             "aio executor (drained at snapshot/close)")
    ap_srv.add_argument("--no-quotient", action="store_true",
                        help="ingest + durability only: skip the live "
                             "quotient index")
    ap_srv.add_argument("--kill-at-op", type=int, default=0, metavar="N",
                        help="crash drill: abandon the service after N "
                             "submitted ops (no clean close), recover "
                             "from the snapshot + committed WAL, resubmit "
                             "the lost suffix, and verify the pid "
                             "history is bit-identical to an "
                             "uninterrupted reference run")
    return ap


def _io_threads(args) -> int:
    return 0 if args.no_prefetch else args.io_threads


def _report_overlap(aio_stats, compute_s: float) -> None:
    line = MetricsReport.format_overlap(
        aio_stats.as_dict() if aio_stats is not None else None, compute_s)
    if line is not None:
        print(line)


def _engine(args) -> str:
    return ("oocore" if args.oocore else
            "dist/" + args.ranking if args.distributed else "single")


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
    elif args.distributed:
        build = build_bisim_distributed
        kwargs.update(ranking=args.ranking)
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


def _level_device_ms() -> dict:
    """Each level's device ms from the installed tracer's ``build.level``
    events (the last build's, on a card), or {} without them."""
    tracer = obs.current_tracer()
    if tracer is None:
        return {}
    return {e["attrs"]["level"]: e["attrs"]["device_ms"]
            for e in tracer.find_events("build.level")}


def report(args, res, dt: float) -> None:
    print(f"k={args.k} mode={args.mode} {_engine(args)}")
    device_ms = _level_device_ms()
    for st in res.stats:
        dev = device_ms.get(st.iteration)
        print(f"  iter {st.iteration:2d}: {st.num_partitions:9d} blocks "
              f"{st.seconds * 1e3:9.1f} ms  sortedB={st.bytes_sorted} "
              f"scannedB={st.bytes_scanned}"
              + ("" if dev is None else f"  device={dev:.1f} ms"))
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


def _make_maintainer(args, g: Graph):
    """A `BisimMaintainer` from the engine flags (shared by the
    maintenance and quotient subcommands), with its `OocBackend` or
    None."""
    if args.distributed:
        raise SystemExit(
            "this subcommand supports the single and --oocore engines "
            "(the distributed builder keeps no store)")
    if args.oocore:
        backend = OocBackend(
            g, chunk_edges=args.chunk_edges, chunk_nodes=args.chunk_nodes,
            spill_threshold=args.spill_threshold, workdir=args.workdir,
            io_threads=_io_threads(args), prefetch_depth=args.prefetch_depth,
            wal=args.wal, wal_group=args.wal_group, device=args.device)
        return BisimMaintainer(backend, args.k, mode=args.mode,
                               device_propagation=args.device_maintenance,
                               wal=args.wal), backend
    return BisimMaintainer(g, args.k, mode=args.mode, device=args.device,
                           device_propagation=args.device_maintenance), None


def run_maintenance(args, g: Graph) -> None:
    """Build the partition, apply one update subcommand, report it."""
    if args.distributed:
        raise SystemExit(
            "maintenance subcommands support the single and --oocore "
            "engines (the distributed builder keeps no store)")
    if args.wal and not (args.oocore and args.workdir):
        raise SystemExit("--wal needs --oocore and --workdir (a tempdir "
                         "workdir would be deleted on exit, defeating "
                         "the point of durability)")
    t0 = time.perf_counter()
    m, backend = _make_maintainer(args, g)
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


def run_materialize(args, g: Graph):
    """Build the partition and persist its quotient artifact; returns the
    `QuotientIndex`."""
    from ..quotient import materialize_quotient
    t0 = time.perf_counter()
    m, backend = _make_maintainer(args, g)
    print(f"initial build: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    io = IOStats()
    index = materialize_quotient(
        backend.ooc if backend is not None else g, m.backend,
        args.quotient_dir, counts=[int(x) for x in m.next_pid],
        mode=m.mode, stats=io, overwrite=True)
    dt = time.perf_counter() - t0
    for j in range(1, index.k + 1):
        print(f"  Q_{j}: {index.counts[j]} blocks, "
              f"{index.levels[j].num_edges} edges")
    print(MetricsReport.format_io(
        io.as_dict(), label="materialize io",
        fields=["sort_cost", "scan_cost", "sort_bytes", "scan_bytes"]))
    print(f"materialized {args.quotient_dir} in {dt:.2f}s "
          f"(k={index.k}, mode={index.mode}, epoch={index.epoch})")
    if backend is not None and not args.workdir:
        backend.close()
    return index


def run_query(args) -> list:
    """Answer ``--path``/``--point`` queries on the card (a loaded
    artifact, or a freshly built and materialized one), optionally
    absorbing ``--update`` random inserts live; returns the answers of
    each epoch queried."""
    from ..quotient import (LabelPath, PointLookup, QuotientEngine,
                            QuotientIndex, QuotientService)
    paths = [tuple(int(x) for x in p.split(":")) for p in args.path]
    svc = None
    if args.quotient_dir and os.path.exists(
            os.path.join(args.quotient_dir, "manifest.json")):
        if args.update:
            raise SystemExit("--update needs a live service; drop "
                             "--quotient-dir to build one")
        index = QuotientIndex.load(args.quotient_dir, verify=True)
        engine = QuotientEngine(index, max_batch=args.batch,
                                device=args.device)
        print(f"loaded {args.quotient_dir}: k={index.k} "
              f"mode={index.mode} epoch={index.epoch}")
    else:
        g = make_graph(args)
        print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges")
        t0 = time.perf_counter()
        m, _ = _make_maintainer(args, g)
        workdir = args.workdir or tempfile.mkdtemp(prefix="quotient-")
        svc = QuotientService(m, workdir, max_batch=args.batch)
        engine, index = svc.engine, svc.index
        print(f"build + materialize: {time.perf_counter() - t0:.2f}s "
              f"(epoch {svc.epoch})")

    queries = [LabelPath(p, level=args.level) for p in paths]
    queries += [PointLookup(nid, index.k) for nid in args.point]
    if not queries:
        queries = [PointLookup(0, index.k)]

    def _report(answers):
        for q, a in zip(queries, answers):
            if isinstance(q, PointLookup):
                print(f"  point {q.node}@{q.level}: pid={a.pid} "
                      f"block_size={a.block_size}")
            else:
                head = ",".join(str(x) for x in a[:8])
                more = "..." if a.shape[0] > 8 else ""
                print(f"  path {q.labels}: {a.shape[0]} nodes "
                      f"[{head}{more}]")

    t0 = time.perf_counter()
    answers = engine.query(queries)
    print(f"epoch {engine.epoch}: {len(queries)} queries "
          f"in {(time.perf_counter() - t0) * 1e3:.1f} ms "
          f"({engine.stats['waves']} waves, {engine.stats['hops']} hops)")
    _report(answers)
    epochs = [answers]
    if args.update and svc is not None:
        rng = np.random.default_rng(args.seed)
        n = svc.m.backend.num_nodes
        src = rng.integers(0, n, args.update).astype(np.int32)
        dst = rng.integers(0, n, args.update).astype(np.int32)
        lab = rng.integers(0, 4, args.update).astype(np.int32)
        t0 = time.perf_counter()
        svc.add_edges(src, lab, dst)
        print(f"absorbed {args.update} edge inserts in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms "
              f"(patches={svc.patches}, "
              f"rematerializations={svc.rematerializations})")
        answers = svc.query(queries)
        print(f"epoch {svc.engine.epoch}:")
        _report(answers)
        epochs.append(answers)
    return epochs


def _stream_pids(m) -> list:
    return [np.asarray(m.pids[j]).copy() for j in range(m.k + 1)]


def run_serve(args, g: Graph) -> dict:
    """Open-loop streaming maintenance over the WAL'd ingest loop; with
    ``--kill-at-op`` the crash drill.  Returns the final service's
    ``stats()`` and pid history (and, for the drill, the uninterrupted
    run's ``stats()`` and pid history)."""
    from ..quotient import QuotientService
    if not (args.oocore and args.wal and args.workdir):
        raise SystemExit("serve-updates needs --oocore --wal --workdir")
    cfg = StreamConfig(
        batch_ops=args.batch_ops,
        batch_deadline_s=args.batch_deadline_ms / 1e3,
        snapshot_every=args.snapshot_every,
        staleness_batches=args.staleness_batches,
        compact_threshold=args.compact_threshold,
        async_wal=args.async_wal)
    ops = synthesize_ops(args.ops, num_nodes=g.num_nodes, seed=args.seed)

    def _spinup(workdir):
        backend = OocBackend(
            g, chunk_edges=args.chunk_edges, chunk_nodes=args.chunk_nodes,
            spill_threshold=args.spill_threshold, workdir=workdir,
            io_threads=_io_threads(args),
            prefetch_depth=args.prefetch_depth,
            wal=True, wal_group=args.wal_group, device=args.device)
        m = BisimMaintainer(backend, args.k, mode=args.mode,
                            device_propagation=args.device_maintenance,
                            wal=True)
        q = (None if args.no_quotient
             else QuotientService(m, workdir, aio=backend.aio))
        return StreamingMaintenanceService(m, config=cfg, quotient=q), \
            backend

    def _print_stats(svc):
        st = svc.stats()
        print(f"stream: {st['applied_ops']} ops in {st['wall_s']:.2f}s "
              f"= {st['updates_per_sec']:.0f} updates/s "
              f"({st['applied_batches']} batches, "
              f"{st['snapshots']} snapshots, {st['rejected']} rejected, "
              f"{st['compactions_scheduled']} compactions, "
              f"{st['rebuilds']} rebuilds)")
        if svc.q is not None:
            ok = st["max_staleness"] <= st["staleness_bound"]
            print(f"staleness: max={st['max_staleness']} batches "
                  f"bound={st['staleness_bound']} "
                  f"{'OK' if ok else 'VIOLATED'} "
                  f"(epoch {st['epoch']})")
            if not ok:
                raise SystemExit("staleness bound violated")
        return st

    if not args.kill_at_op:
        svc, backend = _spinup(args.workdir)
        t0 = time.perf_counter()
        with obs.span("launch.serve", ops=len(ops)):
            replay_open_loop(svc, ops, rate=args.rate or None)
            svc.close()
        st = _print_stats(svc)
        print(f"serve: wall {time.perf_counter() - t0:.2f}s, "
              f"wal committed lsn {backend._wal.committed_lsn}")
        print(f"workdir: {backend.workdir}")
        out = dict(stats=st, pids=_stream_pids(svc.m),
                   next_pid=list(svc.m.next_pid))
        backend.close()
        return out

    # crash drill: reference run, killed run, recover, finish, compare.
    # Compaction scheduling is state-timed, so it is disabled for the
    # drill: a lost (uncommitted) compact record would re-schedule at a
    # different position in the op order and honestly diverge.
    cfg = dataclasses.replace(cfg, compact_threshold=0.0)
    kill_at = min(int(args.kill_at_op), len(ops))
    ref_svc, ref_backend = _spinup(os.path.join(args.workdir, "ref"))
    replay_open_loop(ref_svc, ops)
    ref_svc.close()
    ref_stats, ref_pids = ref_svc.stats(), _stream_pids(ref_svc.m)
    ref_backend.close()

    wd = os.path.join(args.workdir, "live")
    svc, backend = _spinup(wd)
    lsns = replay_open_loop(svc, ops[:kill_at])
    backend.aio.close()   # the "dead" process: no clean close, no drain
    print(f"killed after {kill_at}/{len(ops)} submitted ops "
          f"(last acked lsn {lsns[-1] if lsns else 0})")

    svc2 = StreamingMaintenanceService.recover(
        wd, io_threads=_io_threads(args),
        prefetch_depth=args.prefetch_depth, device=args.device,
        device_propagation=args.device_maintenance, config=cfg,
        quotient=not args.no_quotient)
    committed = svc2.m.backend._wal.committed_lsn
    done = sum(1 for lsn in lsns if lsn <= committed)
    print(f"recovered: committed lsn {committed} -> "
          f"{done} ops survived, resubmitting {len(ops) - done}")
    replay_open_loop(svc2, ops[done:])
    svc2.close()
    st = _print_stats(svc2)
    pids = _stream_pids(svc2.m)
    out = dict(stats=st, pids=pids, next_pid=list(svc2.m.next_pid),
               ref_stats=ref_stats, ref_pids=ref_pids, survived=done)
    svc2.m.backend.close()
    if len(pids) != len(ref_pids):
        raise SystemExit("recovery diverged from the uninterrupted run: "
                         f"{len(pids)} levels, not {len(ref_pids)}")
    for j, (a, b) in enumerate(zip(pids, ref_pids)):
        if not np.array_equal(a, b):
            raise SystemExit(
                f"recovery diverged from the uninterrupted run at "
                f"level {j}")
    print("recovery: pid history bit-identical to uninterrupted run")
    return out


def _dispatch(args):
    """Run the subcommand (or the build); returns what it returns."""
    resolve_device(args.device)  # raise before generating a graph
    if args.cmd == "recover":
        with obs.span("launch.recover"):
            return run_recover(args)  # no graph: state from the workdir
    if args.cmd == "query":
        with obs.span("launch.query"):
            return run_query(args)  # loads its own graph/artifact
    g = make_graph(args)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges")
    if args.cmd == "materialize":
        with obs.span("launch.materialize"):
            return run_materialize(args, g)
    if args.cmd == "serve-updates":
        return run_serve(args, g)  # spans live inside the service loop
    if args.cmd:
        with obs.span("launch.update", cmd=args.cmd):
            return run_maintenance(args, g)
    res, dt = run_build(args, g)
    report(args, res, dt)
    if args.oocore and not args.workdir:
        res.cleanup()  # tempdir workdir: don't strand the spilled tables
    return res


@contextlib.contextmanager
def _ranks(args):
    """A ``--distributed`` build starts the process group (unless one is
    running) and stops the one it started; every rank but 0 runs with
    its output swallowed and no ``--out`` or ``--trace`` to write.
    Yields the arguments this rank runs with."""
    if not (args.distributed and args.cmd is None):
        yield args
        return
    started = not dist.is_initialized()
    rank, _ = init_cluster(args.device, args.dist_backend)
    try:
        if rank == 0:
            yield args
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                yield argparse.Namespace(**{**vars(args), "out": None,
                                            "trace": None})
    finally:
        if started:
            dist.destroy_process_group()


def main(argv=None):
    with _ranks(build_parser().parse_args(argv)) as args:
        return _main(args)


def _main(args):
    if not args.trace:
        return _dispatch(args)
    tracer = obs.Tracer()
    with obs.tracing(tracer):
        out = _dispatch(args)
    write_chrome_trace(tracer, args.trace)
    print(f"trace: {args.trace} ({len(tracer.spans)} spans, "
          f"{len(tracer.events)} events)")
    print(MetricsReport.from_tracer(tracer).format())
    return out


if __name__ == "__main__":
    main()
