"""Streamed Build_Bisim (Algorithm 1) over disk-resident tables.

`build_bisim_oocore` is the out-of-core sibling of
`repro_torch.core.build_bisim`: same partition (up to pid renaming), but
every table — N_t, both E_t sort orders, the per-level pId files and the
signature store S — lives on disk, and per-iteration resident memory is a
constant number of chunks.  The per-iteration pipeline follows the
paper's sort/scan discipline exactly:

  1. *join* (lines 9-11): scan E_tts (sorted by tId) and the pId_{j-1}
     file (sorted by nId) in lockstep — a sequential sort-merge join that
     resolves every edge's `pId_old(tId)` with zero random accesses —
     emitting (sId, eLabel, pId) records.
  2. *re-sort* (line 12): `runs.external_sort` brings the joined records
     into (sId, eLabel, pId) order: run formation + bounded-memory k-way
     merge, the `O(sort(|E_t|))` term.
  3. *fold* (lines 13-15): the sorted stream is deduplicated (set
     semantics; skipped in `multiset` mode) and folded chunk-by-chunk on
     the device: every chunk goes to the card and through the
     hand-written Hopper kernel `kernels.sig_fold.chunk_sig_fold` (dedup,
     the same mix-hash lanes as `core.signatures`, per-source wrap-sum)
     into one row per distinct source of the chunk; the host passes only
     the cross-chunk ``keep0`` bit, and the u32
     partial sums are wrap-add combined across chunk boundaries on the
     host.  On the CPU every chunk takes the kernel's plain version.
  4. *rank* (lines 16-18): walking N_t in node order, each node chunk's
     signature hashes are resolved to dense pids through a
     `SpillableSigStore` and appended to the pId_j file — the paper's
     sorted signature file S with spill-to-disk behavior.

`IOStats.sort_cost`/`scan_cost` count records through these passes, so a
k-iteration build shows the paper's `O(k·sort(|E_t|) + k·scan(|N_t|) +
sort(|N_t|))` shape: both counters grow linearly in k.

Checkpoint/resume: with ``checkpoint=True`` (requires an explicit
``workdir``) every completed level commits a ``ckpt.json`` — build
params, counts, per-iteration stats, cumulative `IOStats`, the CRC-32 of
every finished pid file, and (with ``keep_stores``) each retired store's
flushed run state.  ``resume=True`` re-opens that checkpoint: finished
pid files are checksum-verified (charged to `IOStats` as the recovery
scan), counters continue rather than reset, stale per-iteration scratch
from the killed run is discarded, and the build restarts at the first
unfinished level — so a crash at any point costs at most one level of
redo, never the whole build.

The port of `repro.exmem.build`: the join, the external sort, the spill
store and the rank are the reference's numpy code, bit for bit (pid files
and `IOStats` equal the reference's); only the fold runs on the device.
Every torch call is made on the caller's thread — the `aio` pipeline's
threads move numpy chunks only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
import time
from typing import Iterator, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..core import hashes_np
from ..core.integrity import verify_npy
from ..core.partition import IterationStats
from ..core.sig_store import SpillableSigStore, fuse_key, label_key
from ..graph.storage import Graph
from ..kernels.sig_fold import VEC, chunk_sig_fold
from ..obs import tracer as obs

from . import aio as aio_mod
from . import runs as runs_mod
from .durability import atomic_write_json, read_json
from .runs import IOStats
from .tables import OocGraph

_JOIN_DTYPE = np.dtype([("src", "<i4"), ("elabel", "<i4"), ("pid", "<i4")])
_JOIN_KEYS = ("src", "elabel", "pid")
_CKPT = "ckpt.json"
_CKPT_VERSION = 1


@dataclasses.dataclass
class OocBisimResult:
    """`BisimResult` sibling whose pid history lives in per-level files."""

    workdir: str
    pid_paths: list                 # pid_j file per level (int32 [N] .npy)
    counts: list                    # partitions per iteration
    stats: list                     # list[IterationStats]
    io: IOStats                     # cumulative sort/scan counters
    converged_at: Optional[int]
    k_requested: int
    num_nodes: int
    # with keep_stores=True: the per-level SpillableSigStore (spill dirs
    # under workdir/stores) and the next-free pid per level — what the
    # out-of-core maintenance backend adopts
    stores: Optional[list] = None
    next_pids: Optional[list] = None
    aio: Optional[aio_mod.AioStats] = None   # overlap report (read/write wait)
    _pids_cache: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def k_effective(self) -> int:
        return len(self.pid_paths) - 1

    @property
    def pids(self) -> np.ndarray:
        """Full pid history, materialized in memory (small graphs/tests)."""
        if self._pids_cache is None:
            self._pids_cache = np.stack(
                [np.load(p) for p in self.pid_paths])
        return self._pids_cache

    def pid_at(self, j: int) -> np.ndarray:
        """pId_j with Change-k semantics past convergence (Prop. 7)."""
        return np.load(self.pid_paths[min(j, self.k_effective)])

    def cleanup(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def _upload(lanes: np.ndarray, device: torch.device) -> torch.Tensor:
    """One chunk's (elabel, pid, seg) int32 [3, lanes] block to the device
    in one copy (a no-op view on the CPU)."""
    return torch.from_numpy(lanes).to(device)


def _joined_chunks(ooc: OocGraph, pid_mm: np.ndarray, window_rows: int,
                   io: IOStats, level: int = 0) -> Iterator[np.ndarray]:
    """Stage 1: E_tts ⋈ pId_{j-1} as a sequential merge join.

    Both inputs are sorted by target/node id, so the pid file advances
    monotonically and is scanned once per iteration (counted by the
    caller).  A chunk's dst *span* is unbounded on sparse graphs
    (N >> E), so each chunk is consumed in sub-ranges whose pid window is
    capped at `window_rows` — resident memory stays a constant number of
    chunks regardless of sparsity."""
    scan = ooc.iter_edges_tts(io)
    try:
        for chunk in scan:
            dst = chunk["dst"].astype(np.int64)
            pos = 0
            while pos < dst.shape[0]:
                # span per emitted join sliver, closed before the yield
                with obs.span("build.join", level=level) as sp:
                    d0 = int(dst[pos])
                    cut = int(np.searchsorted(dst, d0 + window_rows,
                                              side="left"))
                    window = np.asarray(pid_mm[d0:d0 + window_rows])
                    part = slice(pos, cut)
                    rec = np.empty(cut - pos, _JOIN_DTYPE)
                    rec["src"] = chunk["src"][part]
                    rec["elabel"] = chunk["elabel"][part]
                    rec["pid"] = window[dst[part] - d0]
                    pos = cut
                    sp.set(rows=int(rec.shape[0]))
                yield rec
    finally:
        # the scan may be a prefetched generator: close it promptly so an
        # abandoned join (early convergence, error) leaves no live thread
        scan.close()


def _fold_sorted_stream(stream: Iterator[np.ndarray], chunk_edges: int,
                        dedup: bool, device: torch.device, level: int = 0):
    """Stage 3: consume (src, elabel, pid)-sorted chunks; yield
    (src_unique, hi_partial, lo_partial) per chunk, sorted by src.

    Duplicate (src, elabel, pid) records are dropped across chunk
    boundaries too (set semantics, Algorithm 1 line 13); partial sums for
    a source spanning several chunks are combined by the caller (u32
    wrap-add is associative).  Each chunk is one `chunk_sig_fold` call on
    ``device`` — the kernel on the card, its plain version on the CPU — over
    its ``n`` lanes (rounded up to the kernel's vector width, so that every
    row of the uploaded [3, lanes] block stays 16-byte aligned) into its
    ``u`` distinct sources, with one copy each way."""
    # the pad lanes past n carry seg = u, which matches no row, so the lane
    # mask may be all True: a slice of one tensor, no device op a chunk
    valid = torch.ones(-(-chunk_edges // VEC) * VEC, dtype=torch.bool,
                       device=device)

    def _rechunk():
        # merge_runs can overshoot its budget by up to one row per run
        # (every live run contributes >= 1-row blocks); split so a fold
        # never exceeds chunk_edges lanes.
        for chunk in stream:
            for s in range(0, chunk.shape[0], chunk_edges):
                yield chunk[s:s + chunk_edges]

    prev_last = None
    for chunk in _rechunk():
        src = chunk["src"]
        lab = chunk["elabel"]
        pid = chunk["pid"]
        n = src.shape[0]
        if n == 0:
            continue
        # the per-chunk device-fold span (the p50/p99 the MetricsReport
        # quotes); closed before the yield
        with obs.span("build.fold", level=level, rows=int(n)):
            keep0 = True
            if dedup and prev_last is not None:
                keep0 = (int(src[0]), int(lab[0]),
                         int(pid[0])) != prev_last
            prev_last = (int(src[-1]), int(lab[-1]), int(pid[-1]))
            new_src = np.ones(n, dtype=bool)
            new_src[1:] = src[1:] != src[:-1]
            src_u = src[new_src].astype(np.int64)
            u = src_u.shape[0]
            width = -(-n // VEC) * VEC
            lanes = np.empty((3, width), np.int32)
            lanes[0, :n] = lab
            lanes[1, :n] = pid
            np.cumsum(new_src, dtype=np.int32, out=lanes[2, :n])
            lanes[2, :n] -= 1
            lanes[:2, n:] = 0
            lanes[2, n:] = u
            lanes = _upload(lanes, device)
            # the kernel owns the dedup: only the cross-chunk boundary bit
            # crosses from the host
            sums = chunk_sig_fold(lanes[0], lanes[1], lanes[2],
                                  valid[:width], keep0, num_segments=u,
                                  dedup=dedup)
            hi_u, lo_u = sums.cpu().numpy().astype(np.uint32)
        yield src_u, hi_u, lo_u


def build_bisim_oocore(graph: Union[Graph, OocGraph], k: int, *,
                       mode: str = "sorted", chunk_edges: int = 1 << 16,
                       chunk_nodes: Optional[int] = None,
                       early_stop: bool = True,
                       workdir: Optional[str] = None,
                       spill_threshold: int = 1 << 20,
                       keep_stores: bool = False,
                       stats: Optional[IOStats] = None,
                       io_threads: int = 1, prefetch_depth: int = 2,
                       aio: Optional[aio_mod.AioConfig] = None,
                       checkpoint: bool = False,
                       resume: bool = False,
                       device=None) -> OocBisimResult:
    """Out-of-core Build_Bisim. Accepts an in-memory `Graph` (spilled to
    chunked tables first) or an `OocGraph` (whose chunk geometry wins).

    mode: 'sorted' / 'dedup_hash' (set semantics, identical partitions) or
    'multiset' (counting bisimulation; dedup pass skipped). Partitions are
    identical, up to pid renaming, to `build_bisim` in the same mode.

    keep_stores=True retains every level's `SpillableSigStore` (spill dirs
    under ``workdir/stores``) on the result instead of deleting them with
    the per-iteration scratch — required by the maintenance backend, which
    keeps resolving new signatures against S after the build.  `stats`
    threads an external `IOStats` so callers accumulating cross-build
    counters (maintenance again) see the build's costs too.

    io_threads / prefetch_depth configure the `exmem.aio` pipeline: table
    scans, the join stream, the external re-sort (async run saves +
    readahead merge inputs), the final sorted stream feeding the device
    fold, and the pid-file writes all run double-buffered behind bounded
    queues.  ``io_threads=0`` disables the pipeline (fully synchronous).
    Either way the partition is bit-identical and `IOStats` is exactly
    equal — the pipeline changes *when* bytes move, never what or how
    much.  An explicit ``aio`` config (the maintenance backend shares
    one across builds) overrides the two knobs; the caller then owns its
    lifecycle.

    checkpoint=True commits a ``ckpt.json`` after every completed level;
    resume=True continues from it if present (a missing checkpoint just
    builds from scratch).  Both require an explicit ``workdir`` — the
    checkpoint's whole point is surviving this process, so it cannot
    live in an owned tempdir that error cleanup deletes.

    ``device`` (default: the card, see `repro_torch.resolve_device`) is
    where every chunk fold runs: ``cuda`` launches the Hopper kernel for
    each chunk, ``cpu`` takes its plain version.  Results are identical.
    """
    device = resolve_device(device)
    if mode not in ("sorted", "dedup_hash", "multiset"):
        raise ValueError(f"unknown signature mode: {mode}")
    if (checkpoint or resume) and workdir is None:
        raise ValueError("checkpoint/resume require an explicit workdir")
    dedup = mode != "multiset"
    owns_workdir = workdir is None
    if owns_workdir:
        workdir = tempfile.mkdtemp(prefix="oocore-")
    os.makedirs(workdir, exist_ok=True)
    owns_aio = aio is None
    if owns_aio:
        aio = aio_mod.AioConfig(io_threads=io_threads,
                                prefetch_depth=prefetch_depth)
    try:
        return _build_oocore(
            graph, k, mode=mode, dedup=dedup, chunk_edges=chunk_edges,
            chunk_nodes=chunk_nodes, early_stop=early_stop,
            workdir=workdir, spill_threshold=spill_threshold,
            keep_stores=keep_stores, stats=stats, aio=aio,
            checkpoint=checkpoint, resume=resume, device=device)
    except BaseException:
        if owns_workdir:
            # a failed build must not strand GBs of spilled tables in a
            # tempdir the caller has no handle to
            shutil.rmtree(workdir, ignore_errors=True)
        raise
    finally:
        if owns_aio:
            aio.close()


def _build_oocore(graph: Union[Graph, OocGraph], k: int, *, mode: str,
                  dedup: bool, chunk_edges: int,
                  chunk_nodes: Optional[int], early_stop: bool,
                  workdir: str, spill_threshold: int,
                  keep_stores: bool = False,
                  stats: Optional[IOStats] = None,
                  aio: Optional[aio_mod.AioConfig] = None,
                  checkpoint: bool = False,
                  resume: bool = False,
                  device: torch.device
                  ) -> OocBisimResult:
    io = stats if stats is not None else IOStats()
    if aio is None:
        aio = aio_mod.AioConfig(io_threads=0)
    restore_graph_aio = False
    if isinstance(graph, Graph):
        ooc = OocGraph.from_graph(
            graph, os.path.join(workdir, "graph"),
            chunk_nodes=chunk_nodes or chunk_edges, chunk_edges=chunk_edges,
            aio=aio)
    else:
        ooc = graph
        if ooc.aio is None:
            # thread the caller's tables through this build's pipeline;
            # put the graph back the way we found it on exit
            ooc.aio = aio
            restore_graph_aio = True
    try:
        return _build_oocore_inner(
            ooc, k, mode=mode, dedup=dedup, early_stop=early_stop,
            workdir=workdir, spill_threshold=spill_threshold,
            keep_stores=keep_stores, io=io, aio=aio,
            checkpoint=checkpoint, resume=resume, device=device)
    finally:
        if restore_graph_aio:
            ooc.aio = None


def _build_oocore_inner(ooc: OocGraph, k: int, *, mode: str, dedup: bool,
                        early_stop: bool, workdir: str,
                        spill_threshold: int, keep_stores: bool,
                        io: IOStats, aio: aio_mod.AioConfig,
                        checkpoint: bool = False, resume: bool = False,
                        device: torch.device
                        ) -> OocBisimResult:
    n = ooc.num_nodes
    c_edges = ooc.chunk_edges
    c_nodes = ooc.chunk_nodes
    kept_stores: list = []
    # everything that must match for a checkpoint to be resumable (k may
    # differ: resuming with a larger k just builds more levels)
    params = dict(mode=mode, dedup=dedup, num_nodes=n,
                  chunk_edges=c_edges, chunk_nodes=c_nodes,
                  spill_threshold=int(spill_threshold),
                  keep_stores=bool(keep_stores))
    ckpt_path = os.path.join(workdir, _CKPT)
    pid_sums: dict = {}      # pid file basename -> [rows, crc32]
    store_states: list = []  # per retired level: SpillableSigStore.state()

    def _pid_path(j: int) -> str:
        return os.path.join(workdir, f"pid_{j:03d}.npy")

    def _new_store(it_dir: str, j: int) -> SpillableSigStore:
        # kept stores outlive the per-iteration scratch dir: their spill
        # runs go under workdir/stores and survive the it_dir rmtree
        spill_dir = (os.path.join(workdir, "stores", f"lvl_{j:03d}")
                     if keep_stores else os.path.join(it_dir, "store"))
        return SpillableSigStore(
            spill_threshold=spill_threshold, spill_dir=spill_dir, io=io,
            aio=aio)

    def _retire_store(store: SpillableSigStore) -> None:
        if keep_stores:
            if checkpoint:
                # a retired store is never written again during the
                # build; flush now so its run files are final and the
                # checkpoint can describe them
                store.flush()
                store_states.append(store.state())
            kept_stores.append(store)
        else:
            store.close()

    def _write_ckpt(level: int, counts, it_stats, converged_at) -> None:
        atomic_write_json(ckpt_path, {
            "version": _CKPT_VERSION, "params": params, "level": level,
            "counts": [int(c) for c in counts],
            "it_stats": [dataclasses.asdict(s) for s in it_stats],
            "io": io.to_dict(), "pids": pid_sums,
            "converged_at": converged_at,
            "stores": store_states if keep_stores else None,
        })

    def _result(pid_paths, counts, it_stats, converged_at):
        return OocBisimResult(
            workdir=workdir, pid_paths=pid_paths, counts=counts,
            stats=it_stats, io=io, converged_at=converged_at,
            k_requested=k, num_nodes=n,
            stores=kept_stores if keep_stores else None,
            next_pids=list(counts) if keep_stores else None,
            aio=aio.stats)

    # ------------------------------------------------------------ resume
    start_level = 0
    converged_at = None
    if resume and os.path.exists(ckpt_path):
        ck = read_json(ckpt_path)
        if ck.get("version") != _CKPT_VERSION or ck.get("params") != params:
            raise ValueError(
                f"checkpoint in {workdir!r} does not match this build "
                f"(checkpoint params {ck.get('params')!r}, ours "
                f"{params!r})")
        io.restore(ck["io"])  # counters continue, not reset
        pid_sums.update(ck["pids"])
        for rel in sorted(pid_sums):
            rows, crc = pid_sums[rel]
            # verify every finished pid file before trusting it; the
            # verification read is the recovery scan, charged to io
            arr = verify_npy(os.path.join(workdir, rel), crc,
                             expected_rows=rows)
            io.count_scan(arr.shape[0], arr.nbytes)
        level = int(ck["level"])
        counts = [int(c) for c in ck["counts"]]
        it_stats = [IterationStats(**d) for d in ck["it_stats"]]
        pid_paths = [_pid_path(j) for j in range(level + 1)]
        converged_at = ck.get("converged_at")
        if keep_stores:
            store_states.extend(ck.get("stores") or [])
            for j, st in enumerate(store_states):
                s = _new_store("", j)
                s.adopt_state(st)
                kept_stores.append(s)
        # drop the killed run's stale scratch: per-iteration dirs,
        # unpublished writer temps, and store dirs past the checkpoint
        for name in os.listdir(workdir):
            p = os.path.join(workdir, name)
            if name.startswith("it") and os.path.isdir(p):
                shutil.rmtree(p, ignore_errors=True)
            elif name.endswith(".aio-tmp"):
                os.remove(p)
        if keep_stores:
            sroot = os.path.join(workdir, "stores")
            if os.path.isdir(sroot):
                for name in os.listdir(sroot):
                    if (name.startswith("lvl_")
                            and int(name[4:]) >= len(store_states)):
                        shutil.rmtree(os.path.join(sroot, name),
                                      ignore_errors=True)
        start_level = level + 1
        if converged_at is not None or start_level > k:
            return _result(pid_paths, counts, it_stats, converged_at)

    # ---------------------------------------------------- iteration 0
    # Rank node labels into pId_0, streaming N_t chunk by chunk through
    # the store — the paper's one-off `sort(|N_t|)` term.  The N_t scan
    # is prefetched (via ooc.aio) and the pid file is appended through a
    # double-buffered StreamingWriter (atomic rename on close).
    if start_level == 0:
        t0 = time.perf_counter()
        s_sort0, s_scan0 = io.sort_bytes, io.scan_bytes
        it_dir = os.path.join(workdir, "it000")
        store = _new_store(it_dir, 0)
        next_pid = 0
        with obs.span("build.level", level=0, io=io), \
                aio.writer(_pid_path(0), np.int32, n) as pid_w:
            for base, labels in ooc.iter_nodes(io):
                with obs.span("build.rank", level=0,
                              rows=int(labels.shape[0])):
                    pids_chunk, next_pid = store.get_or_assign(
                        label_key(labels), next_pid)
                with obs.span("build.pid_write", level=0):
                    pid_w.write(pids_chunk.astype(np.int32))
                io.count_sort(labels.shape[0], labels.shape[0] * 4)  # rank
        pid_sums["pid_000.npy"] = [n, pid_w.checksum]
        _retire_store(store)
        shutil.rmtree(it_dir, ignore_errors=True)
        counts = [next_pid]
        it_stats = [IterationStats(0, next_pid, time.perf_counter() - t0,
                                   bytes_sorted=io.sort_bytes - s_sort0,
                                   bytes_scanned=io.scan_bytes - s_scan0)]
        pid_paths = [_pid_path(0)]
        if checkpoint:
            _write_ckpt(0, counts, it_stats, None)
        start_level = 1

    pid0_mm = np.load(_pid_path(0), mmap_mode="r")
    for j in range(start_level, k + 1):
        t0 = time.perf_counter()
        s_sort0, s_scan0 = io.sort_bytes, io.scan_bytes
        it_dir = os.path.join(workdir, f"it{j:03d}")
        os.makedirs(it_dir, exist_ok=True)
        pid_prev_mm = np.load(pid_paths[-1], mmap_mode="r")

        # stages 1+2: join then external re-sort into (src, elabel, pid).
        # The join emits one sliver per pid window — far below the budget
        # on sparse N >> E graphs — so rebuffer to full chunk_edges-sized
        # chunks first: every formed run is budget-sized and the merge
        # fan-in stays at ceil(|E_t| / chunk_edges).  The pipeline puts
        # one PrefetchReader under the join (the E_tts scan, via ooc.aio)
        # and one over the whole join+re-sort chain, which therefore runs
        # ahead of the device fold; the re-sort itself uses async run
        # saves and windowed readahead of the merge inputs.  (No reader
        # between join and re-sort: both are CPU-light and share one
        # thread — an extra hop costs more GIL churn than it overlaps.)
        # stages 3+4: device fold + streamed ranking in node order; the
        # pId_j file goes through a double-buffered StreamingWriter so
        # ranking window w streams to disk while window w+1 folds.
        store = _new_store(it_dir, j)
        pid_w = aio.writer(_pid_path(j), np.int32, n)
        acc_hi = np.zeros(c_nodes, np.uint32)
        acc_lo = np.zeros(c_nodes, np.uint32)
        next_pid = 0
        node_base = 0

        def _finalize_window(base: int) -> int:
            nonlocal next_pid
            end = min(base + c_nodes, n)
            with obs.span("build.rank", level=j, rows=end - base):
                p0 = np.asarray(pid0_mm[base:end])
                io.count_scan(end - base, (end - base) * 4)  # pId_0 scan
                hi, lo = hashes_np.hash_triple(acc_hi[:end - base],
                                               acc_lo[:end - base], p0)
                keys = fuse_key(hi, lo)
                pids_chunk, next_pid = store.get_or_assign(keys, next_pid)
            with obs.span("build.pid_write", level=j):
                pid_w.write(pids_chunk.astype(np.int32))
            io.count_sort(end - base, (end - base) * 8)  # ranking via S
            acc_hi.fill(0)
            acc_lo.fill(0)
            return end

        try:
            with obs.span("build.level", level=j, io=io), \
                    contextlib.ExitStack() as stack:
                joined = stack.enter_context(contextlib.closing(
                    _joined_chunks(ooc, pid_prev_mm, c_nodes, io,
                                   level=j)))
                sorted_stream = stack.enter_context(contextlib.closing(
                    aio.prefetch(runs_mod.external_sort(
                        runs_mod.rebuffer(joined, c_edges), _JOIN_KEYS,
                        os.path.join(it_dir, "sort"), budget_rows=c_edges,
                        stats=io, aio=aio, obs_attrs={"level": j}))))
                io.count_scan(n, n * 4)  # the pid_{j-1} scan of the join
                for src_u, hi_u, lo_u in _fold_sorted_stream(sorted_stream,
                                                             c_edges, dedup,
                                                             device,
                                                             level=j):
                    i = 0
                    while i < src_u.shape[0]:
                        wend = node_base + c_nodes
                        cut = int(np.searchsorted(src_u, wend, side="left"))
                        if cut > i:
                            # src_u is strictly increasing, so the slice
                            # indices are unique: plain fancy-indexed add
                            # (uint32 wrap) beats the per-element
                            # np.add.at dispatch
                            rows = src_u[i:cut] - node_base
                            with np.errstate(over="ignore"):
                                acc_hi[rows] += hi_u[i:cut]
                                acc_lo[rows] += lo_u[i:cut]
                            i = cut
                        if i < src_u.shape[0]:
                            _finalize_window(node_base)
                            node_base += c_nodes
                while node_base < n:
                    _finalize_window(node_base)
                    node_base += c_nodes
                pid_w.close()
        except BaseException:
            pid_w.abort()
            # the incomplete level's store is scratch: discard its spill
            # runs (a resume rebuilds this level from pid_{j-1}) so an
            # interrupted build leaks neither files nor pending futures
            store.close()
            raise
        pid_sums[f"pid_{j:03d}.npy"] = [n, pid_w.checksum]
        _retire_store(store)
        shutil.rmtree(it_dir, ignore_errors=True)

        counts.append(next_pid)
        pid_paths.append(_pid_path(j))
        it_stats.append(IterationStats(
            j, next_pid, time.perf_counter() - t0,
            bytes_sorted=io.sort_bytes - s_sort0,
            bytes_scanned=io.scan_bytes - s_scan0))
        if early_stop and counts[-1] == counts[-2]:
            converged_at = j
        if checkpoint:
            _write_ckpt(j, counts, it_stats, converged_at)
        if converged_at is not None:
            break

    return _result(pid_paths, counts, it_stats, converged_at)
