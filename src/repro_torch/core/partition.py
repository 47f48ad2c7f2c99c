"""Build_Bisim (Algorithm 1): k-bisimulation partition construction.

The port of `repro.core.partition`.  Bottom-up over iterations j = 0..k
(Prop. 1): iteration 0 dense-ranks node labels; iteration j folds sig_j
from pid_{j-1} (through the Hopper `sig_fold` kernel on the card) and
dense-ranks the signatures.  The early-stop rule of §3.2/App. A.3 — two
consecutive iterations with an equal number of partition blocks mean the
full bisimulation partition has been reached — applies by default.

The JAX package runs the fused build as one `lax.while_loop` program with
a single device->host sync.  Eager PyTorch has no device-side loop (a CUDA
graph would be the tool), so here both routes run the same loop body, one
dispatched iteration at a time, and every iteration leaves its partition
count and a convergence flag (count_j == count_{j-1}) on the device.  The
host drains them in one transfer every ``sync_every`` iterations and stops
at the fixpoint; up to ``sync_every - 1`` iterations dispatched past it are
trimmed, so the result is identical to a per-iteration check.  The routes
differ only in what they sync and keep:

* **fused** (default for ``with_store=False``): iteration 0's count joins
  the first drain; no signature lanes are kept.
* **staged** (``with_store=True`` or ``fused=False``): iteration 0's count
  is synced at once, as in the JAX package, and each level's (hi, lo)
  lanes are kept for the signature stores.

Every device->host transfer emits a ``build.sync`` tracer event and every
dispatched iteration a ``build.dispatch`` event, so ``--trace`` shows what
the port really does; the JAX package's one-sync contract does not carry
over.  The build's phases are tracer spans under ``build.bisim``
(``build.upload``, ``build.prepare``, ``build.iteration`` a level,
``build.drain``, ``build.fetch``, ``build.stores``); each copy emits a
``build.copy`` event with the ``bytes`` it writes; on a card each
level's device time, from CUDA events, is a ``build.level`` event.  A
large graph goes to a card through a fixed ring of pinned buffers
(`core.staging`), so the host's copy of one chunk overlaps the DMA of
the last.  With no tracer installed each of these is one branch.  Pid
histories, counts, convergence, store columns and the `IterationStats`
byte columns equal the JAX package's exactly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..graph.storage import Graph
from ..obs import tracer as obs
from . import signatures as sig
from . import staging
from .sig_store import SigStore, lanes_to_keys

# bytes of sort keys per edge, per mode (Table-7-style accounting)
_KEY_BYTES = {"sorted": 12, "dedup_hash": 12, "multiset": 0}


@dataclasses.dataclass
class IterationStats:
    iteration: int
    num_partitions: int
    # host seconds: this iteration's dispatch plus an even share of the
    # wait of the drain that synced it; not the device's time (on a card
    # with a tracer installed, the ``build.level`` events carry that)
    seconds: float
    # Bytes touched by the bulk operators this iteration — the analogue of
    # the paper's STXXL I/O volume column in Table 7.
    bytes_sorted: int
    bytes_scanned: int


@dataclasses.dataclass
class BisimResult:
    pids: np.ndarray                # int32 [k_eff+1, N] pid history (Table 3)
    counts: list                    # partitions per iteration
    stats: list                     # list[IterationStats]
    converged_at: Optional[int]     # iteration where counts stabilized, or None
    k_requested: int
    # Signature store S per level (sorted u64-key -> pid arrays); level 0
    # keyed by node label — only when with_store=True (maintenance, §4).
    stores: Optional[list] = None
    next_pid: Optional[list] = None

    @property
    def k_effective(self) -> int:
        return self.pids.shape[0] - 1

    def pid_at(self, j: int) -> np.ndarray:
        """pId_j with the paper's Change-k semantics: past the convergence
        point the partition no longer changes (Prop. 7)."""
        return self.pids[min(j, self.k_effective)]


def bisim_step(pid0, src, dst, elabel, pid_prev, *, num_nodes: int,
               mode: str, elabel_range=None, pid_bound=None):
    """One sig_j -> dense-rank iteration on device tensors.

    Returns (pid_new int32 [N], count int32 0-dim, hi, lo) without a host
    sync.  Eager PyTorch needs no buffer donation, so unlike the JAX
    package's step no aliased ``pid_prev`` comes back.  ``pid_bound``
    bounds ``pid_prev`` when it is not a dense rank (maintained pids).
    """
    hi, lo = sig.signature_hashes(pid0, src, dst, elabel, pid_prev,
                                  num_nodes=num_nodes, mode=mode,
                                  elabel_range=elabel_range,
                                  pid_bound=pid_bound)
    pid_new, count = sig.dense_rank_pairs(hi, lo)
    return pid_new, count, hi, lo


def build_bisim(graph: Graph, k: int, *, mode: str = "sorted",
                early_stop: bool = True, with_store: bool = False,
                sync_every: int = 2, fused: Optional[bool] = None,
                device=None) -> BisimResult:
    """Compute the k-bisimulation partition of `graph` on ``device``.

    mode: 'sorted' (paper-faithful), 'dedup_hash' (exact, cheaper sort) or
          'multiset' (sort-free counting-bisimulation refinement).
    device: ``cuda`` unless ``"cpu"`` is asked for; raises without a card.

    ``fused=None`` picks the fused route whenever ``with_store`` is off;
    ``fused=True`` with ``with_store=True`` raises, because the stores
    need each level's signature lanes.  Convergence is drained every
    ``sync_every`` iterations on both routes.
    """
    if sync_every < 1:
        raise ValueError("sync_every must be >= 1")
    if fused and with_store:
        raise ValueError("fused build cannot materialize per-level stores; "
                         "use the staged sync_every path (fused=None/False)")
    if mode not in _KEY_BYTES:
        raise ValueError(f"unknown signature mode: {mode}")
    dev = resolve_device(device)
    if fused is None:
        fused = not with_store
    path = "fused" if fused else "staged"
    with obs.span("build.bisim", nodes=graph.num_nodes,
                  edges=graph.num_edges, k=k, mode=mode, path=path):
        return _build(graph, k, mode, early_stop, with_store, sync_every,
                      path, dev)


class _LevelClock:
    """CUDA events around each level's launches, read at the drain that
    already syncs: each level's device time as a ``build.level`` event and
    as its ``build.iteration`` span's ``device_ms``.  Made only on a card
    with a tracer installed."""

    def __init__(self):
        self._open = {}     # level -> [span, start event, end event]

    @staticmethod
    def _mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self, j: int, span) -> None:
        self._open[j] = [span, self._mark(), None]

    def stop(self, j: int) -> None:
        self._open[j][2] = self._mark()

    def emit(self, levels, converged_at) -> None:
        for j in levels:
            span, start, end = self._open.pop(j)
            ms = start.elapsed_time(end)
            trimmed = converged_at is not None and j > converged_at
            # the span has closed; its record holds this same attrs dict
            span.set(device_ms=ms, trimmed=trimmed)
            obs.event("build.level", level=j, device_ms=ms, trimmed=trimmed)


def _upload(graph: Graph, dev) -> list:
    """The graph's columns on ``dev``; the bytes copied there are counted,
    none on the CPU, whose tensors alias the graph's arrays.  A large
    graph goes to a card through the pinned ring of `core.staging`, and
    the span counts its chunks (``staged_chunks``, 0 on the direct
    path)."""
    columns = (graph.node_labels, graph.src, graph.dst, graph.elabel)
    nbytes = sum(x.nbytes for x in columns) if dev.type != "cpu" else 0
    with obs.span("build.upload", bytes=nbytes) as sp:
        tensors, chunks = staging.upload(columns, dev)
        sp.set(staged_chunks=chunks, slots=staging.SLOTS,
               slot_bytes=staging.SLOT_BYTES)
        obs.event("build.copy", what="upload", to="device", bytes=nbytes)
    return tensors


def _build(graph, k, mode, early_stop, with_store, sync_every, path, dev):
    n = graph.num_nodes
    clock = (_LevelClock() if dev.type == "cuda"
             and obs.current_tracer() is not None else None)
    node_labels, src, dst, elabel = _upload(graph, dev)
    with obs.span("build.prepare"):
        elabel_range = ((int(graph.elabel.min()), int(graph.elabel.max()))
                        if graph.num_edges else (0, 0))
        esize = max(graph.num_edges, 1)
        step_bytes = dict(bytes_sorted=_KEY_BYTES[mode] * esize + 8 * n,
                          bytes_scanned=12 * esize + 8 * n)

    stats, counts = [], []
    with obs.span("build.iteration", level=0) as sp:
        t0 = time.perf_counter()
        if clock:
            clock.start(0, sp)
        obs.event("build.dispatch", path=path, what="iteration0")
        pid0, count0 = sig.dense_rank_ints(node_labels)
        flag0 = count0 != count0
        if clock:
            clock.stop(0)
        # (iteration, count, convergence flag, dispatch seconds), on device
        pending = [(0, count0, flag0, time.perf_counter() - t0)]
    converged_at = None

    def drain() -> bool:
        """One host transfer for all pending (count, flag) scalars."""
        nonlocal converged_at
        if not pending:
            return converged_at is not None
        with obs.span("build.drain", batched=len(pending)) as sp:
            t_sync = time.perf_counter()
            obs.event("build.sync", path=path, what="drain",
                      batched=len(pending))
            scalars = torch.stack([torch.stack([c, f.to(c.dtype)])
                                   for _, c, f, _ in pending])
            host = scalars.tolist()
            nbytes = scalars.numel() * scalars.element_size()
            sp.set(bytes=nbytes)
            obs.event("build.copy", what="drain", to="host", bytes=nbytes)
            # the wait is where the drained steps' device work is paid
            # for; amortize it so per-iteration seconds sum to the wall
            dt_sync = (time.perf_counter() - t_sync) / len(pending)
            for (j, _, _, dt), (c, f) in zip(pending, host):
                counts.append(c)
                stats.append(IterationStats(
                    j, c, dt + dt_sync,
                    **(step_bytes if j else dict(bytes_sorted=4 * n,
                                                 bytes_scanned=4 * n))))
                if early_stop and converged_at is None and f:
                    converged_at = j
            if clock:
                clock.emit([j for j, _, _, _ in pending], converged_at)
            pending.clear()
        return converged_at is not None

    if path == "staged":
        drain()  # the count0 sync of the JAX package's staged path
    history = [pid0]
    sig_pairs = []
    pid_prev, count_prev = pid0, count0
    for j in range(1, k + 1):
        with obs.span("build.iteration", level=j) as sp:
            t0 = time.perf_counter()
            if clock:
                clock.start(j, sp)
            obs.event("build.dispatch", path=path, what="step", iteration=j)
            pid_prev, count, hi, lo = bisim_step(
                pid0, src, dst, elabel, pid_prev, num_nodes=n, mode=mode,
                elabel_range=elabel_range)
            history.append(pid_prev)
            if with_store:
                sig_pairs.append(torch.stack([hi, lo]))
            flag = count == count_prev
            if clock:
                clock.stop(j)
            pending.append((j, count, flag, time.perf_counter() - t0))
            count_prev = count
        if early_stop and j % sync_every == 0 and drain():
            break
    drain()
    if converged_at is not None:
        # Trim iterations dispatched past the fixpoint (Prop. 7: the
        # partition no longer changes, so dropping them loses nothing).
        keep = converged_at + 1
        history = history[:keep]
        counts = counts[:keep]
        stats = stats[:keep]
        sig_pairs = sig_pairs[:keep - 1]

    # one bulk host transfer of the pid history (+ the stores if kept)
    with obs.span("build.fetch") as sp:
        obs.event("build.sync", path=path, what="history")
        pids = torch.stack(history).cpu().numpy()
        sp.set(bytes=pids.nbytes)
        obs.event("build.copy", what="history", to="host",
                  bytes=pids.nbytes)
    stores, next_pid = None, None
    if with_store:
        with obs.span("build.stores", levels=len(history)):
            # level 0 keyed by node label, level j by the sig_j hash
            stores = [SigStore.from_labels(graph.node_labels, pids[0])]
            stores += [_store_of(pair, pid)
                       for pair, pid in zip(sig_pairs, history[1:])]
            next_pid = list(counts[: len(stores)])

    return BisimResult(
        pids=pids, counts=counts, stats=stats,
        converged_at=converged_at, k_requested=k, stores=stores,
        next_pid=next_pid)


def _store_of(pair, pid) -> SigStore:
    """One level's store from its (hi, lo) lanes and pids, on their
    device: the sorted distinct keys, each with its pid — what
    `SigStore.from_hash_pairs` computes on the host (a pid is the dense
    rank of its key, so every copy of a key carries the same one)."""
    key, order = torch.sort(sig.fuse_u32_pair(pair[0], pair[1]))
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    return SigStore(lanes_to_keys(key[first].cpu().numpy()),
                    pid[order][first].cpu().numpy().astype(np.int64),
                    presorted=True)


def partition_blocks(pids: np.ndarray) -> dict:
    """Group node ids by partition id (small-graph helper for tests)."""
    blocks = {}
    for node, p in enumerate(np.asarray(pids).tolist()):
        blocks.setdefault(p, []).append(node)
    return blocks


def same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """Do two pid labelings induce the same partition (up to renaming)?"""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        return False
    fwd, bwd = {}, {}
    for x, y in zip(a.tolist(), b.tolist()):
        if fwd.setdefault(x, y) != y or bwd.setdefault(y, x) != x:
            return False
    return True


def refines(fine: np.ndarray, coarse: np.ndarray) -> bool:
    """Is partition `fine` a refinement of `coarse`?"""
    m = {}
    for f, c in zip(np.asarray(fine).tolist(), np.asarray(coarse).tolist()):
        if m.setdefault(f, c) != c:
            return False
    return True
