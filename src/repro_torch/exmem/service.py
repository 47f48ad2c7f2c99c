"""Streaming maintenance service: sustained ingest over the WAL.

The paper's maintenance algorithms are per-batch; this module turns an
*open-loop stream* of mixed logical updates into scheduled batches with
bounded durability loss and bounded index staleness:

  submit          every op is appended to the WAL immediately (the ack
                  point — group commit already bounds the loss window to
                  ``group - 1`` acknowledged ops) and buffered;
  batch trigger   the buffer is applied through
                  `BisimMaintainer.apply_ops` when it reaches
                  ``batch_ops`` ops or its oldest op ages past
                  ``batch_deadline_s`` (checked on `submit`/`poll`).
                  Ops apply strictly in submission order, one at a time,
                  so the pid history is bit-identical to unbatched
                  application — and to a WAL replay of the same records;
  index patch     after every ``staleness_batches`` applied batches the
                  attached `QuotientService` absorbs the accumulated
                  per-level changed-node union (one engine epoch per
                  absorption; queries stay lock-free on the pinned
                  pre-patch epoch while it lands);
  compaction      when the tombstone fraction crosses
                  ``compact_threshold``, a ``compact`` op is enqueued
                  through the normal submit path (WAL'd like any other
                  op, so recovery replays it at the same point);
  rebuild         the maintainer's §4.2 heuristic firing (most nodes
                  queued -> rebuild is cheaper) is reported through
                  `on_rebuild`; the service counts it and forces an
                  early snapshot, since the WAL records absorbed by the
                  rebuilt state would otherwise replay against a long
                  redo chain;
  snapshot        on a cadence (every ``snapshot_every`` applied
                  batches) instead of per-call; each snapshot commits
                  the WAL (draining any in-flight async group commit),
                  publishes the manifest-committed snapshot directory,
                  and truncates absorbed records — the durable lsn
                  *floor* written by `WriteAheadLog.truncate` keeps the
                  numbering monotone even across a full truncation.

Recovery (`StreamingMaintenanceService.recover`) is the WAL protocol:
`OocBackend.restore` adopts the last committed snapshot, then
`BisimMaintainer.restore` redo-replays every committed WAL record past
it.  Ops the backend rejected are in the log too (redo rule: the record
lands before validation) and are skipped identically, so a killed
stream resumed from its surviving lsn recovers the bit-identical pid
history of a never-killed run.

`synthesize_ops` builds deterministic op streams (one rng per op,
seeded ``seed + 7919 * (i + 1)`` — the fuzz-harness convention, so a
recovered run can resubmit exactly the lost suffix), and
`replay_open_loop` submits them at a fixed arrival rate.

The port's copy of `repro.exmem.service` over the port's maintainer and
`OocBackend`.  One naming differs, as everywhere in the port's
maintenance: `recover` takes ``device_propagation`` (on by default) and
the restored backend's ``device`` where the reference takes
``device: bool``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.maintenance import BisimMaintainer
from ..obs import tracer as obs


@dataclasses.dataclass
class StreamConfig:
    """Scheduling knobs for `StreamingMaintenanceService`."""

    batch_ops: int = 64            # apply when this many ops are pending
    batch_deadline_s: float = 0.05  # ... or when the oldest pending op
    #                                 is this old (checked on submit/poll)
    snapshot_every: int = 8        # snapshot cadence in applied batches;
    #                                0 disables automatic snapshots
    staleness_batches: int = 1     # absorb the quotient index after this
    #                                many applied batches (the staleness
    #                                bound, in batches)
    compact_threshold: float = 0.25  # tombstone fraction that enqueues a
    #                                  compact op; 0 disables
    async_wal: bool = False        # run WAL group-commit fsync rounds on
    #                                the backend's aio executor

    def __post_init__(self):
        if self.batch_ops < 1:
            raise ValueError("batch_ops must be >= 1")
        if self.staleness_batches < 1:
            raise ValueError("staleness_batches must be >= 1")


class StreamingMaintenanceService:
    """Long-running ingest loop over a WAL'd `BisimMaintainer`.

    Single-threaded and cooperative: callers drive it with
    `submit`/`poll`; background concurrency comes from the WAL's async
    group-commit rounds (``async_wal``) on the backend's aio executor.
    ``quotient`` (a `QuotientService` over the same maintainer) is
    optional — without it the service is ingest + durability only.
    """

    def __init__(self, maintainer: BisimMaintainer, *,
                 config: Optional[StreamConfig] = None,
                 quotient=None, clock=time.monotonic):
        self.m = maintainer
        self.cfg = config or StreamConfig()
        self.q = quotient
        self.clock = clock
        if self.cfg.async_wal and self.m.wal:
            enable = getattr(self.m.backend, "wal_enable_async", None)
            if enable is not None:
                enable(True)
        self.m.on_rebuild = self._note_rebuild
        self._pending: List[Tuple[str, dict]] = []
        self._pending_t0: Optional[float] = None
        self._in_apply = False
        self._changed_acc: Optional[list] = []   # [] = clean, None = poisoned
        self._unabsorbed = 0
        self._batches_since_snapshot = 0
        self._force_snapshot = False
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self.submitted = 0
        self.applied_ops = 0
        self.applied_batches = 0
        self.rejected = 0
        self.absorbed = 0
        self.snapshots = 0
        self.rebuilds = 0
        self.compactions_scheduled = 0
        self.max_staleness = 0

    # -------------------------------------------------------------- ingest
    def submit(self, op: str, arrays: dict) -> int:
        """Accept one logical update in WAL-record form (`_REPLAY_OPS`
        vocabulary).  Appends it to the WAL (the ack point), buffers it,
        and fires the batch trigger if due.  Returns the op's lsn (-1
        when the maintainer runs without a WAL)."""
        if op not in BisimMaintainer._REPLAY_OPS:
            raise ValueError(f"unknown streaming op: {op!r}")
        now = self.clock()
        if self._t0 is None:
            self._t0 = now
        lsn = -1
        if self.m.wal:
            lsn = self.m.backend.wal_append(op, dict(arrays))
        self._pending.append((op, arrays))
        self.submitted += 1
        if self._pending_t0 is None:
            self._pending_t0 = now
        if not self._in_apply:
            self._maybe_apply(now)
        return lsn

    # typed conveniences over the record vocabulary
    def add_edges(self, src, elabel, dst) -> int:
        return self.submit("add_edges", dict(
            src=np.atleast_1d(np.asarray(src, dtype=np.int32)),
            elabel=np.atleast_1d(np.asarray(elabel, dtype=np.int32)),
            dst=np.atleast_1d(np.asarray(dst, dtype=np.int32))))

    def delete_edges(self, src, elabel, dst) -> int:
        return self.submit("delete_edges", dict(
            src=np.atleast_1d(np.asarray(src, dtype=np.int32)),
            elabel=np.atleast_1d(np.asarray(elabel, dtype=np.int32)),
            dst=np.atleast_1d(np.asarray(dst, dtype=np.int32))))

    def add_nodes(self, labels) -> int:
        return self.submit("add_nodes", dict(
            labels=np.asarray(list(labels), dtype=np.int32)))

    def delete_node(self, nid: int) -> int:
        return self.submit("delete_node", dict(
            nid=np.asarray([int(nid)], dtype=np.int64)))

    def poll(self) -> None:
        """Deadline tick for idle periods: apply the pending batch if its
        oldest op has aged past ``batch_deadline_s``."""
        if self._pending and not self._in_apply \
                and self._deadline_due(self.clock()):
            self._apply_batch()

    def _deadline_due(self, now: float) -> bool:
        return (self._pending_t0 is not None
                and now - self._pending_t0 >= self.cfg.batch_deadline_s)

    def _maybe_apply(self, now: float) -> None:
        if len(self._pending) >= self.cfg.batch_ops \
                or self._deadline_due(now):
            self._apply_batch()

    # --------------------------------------------------------------- apply
    def _apply_batch(self) -> None:
        ops, self._pending = self._pending, []
        self._pending_t0 = None
        self._in_apply = True
        try:
            with obs.span("service.batch", ops=len(ops),
                          batch=self.applied_batches):
                report, rejected = self.m.apply_ops(ops, logged=False)
            self.applied_ops += len(ops)
            self.applied_batches += 1
            self.rejected += rejected
            self._batches_since_snapshot += 1
            self._t_last = self.clock()
            self._accumulate_changed()
            if self.q is not None:
                self._unabsorbed += 1
                self.max_staleness = max(self.max_staleness,
                                         self._unabsorbed)
                if self._unabsorbed >= self.cfg.staleness_batches:
                    self._absorb()
            self._maybe_compact()
            if self.cfg.snapshot_every and self.m.wal and (
                    self._force_snapshot or self._batches_since_snapshot
                    >= self.cfg.snapshot_every):
                self.snapshot()
        finally:
            self._in_apply = False

    def _accumulate_changed(self) -> None:
        """Union this batch's per-level changed sets into the running
        accumulator the next quotient absorption will use."""
        ch = self.m.last_changed
        if self._changed_acc is None:
            return                      # already poisoned until absorb
        if ch is None:
            self._changed_acc = None    # rebuild/compact/change_k
        elif not self._changed_acc:
            self._changed_acc = [np.asarray(c, dtype=np.int64).copy()
                                 for c in ch]
        elif len(ch) != len(self._changed_acc):
            self._changed_acc = None    # level ladder moved underneath
        else:
            self._changed_acc = [np.union1d(a, c) for a, c in
                                 zip(self._changed_acc, ch)]

    def _absorb(self) -> None:
        if self.q is None or self._unabsorbed == 0:
            return
        with obs.span("service.absorb", staleness=self._unabsorbed,
                      poisoned=self._changed_acc is None):
            # hand the accumulated union to the quotient service through
            # the same channel its wrapped mutators read
            self.m.last_changed = (self._changed_acc
                                   if self._changed_acc else None)
            self.q.absorb()
        self._unabsorbed = 0
        self._changed_acc = []
        self.absorbed += 1

    def _maybe_compact(self) -> None:
        thr = self.cfg.compact_threshold
        if not thr:
            return
        if any(op == "compact" for op, _ in self._pending):
            return                      # one already queued
        n = self.m.backend.num_nodes
        if n and self.m.num_tombstones > thr * n:
            obs.event("service.compact_scheduled",
                      tombstones=self.m.num_tombstones, nodes=n)
            self.compactions_scheduled += 1
            self.submit("compact", {})

    def _note_rebuild(self, level: int, frontier: int) -> None:
        self.rebuilds += 1
        self._force_snapshot = True
        obs.event("service.rebuild", level=level, frontier=frontier)

    # ----------------------------------------------------------- lifecycle
    def snapshot(self) -> None:
        """Snapshot now (cadence-independent): commits + drains the WAL,
        publishes the snapshot, truncates absorbed records."""
        with obs.span("service.snapshot",
                      batches=self._batches_since_snapshot):
            self.m.snapshot()
        self.snapshots += 1
        self._batches_since_snapshot = 0
        self._force_snapshot = False

    def drain(self) -> None:
        """Apply everything pending (including ops those batches
        enqueue), absorb the quotient index up to date, and commit the
        WAL.  After `drain`, served state == submitted state."""
        while self._pending:
            self._apply_batch()
        self._absorb()
        if self.m.wal:
            self.m.backend.wal_flush()

    def close(self, *, snapshot: bool = True) -> None:
        """Drain, then (by default) take a final snapshot.  The backend
        itself stays open — its owner closes it (`OocBackend.close`
        drains the WAL's async commit rounds before the executor goes
        down)."""
        self.drain()
        if snapshot and self.m.wal and self.applied_batches:
            self.snapshot()

    # ------------------------------------------------------------ recovery
    @classmethod
    def recover(cls, workdir: str, *, io_threads: int = 1,
                prefetch_depth: int = 2, device=None,
                device_propagation: bool = True,
                config: Optional[StreamConfig] = None,
                quotient: bool = False, max_batch: int = 64,
                budget_rows: int = 1 << 16,
                clock=time.monotonic) -> "StreamingMaintenanceService":
        """Resume a killed service from its workdir: adopt the last
        committed snapshot, redo-replay committed WAL records, and
        (optionally) rematerialize the quotient index over the recovered
        partition.  ``device`` is the restored backend's (the card
        unless ``"cpu"`` is asked); ``device_propagation`` as in
        `BisimMaintainer.restore`."""
        from .maintenance import OocBackend
        backend, state = OocBackend.restore(workdir,
                                            io_threads=io_threads,
                                            prefetch_depth=prefetch_depth,
                                            device=device)
        m = BisimMaintainer.restore(backend, state,
                                    device_propagation=device_propagation)
        q = None
        if quotient:
            from ..quotient.service import QuotientService
            q = QuotientService(m, workdir, max_batch=max_batch,
                                budget_rows=budget_rows, aio=backend.aio)
        return cls(m, config=config, quotient=q, clock=clock)

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict:
        wall = ((self._t_last - self._t0)
                if self._t0 is not None and self._t_last is not None
                else 0.0)
        return dict(
            submitted=self.submitted,
            applied_ops=self.applied_ops,
            applied_batches=self.applied_batches,
            pending=len(self._pending),
            rejected=self.rejected,
            absorbed=self.absorbed,
            snapshots=self.snapshots,
            rebuilds=self.rebuilds,
            compactions_scheduled=self.compactions_scheduled,
            max_staleness=self.max_staleness,
            staleness_bound=(self.cfg.staleness_batches
                             if self.q is not None else 0),
            epoch=(self.q.epoch if self.q is not None else 0),
            wall_s=float(wall),
            updates_per_sec=(self.applied_ops / wall if wall > 0
                             else 0.0),
        )


# ------------------------------------------------------------ op streams
DEFAULT_MIX = (("add_edges", 0.50), ("delete_edges", 0.20),
               ("add_nodes", 0.15), ("delete_node", 0.15))


def synthesize_ops(n_ops: int, *, num_nodes: int, num_labels: int = 4,
                   num_elabels: int = 3, seed: int = 0,
                   mix=DEFAULT_MIX, max_edges_per_op: int = 4) -> list:
    """Deterministic mixed op stream in WAL-record form.

    Op ``i`` draws from ``default_rng(seed + 7919 * (i + 1))`` — the
    crash-fuzz convention — so any suffix of the stream can be
    regenerated independently after a recovery.  Node-id draws track the
    id space grown by earlier ``add_nodes``; ops the maintainer later
    rejects (e.g. an id compacted away by a service-scheduled compact)
    are part of the deal: they are counted, skipped, and replay
    identically.
    """
    ops = []
    n = int(num_nodes)
    names = [name for name, _ in mix]
    weights = np.asarray([w for _, w in mix], dtype=np.float64)
    cum = np.cumsum(weights / weights.sum())
    for i in range(n_ops):
        rng = np.random.default_rng(seed + 7919 * (i + 1))
        op = names[int(np.searchsorted(cum, rng.random(), side="right"))]
        if op == "add_edges" or op == "delete_edges":
            cnt = int(rng.integers(1, max_edges_per_op + 1))
            arrays = dict(
                src=rng.integers(0, n, cnt).astype(np.int32),
                elabel=rng.integers(0, num_elabels, cnt).astype(np.int32),
                dst=rng.integers(0, n, cnt).astype(np.int32))
        elif op == "add_nodes":
            cnt = int(rng.integers(1, 4))
            arrays = dict(
                labels=rng.integers(0, num_labels, cnt).astype(np.int32))
            n += cnt
        else:  # delete_node
            arrays = dict(
                nid=np.asarray([int(rng.integers(0, n))], dtype=np.int64))
        ops.append((op, arrays))
    return ops


def replay_open_loop(service: StreamingMaintenanceService, ops: list, *,
                     rate: Optional[float] = None) -> list:
    """Submit ``ops`` open-loop at ``rate`` arrivals/sec (None = as fast
    as possible), polling the service's deadline trigger while waiting.
    Returns the per-op lsns (the submit acks)."""
    t0 = service.clock()
    lsns = []
    for i, (op, arrays) in enumerate(ops):
        if rate:
            target = t0 + i / float(rate)
            while True:
                now = service.clock()
                if now >= target:
                    break
                service.poll()
                time.sleep(min(target - now, 1e-3))
        lsns.append(service.submit(op, arrays))
    return lsns
