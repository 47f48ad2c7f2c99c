"""Deterministic fault injection for the out-of-core engine.

Crash safety is only a property once it is *provoked*: this module is
the seam through which tests (and the CI ``crash-recovery`` job) inject
I/O failures at exact, reproducible points.  The aio primitives, the
table/meta writers, the WAL, and the device propagation path each call
`fault_point(kind, path)` before (or around) their side effect; with no
plan installed the call is a counter-free no-op.

A `FaultPlan` is a deterministic schedule over the global sequence of
fault points:

  * ``crash_at=n``      — the n-th fault point (1-based) raises
                          `InjectedCrash`, simulating the process dying
                          right there; nothing after it runs.
  * ``transient_at``    — these points raise `TransientIOError` (a flaky
                          device), each up to ``transient_repeats``
                          times; `with_retries` callers recover, others
                          propagate.
  * ``torn_at=n``       — the n-th point *returns* ``"torn"``: writers
                          that support it publish a corrupted file and
                          then raise `InjectedCrash`, simulating a
                          rename that reached the disk before the data
                          blocks did (the failure mode checksums exist
                          to catch).
  * ``kinds``           — restrict triggering to these kinds; other
                          points still count (so indices are stable
                          when narrowing a schedule).

Plans also *observe*: every firing of a fault point appends to
``plan.log``, so a harness can first run a scenario under an empty plan
to learn how many kill points it has, then re-run with ``crash_at``
sweeping that range — the "kill at any injected fault point" loop of
the crash-recovery fuzz harness.

`with_retries` is the matching graceful-degradation primitive: bounded
retry with exponential backoff for `TransientIOError` only —
`InjectedCrash` (and every real non-transient error) always propagates
on the first throw.

Thread-safety: fault points may fire from aio worker threads; the plan
guards its counter with a lock, so a schedule is deterministic whenever
the fault points themselves are issued in a deterministic order (the
crash-recovery fuzz runs with ``io_threads=0`` for exactly this
reason).

The port's own copy of `repro.core.faults` (stdlib only).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Optional

from ..obs import tracer as obs

MAX_RETRIES = 4
BACKOFF_S = 0.002


class TransientIOError(OSError):
    """A retriable I/O failure (flaky device, injected or real)."""


class InjectedCrash(RuntimeError):
    """A simulated process death at an injected fault point."""


@dataclasses.dataclass
class FaultPlan:
    """Deterministic schedule over the global fault-point sequence."""

    crash_at: Optional[int] = None       # 1-based index raising InjectedCrash
    transient_at: tuple = ()             # indices raising TransientIOError
    transient_repeats: int = 1           # throws per transient index
    torn_at: Optional[int] = None        # index returning the "torn" verdict
    kinds: Optional[frozenset] = None    # restrict triggers to these kinds

    def __post_init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._transient_left = {int(i): int(self.transient_repeats)
                                for i in self.transient_at}
        self.log: list = []              # (index, kind, path) of every point

    @property
    def points_seen(self) -> int:
        with self._lock:
            return self._count

    def fire(self, kind: str, path: Optional[str]) -> Optional[str]:
        with self._lock:
            self._count += 1
            idx = self._count
            self.log.append((idx, kind, path))
            obs.event("fault.point", kind=kind, path=path, index=idx)
            if self.kinds is not None and kind not in self.kinds:
                return None
            if self.crash_at is not None and idx == self.crash_at:
                obs.event("fault.crash", kind=kind, path=path, index=idx)
                raise InjectedCrash(
                    f"injected crash at fault point {idx} ({kind}: {path})")
            if self._transient_left.get(idx, 0) > 0:
                self._transient_left[idx] -= 1
                # transient errors re-fire on retry at *new* indices; keep
                # the budget keyed by the original index so a retried op
                # eventually succeeds
                self._transient_left[idx + 1] = self._transient_left.pop(idx)
                obs.event("fault.transient", kind=kind, path=path, index=idx)
                raise TransientIOError(
                    f"injected transient I/O error at fault point {idx} "
                    f"({kind}: {path})")
            if self.torn_at is not None and idx == self.torn_at:
                obs.event("fault.torn", kind=kind, path=path, index=idx)
                return "torn"
        return None


_ACTIVE: Optional[FaultPlan] = None


def fault_point(kind: str, path: Optional[str] = None) -> Optional[str]:
    """Hook called by I/O primitives before (or around) a side effect.
    No-op unless a plan is installed; returns ``"torn"`` when the caller
    should publish a corrupted artifact before crashing."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.fire(kind, path)


@contextlib.contextmanager
def install_fault_plan(plan: FaultPlan):
    """Install ``plan`` as the process-wide schedule for the duration."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def with_retries(fn: Callable, *, retries: int = MAX_RETRIES,
                 backoff_s: float = BACKOFF_S):
    """Run ``fn``, retrying `TransientIOError` with exponential backoff.

    Only transient errors are retried — `InjectedCrash` and every other
    exception propagate immediately, so a simulated process death is
    never "survived" by the retry loop.  The final attempt's error
    propagates after the budget is exhausted.
    """
    for attempt in range(retries):
        try:
            return fn()
        except TransientIOError:
            obs.event("fault.retry", attempt=attempt + 1)
            time.sleep(backoff_s * (2 ** attempt))
    return fn()
