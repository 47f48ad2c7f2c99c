"""Thread-safe tracing core: `Tracer`, `span()`, and the process-global
default tracer.

Span naming convention is ``layer.phase`` (e.g. ``build.fold``,
``sort.merge_pass``, ``store.probe``, ``wal.commit``, ``aio.read_chunk``,
``maint.level``, ``fault.retry``).  The first dotted component is the
layer and becomes the Chrome-trace category; MetricsReport aggregates by
the full name and, for spans carrying an integer ``level`` attribute, by
level as well.

Off-by-default contract: no tracer is installed at import time and
``span()`` / ``event()`` cost exactly one global read + one branch before
returning the shared no-op span.  Instrumented code must therefore never
change behavior based on tracing — spans only *read* counters (via the
reserved ``io=`` argument, any object with ``as_dict()``/``to_dict()``)
so outputs and IOStats stay bit-identical with tracing on or off.

Spans are context managers and must be fully entered and exited on one
thread (never hold a span open across a generator ``yield``): each
thread keeps its own span stack, which is what gives the Chrome-trace
export one lane per aio worker thread.

While the torch profiler records, every span also opens a profiler range
of its own name (`obs.ranges`), so the profiler's host timeline carries
the program's phases beside the torch ops and the device's activity.
That hook is looked up when the first tracer is made; this module
imports nothing but the standard library.

The port's own copy of `repro.obs.tracer` (stdlib only).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, Optional

__all__ = [
    "Span", "Tracer", "span", "event", "tracing", "current_tracer",
    "install_tracer",
]


def _counters(obj: Any) -> Dict[str, float]:
    """Snapshot the numeric fields of a stats object (duck-typed:
    ``as_dict()`` preferred, ``to_dict()`` accepted)."""
    fn = getattr(obj, "as_dict", None) or getattr(obj, "to_dict", None)
    d = fn() if fn is not None else dict(obj)
    return {k: v for k, v in d.items() if isinstance(v, (int, float))
            and not isinstance(v, bool)}


class _NoopSpan:
    """Shared do-nothing span returned while tracing is off."""
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def event(self, name: str, **attrs) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """A live span. Use as ``with tracer.span("layer.phase", ...):``."""

    __slots__ = ("_tracer", "name", "attrs", "_io", "_io0", "_start",
                 "_tid", "_tname", "_depth", "_parent", "_range")

    def __init__(self, tracer: "Tracer", name: str, io: Any,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._io = io

    def set(self, **attrs) -> "Span":
        """Attach attributes mid-span (records=…, bytes=…, device=…)."""
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs) -> "Span":
        """Emit an instant event while this span is open."""
        self._tracer.event(name, **attrs)
        return self

    def __enter__(self) -> "Span":
        th = threading.current_thread()
        self._tid = th.ident or 0
        self._tname = th.name
        stack = self._tracer._stack()
        self._parent = stack[-1].name if stack else None
        self._depth = len(stack)
        stack.append(self)
        if self._io is not None:
            self._io0 = _counters(self._io)
        hook = _range_hook
        self._range = hook(self.name) if hook is not None else None
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:           # misnesting: recover, don't corrupt
            stack.remove(self)
        if self._io is not None:
            after = _counters(self._io)
            for key, before in self._io0.items():
                delta = after.get(key, 0) - before
                if delta:
                    self.attrs["io." + key] = delta
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._finish(self, end)
        return False


class Tracer:
    """Collects finished spans and instant events, thread-safely.

    Timestamps are `time.perf_counter_ns` relative to the tracer's
    construction, so a single tracer's records share one monotonic
    timeline across threads.
    """

    def __init__(self, max_records: int = 1_000_000):
        if _range_hook is _UNSET:
            _load_range_hook()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._origin = time.perf_counter_ns()
        self._max = max_records
        self.spans: list = []      # finished span record dicts
        self.events: list = []     # instant event record dicts
        self.dropped = 0

    # -- per-thread span stack -------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    # -- recording -------------------------------------------------------
    def span(self, name: str, io: Any = None, **attrs) -> Span:
        return Span(self, name, io, attrs)

    def event(self, name: str, **attrs) -> None:
        th = threading.current_thread()
        st = self._stack()
        rec = {
            "name": name,
            "ts": time.perf_counter_ns() - self._origin,
            "tid": th.ident or 0,
            "tname": th.name,
            "span": st[-1].name if st else None,
            "attrs": attrs,
        }
        with self._lock:
            if len(self.events) < self._max:
                self.events.append(rec)
            else:
                self.dropped += 1

    def _finish(self, sp: Span, end_ns: int) -> None:
        rec = {
            "name": sp.name,
            "ts": sp._start - self._origin,
            "dur": end_ns - sp._start,
            "tid": sp._tid,
            "tname": sp._tname,
            "depth": sp._depth,
            "parent": sp._parent,
            "attrs": sp.attrs,
        }
        with self._lock:
            if len(self.spans) < self._max:
                self.spans.append(rec)
            else:
                self.dropped += 1

    # -- inspection helpers (tests, aggregation) -------------------------
    def find(self, name: str) -> list:
        return [s for s in self.spans if s["name"] == name]

    def find_events(self, name: str) -> list:
        return [e for e in self.events if e["name"] == name]


# -- process-global default tracer ---------------------------------------
_ACTIVE: Optional[Tracer] = None
# ``hook(name)`` opens and returns a profiler range named ``name``, or
# returns None while no profiler records; looked up by the first tracer
_UNSET = object()
_range_hook: Any = _UNSET


def _load_range_hook() -> None:
    global _range_hook
    try:
        from .ranges import profiler_range
    except ImportError:       # no torch: spans stay on this clock alone
        profiler_range = None
    _range_hook = profiler_range


def current_tracer() -> Optional[Tracer]:
    return _ACTIVE


def install_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or, with None, remove) the process-global tracer.
    Returns the previously installed tracer."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tracer
    return prev


def span(name: str, io: Any = None, **attrs):
    """Open a span on the global tracer; no-op (one branch) when off."""
    t = _ACTIVE
    if t is None:
        return NOOP_SPAN
    return Span(t, name, io, attrs)


def event(name: str, **attrs) -> None:
    """Record an instant event on the global tracer; no-op when off."""
    t = _ACTIVE
    if t is not None:
        t.event(name, **attrs)


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Install a tracer globally for the duration of the block."""
    t = tracer if tracer is not None else Tracer()
    prev = install_tracer(t)
    try:
        yield t
    finally:
        install_tracer(prev)
