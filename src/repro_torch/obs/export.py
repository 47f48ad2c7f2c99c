"""Exporters for `obs.Tracer`: Chrome-trace JSON and MetricsReport.

`chrome_trace` renders the Perfetto-loadable ``trace.json`` — one
complete ("X") event per span, one instant ("i") event per
`Tracer.event`, plus thread_name metadata so every aio worker thread
(``exmem-aio-reader*``, ``exmem-aio-writer*``, ``exmem-aio-pool*``) gets
its own labeled lane and prefetch overlap is visible against the main
thread's fold/rank spans.

`MetricsReport` is the aggregated view: per-phase totals (grouped by
span name), a per-level table (spans carrying an integer ``level``
attribute, with the device seconds of those carrying ``device_ms``), and
p50/p99 latencies per phase.  It also owns the
launcher's stable one-line text formats (`format_io`, `format_overlap`)
so every subcommand reports through one code path.

The port's own copy of `repro.obs.export` (stdlib only).
"""
from __future__ import annotations

import json
import os
import threading
from collections import defaultdict
from typing import Any, Dict, List, Optional

from .tracer import Tracer

__all__ = ["chrome_trace", "write_chrome_trace", "MetricsReport"]


def _jsonable(v: Any) -> Any:
    """Coerce an attr value to a JSON-safe scalar (numpy ints/floats in
    particular arrive from counter deltas)."""
    if isinstance(v, (bool, str)) or v is None:
        return v
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        return v
    try:
        i = int(v)
        if isinstance(v, type(i)) or float(v) == i:
            return i
    except (TypeError, ValueError, OverflowError):
        pass
    try:
        return float(v)
    except (TypeError, ValueError, OverflowError):
        return str(v)


def _sanitize(attrs: Dict[str, Any]) -> Dict[str, Any]:
    return {str(k): _jsonable(v) for k, v in attrs.items()}


def chrome_trace(tracer: Tracer) -> dict:
    """Render a tracer as a Chrome-trace / Perfetto JSON object."""
    pid = os.getpid()
    events: List[dict] = []
    lanes: Dict[int, str] = {}
    for rec in tracer.spans:
        lanes.setdefault(rec["tid"], rec["tname"])
    for rec in tracer.events:
        lanes.setdefault(rec["tid"], rec["tname"])
    main_tid = threading.main_thread().ident or 0
    # labeled lanes, main thread pinned on top, workers sorted by name
    order = sorted(lanes, key=lambda t: (t != main_tid, lanes[t]))
    for idx, tid in enumerate(order):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": lanes[tid]}})
        events.append({"name": "thread_sort_index", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"sort_index": idx}})
    for rec in tracer.spans:
        events.append({
            "name": rec["name"],
            "cat": rec["name"].split(".", 1)[0],
            "ph": "X",
            "ts": rec["ts"] / 1e3,            # Chrome trace wants µs
            "dur": max(rec["dur"], 1) / 1e3,
            "pid": pid,
            "tid": rec["tid"],
            "args": _sanitize(rec["attrs"]),
        })
    for rec in tracer.events:
        args = _sanitize(rec["attrs"])
        if rec.get("span"):
            args["span"] = rec["span"]
        events.append({
            "name": rec["name"],
            "cat": rec["name"].split(".", 1)[0],
            "ph": "i",
            "s": "t",
            "ts": rec["ts"] / 1e3,
            "pid": pid,
            "tid": rec["tid"],
            "args": args,
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"spans": len(tracer.spans),
                      "events": len(tracer.events),
                      "dropped": tracer.dropped},
    }


def write_chrome_trace(tracer: Tracer, path: str) -> dict:
    obj = chrome_trace(tracer)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)
    return obj


def _percentile(durs_ns: List[int], q: float) -> float:
    """q-th percentile of span durations, in milliseconds (no numpy:
    nearest-rank on the sorted list is plenty for a report)."""
    if not durs_ns:
        return 0.0
    s = sorted(durs_ns)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[idx] / 1e6


# stable display names for the launcher's io one-liners
_IO_FIELDS = (("sort_cost", "sort_cost"), ("scan_cost", "scan_cost"),
              ("sort_bytes", "sortB"), ("scan_bytes", "scanB"),
              ("runs_written", "runs"), ("merge_passes", "merges"),
              ("spills", "spills"))


class MetricsReport:
    """Aggregated phase metrics: totals + p50/p99 per span name, and a
    per-level breakdown from spans carrying a ``level`` attribute."""

    def __init__(self, phases: Optional[Dict[str, dict]] = None,
                 levels: Optional[Dict[int, Dict[str, float]]] = None,
                 span_count: int = 0, event_count: int = 0,
                 dropped: int = 0,
                 events: Optional[Dict[str, int]] = None):
        self.phases = phases or {}
        self.levels = levels or {}
        self.span_count = span_count
        self.event_count = event_count
        self.dropped = dropped
        # instant-event counts per name (e.g. build.sync / build.dispatch:
        # the device round-trip counters the fused-loop work is judged by)
        self.events = events or {}

    @classmethod
    def from_tracer(cls, tracer: Tracer) -> "MetricsReport":
        durs: Dict[str, List[int]] = defaultdict(list)
        levels: Dict[int, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        for rec in tracer.spans:
            durs[rec["name"]].append(rec["dur"])
            lvl = rec["attrs"].get("level")
            if isinstance(lvl, int) and not isinstance(lvl, bool):
                levels[lvl][rec["name"]] += rec["dur"] / 1e9
                dev_ms = rec["attrs"].get("device_ms")
                if dev_ms is not None:
                    levels[lvl][rec["name"] + ".device"] += dev_ms / 1e3
        phases = {
            name: {"count": len(d),
                   "total_s": sum(d) / 1e9,
                   "p50_ms": _percentile(d, 50),
                   "p99_ms": _percentile(d, 99)}
            for name, d in durs.items()
        }
        event_counts: Dict[str, int] = defaultdict(int)
        for rec in tracer.events:
            event_counts[rec["name"]] += 1
        return cls(phases,
                   {lvl: dict(names) for lvl, names in levels.items()},
                   span_count=len(tracer.spans),
                   event_count=len(tracer.events),
                   dropped=tracer.dropped,
                   events=dict(event_counts))

    def as_dict(self) -> dict:
        return {
            "phases": {name: dict(stats)
                       for name, stats in sorted(self.phases.items())},
            "levels": {str(lvl): {n: s for n, s in sorted(names.items())}
                       for lvl, names in sorted(self.levels.items())},
            "events": {name: n for name, n in sorted(self.events.items())},
            "span_count": self.span_count,
            "event_count": self.event_count,
            "dropped": self.dropped,
        }

    def merge(self, other: "MetricsReport") -> "MetricsReport":
        """Fold another report into this one (in place). Totals and
        counts add; percentiles keep the pessimistic (max) value since
        the raw samples are gone."""
        for name, st in other.phases.items():
            mine = self.phases.setdefault(
                name, {"count": 0, "total_s": 0.0,
                       "p50_ms": 0.0, "p99_ms": 0.0})
            mine["count"] += st["count"]
            mine["total_s"] += st["total_s"]
            mine["p50_ms"] = max(mine["p50_ms"], st["p50_ms"])
            mine["p99_ms"] = max(mine["p99_ms"], st["p99_ms"])
        for lvl, names in other.levels.items():
            mine = self.levels.setdefault(lvl, {})
            for name, sec in names.items():
                mine[name] = mine.get(name, 0.0) + sec
        for name, cnt in other.events.items():
            self.events[name] = self.events.get(name, 0) + cnt
        self.span_count += other.span_count
        self.event_count += other.event_count
        self.dropped += other.dropped
        return self

    def format(self) -> str:
        """The launcher's phase table (``--trace`` pretty-printer)."""
        lines = [f"phases ({self.span_count} spans, "
                 f"{self.event_count} events"
                 + (f", {self.dropped} dropped" if self.dropped else "")
                 + "):"]
        lines.append(f"  {'phase':<28} {'count':>7} {'total_s':>9} "
                     f"{'p50_ms':>9} {'p99_ms':>9}")
        order = sorted(self.phases.items(),
                       key=lambda kv: -kv[1]["total_s"])
        for name, st in order:
            lines.append(f"  {name:<28} {st['count']:>7d} "
                         f"{st['total_s']:>9.3f} {st['p50_ms']:>9.3f} "
                         f"{st['p99_ms']:>9.3f}")
        if self.events:
            cells = " ".join(f"{name}={cnt}" for name, cnt in
                             sorted(self.events.items()))
            lines.append(f"events: {cells}")
        if self.levels:
            lines.append("per level:")
            for lvl in sorted(self.levels):
                cells = " ".join(f"{name}={sec:.3f}s" for name, sec in
                                 sorted(self.levels[lvl].items()))
                lines.append(f"  level {lvl:2d}: {cells}")
        return "\n".join(lines)

    # -- stable launcher one-liners (same text contract as the old
    # hand-rolled prints in launch/bisim.py) ----------------------------
    @staticmethod
    def format_io(io: Dict[str, int], label: str = "io",
                  fields: Optional[List[str]] = None) -> str:
        """``io: sort_cost=.. scan_cost=.. sortB=.. scanB=.. ...`` from an
        IOStats `as_dict()` (or a delta of two)."""
        names = dict(_IO_FIELDS)
        keys = fields if fields is not None else [
            k for k, _ in _IO_FIELDS if k in io]
        return f"{label}: " + " ".join(
            f"{names.get(k, k)}={io[k]}" for k in keys)

    @staticmethod
    def format_overlap(aio: Optional[Dict[str, Any]],
                       compute_s: float) -> Optional[str]:
        """The pipeline overlap one-liner (read/write wait vs fold+rank)
        from an AioStats `as_dict()`; None when the pipeline is off."""
        if aio is None:
            return None
        return (f"overlap: read_wait={aio['read_wait_s']:.3f}s "
                f"write_wait={aio['write_wait_s']:.3f}s "
                f"fold+rank={compute_s:.3f}s "
                f"prefetched={aio['chunks_prefetched']} "
                f"streamed_writes={aio['chunks_written']}")
