"""What a traced run read: the profiler's device and host activity over
the window's builds, the program's tracer events and the benchmark's own
record of the fold calls.  Per-layer metric readers (`bench/metrics/`)
take a `TraceView` and return a number, or None when there is nothing to
read.

Times are microseconds on the profiler's clock.  The window is the span
of the benchmark's ``bench.build`` host ranges (each build and its
synchronize); device activity is clipped to it.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict
from typing import Callable, Optional

import numpy as np

BUILD_RANGE = "bench.build"


@dataclasses.dataclass
class TraceView:
    builds: int
    window: tuple               # (start_us, end_us)
    device: list                # (name, start_us, end_us)
    host: list                  # (name, start_us, end_us)
    events: list = dataclasses.field(default_factory=list)  # tracer's
    fold_calls: list = dataclasses.field(default_factory=list)  # (lanes, rows)
    fold_launches: int = 0      # `sig_fold.launches` over the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _clipped(self):
        lo, hi = self.window
        for name, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                yield name, s, e

    def device_us(self, match: Callable[[str], bool]) -> Optional[float]:
        """Device time of the operations whose name ``match`` accepts, or
        None when there is none."""
        hits = [e - s for name, s, e in self._clipped() if match(name)]
        return float(sum(hits)) if hits else None

    def device_count(self, match: Callable[[str], bool]) -> int:
        return sum(1 for name, _, _ in self._clipped() if match(name))

    def busy_intervals(self) -> list:
        """The union of device activity, as sorted disjoint intervals."""
        out = []
        for _, s, e in sorted(self._clipped(), key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def gaps(self) -> list:
        """Idle stretches of the device inside the window, (start, end)."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def host_at(self, points) -> list:
        """For each time, the innermost host range covering it (the
        shortest), named with the outermost one below the build range."""
        ranges = [(n, s, e) for n, s, e in self.host if n != BUILD_RANGE]
        if not ranges:
            return ["host"] * len(points)
        names = [n for n, _, _ in ranges]
        start = np.array([s for _, s, _ in ranges])
        end = np.array([e for _, _, e in ranges])
        length = end - start
        labels = []
        for p in points:
            cover = np.nonzero((start <= p) & (end >= p))[0]
            if cover.size == 0:
                labels.append("host (python)")
                continue
            inner = cover[np.argmin(length[cover])]
            outer = cover[np.argmax(length[cover])]
            labels.append(names[inner] if inner == outer
                          else f"{names[outer]} > {names[inner]}")
        return labels

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and idle time by
        what the host was doing, each [name, seconds], at most ``top``."""
        ops = defaultdict(float)
        for name, s, e in self._clipped():
            ops[name[:120]] += (e - s) / 1e6
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:2000]
        labels = self.host_at([(s + e) / 2 for s, e in gaps])
        idle, seen = defaultdict(float), Counter()
        for (s, e), label in zip(gaps, labels):
            idle[label] += (e - s) / 1e6
            seen[label] += 1
        return {
            "device_ops": [[n, v] for n, v in
                           sorted(ops.items(), key=lambda x: -x[1])[:top]],
            "idle_gaps": [[f"{n} (x{seen[n]})", v] for n, v in
                          sorted(idle.items(), key=lambda x: -x[1])[:top]],
        }


def from_profiler(prof, builds: int, **extra) -> TraceView:
    """A `TraceView` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device, host = [], []
    for ev in prof.events():
        span = (ev.name, ev.time_range.start, ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            # a host range's image on the device's timeline is no work
            if not (ev.name == BUILD_RANGE
                    or getattr(ev, "is_user_annotation", False)):
                device.append(span)
        elif ev.time_range.end > ev.time_range.start:
            host.append(span)
    ranges = [(s, e) for n, s, e in host if n == BUILD_RANGE]
    window = ((min(s for s, _ in ranges), max(e for _, e in ranges))
              if ranges else (0.0, 0.0))
    return TraceView(builds, window, device, host, **extra)
