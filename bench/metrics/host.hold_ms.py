"""Milliseconds a build in which the program's own host code held the
card: device-idle time inside the program's ``build.bisim`` ranges (its
tracer spans, which open profiler ranges of the same name) where the
innermost host range is one of the build's spans (``build.*``), not a
torch op or a CUDA runtime call under one.  Idle time outside
``build.bisim`` is the harness's, between builds."""
import numpy as np

BUILD = "build.bisim"


def _intervals(pairs) -> np.ndarray:
    return np.asarray(pairs, dtype=float).reshape(-1, 2)


def _inside(ranges, outer) -> np.ndarray:
    """The ``ranges`` that lie within one of the disjoint ``outer``."""
    ranges, outer = _intervals(ranges), _intervals(sorted(outer))
    i = np.searchsorted(outer[:, 0], ranges[:, 0], side="right") - 1
    within = (i >= 0) & (ranges[:, 1] <= outer[np.maximum(i, 0), 1])
    return ranges[within]


def _covered_us(idle, builds, ops) -> float:
    """Length of (idle ∩ builds) minus ops, each a set of intervals."""
    sets = [_intervals(x) for x in (idle, builds, ops)]
    pts = np.concatenate([a.T.ravel() for a in sets])
    deltas = np.zeros((len(pts), 3))
    row = 0
    for col, a in enumerate(sets):
        deltas[row:row + len(a), col] = 1
        deltas[row + len(a):row + 2 * len(a), col] = -1
        row += 2 * len(a)
    order = np.argsort(pts, kind="stable")
    depth = np.cumsum(deltas[order], axis=0)[:-1]
    held = (depth[:, 0] > 0) & (depth[:, 1] > 0) & (depth[:, 2] <= 0)
    return float(np.diff(pts[order])[held].sum())


def read(view):
    builds = [(s, e) for n, s, e in view.host if n == BUILD]
    if not view.device or not builds or not view.builds:
        return None
    ops = _inside([(s, e) for n, s, e in view.host
                   if not n.startswith("build.")], builds)
    us = _covered_us(view.gaps(), builds, ops)
    return us / 1e3 / view.builds
