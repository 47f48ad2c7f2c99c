"""The torch profiler's image of the tracer's spans.

`profiler_range` is the hook `obs.tracer` calls as each span opens: while
the profiler records it opens a ``record_function`` range of the span's
name, which the span closes as it exits, so each span has one profiler
range with the profiler's own start and end.  While the profiler is off
it returns None and costs one flag read.
"""
from __future__ import annotations

import torch

_recording = torch._C._autograd._profiler_enabled


def profiler_range(name: str):
    """An entered ``record_function(name)``, or None while no profiler
    records."""
    if not _recording():
        return None
    rng = torch.profiler.record_function(name)
    rng.__enter__()
    return rng
