"""repro_torch.obs — zero-dependency tracing + metrics (stdlib only; torch
only in `obs.ranges`, loaded when the first tracer is made).

The port's own copy of `repro.obs`: `span()` / `event()` are one global
read + one branch while no tracer is installed, and instrumented code
never changes behaviour with tracing on or off.

The in-memory build (`core.partition.build_bisim`) records, per call:

* spans, each under ``build.bisim`` (``nodes``, ``edges``, ``k``,
  ``mode``, ``path``): ``build.upload`` (the graph's columns to the
  device; ``bytes``, and ``staged_chunks``, ``slots``, ``slot_bytes``:
  the chunks that went through the pinned ring of `core.staging`, 0 on
  the direct path, and the ring's shape), ``build.prepare`` (host work
  before the first kernel: the edge labels' range), ``build.iteration``
  (``level=j``: one level's launches, iteration 0 included; on a card
  ``device_ms`` and ``trimmed`` once drained), ``build.drain``
  (``batched``, ``bytes``), ``build.fetch`` (the pid history to the
  host; ``bytes``) and, with ``with_store``, ``build.stores``;
* events: ``build.dispatch`` — one per launched iteration (``path=``
  ``fused`` or ``staged``, ``what=``, ``iteration=``); ``build.sync`` —
  one per device->host transfer (convergence scalars drained every
  ``sync_every`` iterations, and the final history fetch);
  ``build.copy`` — the counter of copied bytes, one per copy (``what=``
  ``upload``, ``drain`` or ``history``, ``to=`` ``device`` or ``host``,
  ``bytes=``; the upload counts 0 on the CPU, whose tensors alias the
  graph's arrays); ``build.level`` — on a card, each level's device time
  between CUDA events around its launches (``level=``, ``device_ms=``,
  ``trimmed=`` for levels dispatched past the fixpoint), read at the
  drain that already syncs.

While `torch.profiler` records, every span also opens a
``record_function`` range of its own name (`obs.ranges`), so the
profiler's host timeline names the program's phases on its own clock.

Usage::

    from repro_torch import obs
    with obs.tracing() as tracer:
        build_bisim(g, k, device="cuda")
    obs.write_chrome_trace(tracer, "trace.json")   # load in Perfetto
    print(obs.MetricsReport.from_tracer(tracer).format())
"""
from .tracer import (NOOP_SPAN, Span, Tracer, current_tracer, event,
                     install_tracer, span, tracing)
from .export import MetricsReport, chrome_trace, write_chrome_trace

__all__ = [
    "NOOP_SPAN", "Span", "Tracer", "current_tracer", "event",
    "install_tracer", "span", "tracing",
    "MetricsReport", "chrome_trace", "write_chrome_trace",
]
