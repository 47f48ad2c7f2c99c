"""repro_torch.obs — zero-dependency tracing + metrics (stdlib only).

The port's own copy of `repro.obs`: `span()` / `event()` are one global
read + one branch while no tracer is installed, and instrumented code
never changes behaviour with tracing on or off.

The in-memory build emits two instant events per device round trip:

* ``build.dispatch`` — one per launched iteration (``path=`` ``fused``
  or ``staged``, ``what=``, ``iteration=``);
* ``build.sync`` — one per device->host transfer (convergence scalars
  drained every ``sync_every`` iterations, and the final history fetch).

Usage::

    from repro_torch import obs
    with obs.tracing() as tracer:
        build_bisim(g, k, device="cuda")
    obs.write_chrome_trace(tracer, "trace.json")   # load in Perfetto
    print(obs.MetricsReport.from_tracer(tracer).format())
"""
from .tracer import (NOOP_SPAN, Span, Tracer, current_tracer, event,
                     install_tracer, span, tracing)
from .export import (MetricsReport, chrome_trace, validate_chrome_trace,
                     write_chrome_trace)

__all__ = [
    "NOOP_SPAN", "Span", "Tracer", "current_tracer", "event",
    "install_tracer", "span", "tracing",
    "MetricsReport", "chrome_trace", "validate_chrome_trace",
    "write_chrome_trace",
]
