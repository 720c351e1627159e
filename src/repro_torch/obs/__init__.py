"""repro_torch.obs — zero-dependency tracing + typed metrics for the serving
stack.

  * ``trace``   — process-global :class:`Tracer` with nested spans, instant
    events and counters over ``(process, thread)`` tracks;
    ``export_chrome_trace`` writes Perfetto-loadable trace-event JSON where
    a disaggregated run renders as parallel per-arm prefill/ship/decode
    rows.  Disabled, the global is an allocation-free no-op singleton.
  * ``metrics`` — a mergeable fixed-log-bucket streaming :class:`Histogram`
    (p50/p95/p99 with bounded relative error) and a
    :class:`MetricRegistry` of declared kinds (counter | gauge | ratio |
    histogram) that aggregation code keys on instead of suffix-matched
    special cases.

The engine, schedulers, cache store and sim backend emit spans through
``get_tracer()``; benchmarks enable tracing per run via ``trace_to(path)``
and device-profile annotations via ``set_annotations``/``--profile-dir``.
"""
from repro_torch.obs.metrics import (COUNTER, GAUGE, HISTOGRAM, RATIO, Histogram,
                               MetricRegistry, merge_stat_dicts)
from repro_torch.obs.trace import (ENGINE_TRACK, NULL_SPAN, NULL_TRACER, NullTracer,
                             Tracer, annotation, get_tracer, set_annotations,
                             set_tracer, trace_to)

__all__ = [
    "COUNTER", "ENGINE_TRACK", "GAUGE", "HISTOGRAM", "Histogram",
    "MetricRegistry", "NULL_SPAN", "NULL_TRACER", "NullTracer", "RATIO",
    "Tracer", "annotation", "get_tracer", "merge_stat_dicts",
    "set_annotations", "set_tracer", "trace_to",
]
