"""Observability for the serving engine — three layers, none adding a host
sync (port of ``repro/telemetry``):

* **Device-resident counters** (:mod:`repro_torch.telemetry.counters`):
  int32 scalars in ``state["ctr"]``, bumped inside the dispatches where the
  events happen and read in the one transfer that drains each dispatch's
  token grid; they surface as ``stats["counters"]``.
* **Request-lifecycle metrics** (:mod:`repro_torch.telemetry.metrics`): a
  host-side :class:`MetricsRegistry` of counters, gauges and log-bucketed
  histograms — TTFT / TPOT / queue wait, lengths, acceptance rate,
  prefix-hit fraction, allocator gauges — snapshotted to the
  ``repro.telemetry.metrics/v1`` JSON schema and summarized (p50/p95/p99)
  by the serve CLI.
* **Trace export** (:mod:`repro_torch.telemetry.trace`): a :class:`Tracer`
  writing Chrome / Perfetto trace-event JSON, one track per subsystem
  (admission, dispatch, spec, prefill-chunk, eviction) plus counter tracks
  read from the device counters.

Enable the host-side layers with ``Engine(..., metrics=MetricsRegistry(),
tracer=Tracer())`` or ``python -m repro_torch.launch.serve --metrics-out
PATH --trace-out PATH``.
"""
from repro_torch.telemetry.counters import (COUNTER_KEYS, bump, counter_totals,
                                            init_counters)
from repro_torch.telemetry.metrics import (METRICS_SCHEMA, Counter, Gauge, Histogram,
                                           MetricsRegistry)
from repro_torch.telemetry.trace import TRACE_PID, Tracer

__all__ = [
    "COUNTER_KEYS", "init_counters", "bump", "counter_totals",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "METRICS_SCHEMA",
    "Tracer", "TRACE_PID",
]
