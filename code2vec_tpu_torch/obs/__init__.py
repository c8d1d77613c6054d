"""Observability of the port: metrics registry + span tracer + exporters.

The port's copy of code2vec_tpu/obs (metrics.py, tracer.py, reqtrace.py,
exporters.py), with the same metric names, labels and buckets, so that
the server's `GET /metrics` renders the reference's series:

    from code2vec_tpu_torch import obs

    _H = obs.histogram("serving_device_seconds", "one model call")
    with obs.span("device", hist=_H):
        ...
    obs.counter("serving_batches_total").inc()

- Metrics (`obs.metrics`): process-wide registry of counters, gauges and
  fixed-bucket histograms; Prometheus text and flat scalar export.
- Tracing (`obs.tracer`, `obs.reqtrace`): `span(name)` wall-time spans
  into a ring buffer, Chrome trace-event JSON export, and the span tree
  of one serving request with W3C `traceparent` ids.
- Exporters (`obs.exporters`): atomic Prometheus snapshot file
  (`--metrics_file`) and localhost HTTP `/metrics` (`--metrics_port`).

Stdlib only. The reference's flight recorder, SLO, time-series and trace
stitching modules, its heartbeat file and its TensorBoard export are not
ported.
"""

from __future__ import annotations

from code2vec_tpu_torch.obs import exporters, metrics, reqtrace, tracer
from code2vec_tpu_torch.obs.metrics import (
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry,
    default_registry,
)
from code2vec_tpu_torch.obs.reqtrace import RequestTrace
from code2vec_tpu_torch.obs.tracer import SpanTracer, default_tracer, span

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "RequestTrace",
    "SpanTracer", "DEFAULT_BUCKETS", "counter", "gauge", "histogram",
    "span", "default_registry", "default_tracer", "exporters", "metrics",
    "reqtrace", "tracer",
]


def counter(name: str, help: str = "", **labels) -> Counter:
    return default_registry().counter(name, help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return default_registry().gauge(name, help, **labels)


def histogram(name: str, help: str = "", buckets=None, **labels) -> Histogram:
    return default_registry().histogram(name, help, buckets=buckets, **labels)
