"""The port's `obs` package against the JAX package's: the same
operations render the same Prometheus text, the same trace ids and the
same Chrome-trace layout."""

import json
import math

import pytest

from code2vec_tpu.obs import exporters as jexporters
from code2vec_tpu.obs import metrics as jmetrics
from code2vec_tpu.obs import reqtrace as jreqtrace
from code2vec_tpu.obs import tracer as jtracer
from code2vec_tpu_torch import obs
from code2vec_tpu_torch.obs import exporters, metrics, reqtrace, tracer

pytestmark = pytest.mark.torch_port


def _drive(registry):
    """One fixed sequence of counter, gauge and histogram operations,
    labels, escapes, special values and custom buckets included."""
    c = registry.counter("requests_total", "requests by outcome",
                         endpoint="predict", status="200")
    c.inc()
    c.inc(2.5)
    registry.counter("requests_total", endpoint="embed",
                     status="503").inc(7)
    registry.counter("bare_total").inc(0)
    g = registry.gauge("depth", "queue depth")
    g.set(3)
    g.inc(0.25)
    g.dec(1)
    registry.gauge("weird", "label escapes",
                   path='a "b"\\c\nd').set(-math.inf)
    registry.gauge("big").set(1e16)
    h = registry.histogram("latency_seconds", "latency by phase",
                           phase="device")
    for v in (0.00005, 0.0003, 0.004, 0.07, 0.9, 12.0, 400.0):
        h.observe(v)
    rows = registry.histogram("batch_rows", "rows a batch",
                              buckets=(1, 2, 4, 8, 16, 32, 64))
    for v in (1, 3, 3, 64, 100):
        rows.observe(v)
    registry.histogram("latency_seconds", phase="total",
                       status="200").observe(0.01)
    return registry


def test_prometheus_text_equal_to_reference(tmp_path):
    port = _drive(metrics.MetricsRegistry())
    ref = _drive(jmetrics.MetricsRegistry())
    assert port.render_prometheus() == ref.render_prometheus()
    assert obs.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    exporters.write_prometheus(str(tmp_path / "port.prom"), port)
    jexporters.write_prometheus(str(tmp_path / "ref.prom"), ref)
    assert (tmp_path / "port.prom").read_bytes() == \
        (tmp_path / "ref.prom").read_bytes()
    with pytest.raises(ValueError):
        port.counter("depth")   # a gauge already
    with pytest.raises(ValueError):
        port.counter("bare_total").inc(-1)


def test_metrics_http_endpoint_serves_the_registry():
    import urllib.request
    registry = _drive(metrics.MetricsRegistry())
    server = exporters.start_metrics_server(0, registry=registry)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=30) as r:
            assert r.read().decode() == registry.render_prometheus()
    finally:
        exporters.stop_metrics_server(server)


@pytest.mark.parametrize("header", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    " 00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00 ",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331",
    "garbage", "", None])
def test_traceparent_parse_and_format_agree(header):
    assert reqtrace.parse_traceparent(header) == \
        jreqtrace.parse_traceparent(header)
    assert reqtrace.format_traceparent("ab" * 16, "cd" * 8) == \
        jreqtrace.format_traceparent("ab" * 16, "cd" * 8)
    trace = reqtrace.RequestTrace.from_headers(header)
    parsed = jreqtrace.parse_traceparent(header)
    if parsed is None:
        assert trace.minted and len(trace.trace_id) == 32
    else:
        assert trace.trace_id == parsed["trace_id"]
        assert trace.remote_parent == parsed["parent_span_id"]
    # a stable traceparent before any span, then the root's
    first = trace.traceparent()
    assert trace.traceparent() == first
    assert jreqtrace.parse_traceparent(first)["trace_id"] == trace.trace_id
    with trace.span("request"):
        pass
    assert trace.traceparent() == reqtrace.format_traceparent(
        trace.trace_id, trace.root_span_id)


def _spans(module, t):
    trace = module.RequestTrace(trace_id="12" * 16, tracer=t)
    with trace.span("request", endpoint="predict") as root:
        root.attrs["status"] = 200
        with trace.span("cache_lookup") as sp:
            sp.attrs["hit"] = False
        trace.add_span("device", 1.0, 0.5, parent_id="ab" * 8)
    return trace


def test_chrome_trace_and_request_tree_have_the_reference_keys():
    port_tracer, ref_tracer = tracer.SpanTracer(), jtracer.SpanTracer()
    port_tracer.enable()
    ref_tracer.enable()
    got = _spans(reqtrace, port_tracer)
    want = _spans(jreqtrace, ref_tracer)
    with tracer.span("plain", tracer=port_tracer):
        pass
    with jtracer.span("plain", tracer=ref_tracer):
        pass
    g, w = port_tracer.chrome_trace(), ref_tracer.chrome_trace()
    assert sorted(g) == sorted(w)
    assert sorted(g["otherData"]) == sorted(w["otherData"])
    assert len(g["traceEvents"]) == len(w["traceEvents"])
    for ge, we in zip(g["traceEvents"], w["traceEvents"]):
        assert sorted(ge) == sorted(we)
        assert ge["name"] == we["name"] and ge["ph"] == we["ph"]
        if "args" in we and ge["ph"] == "X":
            assert sorted(ge["args"]) == sorted(we["args"])
    gd, wd = got.to_dict(), want.to_dict()
    assert sorted(gd) == sorted(wd)
    assert [(s["name"], sorted(s)) for s in gd["spans"]] == \
        [(s["name"], sorted(s)) for s in wd["spans"]]
    assert gd["spans"][-1]["attrs"] == wd["spans"][-1]["attrs"]
    json.dumps(gd)   # JSON-able, as ?debug=trace ships it
    assert port_tracer.dropped == 0 and len(port_tracer) == len(ref_tracer)


def test_span_ring_counts_its_drops():
    t = tracer.SpanTracer(capacity=2)
    t.enable()
    before = obs.default_registry().counter(
        "obs_spans_dropped_total").value
    for i in range(5):
        t.record(f"s{i}", 0.0, 0.001)
    assert len(t) == 2 and t.dropped == 3 and t.high_water == 2
    assert obs.default_registry().counter(
        "obs_spans_dropped_total").value == before + 3
    assert t.chrome_trace()["otherData"]["spans_dropped"] == 3
