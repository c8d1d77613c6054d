"""Host-side span tracer: wall-time spans in a ring buffer, exportable as
Chrome trace-event JSON (loads in Perfetto / chrome://tracing / the
TensorBoard trace viewer).

The port's copy of code2vec_tpu/obs/tracer.py. It complements a
device-side `torch.profiler` trace: the profiler shows where the card
spends its time, this shows where the HOST spends wall time (extraction,
batch wait, dispatch, render), the split a device trace cannot see.

Spans may carry request-scoped identity (obs/reqtrace.py): a trace id,
a span id and a parent span id, plus free-form attrs. Identified spans
export with an `args` payload so one serving request is reconstructable
as a TREE from the bulk Chrome trace (filter by `trace_id` in
Perfetto), not just a flat phase list.

Cost model: recording is OFF by default (`serve --trace_export FILE`
turns it on and writes the file); a disabled tracer's
`maybe_record` is one attribute check. When enabled, each span is one
tuple append into a bounded deque (the ring buffer caps memory on long
runs — a multi-day run keeps the most recent `capacity` spans). Span
TIMING (perf_counter pairs) is done by the caller / the `span` context
manager regardless, because the same measurement usually feeds a
histogram that is always on.

The ring DROPS the oldest span when full — silently from the file's
point of view, so the drops are first-class metrics:
`obs_spans_dropped_total` counts every overwritten span and
`obs_span_ring_high_water` records the fullest the ring has been; a
truncated Chrome trace is detectable from a /metrics scrape alone (and
from the trace file itself: `otherData.spans_dropped`).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

from code2vec_tpu_torch.obs import metrics as _metrics


# Cached handles: once the ring is full, the drop counter increments on
# EVERY record() — a registry get-or-create per span (key build + the
# registry lock) inside the tracer lock would be a permanent tax for
# the rest of the process lifetime. Lazy so importing this module
# registers nothing.
_C_DROPPED = None
_G_HIGH_WATER = None


def _c_dropped():
    global _C_DROPPED
    if _C_DROPPED is None:
        _C_DROPPED = _metrics.default_registry().counter(
            "obs_spans_dropped_total",
            "spans overwritten in the tracer ring buffer (the Chrome "
            "trace export is missing at least this many oldest spans)")
    return _C_DROPPED


def _g_high_water():
    global _G_HIGH_WATER
    if _G_HIGH_WATER is None:
        _G_HIGH_WATER = _metrics.default_registry().gauge(
            "obs_span_ring_high_water",
            "max spans ever resident in the tracer ring buffer; at "
            "capacity together with obs_spans_dropped_total > 0 the "
            "exported trace is truncated")
    return _G_HIGH_WATER


class SpanTracer:
    """Bounded ring buffer of (name, start, duration, thread[, ids])
    spans."""

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        # perf_counter epoch: Chrome trace wants microsecond timestamps on
        # one monotonic axis; absolute wall time is recorded separately in
        # the metadata so runs can still be aligned to the clock.
        self._epoch = time.perf_counter()
        self._epoch_wall = time.time()
        self._dropped = 0
        self._high_water = 0
        self.enabled = False

    def enable(self) -> None:
        # eager metric registration: a replica that never fills its ring
        # still exports obs_spans_dropped_total=0 / high_water, so the
        # merged scrape (and the SLO/tsdb layer above it) sees the
        # series exist instead of inferring health from absence
        _c_dropped()
        _g_high_water()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def dropped(self) -> int:
        """Spans overwritten by the ring since construction."""
        return self._dropped

    @property
    def high_water(self) -> int:
        return self._high_water

    def maybe_record(self, name: str, start_s: float, dur_s: float,
                     **ids) -> None:
        """Record a completed span (perf_counter start + duration). No-op
        when disabled — the one-attr check keeps instrumented call sites
        free to call this unconditionally."""
        if not self.enabled:
            return
        self.record(name, start_s, dur_s, **ids)

    def record(self, name: str, start_s: float, dur_s: float,
               trace_id: Optional[str] = None,
               span_id: Optional[str] = None,
               parent_id: Optional[str] = None,
               attrs: Optional[dict] = None) -> None:
        # a list, not a tuple: the last slot memoizes this span's
        # serialized Chrome-trace event. Spans are immutable once
        # recorded (attrs are captured "at close" by every call site),
        # so periodic exporters — `serve --trace_export`'s 5 s tick —
        # pay json encoding only for spans NEW since the
        # previous export instead of re-encoding the whole ring
        item = [name, start_s, dur_s, threading.get_ident(),
                threading.current_thread().name,
                trace_id, span_id, parent_id, attrs, None]
        with self._lock:
            if len(self._buf) == self.capacity:
                self._dropped += 1
                _c_dropped().inc()
            self._buf.append(item)
            n = len(self._buf)
            if n > self._high_water:
                self._high_water = n
                g = _g_high_water()
                # several tracer instances share the process gauge; it
                # tracks the fullest ring anywhere in the process
                if n > g.value:
                    g.set(n)

    # ------------------------------------------------------------ export

    def _serialize_chrome_trace(self) -> str:
        """Chrome trace-event JSON (`traceEvents` of `ph:"X"` complete
        events + thread/process-name metadata so Perfetto labels the
        host threads readably). Serialized by hand instead of json.dump:
        the export runs in the trainer's `finally` — including the
        preemption path, where a scheduler grace window is ticking — and
        the stdlib encoder costs seconds on a full 65536-span buffer
        (hundreds of thousands of tiny dict encodes). Span names are
        produced by our own call sites; the fields that could need
        escaping go through json.dumps."""
        with self._lock:
            spans = list(self._buf)
            dropped = self._dropped
        pid = os.getpid()
        parts = []
        seen_tids = {}
        for item in spans:
            (name, start_s, dur_s, tid, tname,
             trace_id, span_id, parent_id, attrs, cached) = item
            if tid not in seen_tids:
                seen_tids[tid] = tname
            if cached is None:
                args = ""
                if trace_id or span_id or parent_id or attrs:
                    payload = dict(attrs or {})
                    if trace_id:
                        payload["trace_id"] = trace_id
                    if span_id:
                        payload["span_id"] = span_id
                    if parent_id:
                        payload["parent_id"] = parent_id
                    args = ',"args":%s' % json.dumps(payload,
                                                     sort_keys=True)
                cached = (
                    '{"name":%s,"ph":"X","cat":"host","ts":%.3f,'
                    '"dur":%.3f,"pid":%d,"tid":%d%s}'
                    % (json.dumps(name), (start_s - self._epoch) * 1e6,
                       dur_s * 1e6, pid, tid, args))
                # idempotent fill outside any lock: every racer
                # computes the identical string for an immutable span
                item[9] = cached
            parts.append(cached)
        for tid, tname in seen_tids.items():
            parts.append(
                '{"name":"thread_name","ph":"M","pid":%d,"tid":%d,'
                '"args":{"name":%s}}' % (pid, tid, json.dumps(tname)))
        parts.append(
            '{"name":"process_name","ph":"M","pid":%d,'
            '"args":{"name":"code2vec_tpu_torch host"}}' % pid)
        return ('{"traceEvents":[%s],"displayTimeUnit":"ms",'
                '"otherData":{"trace_epoch_unix_s":%r,'
                '"spans_dropped":%d,'
                '"producer":"code2vec_tpu_torch.obs.tracer"}}'
                % (",".join(parts), self._epoch_wall, dropped))

    def chrome_trace(self) -> dict:
        """The trace as a parsed object (in-process inspection, tests);
        one serializer, so this can never drift from the exported file."""
        return json.loads(self._serialize_chrome_trace())

    def export_chrome_trace(self, path: str) -> str:
        """Atomically write the Chrome trace JSON to `path`."""
        tmp = f"{path}.tmp-{os.getpid()}"
        dirpart = os.path.dirname(os.path.abspath(path))
        os.makedirs(dirpart, exist_ok=True)
        with open(tmp, "w") as f:
            f.write(self._serialize_chrome_trace())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path


_DEFAULT = SpanTracer()


def default_tracer() -> SpanTracer:
    return _DEFAULT


class span:
    """Context manager timing one named host-side section.

    Always measures (two perf_counter calls); feeds the measurement to an
    optional always-on histogram and to the tracer's ring buffer when
    tracing is enabled. Reentrant-per-instance is NOT supported — create
    one per `with` (the usual idiom `with obs.span("x"):` does)."""

    __slots__ = ("name", "hist", "tracer", "_t0", "seconds")

    def __init__(self, name: str, hist: Optional[_metrics.Histogram] = None,
                 tracer: Optional[SpanTracer] = None):
        self.name = name
        self.hist = hist
        self.tracer = tracer if tracer is not None else _DEFAULT
        self.seconds = 0.0

    def __enter__(self) -> "span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if self.hist is not None:
            self.hist.observe(self.seconds)
        self.tracer.maybe_record(self.name, self._t0, self.seconds)
        return False
