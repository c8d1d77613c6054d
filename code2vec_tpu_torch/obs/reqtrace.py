"""Request-scoped tracing: one trace id + a span tree per serving
request.

The port's copy of code2vec_tpu/obs/reqtrace.py. The span tracer
(obs/tracer.py) answers "where does the HOST spend wall time" in
aggregate; it cannot answer "why was THIS request slow / shed / 504'd".
This module adds the per-request dimension:

- Every request carries a **trace id** (32 lowercase hex chars, W3C
  trace-context format). An inbound `traceparent` header is honored —
  the request joins the caller's distributed trace — otherwise an id is
  minted. The id is echoed in the `X-Trace-Id` response header and a
  `traceparent` response header, so a client can correlate its own
  telemetry with the server's.
- A `RequestTrace` collects **parented spans** for the request: every
  pipeline phase the request crosses (admission, cache lookup,
  extractor pool, batcher wait, the device batch it rode, response
  assembly) records a span with its own 16-hex span id and its parent's,
  so the request is reconstructable as a tree. Batch-level spans are
  SHARED: the batcher stamps the same batch span id into every member
  request's trace, fanning N request trees into one device batch node.
- Spans forward to the process-wide `SpanTracer` ring (id-tagged) when
  bulk tracing is enabled (`serve --trace_export`), so the Chrome-trace
  export carries every request's tree and Perfetto can filter by
  `trace_id`. Per-request export is the server's `?debug=trace`
  response field (gated by `--serve_debug_trace`).

Cost model (this is a per-request hot path): recording a span is ONE tuple
append onto a plain list — no lock (CPython list.append is atomic), no
dict building, no id minting. Span ids, parent defaulting and
millisecond rounding happen lazily at export time (`to_dict()`), which
runs only for `?debug=trace` requests. Python-side work on the request
threads is kept minimal deliberately: under concurrency, per-span
bookkeeping doesn't just cost its own microseconds — it steals GIL
timeslices from the batcher dispatcher thread and inflates device-batch
latency for everyone.
"""

from __future__ import annotations

import random
import re
import secrets
import threading
import time
from typing import Dict, List, Optional

from code2vec_tpu_torch.obs import tracer as _tracer

# W3C trace-context `traceparent`: version "00" - 16-byte trace id -
# 8-byte parent span id - flags. https://www.w3.org/TR/trace-context/
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

# Id minting sits on the request path: a getrandom() syscall per id
# (secrets) costs ~6us on virtualized kernels, so ids come from a
# per-thread PRNG seeded ONCE from the OS entropy pool. Uniqueness is
# what trace ids need (they are correlation keys, not secrets); 128
# bits from a urandom-seeded generator never collides in practice.
_local = threading.local()


def _rng() -> random.Random:
    rng = getattr(_local, "rng", None)
    if rng is None:
        rng = _local.rng = random.Random(secrets.token_bytes(16))
    return rng


def mint_trace_id() -> str:
    """32 lowercase hex chars, never all-zero (the W3C invalid value)."""
    while True:
        tid = "%032x" % _rng().getrandbits(128)
        if tid != "0" * 32:
            return tid


def mint_span_id() -> str:
    while True:
        sid = "%016x" % _rng().getrandbits(64)
        if sid != "0" * 16:
            return sid


def parse_traceparent(header: Optional[str]
                      ) -> Optional[Dict[str, str]]:
    """{"trace_id", "parent_span_id"} from a W3C `traceparent` header,
    or None when the header is absent/malformed/all-zero (a malformed
    hint must not turn a servable request into a 400 — the server just
    mints its own id, mirroring the X-Deadline-Ms policy)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    _version, trace_id, parent_id, _flags = m.groups()
    if trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return {"trace_id": trace_id, "parent_span_id": parent_id}


def format_traceparent(trace_id: str, span_id: str) -> str:
    """`traceparent` response value: this server's root span becomes the
    caller's child reference. Flags 01 = sampled (we always record)."""
    return f"00-{trace_id}-{span_id}-01"


class _TraceSpan:
    """Context manager for one live span inside a RequestTrace. Attrs
    may be added while open (`sp.attrs["status"] = ...`); they are
    recorded at close. `span_id` is None for ordinary spans (minted
    lazily at export); only the root carries an eager id (the
    traceparent response header needs it)."""

    __slots__ = ("trace", "name", "span_id", "parent_id", "attrs", "_t0")

    def __init__(self, trace: "RequestTrace", name: str,
                 parent_id: Optional[str], attrs: dict,
                 span_id: Optional[str] = None):
        self.trace = trace
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs

    def __enter__(self) -> "_TraceSpan":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.trace.add_span(self.name, self._t0,
                            time.perf_counter() - self._t0,
                            span_id=self.span_id,
                            parent_id=self.parent_id,
                            attrs=self.attrs or None)
        return False


class RequestTrace:
    """The span tree of one request. Thread-safe: the HTTP thread, the
    extractor-pool path and the batcher dispatcher all append (one
    atomic list.append per span; export snapshots the list).

    The FIRST span opened (conventionally named `request`) becomes the
    root; later spans default their parent to it at export time.
    `remote_parent` holds the inbound traceparent's span id when the
    caller supplied one, so the exported tree records where it hangs in
    the caller's trace."""

    def __init__(self, trace_id: Optional[str] = None,
                 remote_parent: Optional[str] = None,
                 tracer: Optional[_tracer.SpanTracer] = None):
        self.trace_id = trace_id or mint_trace_id()
        self.remote_parent = remote_parent
        self.minted = trace_id is None
        self.tracer = tracer if tracer is not None \
            else _tracer.default_tracer()
        self.root_span_id: Optional[str] = None
        self._fallback_span_id: Optional[str] = None
        # (name, start_perf_s, dur_s, span_id|None, parent_id|None,
        #  attrs|None) — finalized lazily in to_dict()
        self._spans: List[tuple] = []
        self._t0_wall = time.time()
        self._t0_perf = time.perf_counter()

    @classmethod
    def from_headers(cls, traceparent: Optional[str] = None,
                     tracer: Optional[_tracer.SpanTracer] = None
                     ) -> "RequestTrace":
        parsed = parse_traceparent(traceparent)
        if parsed is None:
            return cls(tracer=tracer)
        return cls(trace_id=parsed["trace_id"],
                   remote_parent=parsed["parent_span_id"],
                   tracer=tracer)

    # ------------------------------------------------------------- spans

    def span(self, name: str, parent_id: Optional[str] = None,
             **attrs) -> _TraceSpan:
        """Open a timed span. The first span becomes the root (its
        parent is the inbound remote parent, if any); subsequent spans
        default to children of the root."""
        if self.root_span_id is None:
            # benign race: two "first" spans would both mint — in
            # practice the root is opened once by handle_request before
            # any concurrency exists for this request
            root_id = mint_span_id()
            self.root_span_id = root_id
            return _TraceSpan(self, name,
                              parent_id or self.remote_parent, attrs,
                              span_id=root_id)
        return _TraceSpan(self, name, parent_id, attrs)

    def add_span(self, name: str, start_perf_s: float, dur_s: float,
                 span_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 attrs: Optional[dict] = None,
                 forward: bool = True) -> str:
        """Append a completed span (perf_counter start + duration) —
        ONE list append on the hot path; ids for spans recorded without
        one are minted lazily at export (`to_dict`). Returns the span
        id only when one was given or the ring forced a mint — a caller
        that needs a shareable id up front mints its own and passes it
        (as the batcher does for the shared batch span). `forward=False`
        skips the process ring tracer — used for that batch span, which
        the dispatcher records into the ring exactly once rather than
        once per member."""
        if forward and self.tracer.enabled:
            # bulk export needs concrete ids NOW; minted only when the
            # ring is actually recording
            span_id = span_id or mint_span_id()
            self.tracer.record(
                name, start_perf_s, dur_s, trace_id=self.trace_id,
                span_id=span_id,
                parent_id=(parent_id if parent_id is not None
                           else (self.root_span_id
                                 if span_id != self.root_span_id
                                 else self.remote_parent)),
                attrs=dict(attrs) if attrs else None)
        self._spans.append(
            (name, start_perf_s, dur_s, span_id, parent_id, attrs))
        return span_id or ""

    # ------------------------------------------------------------ export

    def traceparent(self) -> str:
        """The response `traceparent`, naming the root span once one
        exists. Before any span is recorded (a draining 503, a 400 on
        body decode) a fallback span id is minted ONCE and reused, so
        repeated calls on the same trace agree — the caller gets a
        stable (if span-less) reference, never two different ids for
        one response."""
        span_id = self.root_span_id
        if span_id is None:
            if self._fallback_span_id is None:
                self._fallback_span_id = mint_span_id()
            span_id = self._fallback_span_id
        return format_traceparent(self.trace_id, span_id)

    def to_dict(self) -> dict:
        """JSON-able view for the `?debug=trace` response field: span
        start times are milliseconds relative to `start_unix_s` (the
        trace's first observation), tree edges via parent_id. Spans
        recorded without ids are minted here; parent defaulting (root
        for ordinary spans, the inbound remote parent for the root)
        also happens here — export-time work, not request-time."""
        spans = []
        root_id = self.root_span_id
        for (name, start, dur, span_id, parent_id,
             attrs) in list(self._spans):
            if span_id is None:
                span_id = mint_span_id()
            if parent_id is None:
                parent_id = (self.remote_parent if span_id == root_id
                             else root_id)
            rec = {
                "name": name,
                "span_id": span_id,
                "parent_id": parent_id,
                "start_ms": round((start - self._t0_perf) * 1e3, 3),
                "duration_ms": round(dur * 1e3, 3),
            }
            if attrs:
                rec["attrs"] = dict(attrs)
            spans.append(rec)
        return {
            "trace_id": self.trace_id,
            "root_span_id": root_id,
            "remote_parent": self.remote_parent,
            "start_unix_s": self._t0_wall,
            "spans": spans,
        }
