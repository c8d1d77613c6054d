"""Request batchers: coalesce concurrent predicts into device batches
under a latency budget, with bucketed context counts.

The counterpart of code2vec_tpu/serving/batcher.py with the tenancy
layer off (the per-tenant fills and caps come with tenancy.py):

- `DynamicBatcher`: requests (groups of extracted method lines) enqueue;
  one dispatcher thread collects until `max_batch_rows` rows are pending
  or the OLDEST request has waited `max_delay_s`, then runs one model
  call over the coalesced rows. The model call buckets the context axis
  (model_facade.py), so the shapes the kernels see are bounded by
  len(buckets) per row count.
- `ContinuousBatcher` (--serve_continuous): the next batch is always
  forming. `submit()` reserves rows in the tail slot under the lock,
  parses the lines straight into the slot's padded buffer outside it,
  and up to `inflight_steps` worker threads launch a device step as soon
  as a worker frees; a slot any of whose rows arrived while a step was in
  flight is CHAINED and rides the next step instead of a fresh delay
  window.

`submit()` returns a Future of the per-line results; an optional
`phases` dict receives the `batch_wait` (submit -> dispatch) and
`device` (the whole model call the request rode) phases. Deadlines
(serving/admission.py): a request whose remaining budget cannot cover
its bucket's observed p95 device time (plus, for the continuous batcher,
the soonest in-flight step's ETA) is refused up front
(`DeadlineInfeasible`, a 503); one that expires while waiting settles as
`DeadlineExceeded` (504) and never reaches the device; one running out
of slack forces an early dispatch. Per-bucket device times come from a
rolling window of dispatched-batch durations; a cold tracker refuses
nothing. `drain()` stops intake, flushes what is pending and joins the
threads.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from code2vec_tpu_torch import obs
from code2vec_tpu_torch.serving.admission import (
    Deadline, DeadlineExceeded, DeadlineInfeasible, expired_counter,
)

_H_BATCH_ROWS = obs.histogram(
    "serving_batch_rows",
    "rows per dispatched device batch (coalescing effectiveness)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
_H_BATCH_WAIT = obs.histogram(
    "serving_batch_wait_seconds",
    "request submit to device-batch dispatch (coalescing delay)")
_H_DEVICE = obs.histogram(
    "serving_device_seconds",
    "one coalesced model call: parse + pad + device step + unpack")
_C_BATCHES = obs.counter("serving_batches_total",
                         "device batches dispatched by the batcher")
_C_ROWS = obs.counter("serving_batch_rows_total",
                      "method rows pushed through the batcher")
_G_INFLIGHT = obs.gauge(
    "serving_batch_inflight_steps",
    "device steps currently in flight (continuous batching)")
_C_RIDES = obs.counter(
    "serving_batch_inflight_rides_total",
    "admissions that rode an in-flight dispatch window instead of "
    "opening a fresh delay window (continuous batching)")


def parse_buckets(spec, max_contexts: int, cp: int = 1) -> Tuple[int, ...]:
    """Normalize a bucket spec ("32,64,128" string or int sequence) into
    a sorted tuple capped at `max_contexts` (always included, so every
    legal row fits some bucket) and filtered to multiples of the
    context-parallel degree (a cp-sharded step needs the context axis
    divisible by cp)."""
    if isinstance(spec, str):
        vals = [int(v) for v in spec.replace(" ", "").split(",") if v]
    else:
        vals = [int(v) for v in (spec or ())]
    vals = sorted({v for v in vals if 0 < v < max_contexts
                   and v % max(cp, 1) == 0})
    return tuple(vals) + (max_contexts,)


def bucket_for(n_contexts: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding a row whose deepest valid context sits at
    index n_contexts-1. Callers guarantee buckets[-1] == max_contexts."""
    for b in buckets:
        if b >= n_contexts:
            return b
    return buckets[-1]


class _Pending:
    __slots__ = ("lines", "future", "t_submit", "phases", "deadline",
                 "bucket", "trace", "settled")

    def __init__(self, lines: List[str], phases: Optional[dict],
                 deadline: Optional[Deadline] = None,
                 bucket: Optional[int] = None, trace=None):
        self.lines = lines
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.phases = phases
        self.deadline = deadline
        self.bucket = bucket
        self.trace = trace
        # continuous batcher: an item settled early (504 / parse error)
        # stays in its slot (its rows are reserved in the fixed-shape
        # buffer, mask-zeroed) but is skipped at result fan-out
        self.settled = False


class _DeviceTimeTracker:
    """Rolling per-bucket device-call durations -> p95 estimate. Small
    fixed windows (32 samples) so the estimate tracks the CURRENT
    device behavior — a transient slowdown ages out in 32 batches."""

    MIN_SAMPLES = 4

    def __init__(self, window: int = 32):
        self._window = window
        self._lock = threading.Lock()
        self._samples: Dict[Optional[int], deque] = {}
        # p95 runs on EVERY bounded-deadline admission but samples only
        # arrive once per dispatched batch, so the sorted view is cached
        # per bucket and invalidated on record() — the admission path is
        # O(1) dict lookups unless a new sample landed since last read.
        self._sorted: Dict[Optional[int], List[float]] = {}

    def record(self, bucket: Optional[int], duration_s: float) -> None:
        with self._lock:
            d = self._samples.get(bucket)
            if d is None:
                d = self._samples[bucket] = deque(maxlen=self._window)
            d.append(float(duration_s))
            self._sorted.pop(bucket, None)

    def p95(self, bucket: Optional[int]) -> Optional[float]:
        with self._lock:
            d = self._samples.get(bucket)
            if d is None or len(d) < self.MIN_SAMPLES:
                return None
            ordered = self._sorted.get(bucket)
            if ordered is None:
                ordered = self._sorted[bucket] = sorted(d)
            return ordered[min(int(round(0.95 * (len(ordered) - 1))),
                               len(ordered) - 1)]


class DynamicBatcher:
    """Single dispatcher thread over a condition-guarded pending queue.

    `predict_fn(lines) -> List[result]` is the facade's batched predict:
    it must return exactly one result per input line, in order. All
    pending groups are dispatched together in FIFO order up to
    `max_batch_rows` rows; one oversized group (a file with more methods
    than the cap) dispatches alone — predict_fn chunks internally, so
    correctness never depends on the cap.
    """

    def __init__(self, predict_fn: Callable[[List[str]], List],
                 max_batch_rows: int = 64, max_delay_s: float = 0.01,
                 buckets: Optional[Sequence[int]] = None):
        self.predict_fn = predict_fn
        self.max_batch_rows = max(1, int(max_batch_rows))
        self.max_delay_s = max(0.0, float(max_delay_s))
        # Context-bucket list (model.context_buckets) for per-bucket
        # device-time estimates; None = one global estimate (the
        # standalone/unit-test construction).
        self.buckets = tuple(buckets) if buckets else None
        self.device_times = _DeviceTimeTracker()
        self._cond = threading.Condition()
        self._pending: List[_Pending] = []
        self._pending_rows = 0
        self._draining = False
        self._closed = False
        self.batches_dispatched = 0
        self._thread = threading.Thread(target=self._run,
                                        name="serving-batcher", daemon=True)
        self._thread.start()

    # -------------------------------------------------------------- API

    def _bucket_of(self, lines: Sequence[str]) -> Optional[int]:
        """Context bucket this request's rows would pad to (the deepest
        line decides, exactly as model_facade._predict_chunk buckets a
        chunk). Extractor lines are space-separated `name ctx ctx ...`
        padded with trailing blanks, so a whitespace split counts the
        real contexts."""
        if self.buckets is None:
            return None
        deepest = max((len(line.split()) - 1 for line in lines),
                      default=1)
        return bucket_for(max(deepest, 1), self.buckets)

    def submit(self, lines: Sequence[str],
               phases: Optional[dict] = None,
               deadline: Optional[Deadline] = None,
               trace=None) -> Future:
        item = _Pending(list(lines), phases, deadline, trace=trace)
        if not item.lines:
            item.future.set_result([])
            return item.future
        if deadline is not None and deadline.bounded:
            if deadline.expired():
                expired_counter("batch_wait").inc()
                item.future.set_exception(DeadlineExceeded(
                    "request deadline expired before batching"))
                return item.future
            item.bucket = self._bucket_of(item.lines)
            p95 = self.device_times.p95(item.bucket)
            if p95 is not None and deadline.remaining() < p95:
                # Fail-fast refusal: even an immediate solo dispatch
                # cannot finish inside the budget, so coalescing this
                # request would spend a device slot on a sure 504.
                item.future.set_exception(DeadlineInfeasible(
                    f"remaining deadline budget "
                    f"{deadline.remaining() * 1e3:.0f}ms is below the "
                    f"bucket's observed p95 device time "
                    f"{p95 * 1e3:.0f}ms", retry_after_s=p95))
                return item.future
        elif self.buckets is not None:
            item.bucket = self._bucket_of(item.lines)
        with self._cond:
            if self._draining:
                item.future.set_exception(
                    RuntimeError("batcher is draining; not accepting "
                                 "new requests"))
                return item.future
            self._pending.append(item)
            self._pending_rows += len(item.lines)
            self._cond.notify_all()
        return item.future

    def drain(self, timeout: Optional[float] = None) -> None:
        """Stop intake, flush every pending request, join the thread.
        Idempotent; safe from signal-handler-adjacent threads."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        self._thread.join(timeout)

    # -------------------------------------------------------- dispatcher

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            self._dispatch(batch)

    def _collect(self) -> Optional[List[_Pending]]:
        """Block until a batch is due: rows >= cap, oldest item older
        than max_delay_s, any pending item out of coalescing slack
        (its remaining deadline budget is down to its bucket's p95
        device time), or draining (flush everything). Expired items are
        settled as 504 here, before they can occupy a device slot."""
        with self._cond:
            while True:
                if self._pending:
                    self._expire_locked()
                    if not self._pending:
                        continue
                    if (self._draining
                            or self._pending_rows >= self.max_batch_rows):
                        return self._take_locked()
                    age = time.perf_counter() - self._pending[0].t_submit
                    wait = self.max_delay_s - age
                    for item in self._pending:
                        if item.deadline is None \
                                or not item.deadline.bounded:
                            continue
                        remaining = item.deadline.remaining()
                        p95 = self.device_times.p95(item.bucket) or 0.0
                        # slack = budget left after the device call;
                        # once it's gone, waiting for batch-mates turns
                        # a servable request into a 504.
                        wait = min(wait, remaining - p95, remaining)
                    if wait <= 0:
                        return self._take_locked()
                    self._cond.wait(timeout=wait)
                elif self._draining:
                    self._closed = True
                    return None
                else:
                    self._cond.wait()

    def _expire_locked(self) -> None:
        alive: List[_Pending] = []
        for item in self._pending:
            if item.deadline is not None and item.deadline.expired():
                self._pending_rows -= len(item.lines)
                expired_counter("batch_wait").inc()
                if item.future.set_running_or_notify_cancel():
                    item.future.set_exception(DeadlineExceeded(
                        "request deadline expired while waiting for "
                        "batch-mates"))
            else:
                alive.append(item)
        self._pending = alive

    def _take_locked(self) -> List[_Pending]:
        take: List[_Pending] = []
        rows = 0
        while self._pending:
            nxt = self._pending[0]
            if take and rows + len(nxt.lines) > self.max_batch_rows:
                break
            take.append(self._pending.pop(0))
            rows += len(nxt.lines)
        self._pending_rows -= rows
        return take

    def _dispatch(self, batch: List[_Pending]) -> None:
        t_dispatch = time.perf_counter()
        # Last expiry check before device work: an item that ran out of
        # budget between collection and dispatch settles as 504 here
        # rather than burning rows in the device batch.
        live: List[_Pending] = []
        for item in batch:
            if item.deadline is not None and item.deadline.expired():
                expired_counter("batch_wait").inc()
                if item.future.set_running_or_notify_cancel():
                    item.future.set_exception(DeadlineExceeded(
                        "request deadline expired at dispatch"))
            else:
                live.append(item)
        batch = live
        if not batch:
            return
        all_lines: List[str] = []
        for item in batch:
            wait = t_dispatch - item.t_submit
            _H_BATCH_WAIT.observe(wait)
            if item.phases is not None:
                item.phases["batch_wait"] = wait
            if item.trace is not None:
                item.trace.add_span("batch_wait", item.t_submit, wait)
            all_lines.extend(item.lines)
        _C_BATCHES.inc()
        self.batches_dispatched += 1
        batch_id = self.batches_dispatched
        _C_ROWS.inc(len(all_lines))
        _H_BATCH_ROWS.observe(len(all_lines))
        try:
            results = self.predict_fn(all_lines)
            if len(results) != len(all_lines):
                raise RuntimeError(
                    f"predict_fn returned {len(results)} results for "
                    f"{len(all_lines)} lines")
        except BaseException as e:  # noqa: BLE001 — futures must settle
            for item in batch:
                if not item.future.set_running_or_notify_cancel():
                    continue
                item.future.set_exception(e)
            return
        dur = time.perf_counter() - t_dispatch
        _H_DEVICE.observe(dur)
        # The deepest bucket in the batch is the shape the device call
        # compiled/ran at — that is the bucket this duration informs.
        batch_bucket = max((i.bucket for i in batch
                            if i.bucket is not None), default=None)
        self.device_times.record(batch_bucket, dur)
        self._record_batch_spans(batch, batch_id, batch_bucket,
                                 len(all_lines), t_dispatch, dur)
        off = 0
        for item in batch:
            n = len(item.lines)
            if item.phases is not None:
                item.phases["device"] = dur
            if item.future.set_running_or_notify_cancel():
                item.future.set_result(results[off:off + n])
            off += n

    def _record_batch_spans(self, batch: List[_Pending], batch_id: int,
                            bucket: Optional[int], rows: int,
                            t_dispatch: float, dur: float) -> None:
        _record_batch_spans(batch, batch_id, bucket, rows, t_dispatch,
                            dur)


def _record_batch_spans(batch: List[_Pending], batch_id: int,
                        bucket: Optional[int], rows: int,
                        t_dispatch: float, dur: float) -> None:
    """Fan the coalesced device call into the member traces: ONE
    shared batch span id is stamped into every member request's
    trace (the batch node N request trees share), each member's
    `device` span hangs under it, and the process tracer records the
    batch exactly once — tagged with every member trace id so the
    bulk Chrome trace links batch to requests."""
    traced = [item for item in batch if item.trace is not None]
    if not traced:
        return
    from code2vec_tpu_torch.obs import reqtrace, tracer
    batch_span_id = reqtrace.mint_span_id()
    members = [item.trace.trace_id for item in traced]
    attrs = {"batch_id": batch_id, "rows": rows,
             "requests": len(batch)}
    if bucket is not None:
        attrs["bucket"] = bucket
    # reqtrace stores attrs BY REFERENCE, so the whole batch shares ONE
    # attrs dict built here on the dispatch thread (N spans, one dict +
    # one members list — not N dict constructions; same memoization as
    # the tracer-export fix). It only gets serialized per response on
    # the --serve_debug_trace + ?debug=trace path.
    span_attrs = dict(attrs, members=members)
    for item in traced:
        item.trace.add_span("batch", t_dispatch, dur,
                            span_id=batch_span_id,
                            attrs=span_attrs,
                            forward=False)
        item.trace.add_span("device", t_dispatch, dur,
                            parent_id=batch_span_id)
    tracer.default_tracer().maybe_record(
        "serving_batch", t_dispatch, dur, span_id=batch_span_id,
        attrs=dict(attrs, member_trace_ids=members))


class StaleParse(RuntimeError):
    """Raised by a backend's `predict_rows` when the live model's
    fingerprint no longer matches the slot's parse-time fingerprint (a
    hot-swap landed between parse and dispatch): the slot's int rows
    were built against the OLD vocab tables and must not run under the
    new weights. The worker falls back to the lines path, re-parsing
    under the current model — so the batch still answers with exactly
    one fingerprint."""


class _Slot:
    """One forming/in-flight device batch of the continuous batcher.

    `rows` rows of the fixed-shape buffer are reserved (parse writes
    land in disjoint row ranges, so only the RESERVATION is locked —
    the parse itself runs on the submitter thread outside the lock,
    tracked by `pending_writes`)."""

    __slots__ = ("kind", "items", "offsets", "rows", "buffer",
                 "pending_writes", "sealed", "chained", "t_open", "fps")

    def __init__(self, kind: str, buffer=None):
        self.kind = kind              # "rows" (zero-copy) | "lines"
        self.items: List[_Pending] = []
        self.offsets: List[Tuple[int, int]] = []   # (row_offset, n)
        self.rows = 0
        self.buffer = buffer
        self.pending_writes = 0
        self.sealed = False
        self.chained = False
        self.t_open = time.perf_counter()
        self.fps: set = set()         # model fingerprints seen at parse


class ContinuousBatcher:
    """Slot-reservation dispatcher: continuous batching for the serve
    path (--serve_continuous).

    The collect-then-dispatch DynamicBatcher holds every batch until it
    fills or ages out, so a row arriving just after a dispatch starts a
    FRESH delay window behind a device step it cannot join. Here the
    next batch is always forming: `submit()` reserves rows in the tail
    slot under the lock, parses the extractor lines straight into the
    slot's padded (rows, contexts) buffer OUTSIDE the lock (zero-copy:
    reader.parse_context_lines(out=...) — no per-request RowBatch
    between extractor_pool and the device step), and up to
    `inflight_steps` worker threads launch a device step as soon as the
    previous one's dispatch returns. A slot any of whose rows arrived
    while a step was on device is CHAINED: it dispatches the moment a
    worker frees (riding step N+1) instead of waiting out max_delay_s.
    An idle server degrades exactly to the classic behavior — one slot,
    one delay window, byte-identical responses for a serial client.

    Admission control is re-expressed against the in-flight step's ETA:
    a bounded-deadline request is refused (`DeadlineInfeasible`) when
    `remaining < eta + p95(bucket)` where eta is 0 if a worker is free,
    else the soonest in-flight step's expected completion; the
    slack-aware early dispatch uses the same per-bucket p95s. Cold
    tracker => no refusal, as in the classic batcher.

    `backend` is the model adapter (serving/server.py) with:
    alloc(rows), parse_into(lines, buffer, row_offset) -> fingerprint,
    predict_rows(buffer, n_rows, fingerprint) -> results (raising
    StaleParse when `fingerprint` is no longer the live model's), and
    predict_lines(lines) -> results. Without a backend (unit tests)
    every slot is a "lines" slot dispatched through `predict_fn`,
    exercising the continuous machinery alone. Oversized requests
    (> max_batch_rows) and slots whose parse-time fingerprint no longer
    matches the live model (mid-batch hot-swap) fall back to the lines
    path — predict_lines re-parses under the CURRENT model, so every
    response batch still carries exactly one fingerprint.
    """

    def __init__(self, predict_fn: Optional[Callable[[List[str]], List]]
                 = None,
                 max_batch_rows: int = 64, max_delay_s: float = 0.01,
                 buckets: Optional[Sequence[int]] = None,
                 inflight_steps: int = 2, backend=None):
        if predict_fn is None and backend is None:
            raise ValueError("ContinuousBatcher needs a predict_fn or "
                             "a backend")
        self.predict_fn = predict_fn
        self.backend = backend
        self.max_batch_rows = max(1, int(max_batch_rows))
        self.max_delay_s = max(0.0, float(max_delay_s))
        self.buckets = tuple(buckets) if buckets else None
        self.inflight_steps = max(1, int(inflight_steps))
        self.device_times = _DeviceTimeTracker()
        self._cond = threading.Condition()
        self._slots: deque = deque()
        self._pool: List = []
        self._pool_cap = self.inflight_steps + 2
        self._inflight = 0
        self._inflight_meta: List[List] = []   # [t_launch, bucket]
        self._draining = False
        self.batches_dispatched = 0
        self.rides = 0
        self._workers = [
            threading.Thread(target=self._worker,
                             name=f"serving-batcher-{i}", daemon=True)
            for i in range(self.inflight_steps)]
        for t in self._workers:
            t.start()

    # -------------------------------------------------------------- API

    _bucket_of = DynamicBatcher._bucket_of

    def submit(self, lines: Sequence[str],
               phases: Optional[dict] = None,
               deadline: Optional[Deadline] = None,
               trace=None) -> Future:
        item = _Pending(list(lines), phases, deadline, trace=trace)
        if not item.lines:
            item.future.set_result([])
            return item.future
        item.bucket = self._bucket_of(item.lines)
        if deadline is not None and deadline.bounded:
            if deadline.expired():
                expired_counter("batch_wait").inc()
                item.future.set_exception(DeadlineExceeded(
                    "request deadline expired before batching"))
                return item.future
            p95 = self.device_times.p95(item.bucket)
            if p95 is not None:
                eta = self._inflight_eta()
                if deadline.remaining() < eta + p95:
                    # The request cannot finish inside its budget even
                    # riding the very next step: the soonest in-flight
                    # step completes in `eta`, then its own bucket's
                    # p95 device time runs.
                    item.future.set_exception(DeadlineInfeasible(
                        f"remaining deadline budget "
                        f"{deadline.remaining() * 1e3:.0f}ms is below "
                        f"the in-flight step ETA {eta * 1e3:.0f}ms + "
                        f"bucket p95 device time {p95 * 1e3:.0f}ms",
                        retry_after_s=eta + p95))
                    return item.future
        n = len(item.lines)
        kind = ("rows" if self.backend is not None
                and n <= self.max_batch_rows
                and getattr(self.backend, "supports_rows",
                            lambda: True)() else "lines")
        with self._cond:
            if self._draining:
                item.future.set_exception(
                    RuntimeError("batcher is draining; not accepting "
                                 "new requests"))
                return item.future
            slot = self._slots[-1] if self._slots else None
            if (slot is None or slot.sealed or slot.kind != kind
                    or slot.rows + n > self.max_batch_rows):
                if slot is not None and not slot.sealed:
                    slot.sealed = True
                buffer = self._get_buffer_locked() if kind == "rows" \
                    else None
                slot = _Slot(kind, buffer)
                self._slots.append(slot)
            off = slot.rows
            slot.items.append(item)
            slot.offsets.append((off, n))
            slot.rows += n
            if slot.rows >= self.max_batch_rows:
                slot.sealed = True
            if self._inflight > 0 and not slot.chained:
                # this row arrived while a step was on device: the slot
                # rides the next step instead of a fresh delay window
                slot.chained = True
            if self._inflight > 0:
                self.rides += 1
                _C_RIDES.inc()
            if kind == "rows":
                slot.pending_writes += 1
            self._cond.notify_all()
        if kind != "rows":
            return item.future
        # Zero-copy parse, outside the lock: this submitter thread
        # writes its own disjoint row range of the slot buffer.
        try:
            fp = self.backend.parse_into(item.lines, slot.buffer, off)
        except BaseException as e:  # noqa: BLE001 — future must settle
            with self._cond:
                slot.pending_writes -= 1
                slot.buffer.context_valid_mask[off:off + n] = 0.0
                slot.buffer.example_valid[off:off + n] = False
                item.settled = True
                if item.future.set_running_or_notify_cancel():
                    item.future.set_exception(e)
                self._cond.notify_all()
            return item.future
        with self._cond:
            slot.pending_writes -= 1
            slot.fps.add(fp)
            self._cond.notify_all()
        return item.future

    def drain(self, timeout: Optional[float] = None) -> None:
        """Stop intake, flush every forming slot (partially filled
        included), join the workers. Idempotent."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        for t in self._workers:
            t.join(None if deadline is None
                   else max(deadline - time.monotonic(), 0.0))

    # -------------------------------------------------------- dispatch

    def _inflight_eta(self) -> float:
        """Seconds until the soonest in-flight step is expected to
        free a worker; 0 when a worker is idle or the tracker is cold
        for any in-flight bucket (never refuse on a guess)."""
        with self._cond:
            if self._inflight < self.inflight_steps:
                return 0.0
            meta = [tuple(m) for m in self._inflight_meta]
        now = time.perf_counter()
        eta = None
        for t_launch, bucket, _slot in meta:
            p95 = self.device_times.p95(bucket)
            if p95 is None:
                return 0.0
            done_in = max(t_launch + p95 - now, 0.0)
            eta = done_in if eta is None else min(eta, done_in)
        return eta or 0.0

    def _get_buffer_locked(self):
        if self._pool:
            return self._pool.pop()
        return self.backend.alloc(self.max_batch_rows)

    def _release_buffer(self, buffer, rows: int) -> None:
        if buffer is None:
            return
        # wipe the used rows' validity so a pooled buffer can never
        # inflate the next batch's bucket (indices are re-PADded per
        # claim by parse_into)
        buffer.context_valid_mask[:rows] = 0.0
        buffer.example_valid[:rows] = False
        with self._cond:
            if len(self._pool) < self._pool_cap:
                self._pool.append(buffer)

    def _due_wait_locked(self, slot: _Slot) -> float:
        """Seconds until the head slot is due (<= 0: dispatch now)."""
        if self._draining or slot.sealed or slot.chained:
            return 0.0
        wait = self.max_delay_s - (time.perf_counter() - slot.t_open)
        for item in slot.items:
            if item.deadline is None or not item.deadline.bounded \
                    or item.settled:
                continue
            remaining = item.deadline.remaining()
            p95 = self.device_times.p95(item.bucket) or 0.0
            wait = min(wait, remaining - p95, remaining)
        return wait

    def _expire_head_locked(self, slot: _Slot) -> None:
        if slot.pending_writes:
            return   # a parse is writing; next pass catches expiries
        for (off, n), item in zip(slot.offsets, slot.items):
            if item.settled or item.deadline is None \
                    or not item.deadline.expired():
                continue
            expired_counter("batch_wait").inc()
            item.settled = True
            if slot.buffer is not None:
                slot.buffer.context_valid_mask[off:off + n] = 0.0
                slot.buffer.example_valid[off:off + n] = False
            if item.future.set_running_or_notify_cancel():
                item.future.set_exception(DeadlineExceeded(
                    "request deadline expired while waiting for "
                    "batch-mates"))

    def _worker(self) -> None:
        while True:
            slot = self._next_slot()
            if slot is None:
                return
            try:
                self._run_slot(slot)
            finally:
                self._release_buffer(slot.buffer, slot.rows)
                with self._cond:
                    self._inflight -= 1
                    self._inflight_meta = [
                        m for m in self._inflight_meta
                        if m[2] is not slot]
                    _G_INFLIGHT.set(self._inflight)
                    self._cond.notify_all()

    def _next_slot(self) -> Optional[_Slot]:
        with self._cond:
            while True:
                slot = self._slots[0] if self._slots else None
                if slot is None:
                    if self._draining:
                        return None
                    self._cond.wait()
                    continue
                self._expire_head_locked(slot)
                if all(i.settled for i in slot.items) \
                        and not slot.pending_writes:
                    self._slots.popleft()
                    self._release_buffer_nolock_queue(slot)
                    continue
                wait = self._due_wait_locked(slot)
                if wait <= 0 and slot.pending_writes == 0:
                    self._slots.popleft()
                    slot.sealed = True
                    self._inflight += 1
                    bucket = max((i.bucket for i in slot.items
                                  if i.bucket is not None
                                  and not i.settled), default=None)
                    self._inflight_meta.append(
                        [time.perf_counter(), bucket, slot])
                    _G_INFLIGHT.set(self._inflight)
                    return slot
                self._cond.wait(timeout=wait if wait > 0 else None)

    def _release_buffer_nolock_queue(self, slot: _Slot) -> None:
        # called with the lock held for a fully-expired slot: return
        # the (already mask-wiped) buffer straight to the pool
        if slot.buffer is not None \
                and len(self._pool) < self._pool_cap:
            self._pool.append(slot.buffer)
            slot.buffer = None

    def _run_slot(self, slot: _Slot) -> None:
        t_dispatch = time.perf_counter()
        with self._cond:
            self._expire_head_locked(slot)
            live = [i for i in slot.items if not i.settled]
            if not live:
                return
            # `inflight_steps` workers run this at once: count and take
            # the batch id under the lock, so no update is lost
            self.batches_dispatched += 1
            batch_id = self.batches_dispatched
        for item in live:
            wait = t_dispatch - item.t_submit
            _H_BATCH_WAIT.observe(wait)
            if item.phases is not None:
                item.phases["batch_wait"] = wait
            if item.trace is not None:
                item.trace.add_span("batch_wait", item.t_submit, wait)
        rows_live = sum(len(i.lines) for i in live)
        _C_BATCHES.inc()
        _C_ROWS.inc(rows_live)
        _H_BATCH_ROWS.observe(rows_live)
        use_rows = slot.kind == "rows" and len(slot.fps) == 1
        try:
            if use_rows:
                try:
                    results = self.backend.predict_rows(
                        slot.buffer, slot.rows, next(iter(slot.fps)))
                except StaleParse:
                    use_rows = False
                else:
                    if len(results) < slot.rows:
                        raise RuntimeError(
                            f"predict_rows returned {len(results)} "
                            f"results for {slot.rows} rows")
            if not use_rows:
                # lines fallback: plain lines slot, a rows slot that
                # straddled a hot-swap (mixed parse fingerprints or
                # StaleParse), — re-parse under the CURRENT model so
                # the batch answers with one fingerprint
                all_lines = [l for i in live for l in i.lines]
                fn = (self.backend.predict_lines
                      if self.backend is not None else self.predict_fn)
                results = fn(all_lines)
                if len(results) != len(all_lines):
                    raise RuntimeError(
                        f"predict_fn returned {len(results)} results "
                        f"for {len(all_lines)} lines")
        except BaseException as e:  # noqa: BLE001 — futures must settle
            for item in live:
                if item.future.set_running_or_notify_cancel():
                    item.future.set_exception(e)
            return
        dur = time.perf_counter() - t_dispatch
        _H_DEVICE.observe(dur)
        batch_bucket = max((i.bucket for i in live
                            if i.bucket is not None), default=None)
        self.device_times.record(batch_bucket, dur)
        _record_batch_spans(live, batch_id, batch_bucket, rows_live,
                            t_dispatch, dur)
        if use_rows:
            for (off, n), item in zip(slot.offsets, slot.items):
                if item.settled:
                    continue
                if item.phases is not None:
                    item.phases["device"] = dur
                if item.future.set_running_or_notify_cancel():
                    item.future.set_result(results[off:off + n])
        else:
            off = 0
            for item in live:
                n = len(item.lines)
                if item.phases is not None:
                    item.phases["device"] = dur
                if item.future.set_running_or_notify_cancel():
                    item.future.set_result(results[off:off + n])
                off += n
