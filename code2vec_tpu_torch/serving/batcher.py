"""Dynamic request batcher with bucketed context counts.

The counterpart of code2vec_tpu/serving/batcher.py parse_buckets,
bucket_for (:80-102) and the classic DynamicBatcher (:166), without the
deadline, tenancy and trace machinery. Requests (groups of extractor
lines) queue up; one dispatcher thread collects until `max_batch_rows`
rows are pending or the oldest request has waited `max_delay_s`, then
runs one model call over all of them, so the card sees batches and not
single requests.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence, Tuple


def parse_buckets(spec, max_contexts: int) -> Tuple[int, ...]:
    """A "32,64,128" string or int sequence -> a sorted tuple below
    `max_contexts`, with `max_contexts` appended."""
    if isinstance(spec, str):
        vals = [int(v) for v in spec.replace(" ", "").split(",") if v]
    else:
        vals = [int(v) for v in (spec or ())]
    vals = sorted({v for v in vals if 0 < v < max_contexts})
    return tuple(vals) + (max_contexts,)


def bucket_for(n_contexts: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding `n_contexts` contexts; buckets[-1] is
    max_contexts."""
    for b in buckets:
        if b >= n_contexts:
            return b
    return buckets[-1]


class _Pending:
    __slots__ = ("lines", "future", "t_submit")

    def __init__(self, lines: List[str]):
        self.lines = lines
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class DynamicBatcher:
    """`predict_fn(lines) -> results` must return one result per line, in
    order. Pending requests dispatch together in FIFO order up to
    `max_batch_rows` rows; one larger request dispatches alone."""

    def __init__(self, predict_fn: Callable[[List[str]], List],
                 max_batch_rows: int = 64, max_delay_s: float = 0.01):
        self.predict_fn = predict_fn
        self.max_batch_rows = max(1, int(max_batch_rows))
        self.max_delay_s = max(0.0, float(max_delay_s))
        self._cond = threading.Condition()
        self._pending: List[_Pending] = []
        self._pending_rows = 0
        self._draining = False
        self.batches_dispatched = 0
        self._thread = threading.Thread(target=self._run,
                                        name="serving-batcher", daemon=True)
        self._thread.start()

    def submit(self, lines: Sequence[str]) -> Future:
        item = _Pending(list(lines))
        if not item.lines:
            item.future.set_result([])
            return item.future
        with self._cond:
            if self._draining:
                item.future.set_exception(RuntimeError(
                    "batcher is draining; not accepting new requests"))
                return item.future
            self._pending.append(item)
            self._pending_rows += len(item.lines)
            self._cond.notify_all()
        return item.future

    def drain(self, timeout: Optional[float] = None) -> None:
        """Stop intake, flush what is pending, join the dispatcher."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        self._thread.join(timeout)

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            self._dispatch(batch)

    def _collect(self) -> Optional[List[_Pending]]:
        with self._cond:
            while True:
                if self._pending:
                    if (self._draining
                            or self._pending_rows >= self.max_batch_rows):
                        return self._take_locked()
                    age = time.perf_counter() - self._pending[0].t_submit
                    wait = self.max_delay_s - age
                    if wait <= 0:
                        return self._take_locked()
                    self._cond.wait(timeout=wait)
                elif self._draining:
                    return None
                else:
                    self._cond.wait()

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
        all_lines = [line for item in batch for line in item.lines]
        self.batches_dispatched += 1
        try:
            results = self.predict_fn(all_lines)
            if len(results) != len(all_lines):
                raise RuntimeError(f"predict_fn returned {len(results)} "
                                   f"results for {len(all_lines)} lines")
        except BaseException as e:  # noqa: BLE001 — futures must settle
            for item in batch:
                item.future.set_exception(e)
            return
        off = 0
        for item in batch:
            n = len(item.lines)
            item.future.set_result(results[off:off + n])
            off += n
