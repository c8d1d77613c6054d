"""Host -> device prefetch: the next batches are gathered and staged while
the device runs the current step.

The counterpart of code2vec_tpu/utils/prefetch.py DevicePrefetcher
(:36-153), in PyTorch's idiom. A worker thread iterates the batch stream
(the packed gather or the text parse) and copies each batch's six arrays
into one slot of a small ring of pinned host buffers. The consumer
issues the slot's host -> device copies with `non_blocking=True` on a
copy stream of its own, records an event behind them and makes the
stream it runs the step on wait for that event, so a copy overlaps the
step before it. A pinned slot is written again only after the event
recorded behind its last copy has passed: the worker synchronizes on
that event before it touches the slot, so a copy in flight never reads
a half-written batch. The device tensors are allocated on the copy
stream and marked used by the step's stream (`record_stream`), so the
allocator hands their memory out again only after the step is done.

On the CPU the arrays become tensors without a copy and nothing is
pinned. EpochEnd markers pass through in order, bare. An error on the
worker is raised in the consumer. `double_buffer` holds one staged batch
back, as the reference does: batch N+1's copy is issued before batch N
is handed to the step loop.

The reference's metrics (:19-32, :92, :140): `prefetch_pack_seconds`
(the worker's copy of a batch into its pinned slot; on the CPU its
contiguous arrays), `prefetch_device_put_seconds` (the consumer's issue
of the copies), `prefetch_batches_total` and `prefetch_queue_depth`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from code2vec_tpu_torch import obs
from code2vec_tpu_torch.data.reader import EpochEnd

# Module-scope handles: these fire once per batch on the worker and
# consumer threads (registry metrics are thread-safe).
_H_PACK = obs.histogram(
    "prefetch_pack_seconds",
    "host packing of one batch's fused transfer buffer (worker thread)")
_H_DEVICE_PUT = obs.histogram(
    "prefetch_device_put_seconds",
    "host-side cost of dispatching one batch's device transfer "
    "(consumer thread; the transfer itself is async)")
_C_BATCHES = obs.counter("prefetch_batches_total",
                         "batches staged by the prefetch worker")
_G_DEPTH = obs.gauge(
    "prefetch_queue_depth",
    "ready batches queued ahead of the consumer at its last take "
    "(0 every step = the pipeline is feed-bound)")


def _arrays(batch):
    """The step's six inputs of a RowBatch, host numpy."""
    return (batch.source_token_indices, batch.path_indices,
            batch.target_token_indices, batch.context_valid_mask,
            batch.target_index, batch.example_valid)


class _Slot:
    """Pinned host buffers for one batch, and the event behind the last
    copy out of them."""

    def __init__(self):
        self.host: List[torch.Tensor] = []
        self.event: Optional[torch.cuda.Event] = None

    def fill(self, arrays) -> None:
        if self.event is not None:
            self.event.synchronize()   # the last copy out of it is done
        layout = [(tuple(a.shape), a.dtype) for a in arrays]
        if [(tuple(t.shape), t.numpy().dtype) for t in self.host] != layout:
            self.host = [torch.from_numpy(np.empty(shape, dtype)).pin_memory()
                         for shape, dtype in layout]
        for t, a in zip(self.host, arrays):
            np.copyto(t.numpy(), a, casting="no")


class DevicePrefetcher:
    """Wraps a RowBatch iterable; yields (device arrays, host batch or
    None) with up to `depth` batches staged ahead of the consumer, and
    passes EpochEnd markers through."""

    _END = object()

    def __init__(self, batches: Iterable, device, depth: int = 4,
                 keep_host_batch: bool = False,
                 double_buffer: bool = False):
        self.batches = batches
        self.device = torch.device(device)
        self.depth = max(1, depth)
        self.keep_host_batch = keep_host_batch
        self.double_buffer = double_buffer
        self.cuda = self.device.type == "cuda"
        self._ready: queue.Queue = queue.Queue(maxsize=self.depth)
        # the ring: `depth` slots waiting in the queue, one being copied,
        # one held back by double buffering, one the worker fills
        self._free: queue.Queue = queue.Queue()
        if self.cuda:
            for _ in range(self.depth + 3):
                self._free.put(_Slot())
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)

    def _put(self, item) -> bool:
        """A bounded put that gives up once the consumer has stopped."""
        while not self._stop.is_set():
            try:
                self._ready.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _free_slot(self) -> Optional[_Slot]:
        while not self._stop.is_set():
            try:
                return self._free.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def _worker(self) -> None:
        try:
            for batch in self.batches:
                if isinstance(batch, EpochEnd):
                    item = batch
                elif self.cuda:
                    slot = self._free_slot()
                    if slot is None:
                        return
                    t0 = time.perf_counter()
                    slot.fill(_arrays(batch))
                    self._packed(t0)
                    item = (batch, None, slot)
                else:
                    t0 = time.perf_counter()
                    item = (batch, [np.ascontiguousarray(a)
                                    for a in _arrays(batch)], None)
                    self._packed(t0)
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - raised in __iter__
            self._error = e
        finally:
            self._put(self._END)

    @staticmethod
    def _packed(t0: float) -> None:
        dur = time.perf_counter() - t0
        _H_PACK.observe(dur)
        obs.default_tracer().maybe_record("prefetch_pack", t0, dur)
        _C_BATCHES.inc()

    def _stage(self, item, copy_stream):
        """The batch's arrays on the device: on the CPU the host arrays
        themselves, on the GPU copies issued on `copy_stream` that the
        current stream waits for."""
        batch, arrays, slot = item
        host = batch if self.keep_host_batch else None
        if slot is None:
            return tuple(torch.from_numpy(a) for a in arrays), host
        step_stream = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(copy_stream):
            out = tuple(t.to(self.device, non_blocking=True)
                        for t in slot.host)
            event = torch.cuda.Event()
            event.record(copy_stream)
        step_stream.wait_event(event)
        for t in out:
            t.record_stream(step_stream)
        slot.event = event
        self._free.put(slot)
        return out, host

    def __iter__(self) -> Iterator:
        copy_stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._thread.start()
        pending = None
        try:
            while True:
                item = self._ready.get()
                if item is self._END:
                    if self._error is not None:
                        raise self._error
                    if pending is not None:
                        yield pending
                    return
                if isinstance(item, EpochEnd):
                    if pending is not None:
                        out, pending = pending, None
                        yield out
                    yield item
                    continue
                _G_DEPTH.set(self._ready.qsize())
                t0 = time.perf_counter()
                staged = self._stage(item, copy_stream)
                dur = time.perf_counter() - t0
                _H_DEVICE_PUT.observe(dur)
                obs.default_tracer().maybe_record("prefetch_device_put",
                                                  t0, dur)
                if not self.double_buffer:
                    yield staged
                elif pending is None:
                    pending = staged
                else:
                    out, pending = pending, staged
                    yield out
        finally:
            self._stop.set()
            self._thread.join(timeout=10)
