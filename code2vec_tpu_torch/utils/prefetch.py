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
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from code2vec_tpu_torch.data.reader import EpochEnd


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
                    slot.fill(_arrays(batch))
                    item = (batch, None, slot)
                else:
                    item = (batch, [np.ascontiguousarray(a)
                                    for a in _arrays(batch)], None)
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - raised in __iter__
            self._error = e
        finally:
            self._put(self._END)

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
                staged = self._stage(item, copy_stream)
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
