"""The training loop: batches to the device, the train step, loss windows,
epoch boundaries, and the saves and evaluations they schedule.

The counterpart of code2vec_tpu/training/loop.py Trainer.train (:114-...)
on one device. Batches reach the device through the prefetcher
(utils/prefetch.py, as the reference's :244-246): a worker thread gathers
the next `prefetch_batches` batches into pinned host buffers and their
copies run on a copy stream while the device runs the step before
(`prefetch_double_buffer` holds one staged batch back). Epochs end at
the reader's EpochEnd markers and are
numbered from `initial_epoch` (a resumed run continues the numbering);
the host reads the losses back only at log boundaries and epoch ends
(each read waits for the device), logs the window's average loss with
examples/s every `num_batches_to_log_progress` batches, and checks every
batch's loss for NaN/Inf there (`on_nonfinite_loss`: "halt" raises
NonFiniteLossError, "warn" logs and goes on). At the end of epoch N with
N % save_every_epochs == 0, and at the final epoch, it calls `save_fn`,
then `evaluate_fn` (:458-467); an error in either is raised, not
swallowed. The mid-epoch evaluation every num_train_batches_to_evaluate
batches, preemption, the heartbeat, profiling and the metrics exporters
are not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.data.reader import EpochEnd
from code2vec_tpu_torch.training.state import TrainState
from code2vec_tpu_torch.utils.prefetch import DevicePrefetcher


class NonFiniteLossError(RuntimeError):
    """The loss of a batch came back NaN or Inf under the `halt` policy."""


class Trainer:
    def __init__(self, config, train_step: Callable, device,
                 evaluate_fn: Optional[Callable] = None,
                 save_fn: Optional[Callable] = None,
                 initial_epoch: int = 0, host_group=None):
        self.config = config
        self.train_step = train_step
        self.device = torch.device(device)
        # evaluate_fn(state) -> results (logged); save_fn(state, epoch)
        self.evaluate_fn = evaluate_fn
        self.save_fn = save_fn
        self.initial_epoch = initial_epoch
        # a mesh's gloo group (None on one device)
        self.host_group = host_group
        # the epoch count reached (initial + passes seen)
        self.final_epoch = initial_epoch
        # per finished epoch: its batches' losses
        self.epoch_losses: List[List[float]] = []
        # (epoch, results) of each epoch-end evaluation
        self.eval_results: List[Tuple[int, object]] = []

    def train(self, state: TrainState, batches: Iterable,
              dropout_seed: int) -> TrainState:
        config = self.config
        log = config.log
        log("Starting training"
            + (f" (resuming from epoch {self.initial_epoch})"
               if self.initial_epoch else ""))
        epoch = self.initial_epoch
        batch_num = 0
        pending: List[torch.Tensor] = []
        epoch_losses: List[float] = []
        window_losses: List[float] = []
        window_start = None

        def drain(where: str) -> List[float]:
            nonlocal pending
            if not pending:
                return []
            losses = torch.stack(pending).cpu().tolist()
            pending = []
            bad = [i for i, x in enumerate(losses) if not np.isfinite(x)]
            if bad:
                first = batch_num - len(losses) + 1 + bad[0]
                policy = config.on_nonfinite_loss
                log(f"Non-finite loss at batch {first} (epoch {epoch + 1}, "
                    f"{where}): {len(bad)} poisoned batch(es), loss "
                    f"{losses[bad[0]]}; policy: {policy}")
                if policy == "halt":
                    self.final_epoch = epoch
                    raise NonFiniteLossError(
                        f"training loss became {losses[bad[0]]} at batch "
                        f"{first} (epoch {epoch + 1}); rerun with "
                        f"on_nonfinite_loss='warn' to push through")
            epoch_losses.extend(losses)
            window_losses.extend(losses)
            return losses

        items = iter(DevicePrefetcher(
            batches, self.device, depth=config.prefetch_batches,
            double_buffer=config.prefetch_double_buffer))
        try:
            for item in items:
                if isinstance(item, EpochEnd):
                    drain("epoch boundary")
                    self._check_lockstep(batch_num)
                    epoch = self.initial_epoch + item.epoch
                    self.epoch_losses.append(epoch_losses)
                    mean = (float(np.mean(epoch_losses)) if epoch_losses
                            else float("nan"))
                    log(f"Epoch {epoch} done: {len(epoch_losses)} batches, "
                        f"mean loss {mean:.6f}")
                    epoch_losses, window_losses = [], []
                    window_start = None
                    # the absolute epoch's cadence, stable across resumes; the
                    # final epoch always saves and evaluates
                    if (epoch % config.save_every_epochs == 0
                            or epoch >= config.num_train_epochs):
                        if self.save_fn is not None:
                            self.save_fn(state, epoch)
                        if self.evaluate_fn is not None:
                            results = self.evaluate_fn(state)
                            self.eval_results.append((epoch, results))
                            log(f"After {epoch} epochs -- {results}")
                    continue
                if window_start is None:
                    window_start = time.perf_counter()
                arrays, _ = item
                batch_num += 1
                state, loss = self.train_step(state, *arrays, dropout_seed)
                pending.append(loss)
                if batch_num % config.num_batches_to_log_progress == 0:
                    drain("log boundary")
                    elapsed = time.perf_counter() - window_start
                    n = len(window_losses) * config.train_batch_size
                    log(f"Average loss at batch {batch_num}: "
                        f"{float(np.mean(window_losses)):.6f}, \tthroughput: "
                        f"{n / max(elapsed, 1e-9):.0f} samples/sec")
                    window_losses = []
                    window_start = time.perf_counter()
            drain("end of data")
        finally:
            # stop the prefetch worker also when the loop raises
            items.close()
        self.final_epoch = epoch
        return state

    def _check_lockstep(self, batch_num: int) -> None:
        if self.host_group is None:
            return
        from code2vec_tpu_torch.parallel.distributed import agree_scalar
        low = agree_scalar(batch_num, "min", self.host_group)
        high = agree_scalar(batch_num, "max", self.host_group)
        if low != high:
            raise RuntimeError(f"the mesh's ranks ran {low} to {high} steps "
                               f"by this epoch's end; they must run the same")
