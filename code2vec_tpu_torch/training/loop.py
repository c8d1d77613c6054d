"""The training loop: batches to the device, the train step, loss windows
and epoch boundaries.

The counterpart of code2vec_tpu/training/loop.py Trainer.train (:114-...)
cut to the dense single-device path: epochs end at the reader's EpochEnd
markers; the host reads the losses back only at log boundaries and epoch
ends (each read waits for the device), logs the window's average loss
with examples/s every `num_batches_to_log_progress` batches, and checks
every batch's loss for NaN/Inf there (`on_nonfinite_loss`: "halt" raises
NonFiniteLossError, "warn" logs and goes on). Checkpoints, evaluation,
preemption, profiling and the metrics exporters are not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List

import numpy as np
import torch

from code2vec_tpu_torch.data.reader import EpochEnd
from code2vec_tpu_torch.training.state import TrainState


class NonFiniteLossError(RuntimeError):
    """The loss of a batch came back NaN or Inf under the `halt` policy."""


class Trainer:
    def __init__(self, config, train_step: Callable, device):
        self.config = config
        self.train_step = train_step
        self.device = torch.device(device)
        self.final_epoch = 0
        # per finished epoch: its batches' losses
        self.epoch_losses: List[List[float]] = []

    def _to_device(self, batch):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in (batch.source_token_indices, batch.path_indices,
                               batch.target_token_indices,
                               batch.context_valid_mask, batch.target_index,
                               batch.example_valid))

    def train(self, state: TrainState, batches: Iterable,
              dropout_seed: int) -> TrainState:
        config = self.config
        log = config.log
        log("Starting training")
        epoch = 0
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

        for item in batches:
            if isinstance(item, EpochEnd):
                drain("epoch boundary")
                epoch = item.epoch
                self.epoch_losses.append(epoch_losses)
                mean = (float(np.mean(epoch_losses)) if epoch_losses
                        else float("nan"))
                log(f"Epoch {epoch} done: {len(epoch_losses)} batches, "
                    f"mean loss {mean:.6f}")
                epoch_losses, window_losses = [], []
                window_start = None
                continue
            if window_start is None:
                window_start = time.perf_counter()
            arrays = self._to_device(item)
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
        self.final_epoch = epoch
        return state
