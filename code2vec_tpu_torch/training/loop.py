"""The training loop: batches to the device, the train step, loss windows,
epoch boundaries, the saves and evaluations they schedule, and the
loop's operations.

The counterpart of code2vec_tpu/training/loop.py (Trainer.train
:114-681) on one device or one rank of a mesh. Batches reach the device
through the prefetcher (utils/prefetch.py, as the reference's :244-246):
a worker thread gathers the next `prefetch_batches` batches into pinned
host buffers and their copies run on a copy stream while the device runs
the step before (`prefetch_double_buffer` holds one staged batch back).
Epochs end at the reader's EpochEnd markers and are numbered from
`initial_epoch` (a resumed run continues the numbering); the host reads
the losses back only at log boundaries, mid-epoch evaluations,
preemption and epoch ends (each read waits for the device), logs the
reference's progress line every `num_batches_to_log_progress` batches
(loss, examples/s and path-contexts/s, the epoch's ETA, and where the
window's host time went), and checks every batch's loss for NaN/Inf
there (`on_nonfinite_loss`: "halt" saves `_iter<N>_nanhalt` through the
preemption path, which resume never picks, and raises
NonFiniteLossError; "warn" logs and goes on). At the end of epoch N with
N % save_every_epochs == 0, and at the final epoch, it calls `save_fn`,
then `evaluate_fn` (:458-467); every `num_train_batches_to_evaluate`
batches it evaluates mid-epoch (:596-606). An error in either is
raised, not swallowed.

Operations (:60-111, :257-367, :481-523, :559-674):

- preemption: `PreemptionWatcher` turns SIGTERM into a checkpoint at the
  next step boundary (`save_fn(..., suffix="_preempt", cursor_rows=rows
  this epoch consumed)`) and a clean stop (`trainer.preempted`); so does
  the process's resident memory crossing `rss_limit_gb`. A mesh run
  installs neither: its ranks would have to agree on the stop (the
  reference ORs the flag every `_PREEMPT_SYNC_EVERY` batches), which
  comes with the mesh's checkpoints;
- `commit_drain_fn` (the async committer's drain) runs before any
  preemption-path save and in the `finally`, where a failed commit fails
  the run;
- the heartbeat JSON (`heartbeat_file`): starting, running, and at the
  end done, preempted or error (with `error_type`, `error_message`);
- the registry's `train_*` metrics and `process_rss_bytes`, the
  Prometheus file (`metrics_file`) and port (`metrics_port`) and the
  host spans' Chrome trace (`trace_export`);
- TensorBoard scalars (`use_tensorboard`, utils/tb.py): train/loss,
  train/examples_per_sec, eval/* and every registry metric under obs/;
- the profiler (`profile_dir`): torch.profiler with CPU and CUDA
  activities over batches 10-20, written as a Chrome trace, and closed
  in the `finally` when the loop raises.
"""

from __future__ import annotations

import os
import resource
import signal
import sys
import threading
import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch import obs
from code2vec_tpu_torch.data.reader import EpochEnd
from code2vec_tpu_torch.obs import exporters as obs_exporters
from code2vec_tpu_torch.training.state import TrainState
from code2vec_tpu_torch.utils.prefetch import DevicePrefetcher

# EMA smoothing of the throughput for the ETA, once per log window (the
# reference's :37-42)
_THROUGHPUT_EMA_ALPHA = 0.5

# the batches a profiler trace covers (the reference's :481, :519)
PROFILE_START_BATCH = 10
PROFILE_STOP_BATCH = 20

_PAGE_SIZE = resource.getpagesize()


class NonFiniteLossError(RuntimeError):
    """Raised by the non-finite-loss sentinel under the `halt` policy,
    after an `_iter<N>_nanhalt` checkpoint has been written: the process
    exits nonzero while `--load` still resumes the last finite state."""


def current_rss_bytes() -> int:
    """Current (not peak) resident set size: /proc/self/statm on Linux,
    the getrusage peak elsewhere (reference :60-69)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak if sys.platform == "darwin" else peak * 1024


class PreemptionWatcher:
    """SIGTERM -> checkpoint-and-stop (reference :72-111). The trainer
    checks the flag at every step boundary; when it is set it saves a
    `_preempt` checkpoint and leaves the loop, so `--load` resumes the
    interrupted epoch. `install` is a no-op off the main thread (signals
    bind only there); the previous handler is chained, and restored by
    `uninstall`."""

    def __init__(self, log=print):
        self._requested = False
        self._log = log
        self._prev = None
        self._installed = False

    def install(self) -> "PreemptionWatcher":
        if threading.current_thread() is not threading.main_thread():
            return self
        self._prev = signal.signal(signal.SIGTERM, self._handle)
        self._installed = True
        return self

    def _handle(self, signum, frame):
        self._requested = True
        self._log("SIGTERM received: will checkpoint at the next step "
                  "boundary and stop")
        if callable(self._prev):
            self._prev(signum, frame)

    @property
    def requested(self) -> bool:
        return self._requested

    def uninstall(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev or signal.SIG_DFL)
            self._installed = False


class Trainer:
    def __init__(self, config, train_step: Callable, device,
                 evaluate_fn: Optional[Callable] = None,
                 save_fn: Optional[Callable] = None,
                 profile_dir: Optional[str] = None,
                 initial_epoch: int = 0,
                 steps_per_epoch_hint: Optional[int] = None,
                 stop_fn: Optional[Callable[[], bool]] = None,
                 commit_drain_fn: Optional[Callable[[], None]] = None,
                 heartbeat_extra: Optional[dict] = None,
                 host_group=None):
        self.config = config
        self.train_step = train_step
        self.device = torch.device(device)
        # evaluate_fn(state) -> results (logged); save_fn(state, epoch,
        # suffix="", cursor_rows=0)
        self.evaluate_fn = evaluate_fn
        self.save_fn = save_fn
        self.profile_dir = profile_dir
        self.initial_epoch = initial_epoch
        # the full epoch's batch count, for the ETA (None: learnt from the
        # first epoch)
        self.steps_per_epoch_hint = steps_per_epoch_hint
        # checked after each epoch-end evaluation: True stops early
        self.stop_fn = stop_fn
        # blocks until every in-flight async commit finished, re-raising
        # the first failure
        self.commit_drain_fn = commit_drain_fn
        # fields merged into every heartbeat (the facade's resume report)
        self.heartbeat_extra = dict(heartbeat_extra or {})
        # a mesh's gloo group (None on one device)
        self.host_group = host_group
        # the epoch count reached (initial + passes seen)
        self.final_epoch = initial_epoch
        # True when train() left through a preemption checkpoint (the
        # caller skips its final save)
        self.preempted = False
        # per finished epoch: its batches' losses
        self.epoch_losses: List[List[float]] = []
        # (epoch, results) of each epoch-end evaluation
        self.eval_results: List[Tuple[int, object]] = []
        # (batch, results) of each mid-epoch evaluation
        self.mid_epoch_results: List[Tuple[int, object]] = []

    def _make_tb_writer(self):
        if not self.config.use_tensorboard:
            return None
        from code2vec_tpu_torch.utils.tb import ScalarWriter
        logdir = self.config.tensorboard_dir
        self.config.log(f"Writing TensorBoard scalars to {logdir}")
        return ScalarWriter(logdir)

    def train(self, state: TrainState, batches: Iterable,
              dropout_seed: int) -> TrainState:
        config = self.config
        log = config.log
        log("Starting training"
            + (f" (resuming from epoch {self.initial_epoch})"
               if self.initial_epoch else ""))
        start_time = time.time()
        eval_every = config.num_train_batches_to_evaluate
        tb = self._make_tb_writer()

        # ---- observability: always-on histograms (handles cached: the
        # registry lookup takes a lock), spans into the ring only under
        # --trace_export, exports at log boundaries
        reg = obs.default_registry()
        tracer = obs.default_tracer()
        trace_path = config.trace_export
        if trace_path:
            tracer.enable()
        metrics_file = config.metrics_file
        heartbeat_file = config.heartbeat_file
        metrics_server = None
        if config.metrics_port:
            metrics_server = obs_exporters.start_metrics_server(
                config.metrics_port)
            log(f"Serving Prometheus metrics at http://127.0.0.1:"
                f"{metrics_server.server_address[1]}/metrics")
        h_data_wait = reg.histogram(
            "train_data_wait_seconds",
            "host wait for the next prefetched batch")
        h_dispatch = reg.histogram(
            "train_step_dispatch_seconds",
            "host-side dispatch of the jitted train step (async: device "
            "execution overlaps; sync time is train_loss_sync_seconds)")
        h_loss_sync = reg.histogram(
            "train_loss_sync_seconds",
            "blocking device fetch of a window's losses")
        c_batches = reg.counter("train_batches_total",
                                "train batches consumed this process")
        c_epochs = reg.counter("train_epochs_total", "completed data passes")
        c_nonfinite = reg.counter(
            "train_nonfinite_loss_batches_total",
            "individual batches whose loss came back NaN/Inf")
        g_loss = reg.gauge("train_last_avg_loss",
                           "window-average loss at the last drain")
        g_throughput = reg.gauge(
            "train_examples_per_sec",
            "window throughput at the last log boundary")
        g_epoch = reg.gauge("train_epoch", "current epoch number")
        g_rss = reg.gauge("process_rss_bytes", "current resident set size")

        batch_num = 0              # batches this run
        profiler = None            # torch.profiler over batches 10-20
        epoch = self.initial_epoch
        batch_in_epoch = 0
        batches_since_eval = 0
        steps_per_epoch = self.steps_per_epoch_hint
        throughput_ema = None
        pending: List[torch.Tensor] = []
        epoch_losses: List[float] = []
        multi_batch_start = time.time()
        win_data_wait = 0.0        # host-side step-time breakdown,
        win_dispatch = 0.0         # accumulated over the log window
        last_avg_loss = float("nan")
        watcher = None
        rss_limit_bytes = int(float(config.rss_limit_gb) * (1 << 30))
        if self.host_group is not None:
            if config.save_on_preemption or rss_limit_bytes:
                log("On a mesh no SIGTERM handler or RSS watchdog is "
                    "installed: the ranks' agreement on a stop comes with "
                    "the mesh's checkpoints")
            rss_limit_bytes = 0
        elif config.save_on_preemption:
            watcher = PreemptionWatcher(log).install()
        rss_tripped = False

        def stop_requested() -> bool:
            """SIGTERM received, or the current RSS over the limit
            (sticky once tripped; current, not peak, RSS, so a start-up
            spike cannot trip every resume)."""
            nonlocal rss_tripped
            if watcher is not None and watcher.requested:
                return True
            if rss_limit_bytes > 0 and not rss_tripped:
                rss = current_rss_bytes()
                if rss > rss_limit_bytes:
                    rss_tripped = True
                    log(f"Host RSS {rss / (1 << 30):.2f} GB exceeds "
                        f"rss_limit_gb="
                        f"{rss_limit_bytes / (1 << 30):.2f}: will "
                        f"checkpoint at the next step boundary and stop")
            return rss_tripped

        def drain_commits(where: str) -> None:
            """Complete any in-flight async commit. On the preemption
            path a failed commit is logged, not raised: the artifact
            about to be written supersedes it."""
            if self.commit_drain_fn is None:
                return
            try:
                self.commit_drain_fn()
            except Exception as e:
                log(f"In-flight async checkpoint commit failed during "
                    f"{where} drain: {type(e).__name__}: {e}")

        def save_preempt(state, epoch, suffix="_preempt"):
            if self.save_fn is None:
                return
            # a name of its own (never clobbers the clean epoch save) and
            # the rows the interrupted epoch consumed
            self.save_fn(state, epoch, suffix=suffix,
                         cursor_rows=batch_in_epoch * config.train_batch_size)

        def stop_profiler() -> None:
            nonlocal profiler
            if profiler is None:
                return
            p, profiler = profiler, None
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            p.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            path = os.path.join(self.profile_dir,
                                f"train_trace.{os.getpid()}.json")
            p.export_chrome_trace(path)
            log(f"Wrote profiler trace to {path}")

        def run_eval(state, label) -> object:
            if self.evaluate_fn is None:
                return None
            # the evaluator records its own `evaluate` span and histogram
            results = self.evaluate_fn(state)
            if results is not None:
                log(f"{label} -- {results}")
                if tb is not None:
                    step = int(state.step)
                    for name, value in results.tb_scalars():
                        tb.scalar(f"eval/{name}", value, step)
                    tb.flush()
            return results

        def write_heartbeat(status: str, **extra) -> None:
            """The atomic JSON heartbeat of host-side counters (never
            syncs the device); `extra` carries an error's class and
            message."""
            if heartbeat_file is None:
                return
            fields = dict(self.heartbeat_extra)
            fields.update(extra)
            obs_exporters.write_heartbeat(
                heartbeat_file,
                status=status,
                step=batch_num,
                epoch=epoch,
                batch_in_epoch=batch_in_epoch,
                last_loss=(None if not np.isfinite(last_avg_loss)
                           else last_avg_loss),
                examples_per_sec=throughput_ema,
                rss_bytes=current_rss_bytes(),
                **fields)

        def drain_losses(where: str):
            """Fetch every pending per-batch loss (where the host waits
            for the device), update the window average, and run the
            non-finite sentinel over each batch's loss. Returns (losses,
            sync seconds)."""
            nonlocal pending, last_avg_loss
            if not pending:
                return np.empty((0,)), 0.0
            t0 = time.perf_counter()
            fetched = torch.stack(pending).float().cpu()
            sync_s = time.perf_counter() - t0
            h_loss_sync.observe(sync_s)
            tracer.maybe_record("loss_sync", t0, sync_s)
            pending = []
            losses = fetched.numpy().astype(np.float64)
            last_avg_loss = float(losses.mean())
            g_loss.set(last_avg_loss)
            epoch_losses.extend(losses.tolist())
            finite = np.isfinite(losses)
            if finite.all() and np.isfinite(last_avg_loss):
                return losses, sync_s
            n_bad = int((~finite).sum())
            c_nonfinite.inc(max(n_bad, 1))
            first_bad = int(np.argmax(~finite)) if n_bad else losses.size - 1
            bad_batch = batch_num - losses.size + 1 + first_bad
            bad_value = float(losses[first_bad]) if n_bad else last_avg_loss
            policy = config.on_nonfinite_loss
            log(f"Non-finite average loss ({last_avg_loss}) at batch "
                f"{batch_num} (epoch {epoch}, {where}): {max(n_bad, 1)} "
                f"poisoned batch(es), first is batch {bad_batch} with "
                f"loss {bad_value}; policy: {policy}")
            if policy != "halt":
                return losses, sync_s
            stop_profiler()
            # the poisoned state under `_nanhalt`, kept for post-mortem and
            # invisible to resume and rotation, so `--load <base>` takes
            # the last finite artifact
            drain_commits("NaN halt")
            save_preempt(state, epoch, suffix="_nanhalt")
            self.preempted = True
            self.final_epoch = epoch
            raise NonFiniteLossError(
                f"training loss became {bad_value} at batch {bad_batch} "
                f"(epoch {epoch}, window average {last_avg_loss}); "
                f"poisoned state kept in an _iter{epoch}_nanhalt "
                f"artifact for post-mortem (excluded from resume). "
                f"`--load` resumes the last clean artifact; rerun with "
                f"--on_nonfinite_loss warn to push through.")

        write_heartbeat("starting")
        batch_iter = iter(DevicePrefetcher(
            batches, self.device, depth=config.prefetch_batches,
            double_buffer=config.prefetch_double_buffer))
        try:
            while True:
                t_wait = time.perf_counter()
                try:
                    item = next(batch_iter)
                except StopIteration:
                    break
                wait_s = time.perf_counter() - t_wait
                if isinstance(item, EpochEnd):
                    # the sentinel over the partial window the boundary
                    # would otherwise discard
                    drain_losses("epoch boundary")
                    self._check_lockstep(batch_num)
                    epoch = self.initial_epoch + item.epoch
                    c_epochs.inc()
                    g_epoch.set(epoch)
                    self.epoch_losses.append(epoch_losses)
                    mean = (float(np.mean(epoch_losses)) if epoch_losses
                            else float("nan"))
                    log(f"Epoch {epoch} done: {len(epoch_losses)} batches, "
                        f"mean loss {mean:.6f}")
                    epoch_losses = []
                    if steps_per_epoch is None:
                        steps_per_epoch = batch_in_epoch
                    batch_in_epoch = 0
                    batches_since_eval = 0
                    # the absolute epoch's cadence, stable across resumes;
                    # the final epoch always saves and evaluates
                    if (epoch % config.save_every_epochs == 0
                            or epoch >= config.num_train_epochs):
                        if self.save_fn is not None:
                            with obs.span("checkpoint_save_epoch"):
                                self.save_fn(state, epoch)
                        results = run_eval(state, f"After {epoch} epochs")
                        if self.evaluate_fn is not None:
                            self.eval_results.append((epoch, results))
                        if self.stop_fn is not None and self.stop_fn():
                            log(f"Early stopping after epoch {epoch}")
                            break
                    write_heartbeat("running")
                    win_data_wait = win_dispatch = 0.0
                    multi_batch_start = time.time()
                    continue

                arrays, _ = item
                batch_num += 1
                batch_in_epoch += 1
                batches_since_eval += 1
                h_data_wait.observe(wait_s)
                win_data_wait += wait_s
                tracer.maybe_record("data_wait", t_wait, wait_s)
                if self.profile_dir and batch_num == PROFILE_START_BATCH:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if self.device.type == "cuda":
                        activities.append(
                            torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                t_disp = time.perf_counter()
                state, loss = self.train_step(state, *arrays, dropout_seed)
                disp_s = time.perf_counter() - t_disp
                h_dispatch.observe(disp_s)
                win_dispatch += disp_s
                tracer.maybe_record("step_dispatch", t_disp, disp_s)
                c_batches.inc()
                pending.append(loss)
                if stop_requested():
                    # Drain first: a NaN window must take the halt path
                    # (`_nanhalt`, invisible to resume), never become a
                    # resumable `_preempt` artifact.
                    drain_losses("preemption")
                    stop_profiler()
                    # the in-flight commit lands before the (synchronous)
                    # preemption artifact
                    drain_commits("preemption")
                    save_preempt(state, epoch)
                    log(f"Preemption checkpoint saved (epoch {epoch}, "
                        f"batch {batch_num}); stopping")
                    self.preempted = True
                    break
                if profiler is not None and batch_num == PROFILE_STOP_BATCH:
                    stop_profiler()
                if batch_num % config.num_batches_to_log_progress == 0:
                    # the only regular wait on the device: the window's
                    # losses, each checked by the sentinel
                    losses, sync_s = drain_losses("log boundary")
                    elapsed = time.time() - multi_batch_start
                    n = losses.size * config.train_batch_size
                    throughput = n / max(elapsed, 1e-9)
                    throughput_ema = (
                        throughput if throughput_ema is None else
                        _THROUGHPUT_EMA_ALPHA * throughput
                        + (1 - _THROUGHPUT_EMA_ALPHA) * throughput_ema)
                    contexts_rate = throughput * config.max_contexts
                    eta = ""
                    if steps_per_epoch:
                        remaining = max(steps_per_epoch - batch_in_epoch, 0)
                        eta_s = remaining * config.train_batch_size / max(
                            throughput_ema, 1e-9)
                        eta = (f", epoch {epoch + 1}: "
                               f"{batch_in_epoch}/{steps_per_epoch} batches, "
                               f"ETA {int(eta_s) // 60}m{int(eta_s) % 60:02d}s")
                    # where the window's wall time went on the host;
                    # device/other is the rest (the device-bound share on
                    # a healthy run)
                    other_s = max(
                        elapsed - win_data_wait - win_dispatch - sync_s, 0.0)
                    log(f"Average loss at batch {batch_num}: {last_avg_loss:.6f}, "
                        f"\tthroughput: {throughput:.0f} samples/sec "
                        f"({contexts_rate / 1e6:.2f}M path-contexts/sec{eta})"
                        f" [host: data-wait {win_data_wait:.2f}s, dispatch "
                        f"{win_dispatch:.2f}s, loss-sync {sync_s:.2f}s, "
                        f"device/other {other_s:.2f}s]")
                    g_throughput.set(throughput)
                    g_epoch.set(epoch)
                    g_rss.set(current_rss_bytes())
                    reg.gauge("train_window_data_wait_seconds",
                              "data wait total over the last log window"
                              ).set(win_data_wait)
                    reg.gauge("train_window_dispatch_seconds",
                              "dispatch total over the last log window"
                              ).set(win_dispatch)
                    reg.gauge("train_window_loss_sync_seconds",
                              "loss sync at the last log boundary"
                              ).set(sync_s)
                    reg.gauge("train_input_bound_fraction",
                              "fraction of the last log window the step "
                              "loop spent blocked on input data"
                              ).set(win_data_wait / max(elapsed, 1e-9))
                    if tb is not None:
                        step = int(state.step)
                        tb.scalar("train/loss", last_avg_loss, step)
                        tb.scalar("train/examples_per_sec", throughput, step)
                        obs_exporters.tb_export(tb, step, registry=reg)
                        tb.flush()
                    write_heartbeat("running")
                    if metrics_file:
                        obs_exporters.write_prometheus(metrics_file,
                                                       registry=reg)
                    win_data_wait = win_dispatch = 0.0
                    multi_batch_start = time.time()
                if eval_every and batches_since_eval >= eval_every:
                    # the reference's ModelEvaluationCallback every
                    # NUM_TRAIN_BATCHES_TO_EVALUATE batches; drain first,
                    # so the sentinel sees the window the eval resets
                    batches_since_eval = 0
                    drain_losses("mid-epoch eval boundary")
                    results = run_eval(
                        state, f"Mid-epoch (batch {batch_num}) evaluation")
                    if self.evaluate_fn is not None:
                        self.mid_epoch_results.append((batch_num, results))
                    win_data_wait = win_dispatch = 0.0
                    multi_batch_start = time.time()
            drain_losses("end of data")
        finally:
            # stop the prefetch worker also when the loop raises
            batch_iter.close()
            if profiler is not None:
                # a raise between batches 10 and 20 must not leak an open
                # profiler; never mask the original exception
                try:
                    stop_profiler()
                except Exception:
                    profiler = None
            if watcher is not None:
                watcher.uninstall()
            # the event file's tail, the last heartbeat and snapshot say
            # why the process stopped: written here, best-effort
            if tb is not None:
                try:
                    tb.close()
                except Exception:
                    pass
            # an abandoned commit thread would leave a staging directory
            # without its manifest: complete it; a failure with no other
            # exception in flight fails the run
            commit_error = None
            if self.commit_drain_fn is not None:
                try:
                    self.commit_drain_fn()
                except Exception as e:
                    commit_error = e
                    log(f"Async checkpoint commit failed at drain: "
                        f"{type(e).__name__}: {e}")
            exc_type, exc_value, _tb = sys.exc_info()
            if exc_type is None and commit_error is not None:
                exc_type, exc_value = type(commit_error), commit_error
            exc_in_flight = exc_type is not None
            status = ("error" if exc_in_flight
                      else "preempted" if self.preempted else "done")
            hb_extra = {}
            if exc_in_flight:
                hb_extra = {"error_type": exc_type.__name__,
                            "error_message": str(exc_value)[:300]}
            try:
                write_heartbeat(status, **hb_extra)
                if metrics_file:
                    obs_exporters.write_prometheus(metrics_file,
                                                   registry=reg)
                if trace_path:
                    tracer.export_chrome_trace(trace_path)
                    log(f"Wrote host-span Chrome trace to {trace_path} "
                        f"({len(tracer)} spans buffered)")
            except Exception:
                if not exc_in_flight:
                    raise
            obs_exporters.stop_metrics_server(metrics_server)
            if commit_error is not None and sys.exc_info()[0] is None:
                raise commit_error

        log("Done training")
        self.final_epoch = epoch
        elapsed = int(time.time() - start_time)
        log("Training time: %sH:%sM:%sS\n" % (
            elapsed // 3600, (elapsed // 60) % 60, elapsed % 60))
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
