"""Warm extractor worker pool: persistent path-extractor processes.

The counterpart of code2vec_tpu/serving/extractor_pool.py. The one-shot
bridge (extractor_bridge.PathExtractor) pays a process spawn per
extraction; this pool keeps N extractor children RESIDENT:

- **warm mode**: the native `c2v-extract --server` worker loop
  (cpp/src/main.cc; probed once at pool start). Requests are line-framed
  over the child's stdin (`FILE <path>` / `SRC <nbytes>` + payload),
  responses on its stdout (`OK <nlines>` + lines, or `ERR <msg>`), so an
  extraction costs the parse alone.
- **cold mode** (only where the binary has no `--server` mode): each
  worker slot runs the one-shot PathExtractor per request. Same API,
  same concurrency bound.

Failure semantics (bound: `config.extractor_retries`):

- A worker that DIES mid-request (OOM kill, signal) has its request
  REQUEUED onto a fresh worker, up to the retry bound; the dead worker
  is replaced so the pool keeps its size. Each failed attempt counts
  `extractor_failures_total` exactly once (retried=yes when another
  attempt follows, retried=no when the failure reaches the caller).
- An `ERR` frame is a deterministic rejection (parse failure): raised as
  ValueError at once, never retried.
- A request past `config.extractor_timeout_s`, or past the request's
  remaining deadline budget when that is tighter, kills THAT worker and
  is not retried (ExtractionTimeout, or DeadlineExceeded when the
  deadline was the binding bound).
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from code2vec_tpu_torch import obs
from code2vec_tpu_torch.serving import extractor_bridge as bridge
from code2vec_tpu_torch.serving.admission import (
    DeadlineExceeded, expired_counter,
)
from code2vec_tpu_torch.serving.extractor_bridge import (
    ExtractionTimeout, ExtractorCrash, PathExtractor,
    postprocess_extractor_output,
)

_H_EXTRACT = obs.histogram(
    "extractor_pool_extract_seconds",
    "warm-pool path extraction: request handed to a worker to parsed "
    "contexts (excludes the wait for a free worker)")
_H_WAIT = obs.histogram(
    "extractor_pool_wait_seconds",
    "wait for a free extractor worker slot (serving queue pressure)")
_C_REQS = obs.counter("extractor_pool_requests_total",
                      "extractions served by the warm pool")
_C_REQUEUES = obs.counter(
    "extractor_pool_requeues_total",
    "requests re-run on a fresh worker after their worker died "
    "mid-request")
_G_SIZE = obs.gauge("extractor_pool_size", "live extractor workers")


class _Worker:
    """One extractor child. Warm: a resident `--server` process. Cold: a
    per-request PathExtractor (the POOL owns retry accounting)."""

    def __init__(self, config, warm_command: Optional[List[str]],
                 max_path_length: int, max_path_width: int,
                 timeout: Optional[float]):
        self.config = config
        self.warm_command = warm_command
        self.timeout = timeout
        self.proc: Optional[subprocess.Popen] = None
        self.dead = False
        self.timed_out = False
        if warm_command is None:
            # single-attempt calls below (extract_once): the POOL owns
            # retry and failure accounting in both modes (no
            # double-counted extractor_failures_total)
            self.cold = PathExtractor(config,
                                      max_path_length=max_path_length,
                                      max_path_width=max_path_width,
                                      timeout=timeout or 0)
        else:
            self.cold = None
            self._spawn()

    # ------------------------------------------------------------- warm

    def _spawn(self) -> None:
        assert self.warm_command is not None
        self.proc = subprocess.Popen(
            self.warm_command, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        timer = threading.Timer(30.0, self._watchdog_kill)
        timer.start()
        try:
            ready = self._readline()
        finally:
            timer.cancel()
        if ready.strip() != "READY":
            self.kill()
            raise ExtractorCrash(
                f"warm extractor worker failed its READY handshake "
                f"(got {ready!r})")

    def _readline(self) -> str:
        """Blocking readline; a hung child is handled by the ONE
        per-request watchdog timer in `_request` (a kill makes this
        return EOF instead of hanging the serving thread forever)."""
        assert self.proc is not None and self.proc.stdout is not None
        return self.proc.stdout.readline().decode(errors="replace")

    def _watchdog_kill(self) -> None:
        self.timed_out = True
        self.kill()

    def _request(self, header: bytes, payload: bytes = b"",
                 timeout_s: Optional[float] = None) -> List[str]:
        """One framed request/response exchange, guarded by a SINGLE
        watchdog Timer covering the whole exchange, cancelled on the
        fast path. (A timer per readline would create a fresh Timer
        thread per response line — thousands of short-lived threads per
        second under sustained load.) `timeout_s` overrides the pool-wide
        timeout when the caller's remaining deadline budget is tighter."""
        assert self.proc is not None and self.proc.stdin is not None
        self.timed_out = False
        timeout = self.timeout if timeout_s is None else timeout_s
        timer = None
        if timeout is not None:
            timer = threading.Timer(max(timeout, 0.001),
                                    self._watchdog_kill)
            timer.start()
        try:
            try:
                self.proc.stdin.write(header + payload)
                self.proc.stdin.flush()
            except (BrokenPipeError, OSError) as e:
                raise ExtractorCrash(
                    f"warm extractor worker died before the request could "
                    f"be written: {e}") from e
            status = self._readline()
            if self.timed_out:
                bridge.count_timeout()
                raise ExtractionTimeout(
                    f"warm extraction exceeded {timeout:g}s; worker "
                    f"killed")
            if not status:
                rc = self.proc.poll()
                raise ExtractorCrash(
                    f"warm extractor worker died mid-request "
                    f"(exit code {rc})")
            if status.startswith("ERR"):
                raise ValueError(f"extractor rejected the input: "
                                 f"{status[4:].strip() or 'no detail'}")
            if not status.startswith("OK "):
                raise ExtractorCrash(
                    f"warm extractor framing violation: {status!r}")
            n = int(status[3:])
            lines = []
            for _ in range(n):
                line = self._readline()
                if self.timed_out:
                    # mid-response watchdog fire is a TIMEOUT (never
                    # retried), not a crash — retrying a hang would
                    # double the stall (bridge policy).
                    raise ExtractionTimeout(
                        f"warm extraction exceeded {timeout:g}s "
                        f"mid-response; worker killed")
                if not line:
                    self.kill()
                    raise ExtractorCrash(
                        "warm extractor worker died mid-response")
                lines.append(line.rstrip("\n"))
            return lines
        finally:
            if timer is not None:
                timer.cancel()

    # -------------------------------------------------------------- API

    def extract(self, *, path: Optional[str] = None,
                source: Optional[str] = None, max_contexts: int,
                timeout_s: Optional[float] = None
                ) -> Tuple[List[str], Dict[str, str]]:
        if self.cold is not None:
            return self._extract_cold(path=path, source=source,
                                      timeout_s=timeout_s)
        if path is not None:
            raw = self._request(f"FILE {os.path.abspath(path)}\n".encode(),
                                timeout_s=timeout_s)
        else:
            assert source is not None
            payload = source.encode()
            raw = self._request(f"SRC {len(payload)}\n".encode(),
                                payload + b"\n", timeout_s=timeout_s)
        if not raw:
            raise ValueError("extractor produced no methods "
                             "(empty or unparsable input)")
        return postprocess_extractor_output(raw, max_contexts)

    def _extract_cold(self, *, path: Optional[str],
                      source: Optional[str],
                      timeout_s: Optional[float] = None
                      ) -> Tuple[List[str], Dict[str, str]]:
        assert self.cold is not None
        # extract_once = ONE attempt, no failure counting
        if path is not None:
            return self.cold.extract_once(path, timeout=timeout_s)
        fd, tmp = tempfile.mkstemp(suffix=".java", prefix="c2v-serve-")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(source or "")
            return self.cold.extract_once(tmp, timeout=timeout_s)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def kill(self) -> None:
        self.dead = True
        if self.proc is not None:
            try:
                self.proc.kill()
                self.proc.wait(timeout=5)
            except Exception:
                pass

    @property
    def alive(self) -> bool:
        if self.cold is not None:
            return not self.dead
        return (not self.dead and self.proc is not None
                and self.proc.poll() is None)


class ExtractorPool:
    """Fixed-size pool of warm extractor workers behind a free-list.

    `extract_file` / `extract_source` block for a free worker (the wait
    is the serving `queue_wait` SLO phase, recorded into
    `extractor_pool_wait_seconds` and surfaced to the caller via the
    optional `phases` out-dict), run the extraction, and return the
    worker to the free list. A worker that dies mid-request is replaced
    and the request requeued, bounded by `config.extractor_retries`.
    """

    def __init__(self, config, size: int = 2,
                 max_path_length: int = 8, max_path_width: int = 2,
                 log=None):
        self.config = config
        self.size = max(1, int(size))
        self.max_path_length = max_path_length
        self.max_path_width = max_path_width
        self.log = log or (lambda msg: None)
        timeout = float(getattr(config, "extractor_timeout_s", 120.0))
        self.timeout = timeout if timeout > 0 else None
        self.retries = max(int(getattr(config, "extractor_retries", 2)), 0)
        self._lock = threading.Lock()
        self._free = threading.Semaphore(0)
        self._idle: List[_Worker] = []
        self._closed = False
        self.warm_command = self._probe_warm_command()
        self.warm = self.warm_command is not None
        for _ in range(self.size):
            self._idle.append(self._new_worker())
            self._free.release()
        _G_SIZE.set(self.size)
        self.log(f"Extractor pool up: {self.size} "
                 f"{'warm --server' if self.warm else 'cold one-shot'} "
                 f"worker(s)")

    # ---------------------------------------------------------- workers

    def _probe_warm_command(self) -> Optional[List[str]]:
        """One probe spawn decides warm vs cold for the whole pool: a
        binary without --server exits with a flag error instead of
        printing READY, and the pool degrades to cold mode (logged)."""
        native = bridge.native_extractor_path()
        if not os.path.exists(native):
            return None
        command = [native, "--max_path_length", str(self.max_path_length),
                   "--max_path_width", str(self.max_path_width),
                   "--server", "--no_hash"]
        try:
            proc = subprocess.Popen(command, stdin=subprocess.PIPE,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.DEVNULL)
            try:
                line = proc.stdout.readline().decode(errors="replace")
            finally:
                proc.kill()
                proc.wait(timeout=5)
        except OSError:
            return None
        if line.strip() != "READY":
            self.log(f"Extractor binary {native} has no --server mode; "
                     f"pool degrades to cold per-request workers")
            return None
        return command

    def _new_worker(self) -> _Worker:
        return _Worker(self.config, self.warm_command,
                       self.max_path_length, self.max_path_width,
                       self.timeout)

    def _replacement_worker(self) -> _Worker:
        """A dead worker's replacement MUST materialize or the pool's
        free-list semaphore would leak a permit and capacity would decay
        request by request: if the warm respawn itself fails (binary
        deleted, fork pressure), fall back to a cold slot (PathExtractor
        construction cannot fail) and keep serving."""
        try:
            return self._new_worker()
        except Exception as e:
            self.log(f"Warm extractor respawn failed ({e}); slot "
                     f"degrades to a cold one-shot worker")
            return _Worker(self.config, None, self.max_path_length,
                           self.max_path_width, self.timeout)

    def _acquire(self, phases: Optional[dict], deadline=None) -> _Worker:
        t0 = time.perf_counter()
        budget = 300.0
        deadline_bound = False
        if deadline is not None and deadline.bounded:
            remaining = deadline.remaining()
            if remaining < budget:
                budget, deadline_bound = max(remaining, 0.001), True
        if not self._free.acquire(timeout=budget):
            if deadline_bound:
                expired_counter("extract").inc()
                raise DeadlineExceeded(
                    "request deadline expired waiting for a free "
                    "extractor worker")
            raise TimeoutError("no extractor worker became free in 300s")
        wait = time.perf_counter() - t0
        _H_WAIT.observe(wait)
        if phases is not None:
            phases["queue_wait"] = phases.get("queue_wait", 0.0) + wait
        with self._lock:
            if self._closed:
                self._free.release()
                raise RuntimeError("extractor pool is closed")
            worker = self._idle.pop()
        if not worker.alive:
            # died while idle (OOM killer sweeps idle children too)
            worker.kill()
            worker = self._replacement_worker()
        return worker

    def _release(self, worker: _Worker) -> None:
        if not worker.alive:
            worker.kill()
            worker = self._replacement_worker()
        with self._lock:
            if self._closed:
                worker.kill()
                return
            self._idle.append(worker)
        self._free.release()

    # -------------------------------------------------------------- API

    def extract_file(self, path: str, phases: Optional[dict] = None,
                     deadline=None, trace=None
                     ) -> Tuple[List[str], Dict[str, str]]:
        return self._extract(phases, path=path, deadline=deadline,
                             trace=trace)

    def extract_source(self, source: str, phases: Optional[dict] = None,
                       deadline=None, trace=None
                       ) -> Tuple[List[str], Dict[str, str]]:
        return self._extract(phases, source=source, deadline=deadline,
                             trace=trace)

    def _effective_timeout(self, deadline) -> Tuple[Optional[float], bool]:
        """min(pool timeout, remaining deadline budget) and whether the
        DEADLINE is the binding constraint (a fire then surfaces as
        DeadlineExceeded/504, not ExtractionTimeout/422)."""
        if deadline is None or not deadline.bounded:
            return None, False  # None -> worker uses the pool timeout
        remaining = deadline.remaining()
        if self.timeout is None or remaining < self.timeout:
            return max(remaining, 0.001), True
        return None, False

    def _extract(self, phases: Optional[dict], *,
                 path: Optional[str] = None, source: Optional[str] = None,
                 deadline=None, trace=None
                 ) -> Tuple[List[str], Dict[str, str]]:
        _C_REQS.inc()
        max_contexts = self.config.max_contexts
        for attempt in range(self.retries + 1):
            if deadline is not None and deadline.expired():
                expired_counter("extract").inc()
                raise DeadlineExceeded(
                    "request deadline expired before extraction")
            t_wait0 = time.perf_counter()
            worker = self._acquire(phases, deadline=deadline)
            if trace is not None:
                trace.add_span("extract_wait", t_wait0,
                               time.perf_counter() - t_wait0)
            timeout_s, deadline_bound = self._effective_timeout(deadline)
            t0 = time.perf_counter()
            try:
                result = worker.extract(path=path, source=source,
                                        max_contexts=max_contexts,
                                        timeout_s=timeout_s)
            except ExtractionTimeout:
                # bridge policy: a hung worker is killed, never retried.
                # When the binding constraint was the request's own
                # deadline budget (not the pool-wide hang timeout), the
                # honest status is 504, not an extraction failure.
                worker.kill()
                if deadline_bound:
                    expired_counter("extract").inc()
                    raise DeadlineExceeded(
                        "request deadline expired during extraction "
                        "(worker killed)")
                raise
            except FileNotFoundError:
                raise  # no extractor installed at all — not transient
            except (ExtractorCrash, OSError) as e:
                final = attempt == self.retries
                worker.kill()
                bridge.count_failure(retried=not final)
                if final:
                    raise
                _C_REQUEUES.inc()
                self.log(f"Extractor worker died mid-request "
                         f"({e}); requeued on a fresh worker "
                         f"(attempt {attempt + 2}/{self.retries + 1})")
                continue
            except ValueError:
                # deterministic rejection (parse error / empty output):
                # identical on every retry, surfaced immediately. Both
                # modes count HERE and only here (cold workers run the
                # bridge's raw single-attempt path, which never counts).
                bridge.count_failure(retried=False)
                raise
            finally:
                dur = time.perf_counter() - t0
                _H_EXTRACT.observe(dur)
                if phases is not None:
                    phases["extract"] = phases.get("extract", 0.0) + dur
                if trace is not None:
                    trace.add_span(
                        "extract", t0, dur,
                        attrs={"attempt": attempt + 1,
                               "mode": "cold" if worker.cold is not None
                               else "warm",
                               "worker_pid": (worker.proc.pid
                                              if worker.proc is not None
                                              else None)})
                self._release(worker)
            return result
        raise AssertionError("unreachable")  # pragma: no cover

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            idle, self._idle = self._idle, []
        for w in idle:
            w.kill()
        _G_SIZE.set(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
