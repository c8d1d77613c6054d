"""Admission control and end-to-end request deadlines.

The counterpart of code2vec_tpu/serving/admission.py without its tenancy
layer (the per-tenant shares and rate quotas come with tenancy.py):

- **Deadline**: every request carries one, from `--serve_deadline_ms`
  (the client may override it with the `X-Deadline-Ms` header, clamped
  by `--serve_deadline_max_ms`). It travels the whole pipeline: the
  extractor pool takes the remaining budget as its timeout, the batcher
  refuses a request whose budget cannot cover its bucket's observed p95
  device time, and a request that expires mid-pipeline settles as 504
  without taking a device slot.
- **AdmissionController**: a bounded gate in front of the cache-miss
  pipeline. A request is SHED (503 + `Retry-After`) when the pipeline
  already holds `--serve_queue_depth` requests, or when the estimated
  queue wait (depth x EWMA request duration / pipeline concurrency)
  exceeds the request's remaining budget.

Sheds count in `serving_requests_shed_total{reason=...}` (queue_full,
deadline, draining); 504s in `serving_requests_expired_total{stage=...}`.
`Shed` (503: never worked on) stays distinct from `DeadlineExceeded`
(504: admitted, then out of budget). Fault point `admission_enqueue`
(utils/faults.py) fires on the admit path.
"""

from __future__ import annotations

import math
import random
import threading
import time
from typing import Optional

from code2vec_tpu_torch import obs
from code2vec_tpu_torch.utils.faults import fault_point

_G_DEPTH = obs.gauge(
    "serving_admission_depth",
    "requests admitted into the cache-miss pipeline and not yet "
    "finished (the admission queue bound applies to this)")

SHED_HELP = (
    "requests refused with an honest 503 before any pipeline work: "
    "queue_full (admission depth at the bound), deadline (estimated "
    "wait or device time exceeds the request's remaining budget), "
    "draining (the server is shutting down)")


def _shed_counter(reason: str):
    return obs.counter("serving_requests_shed_total", SHED_HELP,
                       reason=reason)


def expired_counter(stage: str):
    return obs.counter(
        "serving_requests_expired_total",
        "admitted requests whose deadline ran out mid-pipeline (504); "
        "stage says how far they got before expiring",
        stage=stage)


def retry_after_seconds(base_s: float, jitter_frac: float = 0.5) -> int:
    """Retry-After value for a shed: the base estimate plus up to
    `jitter_frac` of it in random jitter, rounded up to whole seconds
    (>= 1), so shed clients do not all retry at the same instant."""
    base = max(1.0, float(base_s))
    return max(1, int(math.ceil(
        base * (1.0 + random.random() * max(0.0, jitter_frac)))))


class Shed(Exception):
    """Request refused before any pipeline work: an honest 503. The
    server counts `reason` in serving_requests_shed_total and sends
    `retry_after_s` as the Retry-After header."""

    def __init__(self, reason: str, message: str,
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = max(1.0, float(retry_after_s))

    def count(self) -> None:
        _shed_counter(self.reason).inc()


class DeadlineExceeded(Exception):
    """An admitted request's budget ran out mid-pipeline: a 504."""


class DeadlineInfeasible(Shed):
    """The batcher's fail-fast refusal: the request has budget left, but
    its bucket's observed p95 device time alone exceeds it. A Shed: the
    request was not worked on."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__("deadline", message, retry_after_s)


class Deadline:
    """Monotonic per-request budget. `budget_s` <= 0 means unbounded:
    `remaining()` is +inf and `expired()` never fires."""

    __slots__ = ("t0", "budget_s")

    def __init__(self, budget_s: float):
        self.t0 = time.monotonic()
        self.budget_s = float(budget_s)

    @property
    def bounded(self) -> bool:
        return self.budget_s > 0

    def remaining(self) -> float:
        if not self.bounded:
            return math.inf
        return self.budget_s - (time.monotonic() - self.t0)

    def expired(self) -> bool:
        return self.bounded and self.remaining() <= 0


def deadline_from_request(config, header_ms: Optional[str]) -> Deadline:
    """One request's deadline: the `X-Deadline-Ms` header when present,
    else `--serve_deadline_ms`, both clamped by `--serve_deadline_max_ms`
    (with no default and no header, the maximum is the budget). An
    unparsable header counts as absent, not as a 400."""
    budget_ms = float(getattr(config, "serve_deadline_ms", 0.0))
    if header_ms is not None:
        try:
            requested = float(header_ms)
        except (TypeError, ValueError):
            requested = None
        if requested is not None and requested > 0:
            budget_ms = requested
    max_ms = float(getattr(config, "serve_deadline_max_ms", 0.0))
    if max_ms > 0 and budget_ms > 0:
        budget_ms = min(budget_ms, max_ms)
    elif max_ms > 0 and budget_ms <= 0:
        budget_ms = max_ms
    return Deadline(budget_ms / 1000.0)


class AdmissionController:
    """Bounded admission gate for the cache-miss pipeline.

    `admit(deadline)` returns (the caller MUST pair it with
    `finish(duration_s)` in a finally) or raises `Shed`. The queue-wait
    estimate is depth x EWMA(request duration) / `concurrency` (the
    extractor pool size); until the first completion seeds the EWMA only
    the depth bound sheds, so a cold server never refuses its first
    requests on a made-up estimate. `finish(-1)` releases the slot
    without feeding the EWMA (a request refused after admission)."""

    def __init__(self, max_depth: int, concurrency: int = 1,
                 ewma_alpha: float = 0.2):
        self.max_depth = max(1, int(max_depth))
        self.concurrency = max(1, int(concurrency))
        self._alpha = float(ewma_alpha)
        self._lock = threading.Lock()
        self._depth = 0
        self._ewma_s: Optional[float] = None

    @property
    def depth(self) -> int:
        return self._depth

    def estimated_wait_s(self) -> Optional[float]:
        """Expected queue wait for a request admitted now; None until
        the EWMA has a sample."""
        with self._lock:
            if self._ewma_s is None:
                return None
            return self._depth * self._ewma_s / self.concurrency

    def admit(self, deadline: Optional[Deadline] = None) -> None:
        fault_point("admission_enqueue")
        with self._lock:
            if self._depth >= self.max_depth:
                wait = (self._ewma_s or 1.0) * self.max_depth \
                    / self.concurrency
                raise Shed(
                    "queue_full",
                    f"admission queue full ({self._depth}/"
                    f"{self.max_depth} in flight)",
                    retry_after_s=wait)
            if (deadline is not None and deadline.bounded
                    and self._ewma_s is not None):
                est = self._depth * self._ewma_s / self.concurrency
                if est > deadline.remaining():
                    raise Shed(
                        "deadline",
                        f"estimated queue wait {est * 1e3:.0f}ms exceeds "
                        f"the request's remaining deadline budget "
                        f"{max(deadline.remaining(), 0) * 1e3:.0f}ms",
                        retry_after_s=est)
            self._depth += 1
            _G_DEPTH.set(self._depth)

    def finish(self, duration_s: float) -> None:
        with self._lock:
            self._depth = max(0, self._depth - 1)
            _G_DEPTH.set(self._depth)
            if duration_s >= 0:
                if self._ewma_s is None:
                    self._ewma_s = float(duration_s)
                else:
                    self._ewma_s += self._alpha * (duration_s
                                                   - self._ewma_s)
