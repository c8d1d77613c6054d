"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The port's copy of code2vec_tpu/obs/metrics.py: the same metric kinds,
default buckets and Prometheus text, byte for byte.

Dependency-free (stdlib only) so every layer — training loop, evaluator,
data reader/prefetcher threads, checkpoint code, serving bridge, fault
hooks — can record into one registry without import-order or extra-package
concerns. Thread-safe: the reader workers and the prefetch thread update
concurrently with the consumer.

Design notes:
- Registration is idempotent: asking for an existing (name, labels) pair
  returns the SAME instance, so call sites can `obs.counter(...)` at use
  time without caching handles (checkpoint saves, extractor calls). Hot
  per-batch paths should still cache the handle — the lookup takes the
  registry lock.
- Histograms use fixed cumulative buckets (Prometheus semantics): an
  observation lands in every bucket whose upper bound is >= the value,
  plus the implicit +Inf bucket; `sum` and `count` ride along. Fixed
  buckets keep `observe()` to one bisect + a few increments — cheap
  enough for per-batch step-phase timings.
- Export surface: `render_prometheus()` (node-exporter textfile / HTTP
  scrape format). The reference's `tb_scalars()` has no reader in the
  port (it has no TensorBoard writer) and is not ported.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

# Durations in seconds, ~100us .. 5min: covers a per-batch host phase at
# the fast end and a multi-GB checkpoint save / full eval at the slow end.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _format_labels(key: LabelsKey) -> str:
    if not key:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, v.replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for k, v in key)
    return "{" + inner + "}"


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonically increasing value (Prometheus `counter`)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Set-to-current-value metric (Prometheus `gauge`)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_to_current_time(self) -> None:
        self.set(time.time())

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus `histogram`)."""

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS):
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets: Tuple[float, ...] = tuple(bounds)
        self._lock = threading.Lock()
        # one slot per finite bound + the +Inf overflow slot
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def cumulative_counts(self) -> List[int]:
        """Per-bound cumulative counts (Prometheus `le` semantics),
        NOT including the +Inf bucket (that equals `count`)."""
        with self._lock:
            out, acc = [], 0
            for c in self._counts[:-1]:
                acc += c
                out.append(acc)
            return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """All children of one metric name (same kind/help, varying labels)."""

    __slots__ = ("name", "kind", "help", "buckets", "children")

    def __init__(self, name: str, kind: str, help: str,
                 buckets: Optional[Tuple[float, ...]]):
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = buckets
        self.children: Dict[LabelsKey, object] = {}


class MetricsRegistry:
    """Thread-safe named-metric registry with idempotent registration."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # ------------------------------------------------------------ create

    def _get(self, kind: str, name: str, help: str,
             labels: Dict[str, str],
             buckets: Optional[Iterable[float]] = None):
        key = _labels_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help,
                              tuple(buckets) if buckets else None)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"cannot re-register as {kind}")
            child = fam.children.get(key)
            if child is None:
                if kind == "histogram":
                    child = Histogram(fam.buckets or DEFAULT_BUCKETS)
                else:
                    child = _KINDS[kind]()
                fam.children[key] = child
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        return self._get("histogram", name, help, labels, buckets=buckets)

    # ------------------------------------------------------------ export

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4) — what a node-exporter
        textfile collector or a /metrics scrape expects."""
        with self._lock:
            families = [(f.name, f.kind, f.help, dict(f.children))
                        for f in self._families.values()]
        lines: List[str] = []
        for name, kind, help_text, children in sorted(families):
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for key in sorted(children):
                child = children[key]
                if kind == "histogram":
                    cumulative = child.cumulative_counts()
                    for bound, c in zip(child.buckets, cumulative):
                        le = key + (("le", _format_value(bound)),)
                        lines.append(f"{name}_bucket{_format_labels(le)} {c}")
                    inf = key + (("le", "+Inf"),)
                    lines.append(
                        f"{name}_bucket{_format_labels(inf)} {child.count}")
                    lines.append(f"{name}_sum{_format_labels(key)} "
                                 f"{_format_value(child.sum)}")
                    lines.append(f"{name}_count{_format_labels(key)} "
                                 f"{child.count}")
                else:
                    lines.append(f"{name}{_format_labels(key)} "
                                 f"{_format_value(child.value)}")
        return "\n".join(lines) + "\n"

    def collect(self) -> Dict[str, Dict[LabelsKey, object]]:
        """Raw {name: {labels_key: metric}} view (tests, debugging)."""
        with self._lock:
            return {name: dict(f.children)
                    for name, f in self._families.items()}


# The process-wide registry every instrumented subsystem records into.
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
