"""LRU prediction cache keyed by a hash of the normalized source.

The port's copy of code2vec_tpu/serving/cache.py. Serving traffic
repeats itself (an editor plugin re-sends the method on every pause; CI
re-submits unchanged files), so a small LRU in front of extract+predict
turns the common case into a dict hit. Keys are a blake2b digest of the
WHITESPACE-NORMALIZED source plus every knob that changes the answer
(endpoint, topk, the model fingerprint, and /neighbors' k, nprobe and
index fingerprint), so a re-exported model never satisfies a stale
entry: reformatting a method hits, editing it misses. The server stores
the serialized response bytes, so a hit is byte-equal to its miss.

Thread-safe; hits, misses and evictions are counters.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional

from code2vec_tpu_torch import obs

_C_HITS = obs.counter("serving_cache_hits_total",
                      "prediction-cache lookups served from memory")
_C_MISSES = obs.counter("serving_cache_misses_total",
                        "prediction-cache lookups that went to the model")
_C_EVICTIONS = obs.counter(
    "serving_cache_evictions_total",
    "LRU entries dropped to stay under serve_cache_entries")
_G_ENTRIES = obs.gauge("serving_cache_entries",
                       "live prediction-cache entries")


def normalize_source(code: str) -> bytes:
    """Whitespace-insensitive canonical form: any run of whitespace
    (indentation, newlines, trailing blanks) collapses to one space.
    Java is whitespace-insensitive outside string literals; collapsing
    INSIDE a literal could alias two genuinely different methods, but
    only onto a prediction for code differing solely in literal spacing
    — an acceptable trade for reformat-hits."""
    return " ".join(code.split()).encode()


def cache_key(code: str, **knobs) -> str:
    return cache_key_normalized(normalize_source(code), **knobs)


def cache_key_normalized(normalized: bytes, **knobs) -> str:
    """Key from an ALREADY-normalized source (one `normalize_source`
    pass per request)."""
    h = hashlib.blake2b(normalized, digest_size=16)
    for name in sorted(knobs):
        h.update(f"\x00{name}={knobs[name]}".encode())
    return h.hexdigest()


class PredictionCache:
    """Bounded LRU. capacity <= 0 disables (every get misses, puts are
    dropped) so one code path serves cache-on and cache-off runs."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._data: "OrderedDict[str, object]" = OrderedDict()

    def get(self, key: str) -> Optional[object]:
        if self.capacity <= 0:
            _C_MISSES.inc()
            return None
        with self._lock:
            value = self._data.get(key)
            if value is None:
                _C_MISSES.inc()
                return None
            self._data.move_to_end(key)
        _C_HITS.inc()
        return value

    def put(self, key: str, value: object) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                _C_EVICTIONS.inc()
            _G_ENTRIES.set(len(self._data))

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            _G_ENTRIES.set(0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)
