"""Run the native path extractor (`cpp/build/c2v-extract`) as a one-shot
subprocess and turn its output into model-ready predict lines.

The counterpart of code2vec_tpu/serving/extractor_bridge.py without the
Java jar fallback: run with `--no_hash` so paths come out readable, keep
at most `max_contexts` contexts per method, re-hash each path with
Java's String#hashCode (the vocabularies hold hashed paths), and keep
hash -> path for the attention display. A child that CRASHES (killed by
a signal, or a fatal exit code >= 126) raises `ExtractorCrash`, a plain
nonzero exit (the parser rejected the input) a ValueError, a hung child
`ExtractionTimeout`. The serving path runs the warm pool
(extractor_pool.py), which shares this module's postprocessing and
failure vocabulary and requeues a crashed request up to
`extractor_retries` times; this one-shot route makes one attempt (the
reference's second retry loop here, with its backoff, is not ported).
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from code2vec_tpu_torch import obs
from code2vec_tpu_torch.common import java_string_hashcode

NATIVE_EXTRACTOR_ENV = "C2V_NATIVE_EXTRACTOR"

_H_EXTRACT = obs.histogram(
    "extractor_seconds",
    "serving-side path extraction: subprocess spawn to parsed contexts")
_C_CALLS = obs.counter("extractor_calls_total",
                       "serving-side extractions attempted")
_C_TIMEOUTS = obs.counter(
    "extractor_timeouts_total",
    "extractor children killed after config.extractor_timeout_s")

_FAILURES_HELP = ("extractions that failed (nonzero exit / empty output / "
                  "launch failure), timeouts excluded; retried=yes means "
                  "another attempt followed, retried=no means the failure "
                  "was surfaced to the caller")


def count_failure(retried: bool) -> None:
    obs.counter("extractor_failures_total", _FAILURES_HELP,
                retried="yes" if retried else "no").inc()


def count_timeout() -> None:
    _C_TIMEOUTS.inc()


class ExtractionTimeout(ValueError):
    """A hung extractor child was killed after the configured timeout."""


class ExtractorCrash(ValueError):
    """The extractor child DIED rather than rejecting its input: killed
    by a signal (negative returncode) or a fatal exit code >= 126 (137 =
    SIGKILL/OOM, 134 = SIGABRT). Only crashes are plausibly transient,
    so only they are retried."""


def native_extractor_path() -> str:
    env = os.environ.get(NATIVE_EXTRACTOR_ENV)
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "cpp", "build", "c2v-extract")


def postprocess_extractor_output(output: List[str], max_contexts: int
                                 ) -> Tuple[List[str], Dict[str, str]]:
    """Raw `--no_hash` lines -> (predict lines padded to max_contexts,
    hashed path -> readable path)."""
    hash_to_string: Dict[str, str] = {}
    result = []
    for line in output:
        parts = line.rstrip().split(" ")
        line_parts = [parts[0]]
        contexts = parts[1:]
        for context in contexts[:max_contexts]:
            w1, p, w2 = context.split(",")
            hashed = str(java_string_hashcode(p))
            hash_to_string[hashed] = p
            line_parts.append(f"{w1},{hashed},{w2}")
        padding = " " * (max_contexts - len(contexts))
        result.append(" ".join(line_parts) + padding)
    return result, hash_to_string


class PathExtractor:
    def __init__(self, config, max_path_length: int = 8,
                 max_path_width: int = 2, timeout: Optional[float] = None):
        self.config = config
        self.max_path_length = max_path_length
        self.max_path_width = max_path_width
        if timeout is None:
            timeout = float(getattr(config, "extractor_timeout_s", 120.0))
        self.timeout = timeout if timeout > 0 else None

    def _command(self, path: str) -> List[str]:
        native = native_extractor_path()
        if not os.path.exists(native):
            raise FileNotFoundError(
                f"No extractor available: native binary `{native}` not "
                f"built (make -C cpp)")
        return [native, "--max_path_length", str(self.max_path_length),
                "--max_path_width", str(self.max_path_width),
                "--file", path, "--no_hash"]

    def extract_paths(self, path: str) -> Tuple[List[str], Dict[str, str]]:
        """One counted attempt: a failure other than a timeout or a
        missing binary counts as extractor_failures_total{retried=no}."""
        _C_CALLS.inc()
        t0 = time.perf_counter()
        try:
            return self.extract_once(path)
        except (ExtractionTimeout, FileNotFoundError):
            raise
        except (ValueError, OSError):
            count_failure(retried=False)
            raise
        finally:
            dur = time.perf_counter() - t0
            _H_EXTRACT.observe(dur)
            obs.default_tracer().maybe_record("extract_paths", t0, dur)

    def extract_once(self, path: str, timeout: Optional[float] = None
                     ) -> Tuple[List[str], Dict[str, str]]:
        """One attempt with no failure counting (the pool counts and
        requeues itself); `timeout` overrides the configured one."""
        effective = self.timeout if timeout is None else timeout
        process = subprocess.Popen(self._command(path),
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE)
        try:
            out, err = process.communicate(timeout=effective)
        except subprocess.TimeoutExpired:
            process.kill()
            out, err = process.communicate()
            count_timeout()
            raise ExtractionTimeout(
                f"path extraction of {path} exceeded {effective:g}s "
                f"and was killed; partial stderr: "
                f"{err.decode(errors='replace').strip()!r}")
        output = out.decode().splitlines()
        if process.returncode != 0:
            crashed = process.returncode < 0 or process.returncode >= 126
            raise (ExtractorCrash if crashed else ValueError)(
                f"extractor {'crashed' if crashed else 'exited'} with code "
                f"{process.returncode} on {path} ({len(output)} stdout "
                f"lines discarded); stderr: "
                f"{err.decode(errors='replace').strip()!r}")
        if not output:
            raise ValueError(err.decode(errors="replace"))
        return postprocess_extractor_output(output, self.config.max_contexts)

    def extract_source(self, source: str) -> Tuple[List[str], Dict[str, str]]:
        """Extract from Java source text through a temporary file."""
        fd, tmp = tempfile.mkstemp(suffix=".java", prefix="c2v-serve-")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(source)
            return self.extract_paths(tmp)
        finally:
            os.unlink(tmp)
