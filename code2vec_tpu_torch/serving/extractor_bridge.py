"""Run the native path extractor (`cpp/build/c2v-extract`) as a
subprocess, one cold process per extraction, and turn its output into
model-ready predict lines.

The counterpart of code2vec_tpu/serving/extractor_bridge.py in cold mode
(no warm worker pool, no jar fallback, no retries): run with `--no_hash`
so paths come out readable, keep at most `max_contexts` contexts per
method, re-hash each path with Java's String#hashCode (the vocabularies
hold hashed paths), and keep hash -> path for the attention display.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Dict, List, Optional, Tuple

from code2vec_tpu_torch.common import java_string_hashcode

NATIVE_EXTRACTOR_ENV = "C2V_NATIVE_EXTRACTOR"


class ExtractionTimeout(ValueError):
    """A hung extractor child was killed after the configured timeout."""


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
        process = subprocess.Popen(self._command(path),
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE)
        try:
            out, err = process.communicate(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            process.kill()
            out, err = process.communicate()
            raise ExtractionTimeout(
                f"path extraction of {path} exceeded {self.timeout:g}s "
                f"and was killed; partial stderr: "
                f"{err.decode(errors='replace').strip()!r}")
        output = out.decode().splitlines()
        if process.returncode != 0:
            raise ValueError(
                f"extractor exited with code {process.returncode} on "
                f"{path} ({len(output)} stdout lines discarded); stderr: "
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
