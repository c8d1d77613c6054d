"""String and file helpers of the serving and evaluation paths
(counterparts of code2vec_tpu/common.py:22-47, :79 and :86)."""

from __future__ import annotations

import re
from itertools import repeat, takewhile
from typing import List

_NON_ALPHA_RE = re.compile(r"[^a-zA-Z]")
_LEGAL_NAME_RE = re.compile(r"^[a-zA-Z|]+$")


def normalize_word(word: str) -> str:
    """Strip non-alphabetic characters and lowercase; plain lowercase
    where nothing alphabetic is left."""
    stripped = _NON_ALPHA_RE.sub("", word)
    return word.lower() if not stripped else stripped.lower()


def is_legal_method_name(name: str, oov_word: str) -> bool:
    """A prediction is legal iff it is not OOV and matches ^[a-zA-Z|]+$."""
    return name != oov_word and bool(_LEGAL_NAME_RE.match(name))


def count_lines_in_file(file_path: str) -> int:
    """Newlines in a file, counted in 1 MiB reads."""
    with open(file_path, "rb") as f:
        bufgen = takewhile(lambda x: x, (f.raw.read(1024 * 1024)
                                         for _ in repeat(None)))
        return sum(buf.count(b"\n") for buf in bufgen)


def get_subtokens(name: str) -> List[str]:
    """Subtokens of a method name are '|'-separated."""
    return name.split("|")


def java_string_hashcode(s: str) -> int:
    """Java's `String#hashCode`: the extractor's hashed path strings map
    back to readable ones for the attention display."""
    h = 0
    for ch in s:
        h = (31 * h + ord(ch)) & 0xFFFFFFFF
    if h > 0x7FFFFFFF:
        h -= 0x100000000
    return h
