"""String helpers of the serving path (counterparts of
code2vec_tpu/common.py:44 and :86)."""

from __future__ import annotations

from typing import List


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
