"""String and file helpers of the serving, evaluation and export paths
(counterparts of code2vec_tpu/common.py:22-47, :64, :79 and :86)."""

from __future__ import annotations

import re
from itertools import repeat, takewhile
from typing import Dict, List

import numpy as np

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


def save_word2vec_file(output_file, index_to_word: Dict[int, str],
                       embedding_matrix: np.ndarray) -> None:
    """Plain-text word2vec format: a 'vocab dim' header, then 'word v0 v1
    ...' a row (reference: common.py:82-91)."""
    if embedding_matrix.ndim != 2:
        raise ValueError("the embedding matrix must be 2-D")
    vocab_size, dim = embedding_matrix.shape
    output_file.write("%d %d\n" % (vocab_size, dim))
    for word_idx in range(vocab_size):
        output_file.write(index_to_word[word_idx] + " ")
        output_file.write(" ".join(map(str, embedding_matrix[word_idx]))
                          + "\n")


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
