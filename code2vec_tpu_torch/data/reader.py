"""Host-side parsing of extractor lines into model inputs, Predict action.

The counterpart of code2vec_tpu/data/reader.py (RowBatch, and the
keep-strings path of parse_context_lines :115, empty_predict_batch :290,
slice_contexts :319, truncate_rows :344, _pad_rows :359). It must give
the same int arrays as the reference for the same lines:

- a missing or empty part is PAD, an unknown word is OOV (in the joined
  scheme both are index 0);
- a context is valid iff any of its three parts is not PAD;
- predict rows are never filtered.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from code2vec_tpu_torch.vocab import Code2VecVocabs


@dataclasses.dataclass
class RowBatch:
    """One batch of model inputs on the host."""
    source_token_indices: np.ndarray   # (B, M) int32
    path_indices: np.ndarray           # (B, M) int32
    target_token_indices: np.ndarray   # (B, M) int32
    context_valid_mask: np.ndarray     # (B, M) float32
    target_index: np.ndarray           # (B,) int32
    example_valid: np.ndarray          # (B,) bool
    target_strings: Optional[List[str]] = None
    # raw string triples for the attention display
    source_strings: Optional[np.ndarray] = None     # (B, M) object
    path_strings: Optional[np.ndarray] = None       # (B, M) object
    target_token_strings: Optional[np.ndarray] = None  # (B, M) object

    def model_arrays(self):
        return (self.source_token_indices, self.path_indices,
                self.target_token_indices, self.context_valid_mask,
                self.target_index, self.example_valid)


def parse_context_lines(lines: Sequence[str], vocabs: Code2VecVocabs,
                        max_contexts: int,
                        out: Optional[RowBatch] = None,
                        row_offset: int = 0) -> RowBatch:
    """Parse `name ctx ctx ...` lines (ctx = `token,path,token`) into a
    keep-strings RowBatch, or into rows [row_offset, row_offset + n) of
    `out` (a buffer from `empty_predict_batch`)."""
    n, m = len(lines), max_contexts
    token_w2i = vocabs.token_vocab.word_to_index
    path_w2i = vocabs.path_vocab.word_to_index
    token_oov = vocabs.token_vocab.oov_index
    path_oov = vocabs.path_vocab.oov_index
    token_pad = vocabs.token_vocab.pad_index
    path_pad = vocabs.path_vocab.pad_index
    if out is None:
        src = np.full((n, m), token_pad, dtype=np.int32)
        pth = np.full((n, m), path_pad, dtype=np.int32)
        tgt = np.full((n, m), token_pad, dtype=np.int32)
        target_index = np.empty((n,), dtype=np.int32)
        src_s = np.full((n, m), "", dtype=object)
        pth_s = np.full((n, m), "", dtype=object)
        tgt_s = np.full((n, m), "", dtype=object)
    else:
        if out.source_token_indices.shape[1] != m:
            raise ValueError(f"out buffer context width "
                             f"{out.source_token_indices.shape[1]} != {m}")
        sl = slice(row_offset, row_offset + n)
        src, pth, tgt = (out.source_token_indices[sl], out.path_indices[sl],
                         out.target_token_indices[sl])
        target_index = out.target_index[sl]
        src_s, pth_s, tgt_s = (out.source_strings[sl], out.path_strings[sl],
                               out.target_token_strings[sl])
        src[:], pth[:], tgt[:] = token_pad, path_pad, token_pad
        src_s[:], pth_s[:], tgt_s[:] = "", "", ""
    target_strings: List[str] = []
    target_lookup = vocabs.target_vocab.lookup_index
    for i, line in enumerate(lines):
        parts = line.rstrip("\n").split(" ")
        target_str = parts[0] if parts else ""
        target_strings.append(target_str)
        target_index[i] = target_lookup(target_str)
        for j, ctx in enumerate(parts[1:m + 1]):
            if not ctx:
                continue
            pieces = ctx.split(",")
            a = pieces[0] if len(pieces) > 0 else ""
            b = pieces[1] if len(pieces) > 1 else ""
            c = pieces[2] if len(pieces) > 2 else ""
            src[i, j] = token_w2i.get(a, token_pad if a == "" else token_oov)
            pth[i, j] = path_w2i.get(b, path_pad if b == "" else path_oov)
            tgt[i, j] = token_w2i.get(c, token_pad if c == "" else token_oov)
            src_s[i, j], pth_s[i, j], tgt_s[i, j] = a, b, c
    mask = ((src != token_pad) | (tgt != token_pad) | (pth != path_pad))
    context_valid_mask = mask.astype(np.float32)
    if out is not None:
        sl = slice(row_offset, row_offset + n)
        out.context_valid_mask[sl] = context_valid_mask
        out.example_valid[sl] = True
        out.target_strings[sl] = target_strings
        return out
    return RowBatch(
        source_token_indices=src, path_indices=pth,
        target_token_indices=tgt, context_valid_mask=context_valid_mask,
        target_index=target_index, example_valid=np.ones((n,), dtype=bool),
        target_strings=target_strings, source_strings=src_s,
        path_strings=pth_s, target_token_strings=tgt_s)


def empty_predict_batch(batch_size: int, max_contexts: int,
                        vocabs: Code2VecVocabs) -> RowBatch:
    """A PAD-filled keep-strings RowBatch whose rows are all invalid."""
    m = max_contexts
    token_pad = vocabs.token_vocab.pad_index
    path_pad = vocabs.path_vocab.pad_index
    return RowBatch(
        source_token_indices=np.full((batch_size, m), token_pad, np.int32),
        path_indices=np.full((batch_size, m), path_pad, np.int32),
        target_token_indices=np.full((batch_size, m), token_pad, np.int32),
        context_valid_mask=np.zeros((batch_size, m), np.float32),
        target_index=np.zeros((batch_size,), np.int32),
        example_valid=np.zeros((batch_size,), bool),
        target_strings=[""] * batch_size,
        source_strings=np.full((batch_size, m), "", dtype=object),
        path_strings=np.full((batch_size, m), "", dtype=object),
        target_token_strings=np.full((batch_size, m), "", dtype=object))


def slice_contexts(batch: RowBatch, m: int) -> RowBatch:
    """Keep the first `m` context columns (the bucket holds every valid
    context, so only padding is cut)."""
    if batch.source_token_indices.shape[1] <= m:
        return batch

    def cut(x):
        return None if x is None else x[:, :m]

    return dataclasses.replace(
        batch, source_token_indices=cut(batch.source_token_indices),
        path_indices=cut(batch.path_indices),
        target_token_indices=cut(batch.target_token_indices),
        context_valid_mask=cut(batch.context_valid_mask),
        source_strings=cut(batch.source_strings),
        path_strings=cut(batch.path_strings),
        target_token_strings=cut(batch.target_token_strings))


def truncate_rows(batch: RowBatch, rows: int) -> RowBatch:
    """Drop trailing rows (callers guarantee they are padding)."""
    if batch.target_index.shape[0] <= rows:
        return batch
    return RowBatch(**{f.name: (None if getattr(batch, f.name) is None
                                else getattr(batch, f.name)[:rows])
                       for f in dataclasses.fields(RowBatch)})


def _pad_rows(batch: RowBatch, batch_size: int) -> RowBatch:
    """Pad with invalid rows (index 0, zero mask) up to `batch_size`."""
    n = batch.target_index.shape[0]
    if n == batch_size:
        return batch
    pad = batch_size - n

    def pad_arr(x, fill=0):
        if x is None:
            return None
        if isinstance(x, list):
            return x + [""] * pad
        return np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, dtype=x.dtype)], axis=0)

    return RowBatch(
        source_token_indices=pad_arr(batch.source_token_indices),
        path_indices=pad_arr(batch.path_indices),
        target_token_indices=pad_arr(batch.target_token_indices),
        context_valid_mask=pad_arr(batch.context_valid_mask),
        target_index=pad_arr(batch.target_index),
        example_valid=pad_arr(batch.example_valid, fill=False),
        target_strings=pad_arr(batch.target_strings),
        source_strings=pad_arr(batch.source_strings, fill=""),
        path_strings=pad_arr(batch.path_strings, fill=""),
        target_token_strings=pad_arr(batch.target_token_strings, fill=""))
