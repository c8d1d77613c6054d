"""Host-side parsing of `.c2v` lines into model inputs: the Predict,
Train and Evaluate actions.

The counterpart of code2vec_tpu/data/reader.py (RowBatch, EpochEnd :54,
EstimatorAction :68, parse_context_lines :115, row_filter_mask :251,
_select_rows :261, empty_predict_batch :290,
slice_contexts :319, truncate_rows :344, _pad_rows :359, _iter_file_lines
:390, _epoch_shuffle_rng :401, and PathContextReader :413-640 for one
shard of a text `.c2v`). It must give the same int arrays, and in
training the same batches in the same order, as the reference for the
same file and seed:

- a missing or empty part is PAD, an unknown word is OOV (in the joined
  scheme both are index 0);
- a context is valid iff any of its three parts is not PAD;
- train rows are dropped when the target is PAD/OOV or no context is
  valid; evaluation rows when no context is valid; predict rows are
  never filtered;
- training shuffles through a bounded buffer keyed per epoch, yields an
  EpochEnd marker after every file pass, and drops the ragged tail;
- evaluation reads the file once in order, with no shuffle, and pads its
  tail batch with invalid rows, so every kept row is scored.

The reference's embed job reads a packed `.c2vb` it writes beside the
corpus; the port reads the same text file in the same row order (the
packed reader is not ported).
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import random
import struct
from typing import Iterator, List, Optional, Sequence

import numpy as np

from code2vec_tpu_torch.vocab import Code2VecVocabs


@dataclasses.dataclass(frozen=True)
class EpochEnd:
    """Marker a train stream yields after the last batch of each file
    pass; `epoch` is 1-based."""
    epoch: int


class EstimatorAction(enum.Enum):
    Train = "train"
    Evaluate = "evaluate"
    Predict = "predict"

    @property
    def is_train(self) -> bool:
        return self is EstimatorAction.Train

    @property
    def is_evaluate(self) -> bool:
        return self is EstimatorAction.Evaluate

    @property
    def is_predict(self) -> bool:
        return self is EstimatorAction.Predict


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
                        row_offset: int = 0,
                        keep_strings: bool = True,
                        with_target_strings: bool = False) -> RowBatch:
    """Parse `name ctx ctx ...` lines (ctx = `token,path,token`) into a
    RowBatch, or into rows [row_offset, row_offset + n) of `out` (a
    buffer from `empty_predict_batch`). Without `keep_strings` (the
    train and eval paths) only the int arrays are filled, and the method
    names too with `with_target_strings`."""
    n, m = len(lines), max_contexts
    if out is not None and not keep_strings:
        raise ValueError("out= requires the keep-strings parse path")
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
        if keep_strings:
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
            if keep_strings:
                src_s[i, j], pth_s[i, j], tgt_s[i, j] = a, b, c
    mask = ((src != token_pad) | (tgt != token_pad) | (pth != path_pad))
    context_valid_mask = mask.astype(np.float32)
    if out is not None:
        sl = slice(row_offset, row_offset + n)
        out.context_valid_mask[sl] = context_valid_mask
        out.example_valid[sl] = True
        out.target_strings[sl] = target_strings
        return out
    if not keep_strings:
        return RowBatch(
            source_token_indices=src, path_indices=pth,
            target_token_indices=tgt, context_valid_mask=context_valid_mask,
            target_index=target_index,
            example_valid=np.ones((n,), dtype=bool),
            target_strings=target_strings if with_target_strings else None)
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


def row_filter_mask(batch: RowBatch, vocabs: Code2VecVocabs,
                    estimator_action: EstimatorAction) -> np.ndarray:
    """The reference row filter: train rows need a known target and a
    valid context, other rows only a valid context."""
    any_valid = batch.context_valid_mask.any(axis=1)
    if estimator_action.is_train:
        target_known = batch.target_index > vocabs.target_vocab.oov_index
        return any_valid & target_known
    return any_valid


def _select_rows(batch: RowBatch, idx: np.ndarray) -> RowBatch:
    def sel(x):
        if x is None:
            return None
        if isinstance(x, list):
            return [x[i] for i in idx]
        return x[idx]
    return RowBatch(**{f.name: sel(getattr(batch, f.name))
                       for f in dataclasses.fields(RowBatch)})


def _iter_file_lines(path: str, buffer_size: int = 16 * 1024 * 1024
                     ) -> Iterator[str]:
    with open(path, "r", buffering=buffer_size) as f:
        yield from f


def _epoch_shuffle_rng(seed: int, epoch: int) -> random.Random:
    """Shuffle RNG of one absolute epoch: a blake2b hash of (seed, epoch),
    stable across processes (code2vec_tpu/data/reader.py:401)."""
    digest = hashlib.blake2b(struct.pack("<qq", seed, epoch),
                             digest_size=16).digest()
    return random.Random(int.from_bytes(digest, "little"))


def _concat_batches(batches: List[RowBatch]) -> RowBatch:
    if len(batches) == 1:
        return batches[0]

    def cat(name):
        vals = [getattr(b, name) for b in batches]
        if vals[0] is None:
            return None
        if isinstance(vals[0], list):
            return [x for v in vals for x in v]
        return np.concatenate(vals, axis=0)

    return RowBatch(**{f.name: cat(f.name)
                       for f in dataclasses.fields(RowBatch)})


class PathContextReader:
    """Streaming batched reader of one text `.c2v` file, Train or Evaluate
    action.

    Yields RowBatches of exactly `batch_size` rows. Train: with
    `yield_epoch_markers`, an EpochEnd after each file pass; lines go
    through a bounded shuffle buffer (`.repeat(epochs).shuffle(buffer)`
    of the original reader) whose RNG is keyed per epoch; the final
    partial batch of the run is dropped. Evaluate: one pass in file
    order, the partial tail batch padded with invalid rows;
    `with_target_strings` keeps each row's method name (the embed job's
    ids). Rows are parsed in chunks of `parse_chunk_lines` and filtered.
    Chunks are parsed in order on the calling thread (the reference
    parses them on a worker pool, which yields the same order)."""

    def __init__(self, vocabs: Code2VecVocabs, config,
                 estimator_action: EstimatorAction,
                 data_path: Optional[str] = None,
                 parse_chunk_lines: int = 4096,
                 batch_size: Optional[int] = None,
                 num_epochs: Optional[int] = None,
                 yield_epoch_markers: bool = False,
                 with_target_strings: bool = False):
        if estimator_action.is_predict:
            raise ValueError("the reader streams the Train and Evaluate "
                             "actions; predict parses its lines directly")
        self.vocabs = vocabs
        self.config = config
        self.estimator_action = estimator_action
        if data_path is None:
            data_path = (config.train_data_path if estimator_action.is_train
                         else config.test_data_path)
        self.data_path = data_path
        self.parse_chunk_lines = parse_chunk_lines
        self.batch_size = batch_size or (
            config.train_batch_size if estimator_action.is_train
            else config.test_batch_size)
        self.with_target_strings = with_target_strings
        self.num_epochs = (config.num_train_epochs if num_epochs is None
                           else num_epochs)
        self.yield_epoch_markers = yield_epoch_markers

    def __iter__(self) -> Iterator:
        if self.estimator_action.is_train:
            lines = self._shuffled_lines(self.num_epochs)
        else:
            lines = _iter_file_lines(self.data_path,
                                     self.config.csv_buffer_size)
        yield from self._batched(lines, self.batch_size)

    def _shuffled_lines(self, epochs: int) -> Iterator:
        """Repeat + bounded shuffle buffer; an EpochEnd after every pass
        (the buffer is drained before the final one)."""
        buf: List[str] = []
        buf_size = self.config.shuffle_buffer_size
        epoch = 0
        while epoch < epochs:
            rng = _epoch_shuffle_rng(self.config.seed, epoch)
            for line in _iter_file_lines(self.data_path,
                                         self.config.csv_buffer_size):
                if len(buf) < buf_size:
                    buf.append(line)
                    continue
                j = rng.randrange(buf_size)
                out, buf[j] = buf[j], line
                yield out
            epoch += 1
            if epoch == epochs:
                rng.shuffle(buf)
                yield from buf
                buf = []
            yield EpochEnd(epoch)

    def _parse_chunk(self, chunk: List[str]) -> RowBatch:
        raw = parse_context_lines(
            chunk, self.vocabs, self.config.max_contexts,
            keep_strings=False, with_target_strings=self.with_target_strings)
        keep = row_filter_mask(raw, self.vocabs, self.estimator_action)
        return _select_rows(raw, np.nonzero(keep)[0])

    def _parsed_chunks(self, line_iter: Iterator) -> Iterator:
        chunk: List[str] = []
        for line in line_iter:
            if isinstance(line, EpochEnd):
                if chunk:
                    yield self._parse_chunk(chunk)
                    chunk = []
                yield line
                continue
            chunk.append(line)
            if len(chunk) >= self.parse_chunk_lines:
                yield self._parse_chunk(chunk)
                chunk = []
        if chunk:
            yield self._parse_chunk(chunk)

    def _batched(self, line_iter: Iterator, batch_size: int) -> Iterator:
        pending: List[RowBatch] = []
        pending_rows = 0

        def pop_batches() -> Iterator[RowBatch]:
            nonlocal pending, pending_rows
            while pending_rows >= batch_size:
                merged = _concat_batches(pending)
                pending, pending_rows = [], 0
                n = merged.target_index.shape[0]
                for start in range(0, n - batch_size + 1, batch_size):
                    yield _select_rows(merged,
                                       np.arange(start, start + batch_size))
                tail = n % batch_size
                if tail:
                    pending = [_select_rows(merged, np.arange(n - tail, n))]
                    pending_rows = tail

        for item in self._parsed_chunks(line_iter):
            if isinstance(item, EpochEnd):
                yield from pop_batches()
                if self.yield_epoch_markers:
                    yield item
                continue
            if item.target_index.shape[0]:
                pending.append(item)
                pending_rows += item.target_index.shape[0]
            yield from pop_batches()
        yield from pop_batches()
        # the ragged tail of a train run is dropped; evaluation pads it
        if pending_rows and not self.estimator_action.is_train:
            yield _pad_rows(_concat_batches(pending), batch_size)
