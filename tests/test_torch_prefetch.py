"""The prefetcher (code2vec_tpu_torch/utils/prefetch.py) on the CPU.

It must yield the reader's batches in order, as tensors holding the
reader's arrays, with EpochEnd markers passed through in place, at depth
1 and 4 with double buffering on and off; raise a worker's error in the
consumer; and stop its worker when the consumer stops early. On the CPU
it pins nothing: the ring of pinned buffers and the copy stream exist on
the GPU only, where chip_smoke.py checks every batch the device received
against the host's (a per-batch checksum over an epoch).
"""

import sys

import numpy as np
import pytest
import torch

from code2vec_tpu_torch.data.packed import PackedDataset, pack_c2v
from code2vec_tpu_torch.data.reader import EpochEnd, EstimatorAction
from code2vec_tpu_torch.utils.prefetch import DevicePrefetcher
from code2vec_tpu_torch.vocab import Code2VecVocabs

from test_torch_native import FIELDS
from test_torch_train import _make_synthetic_dataset

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    prefix = _make_synthetic_dataset(tmp_path_factory.mktemp("prefetch"),
                                     n_rows=200)
    vocabs = Code2VecVocabs.from_words(
        [f"tok{i}" for i in range(12)], [f"path{i}" for i in range(6)],
        [f"name|{w}" for w in ("alpha", "beta", "gamma", "delta")])
    path = pack_c2v(prefix + ".train.c2v", vocabs, 8)
    return PackedDataset(path, vocabs)


def _stream(ds):
    return ds.iter_batches(16, EstimatorAction.Train, num_epochs=3, seed=1,
                           yield_epoch_markers=True)


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("depth", [1, 4])
def test_yields_the_readers_batches_in_order(dataset, depth, double_buffer):
    want = list(_stream(dataset))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)   # interleave the worker and the consumer
    try:
        got = list(DevicePrefetcher(_stream(dataset), "cpu", depth=depth,
                                    keep_host_batch=True,
                                    double_buffer=double_buffer))
    finally:
        sys.setswitchinterval(old)
    assert len(got) == len(want) and sum(
        isinstance(x, EpochEnd) for x in got) == 3
    for g, w in zip(got, want):
        if isinstance(w, EpochEnd):
            assert g == w
            continue
        arrays, host = g
        assert host is not None
        for name, tensor in zip(FIELDS, arrays):
            assert isinstance(tensor, torch.Tensor)
            np.testing.assert_array_equal(tensor.numpy(), getattr(w, name),
                                          err_msg=name)
            np.testing.assert_array_equal(getattr(host, name),
                                          getattr(w, name), err_msg=name)


def test_worker_error_is_raised_in_the_consumer(dataset):
    def broken():
        it = _stream(dataset)
        yield next(it)
        yield next(it)
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for item in DevicePrefetcher(broken(), "cpu", depth=2):
            got.append(item)
    assert len(got) == 2
    arrays, host = got[0]
    assert host is None and len(arrays) == len(FIELDS)


def test_an_early_stop_ends_the_worker(dataset):
    prefetcher = DevicePrefetcher(
        dataset.iter_batches(16, EstimatorAction.Train, num_epochs=None,
                             repeat_endlessly=True), "cpu", depth=2)
    items = iter(prefetcher)
    for _ in range(5):
        next(items)
    items.close()
    prefetcher._thread.join(timeout=10)
    assert not prefetcher._thread.is_alive()
