"""The port's retrieval stack against the JAX package's, on the CPU.

Seeded numpy inputs go through both packages: the vector store (each
package opens the other's), k-means, the index build, IVF and brute
search (an index built by either package searched by both), the MIPS
head, the embed job, the /neighbors body and the CLI. On CPU tensors the
port runs the plain versions of K3 (float32 mode), K9, K10 and K11.

Tolerances, and why:
- F32 (rtol 1e-5, atol 1e-6): f32 math whose sums run in another order
  (k-means centroids, the embed job's code vectors with f32 compute).
- Scores: within 1e-5, the same dot products summed in another order.
- Top-k positions and ids: equal, except where the reference's
  neighbouring scores lie within that 1e-5 of each other (near-ties).
- BF16 (atol 2e-2, rtol 1e-2): predictions of a bf16-compute artifact.
"""

import dataclasses
import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from code2vec_tpu.release import artifact as jart
from code2vec_tpu.release.runtime import ReleaseModel as JaxReleaseModel
from code2vec_tpu.retrieval import index as jindex
from code2vec_tpu.retrieval import mips as jmips
from code2vec_tpu.retrieval import store as jstore
from code2vec_tpu.serving.server import PredictionServer as JaxServer
from code2vec_tpu_torch import cli, kernels
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.ops.quant import quantize_rows
from code2vec_tpu_torch.release.runtime import ReleaseModel
from code2vec_tpu_torch.retrieval import index as tindex
from code2vec_tpu_torch.retrieval import mips as tmips
from code2vec_tpu_torch.retrieval import store as tstore
from code2vec_tpu_torch.retrieval.api import (
    EmbeddingSpaceMismatch, RetrievalHandle,
)
from code2vec_tpu_torch.retrieval.embed_job import run_embed_job
from code2vec_tpu_torch.serving.server import PredictionServer

from test_torch_release import _tiny_jax_model
from test_torch_server import FAKE_EXTRACTOR, SOURCE

pytestmark = pytest.mark.torch_port
# the shapes are tiny; one intra-op thread leaves the CPU cores to the
# other pytest workers
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
SCORE_TOL = 1e-5
BF16 = dict(rtol=1e-2, atol=2e-2)
STORES = {"jax": jstore, "torch": tstore}
INDEXES = {"jax": jindex, "torch": tindex}


def _clustered(n_clusters=12, per=40, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)) * 5.0
    pts = np.concatenate(
        [c + rng.normal(size=(per, dim)) * 0.3 for c in centers])
    return pts.astype(np.float32)


def _write_store(pkg, path, vectors, fingerprint="fp:test",
                 dtype="float32", shard_rows=100):
    w = STORES[pkg].VectorStoreWriter(
        str(path), dim=vectors.shape[1], dtype=dtype,
        model_fingerprint=fingerprint, shard_rows=shard_rows)
    w.append(vectors, [f"m{i}" for i in range(len(vectors))])
    return w.finalize()


def _build(pkg, store, out, **kw):
    if pkg == "torch":
        kw["device"] = "cpu"
    return INDEXES[pkg].build_index(str(store), str(out), log=lambda m: None,
                                    **kw)


def _load(pkg, path):
    if pkg == "torch":
        return tindex.load_index(str(path), device="cpu")
    return jindex.load_index(str(path))


def _assert_topk_close(got_idx, got_val, want_idx, want_val):
    """Values within SCORE_TOL; indices equal except at near-ties of the
    reference's values."""
    got_val, want_val = np.asarray(got_val), np.asarray(want_val)
    np.testing.assert_allclose(got_val, want_val, rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    diff = np.asarray(got_idx) != np.asarray(want_idx)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(want_val, axis=1))
    gap = np.nan_to_num(gap, nan=np.inf)
    near = np.zeros_like(diff)
    near[:, 1:] |= gap <= SCORE_TOL * (1 + np.abs(want_val[:, 1:]))
    near[:, :-1] |= gap <= SCORE_TOL * (1 + np.abs(want_val[:, :-1]))
    assert not (diff & ~near).any(), (got_idx, want_idx)


# ------------------------------------------------------------------ store


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_store_opens_in_the_other_package(tmp_path, writer, reader, dtype):
    pts = _clustered(n_clusters=3, per=25, dim=8)
    written = _write_store(writer, tmp_path / "s", pts, dtype=dtype,
                           shard_rows=30)
    _write_store(reader, tmp_path / "own", pts, dtype=dtype, shard_rows=30)
    got = STORES[reader].VectorStore.open(str(tmp_path / "s"))
    own = STORES[reader].VectorStore.open(str(tmp_path / "own"))
    assert got.manifest == written
    assert {k: v for k, v in got.manifest.items() if k != "source"} == \
        {k: v for k, v in own.manifest.items() if k != "source"}
    assert got.ids == own.ids == [f"m{i}" for i in range(len(pts))]
    np.testing.assert_array_equal(got.load(), own.load())
    for name in sorted(os.listdir(tmp_path / "s")):
        with open(tmp_path / "s" / name, "rb") as a, \
                open(tmp_path / "own" / name, "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_store_resumes_past_committed_shards(tmp_path, first):
    """A store killed after two committed shards (five rows buffered) is
    resumed by the port's writer, whichever package began it, and ends
    byte-equal to one written in a single pass."""
    pts = _clustered(n_clusters=2, per=20, dim=8)
    ids = [f"m{i}" for i in range(len(pts))]
    path = str(tmp_path / "s")
    w = STORES[first].VectorStoreWriter(path, dim=8, dtype="float32",
                                        model_fingerprint="fp:x",
                                        shard_rows=10)
    w.append(pts[:25], ids[:25])  # killed here: 20 rows committed
    with pytest.raises(tstore.StoreError, match="model_fingerprint"):
        tstore.VectorStoreWriter(path, dim=8, dtype="float32",
                                 model_fingerprint="fp:other")
    w2 = tstore.VectorStoreWriter(path, dim=8, dtype="float32",
                                  model_fingerprint="fp:x", shard_rows=10)
    assert w2.rows_done == 20
    w2.append(pts[20:], ids[20:])
    w2.finalize()
    _write_store("jax", tmp_path / "once", pts, fingerprint="fp:x",
                 shard_rows=10)
    for name in sorted(os.listdir(tmp_path / "once")):
        with open(os.path.join(path, name), "rb") as a, \
                open(tmp_path / "once" / name, "rb") as b:
            assert a.read() == b.read(), name
    assert jstore.VectorStore.open(path).ids == ids


# ---------------------------------------------------------------- k-means


@pytest.mark.parametrize("spherical", [False, True])
def test_train_kmeans_matches_jax(spherical):
    pts = _clustered(n_clusters=8, per=30, dim=16, seed=1)
    if spherical:
        pts = tindex._normalize(pts)
    want = jindex.train_kmeans(pts, 8, iters=6, seed=3, spherical=spherical)
    cent, order, offsets = tindex.ivf_lists(pts, 8, 6, seed=3,
                                            spherical=spherical,
                                            device="cpu")
    np.testing.assert_allclose(cent.numpy(), want, **F32)
    # the lists as the reference's build_index groups its assignment
    assign = jindex.assign_lists(pts, want)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(assign, kind="stable"))
    np.testing.assert_array_equal(
        np.diff(offsets.numpy()), np.bincount(assign, minlength=8))


def test_kmeans_update_keeps_empty_clusters_and_renormalises():
    from code2vec_tpu_torch.kernels.kmeans import kmeans_update
    x = torch.tensor([[3.0, 4.0], [1.0, 0.0], [3.0, 0.0]])
    old = torch.tensor([[9.0, 9.0], [0.0, 1.0], [5.0, 5.0]])
    assign = torch.tensor([0, 2, 2], dtype=torch.int32)
    plain = kmeans_update(x, assign, old)
    np.testing.assert_allclose(plain.numpy(),
                               [[3, 4], [0, 1], [2, 0]], **F32)
    sph = kmeans_update(x, assign, old, spherical=True)
    np.testing.assert_allclose(sph.numpy(),
                               [[0.6, 0.8], [0, 1], [1, 0]], **F32)


# ------------------------------------------------------------------ index


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_build_index_matches_jax(tmp_path, metric):
    pts = _clustered(n_clusters=12, per=40, seed=2)
    _write_store("torch", tmp_path / "store", pts)
    jm = _build("jax", tmp_path / "store", tmp_path / "j", nlist=12,
                nprobe=4, kmeans_iters=6, metric=metric)
    tm = _build("torch", tmp_path / "store", tmp_path / "t", nlist=12,
                nprobe=4, kmeans_iters=6, metric=metric)
    skip = ("build_seconds", "source_store")
    assert {k: v for k, v in tm.items() if k not in skip} == \
        {k: v for k, v in jm.items() if k not in skip}
    assert tm["backend"] == jindex.BACKEND_IVF
    for name in ("list_offsets.npy", "store_rows.npy", "vectors.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / name),
                                      np.load(tmp_path / "j" / name))
    np.testing.assert_allclose(np.load(tmp_path / "t" / "centroids.npy"),
                               np.load(tmp_path / "j" / "centroids.npy"),
                               **F32)
    with open(tmp_path / "t" / "ids.txt") as a, \
            open(tmp_path / "j" / "ids.txt") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("mode", ["ivf", "full_probe", "brute"])
@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_index_searches_match_across_packages(tmp_path, built_by, mode):
    """An index built by either package, loaded and searched by both:
    positions equal away from near-ties, scores within 1e-5. The store
    holds exact duplicates, so ties resolve by candidate position."""
    pts = _clustered(n_clusters=12, per=40, seed=4)
    pts[100:103] = pts[99]  # identical methods
    _write_store(built_by, tmp_path / "store", pts)
    _build(built_by, tmp_path / "store", tmp_path / "idx", nlist=12,
           nprobe=3, kmeans_iters=6)
    ji, ti = _load("jax", tmp_path / "idx"), _load("torch", tmp_path / "idx")
    queries = np.concatenate([pts[::23], pts[99:100]])
    kw = {"ivf": {}, "full_probe": {"nprobe": 12},
          "brute": {"exact": True}}[mode]
    want_pos, want_val = ji.search(queries, 10, **kw)
    got_pos, got_val = ti.search(queries, 10, **kw)
    _assert_topk_close(got_pos, got_val, want_pos, want_val)
    # the duplicates come back in candidate order, the query's own row first
    dup_row = list(got_pos[-1][:4])
    assert [ti.store_rows[p] for p in dup_row] == [99, 100, 101, 102]


def test_full_probe_equals_brute(tmp_path):
    pts = _clustered(n_clusters=12, per=40, seed=7)
    _write_store("torch", tmp_path / "store", pts)
    _build("torch", tmp_path / "store", tmp_path / "idx", nlist=12,
           kmeans_iters=6)
    idx = _load("torch", tmp_path / "idx")
    queries = pts[::11]
    approx, av = idx.search(queries, 10, nprobe=idx.nlist)
    exact, ev = idx.search(queries, 10, exact=True)
    for a, e in zip(approx, exact):
        assert set(a.tolist()) == set(e.tolist())
    np.testing.assert_allclose(av, ev, rtol=SCORE_TOL, atol=SCORE_TOL)
    assert tindex.measure_recall(idx, queries, 10, nprobe=idx.nlist) == 1.0
    assert tindex.measure_recall(idx, queries, 10) >= 0.9


def test_k_above_candidates_pads(tmp_path):
    """Where the one probed list holds fewer than k rows, the rest of the
    answer is position -1 with score -inf, in both packages."""
    pts = _clustered(n_clusters=12, per=40, seed=5)
    _write_store("torch", tmp_path / "store", pts)
    _build("torch", tmp_path / "store", tmp_path / "idx", nlist=12,
           nprobe=1, kmeans_iters=6)
    ji, ti = _load("jax", tmp_path / "idx"), _load("torch", tmp_path / "idx")
    got_pos, got_val = ti.search(pts[::40], 64)
    want_pos, want_val = ji.search(pts[::40], 64)
    dead = got_pos < 0
    assert dead.any(axis=1).sum() >= 4
    np.testing.assert_array_equal(dead, want_pos < 0)
    assert np.all(np.isneginf(got_val[dead]))
    _assert_topk_close(got_pos, got_val, want_pos, want_val)


def test_small_store_is_brute_force_in_both(tmp_path):
    pts = _clustered(n_clusters=2, per=20, dim=8)
    _write_store("torch", tmp_path / "store", pts, fingerprint="fp:abc",
                 dtype="float16")
    meta = _build("torch", tmp_path / "store", tmp_path / "idx", nlist=8)
    assert meta["backend"] == tindex.BACKEND_BRUTE
    ji, ti = _load("jax", tmp_path / "idx"), _load("torch", tmp_path / "idx")
    got = ti.search(pts[3], 5)
    want = ji.search(pts[3], 5)
    _assert_topk_close(got[0], got[1], want[0], want[1])
    assert ti.ids[got[0][0, 0]] == "m3"
    with pytest.raises(tindex.IndexArtifactError, match="model_fingerprint"):
        tindex.load_index(str(tmp_path / "idx"), expect_fingerprint="fp:z",
                          device="cpu")


@pytest.mark.parametrize("field,value", [("kind", "nope"), ("format", 99),
                                         ("backend", "hnsw"),
                                         ("metric", "l1")])
def test_index_rejection_names_the_field(tmp_path, field, value):
    pts = _clustered(n_clusters=12, per=40)
    _write_store("torch", tmp_path / "store", pts)
    meta = _build("torch", tmp_path / "store", tmp_path / "idx", nlist=4)
    doctored = dict(meta)
    doctored[field] = value
    (tmp_path / "idx" / "index_meta.json").write_text(json.dumps(doctored))
    with pytest.raises(tindex.IndexArtifactError, match=field):
        tindex.load_index(str(tmp_path / "idx"), device="cpu")


# ------------------------------------------------------------------- MIPS


@pytest.mark.parametrize("scheme", ["int8", "float32"])
def test_mips_topk_fn_matches_jax(scheme):
    rng = np.random.default_rng(6)
    table = rng.normal(size=(301, 16)).astype(np.float32)
    table[7] = table[3]  # a tie
    if scheme == "int8":
        table, scales = quantize_rows(table)
    else:
        scales = None
    kw = dict(real_vocab=300, nlist=12, nprobe=3, kmeans_iters=6, seed=2)
    jh = jmips.MipsHead.build(table, scales, **kw)
    th = tmips.MipsHead.build(table, scales, device="cpu", **kw)
    assert (th.nlist, th.nprobe, th.real_vocab) == (12, 3, 300)
    cv = rng.normal(size=(5, 16)).astype(np.float32)
    cv[4] = (table[3].astype(np.float32) * (1 if scales is None
                                              else scales[3]))
    for nprobe, k in ((None, 10), (12, 10), (1, 64)):
        want_v, want_i = jh.search(cv, k, nprobe)
        got_v, got_i = th.search(cv, k, nprobe)
        _assert_topk_close(got_i, got_v, want_i, want_v)
        if k == 64:  # fewer candidates than k: id 0, value -inf
            dead = np.isneginf(got_v)
            assert dead.any()
            assert (got_i[dead] == 0).all()
    # the MIPS head over every list is the exact top-k
    exact = cv @ (table.astype(np.float32) * (1 if scales is None
                                              else scales)).T
    exact[:, 300:] = -np.inf
    got_v, got_i = th.search(cv, 10, 12)
    want_i = np.argsort(-exact, axis=1, kind="stable")[:, :10]
    _assert_topk_close(got_i, got_v, want_i,
                       np.take_along_axis(exact, want_i, axis=1))


# ------------------------------------------------- artifact, embed, serve


@pytest.fixture(scope="module")
def f32_artifact(tmp_path_factory):
    """A tiny f32-compute JAX model, its int8 artifact and its corpus
    (the 48 training methods, one method with no valid context, which
    the eval filter drops, and the methods again: exact duplicates)."""
    tmp = tmp_path_factory.mktemp("torch-retrieval")
    model = _tiny_jax_model(tmp, compute_dtype="float32")
    art = str(tmp / "artifact")
    jart.export_artifact(model, art, aot=False, log=lambda m: None)
    with open(model.config.train_data_path) as f:
        lines = f.read().splitlines()
    corpus = tmp / "corpus.c2v"
    corpus.write_text("\n".join(lines[:20] + ["empty_method"] + lines[20:]
                                + lines * 5) + "\n")
    return model, art, str(corpus)


def _torch_config(art, **kw):
    return Config(serve_artifact=art, device="cpu", verbose_mode=0,
                  serve_batch_size=4, **kw)


def test_eval_reader_matches_jax(f32_artifact):
    """The Evaluate action of the text reader: file order, the eval row
    filter (a method with no valid context is dropped), the padded tail
    batch, and the method names, as the JAX text reader gives them."""
    from code2vec_tpu.data import reader as jreader
    from code2vec_tpu_torch.data import reader as treader
    model, art, corpus = f32_artifact
    tm = ReleaseModel(_torch_config(art))
    jcfg = dataclasses.replace(model.config, test_data_path=corpus,
                               test_batch_size=40)
    want = list(jreader.PathContextReader(
        model.vocabs, jcfg, jreader.EstimatorAction.Evaluate,
        data_path=corpus, batch_size=40))
    got = list(treader.PathContextReader(
        tm.vocabs, tm.config, treader.EstimatorAction.Evaluate,
        data_path=corpus, batch_size=40, with_target_strings=True))
    assert len(got) == len(want) == 8   # 288 rows: 7 full, 1 padded
    for g, w in zip(got, want):
        for name in ("source_token_indices", "path_indices",
                     "target_token_indices", "context_valid_mask",
                     "target_index", "example_valid"):
            np.testing.assert_array_equal(getattr(g, name),
                                          getattr(w, name), name)
        assert g.target_strings == w.target_strings
    assert int(got[-1].example_valid.sum()) == 288 - 7 * 40


def test_embed_job_matches_jax(f32_artifact, tmp_path):
    model, art, corpus = f32_artifact
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jcorpus = str(jdir / "corpus.c2v")  # the JAX job packs beside it
    shutil.copy(corpus, jcorpus)
    jcfg = dataclasses.replace(model.config, train_data_path_prefix=None,
                               serve_artifact=art, test_data_path=jcorpus,
                               embed_shard_rows=64, test_batch_size=32)
    from code2vec_tpu.retrieval.embed_job import run_embed_job as jrun
    jsum = jrun(JaxReleaseModel(jcfg, log=lambda m: None),
                out_dir=str(tmp_path / "jstore"), log=lambda m: None)
    tm = ReleaseModel(_torch_config(art, test_data_path=corpus,
                                    embed_shard_rows=64,
                                    test_batch_size=32))
    before = kernels.launch_counts()
    tsum = run_embed_job(tm, out_dir=str(tmp_path / "tstore"))
    assert kernels.launch_counts() == before  # the CPU ran plain versions
    assert tsum["rows"] == jsum["rows"] == 48 * 6
    assert tsum["fingerprint"] == jsum["fingerprint"] == \
        tm.model_fingerprint()
    # the port packs the corpus beside itself, as the JAX job does
    assert os.path.exists(corpus + "b")
    js = jstore.VectorStore.open(str(tmp_path / "jstore"))
    ts = tstore.VectorStore.open(str(tmp_path / "tstore"))
    assert ts.ids == js.ids
    assert [r["rows"] for r in ts.manifest["shards"]] == \
        [r["rows"] for r in js.manifest["shards"]]
    np.testing.assert_allclose(ts.load(), js.load(), **F32)


def test_embed_job_resumes_without_recomputing(f32_artifact, tmp_path,
                                               monkeypatch):
    _, art, corpus = f32_artifact
    tm = ReleaseModel(_torch_config(art, test_data_path=corpus,
                                    embed_shard_rows=40,
                                    test_batch_size=32))
    out = str(tmp_path / "store")
    real = tm.eval_callable
    calls = {"n": 0}

    def failing():
        step, params = real()

        def wrapped(p, *arrays):
            calls["n"] += 1
            if calls["n"] == 4:
                raise RuntimeError("killed")
            return step(p, *arrays)
        return wrapped, params

    monkeypatch.setattr(tm, "eval_callable", failing)
    with pytest.raises(RuntimeError, match="killed"):
        run_embed_job(tm, out_dir=out)
    assert tstore.VectorStore.open(out, allow_partial=True).rows == 80
    calls["n"] = -100
    summary = run_embed_job(tm, out_dir=out)
    assert summary["resumed_rows"] == 80
    assert calls["n"] == -100 + 9 - 2  # batches 1-2 hold resumed rows only
    full = str(tmp_path / "full")
    monkeypatch.setattr(tm, "eval_callable", real)
    run_embed_job(tm, out_dir=full)
    a, b = tstore.VectorStore.open(out), tstore.VectorStore.open(full)
    assert a.ids == b.ids
    np.testing.assert_array_equal(a.load(), b.load())


@pytest.fixture(scope="module")
def neighbor_servers(f32_artifact, tmp_path_factory):
    """The JAX and the port's server over one artifact and one index (an
    IVF index of the embedded corpus), with the fake extractor."""
    model, art, corpus = f32_artifact
    tmp = tmp_path_factory.mktemp("torch-neighbors")
    fake = tmp / "fake-c2v-extract"
    fake.write_text(FAKE_EXTRACTOR)
    fake.chmod(0o755)
    mp = pytest.MonkeyPatch()
    mp.setenv("C2V_NATIVE_EXTRACTOR", str(fake))
    tm = ReleaseModel(_torch_config(art, test_data_path=corpus))
    run_embed_job(tm, out_dir=str(tmp / "store"))
    meta = tindex.build_index(str(tmp / "store"), str(tmp / "idx"),
                              nprobe=4, log=lambda m: None, device="cpu")
    assert meta["backend"] == tindex.BACKEND_IVF
    jcfg = dataclasses.replace(model.config, train_data_path_prefix=None,
                               serve_artifact=art, extractor_pool_size=1,
                               serve=True, retrieval_index=str(tmp / "idx"))
    jserver = JaxServer(JaxReleaseModel(jcfg, log=lambda m: None), jcfg)
    cfg = _torch_config(art, serve_max_delay_ms=2.0, serve=True,
                        retrieval_index=str(tmp / "idx"))
    tserver = PredictionServer(ReleaseModel(cfg))
    port = tserver.start(port=0)
    yield jserver, tserver, f"http://127.0.0.1:{port}", str(tmp / "idx")
    tserver.shutdown()
    jserver.drain(timeout=5)
    mp.undo()


def _post(url, body, ctype="text/plain"):
    req = urllib.request.Request(url, data=body.encode(), method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _neighbor_lists_close(got, want):
    assert sorted(got) == sorted(want)
    for key in ("model", "model_fingerprint", "embedding_fingerprint",
                "index"):
        assert got[key] == want[key], key
    assert len(got["methods"]) == len(want["methods"])
    for g, w in zip(got["methods"], want["methods"]):
        assert sorted(g) == sorted(w) == ["neighbors", "original_name"]
        assert g["original_name"] == w["original_name"]
        assert len(g["neighbors"]) == len(w["neighbors"])
        for gn, wn in zip(g["neighbors"], w["neighbors"]):
            assert sorted(gn) == sorted(wn)
            np.testing.assert_allclose([gn["score"], gn["distance"]],
                                       [wn["score"], wn["distance"]],
                                       rtol=1e-4, atol=1e-4)
        scores = [n["score"] for n in w["neighbors"]]
        for j, (gn, wn) in enumerate(zip(g["neighbors"], w["neighbors"])):
            near = any(abs(scores[j] - scores[i]) <= 1e-4
                       for i in (j - 1, j + 1) if 0 <= i < len(scores))
            if not near:
                assert (gn["id"], gn["store_row"]) == \
                    (wn["id"], wn["store_row"])


@pytest.mark.parametrize("params", [None, {"k": 5, "nprobe": 3},
                                    {"k": 64, "nprobe": 16}])
def test_neighbors_body_matches_jax(neighbor_servers, params):
    jserver, _, url, _ = neighbor_servers
    if params is None:
        want = json.loads(jserver.handle("neighbors", SOURCE))
        status, body = _post(f"{url}/neighbors", SOURCE)
    else:
        want = json.loads(jserver.handle("neighbors", SOURCE,
                                         params=params))
        status, body = _post(f"{url}/neighbors",
                             json.dumps(dict(code=SOURCE, **params)),
                             "application/json")
    assert status == 200, body
    got = json.loads(body)
    _neighbor_lists_close(got, want)
    assert body == json.dumps(got, sort_keys=True).encode() + b"\n"
    assert len(got["methods"][0]["neighbors"]) == \
        (params or {}).get("k", 10)


def test_neighbors_errors_and_healthz(neighbor_servers, monkeypatch):
    jserver, tserver, url, _ = neighbor_servers
    # a k above the 64 entries of the kernels' lists is answered, as the
    # reference answers it
    want = json.loads(jserver.handle("neighbors", SOURCE,
                                     params={"k": 100}))
    status, body = _post(f"{url}/neighbors",
                         json.dumps({"code": SOURCE, "k": 100}),
                         "application/json")
    assert status == 200, body
    _neighbor_lists_close(json.loads(body), want)
    status, _ = _post(f"{url}/neighbors",
                      json.dumps({"code": SOURCE, "k": 0}),
                      "application/json")
    assert status == 400
    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health["retrieval"]["status"] == "attached"
    assert health["retrieval"]["fingerprint"] == tserver.fingerprint
    # zero extracted methods: an empty answer, not a search (a source
    # not asked before, so the prediction cache cannot answer it)
    monkeypatch.setattr(tserver.pool, "extract_source",
                        lambda code, **kw: ([], {}))
    status, body = _post(f"{url}/neighbors", "interface Empty { }")
    assert status == 200 and json.loads(body)["methods"] == []


def test_neighbors_refuses_other_embedding_spaces(neighbor_servers,
                                                  f32_artifact):
    _, tserver, _, idx = neighbor_servers
    _, art, _ = f32_artifact
    with pytest.raises(tindex.IndexArtifactError, match="model_fingerprint"):
        RetrievalHandle.mount(idx, "artifact:0000000000000000",
                              device="cpu")
    # a default k above the kernels' list length is taken at mount
    handle = RetrievalHandle.mount(idx, tserver.fingerprint, default_topk=65,
                                   device="cpu")
    assert handle.default_topk == 65 and handle.search_k() == 128
    handle = RetrievalHandle.mount(idx, tserver.fingerprint, device="cpu")
    with pytest.raises(EmbeddingSpaceMismatch):
        handle.neighbors(np.zeros((1, 384), np.float32), "artifact:other")
    handle.detach("test")
    assert handle.status()["status"] == "detached"
    with pytest.raises(EmbeddingSpaceMismatch):
        handle.neighbors(np.zeros((1, 384), np.float32), tserver.fingerprint)
    # a server over the artifact serves /neighbors only with a mount
    plain = PredictionServer(ReleaseModel(_torch_config(art)))
    status, body, _ = plain.handle_request("neighbors", SOURCE)
    assert status == 404 and b"retrieval_index" in body
    plain.shutdown()
    tserver.retrieval = handle  # detached: 503
    try:
        status, _, _ = tserver.handle_request("neighbors", SOURCE)
        assert status == 503
    finally:
        tserver.retrieval = RetrievalHandle.mount(idx, tserver.fingerprint,
                                                  device="cpu")


def test_mips_head_dispatch(f32_artifact):
    """Crossover 2 of a 4-row serve batch: one live row takes the MIPS
    head (padded to 2 rows), four take the exact head. At nprobe = nlist
    the MIPS head's words are the JAX MIPS head's and the exact head's."""
    model, art, _ = f32_artifact
    lines = [ln for ln in open(model.config.train_data_path)][:4]
    cfg = _torch_config(art, serve_mips_nprobe=64, serve_mips_crossover=2,
                        serve=True)
    tm = ReleaseModel(cfg)
    assert tm.mips_head is not None and tm.mips_rows == 2
    assert "target_embedding" in tm.params
    got_one = tm.predict(lines[:1], batch_size=4)
    assert tm.head_dispatches == {"exact": 0, "mips": 1}
    tm.predict(lines, batch_size=4)
    assert tm.head_dispatches == {"exact": 1, "mips": 1}
    exact = ReleaseModel(_torch_config(art)).predict(lines[:1], batch_size=4)
    jcfg = dataclasses.replace(model.config, train_data_path_prefix=None,
                               serve_artifact=art, serve=True,
                               serve_mips_nprobe=64, serve_batch_size=4,
                               serve_mips_crossover=2)
    want = JaxReleaseModel(jcfg, log=lambda m: None).predict(
        lines[:1], batch_size=4)
    for g, w in ((got_one[0], want[0]), (got_one[0], exact[0])):
        assert g.topk_predicted_words == w.topk_predicted_words
        np.testing.assert_allclose(g.topk_predicted_words_scores,
                                   w.topk_predicted_words_scores, **BF16)


@pytest.mark.parametrize("crossover,calibrated,mode", [
    (-1, None, "all"), (-1, 3, "split"), (0, 3, "exact"), (4, None, "all"),
    (3, None, "split"), (-1, 0, "exact")])
def test_mips_crossover_resolution(f32_artifact, tmp_path, crossover,
                                   calibrated, mode):
    """A calibrated 0 (MIPS lost at one row) serves exact-only, where
    the JAX runtime goes all-MIPS (ROADMAP Queue 3)."""
    _, art, _ = f32_artifact
    if calibrated is not None:  # the meta field export calibration writes
        shutil.copytree(art, tmp_path / "art")
        art = str(tmp_path / "art")
        with open(os.path.join(art, "release_meta.json")) as f:
            meta = json.load(f)
        meta["mips_crossover"] = calibrated
        with open(os.path.join(art, "release_meta.json"), "w") as f:
            json.dump(meta, f)
    tm = ReleaseModel(_torch_config(art, serve_mips_nprobe=2, serve=True,
                                    serve_mips_crossover=crossover))
    assert (tm.mips_head is not None) == (mode != "exact")
    assert tm._mips_all == (mode == "all")
    # all-MIPS never uploads the original-order target table
    assert ("target_embedding" in tm.params) == (mode != "all")
    assert tm.mips_rows == (3 if mode == "split" else 0)


# -------------------------------------------------------------------- CLI


def test_cli_embed_and_index_build(f32_artifact, tmp_path):
    _, art, corpus = f32_artifact
    store, idx = str(tmp_path / "store"), str(tmp_path / "idx")
    summary = cli.main(["embed", "--artifact", art, "--test", corpus,
                        "--embed_out", store, "--embed_dtype", "float16",
                        "--embed_shard_rows", "100", "--device", "cpu"])
    s = tstore.VectorStore.open(store)
    assert s.rows == summary["rows"] == 48 * 6 and s.dtype == "float16"
    assert [r["rows"] for r in s.manifest["shards"]] == [100, 100, 88]
    meta = cli.main(["index-build", "--vectors", store, "--index_out", idx,
                     "--nlist", "8", "--nprobe", "3", "--kmeans_iters", "4",
                     "--index_metric", "dot", "--device", "cpu"])
    assert (meta["nlist"], meta["nprobe"], meta["kmeans_iters"],
            meta["metric"], meta["dtype"]) == (8, 3, 4, "dot", "float16")
    assert jindex.load_index(idx).fingerprint == summary["fingerprint"]


@pytest.mark.parametrize("argv,message", [
    (["embed", "--artifact", "A", "--test", "c.c2v"], "--embed_out"),
    (["embed", "--artifact", "A", "--embed_out", "S"], "--test"),
    (["index-build", "--vectors", "S"], "--index_out"),
    (["index-build", "--index_out", "I"], "--vectors"),
    (["index-build", "--vectors", "S", "--index_out", "I", "--nprobe", "0"],
     "index_nprobe"),
    (["predict", "--artifact", "A", "--retrieval_index", "I"],
     "retrieval_index"),
    (["serve", "--artifact", "A", "--serve_mips_crossover", "2"],
     "serve_mips_nprobe"),
    (["serve", "--artifact", "A", "--test", "c.c2v"], "--test"),
])
def test_cli_refuses_bad_retrieval_flags(argv, message, capsys):
    with pytest.raises(SystemExit):
        cli.config_from_args(argv)
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("k", [100, "rows"])
def test_serve_takes_any_retrieval_topk(neighbor_servers, f32_artifact, k):
    """`serve --retrieval_topk 65` parses, and /neighbors at k = 100 and
    at k = the index rows (above the kernels' 64-entry lists) returns the
    JAX server's body."""
    jserver, tserver, url, idx = neighbor_servers
    _, art, _ = f32_artifact
    _, cfg = cli.config_from_args(["serve", "--artifact", art,
                                   "--retrieval_index", idx,
                                   "--retrieval_topk", "65",
                                   "--device", "cpu"])
    assert cfg.retrieval_topk == 65
    rows = tserver.retrieval.index.rows
    k = rows if k == "rows" else k
    params = {"k": k, "nprobe": 64}   # every list: k real neighbors
    want = json.loads(jserver.handle("neighbors", SOURCE, params=params))
    status, body = _post(f"{url}/neighbors",
                         json.dumps(dict(code=SOURCE, **params)),
                         "application/json")
    assert status == 200, body
    got = json.loads(body)
    _neighbor_lists_close(got, want)
    assert got["index"]["k"] == k
    assert all(len(m["neighbors"]) == min(k, rows) for m in got["methods"])


@pytest.fixture(scope="module")
def wide_artifact(tmp_path_factory):
    """A tiny f32-compute JAX model over 150 method names, exported with
    top-k 100 (above the kernels' 64-entry lists)."""
    import pickle
    import random

    from code2vec_tpu.config import Config as JaxConfig
    from code2vec_tpu.model_facade import Code2VecModel as JaxModel
    tmp = tmp_path_factory.mktemp("torch-wide")
    rng = random.Random(1)
    tokens = [f"tok{i}" for i in range(12)]
    paths = [f"p{i}" for i in range(6)]
    targets = [f"name|x{i}" for i in range(150)]
    rows = []
    for _ in range(64):
        t = rng.randrange(len(targets))
        ctxs = [f"{tokens[t % 12]},{rng.choice(paths)},{tokens[t % 7]}"
                for _ in range(rng.randint(2, 6))]
        rows.append(f"{targets[t]} " + " ".join(ctxs))
    prefix = str(tmp / "wide")
    with open(prefix + ".train.c2v", "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(prefix + ".dict.c2v", "wb") as f:
        pickle.dump({w: 10 for w in tokens}, f)
        pickle.dump({p: 10 for p in paths}, f)
        pickle.dump({t: 10 for t in targets}, f)
        pickle.dump(len(rows), f)
    model = JaxModel(JaxConfig(
        train_data_path_prefix=prefix, max_contexts=8, train_batch_size=8,
        test_batch_size=8, compute_dtype="float32", verbose_mode=0,
        serve_batch_size=4, serve_buckets="4,8", num_train_epochs=1,
        save_every_epochs=1000, top_k_words_considered_during_prediction=100))
    art = str(tmp / "artifact")
    jart.export_artifact(model, art, aot=False, log=lambda m: None)
    return model, art, rows


@pytest.mark.parametrize("head", ["exact", "mips"])
def test_release_model_topk_100_matches_jax(wide_artifact, head):
    """An artifact exported with top-k 100 serves through ReleaseModel
    with the exact head and with the MIPS head over every list, as the
    JAX package's ReleaseModel serves it."""
    model, art, rows = wide_artifact
    knobs = {} if head == "exact" else dict(serve_mips_nprobe=64,
                                            serve=True)
    jcfg = dataclasses.replace(model.config, train_data_path_prefix=None,
                               serve_artifact=art, serve_batch_size=4,
                               **knobs)
    jrm = JaxReleaseModel(jcfg, log=lambda m: None)
    trm = ReleaseModel(_torch_config(art, **knobs))
    assert (trm.mips_head is not None) == (head == "mips")
    assert int(trm.meta["topk"]) == 100
    want = jrm.predict(rows[:6], batch_size=4)
    got = trm.predict(rows[:6], batch_size=4)
    assert trm.head_dispatches[head] > 0
    for g, w in zip(got, want):
        assert len(g.topk_predicted_words) == len(w.topk_predicted_words) \
            == 100
        np.testing.assert_allclose(g.topk_predicted_words_scores,
                                   w.topk_predicted_words_scores, **F32)
        # names equal except where the reference's neighbouring
        # probabilities are within tolerance of each other (near-ties)
        p = np.asarray(w.topk_predicted_words_scores)
        for j, (a, b) in enumerate(zip(g.topk_predicted_words,
                                       w.topk_predicted_words)):
            near = any(abs(p[j] - p[i]) <= 1e-6 + 1e-5 * abs(p[j])
                       for i in (j - 1, j + 1) if 0 <= i < len(p))
            assert a == b or near, (j, a, b)
