"""The port's packed corpus (code2vec_tpu_torch/data/packed.py) and offline
compile (data/preprocess.py) against the JAX package's, on the CPU.

Files: `preprocess`, `compile_corpus` at 1 and 3 workers (with and
without the native library), `pack_c2v`, `pack_raw` and
`external_shuffle` must write the bytes the JAX functions write on the
same inputs, and each package must open the other's `.c2vb` and
manifests. Reader: `PackedDataset.iter_batches` and `ShardedCorpus` must
give the JAX batches, array for array, over a grid of actions, seeds,
start epochs, resume cursors and host shard counts, and the same
`steps_per_epoch`. Manifests and the `corpus` command: create, append,
validate, a mixed-vocabulary append refused, relative paths surviving a
move, and the command's log lines equal to the JAX command's. Every
comparison is exact: both packages do the same integer work.
"""

import json
import os
import pickle
import random
import shutil

import numpy as np
import pytest

from code2vec_tpu import cli as jcli
from code2vec_tpu.data import packed as jpacked
from code2vec_tpu.data import preprocess as jpp
from code2vec_tpu.data.reader import EpochEnd as JaxEpochEnd
from code2vec_tpu.data.reader import EstimatorAction as JaxAction
from code2vec_tpu.vocab import Code2VecVocabs as JaxVocabs
from code2vec_tpu.vocab import load_word_freq_dicts as jax_freq
from code2vec_tpu_torch import cli
from code2vec_tpu_torch.data import packed
from code2vec_tpu_torch.data import preprocess as pp
from code2vec_tpu_torch.data.reader import EpochEnd, EstimatorAction
from code2vec_tpu_torch.vocab import Code2VecVocabs, load_word_freq_dicts

from test_torch_native import FIELDS, ensure_cpp_built, python_only

pytestmark = pytest.mark.torch_port

SIZES = dict(word_vocab_size=15, path_vocab_size=8, target_vocab_size=10)
ROLES = ("train", "val", "test")


def write_raw(path, n, seed, n_tokens=20, n_paths=9, n_names=12,
              widths=(1, 2, 3, 8, 12)):
    """Raw extractor output: repeated contexts, empty fields, blank
    lines and (at a small max_contexts) methods over the budget."""
    r = random.Random(seed)
    with open(path, "w") as f:
        for _ in range(n):
            ctxs = [f"t{r.randrange(n_tokens)},p{r.randrange(n_paths)},"
                    f"t{r.randrange(n_tokens)}"
                    for _ in range(r.choice(widths))]
            if r.random() < 0.1:
                ctxs.append("")
            f.write(f"m|{r.randrange(n_names)} " + " ".join(ctxs) + "\n")
            if r.random() < 0.05:
                f.write("\n")


@pytest.fixture(scope="module", autouse=True)
def built():
    ensure_cpp_built()


@pytest.fixture(scope="module")
def raws(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    out = {}
    for role, (n, seed) in {"train": (400, 1), "val": (60, 2),
                            "test": (60, 3)}.items():
        out[role] = str(d / f"{role}.raw.txt")
        write_raw(out[role], n, seed)
    return out


def vocabs_of(name):
    """Both packages' vocabularies from a `.dict.c2v`."""
    sizes = dict(max_token_vocab_size=SIZES["word_vocab_size"],
                 max_path_vocab_size=SIZES["path_vocab_size"],
                 max_target_vocab_size=SIZES["target_vocab_size"])
    return (JaxVocabs.create_from_freq_dicts(jax_freq(name + ".dict.c2v"),
                                             **sizes),
            Code2VecVocabs.create_from_freq_dicts(
                load_word_freq_dicts(name + ".dict.c2v"), **sizes))


@pytest.fixture(scope="module")
def corpus(raws, tmp_path_factory):
    """A fused-compiled corpus (M 6) and both packages' vocabularies."""
    name = str(tmp_path_factory.mktemp("corpus") / "data")
    pp.compile_corpus(raws["train"], raws["val"], raws["test"], name,
                      max_contexts=6, seed=7, num_workers=1,
                      log=lambda *a: None, **SIZES)
    return (name,) + vocabs_of(name)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _outputs(name, suffixes):
    return {f"{role}{s}": _read(f"{name}.{role}{s}")
            for role in ROLES for s in suffixes}


# ----------------------------------------------------------------- files


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("route", ["native", "python"])
def test_compile_corpus_matches_jax(raws, tmp_path, monkeypatch, workers,
                                    route):
    """`.c2vb`, `.targets`, `.meta.json`, the compat `.c2v` text and the
    `.dict.c2v` of the fused compile, byte for byte."""
    if route == "python":
        python_only(monkeypatch)
    names = {}
    for pkg, fn in (("jax", jpp.compile_corpus), ("port", pp.compile_corpus)):
        os.makedirs(tmp_path / pkg)
        names[pkg] = str(tmp_path / pkg / "data")
        stats = {}
        fn(raws["train"], raws["val"], raws["test"], names[pkg],
           max_contexts=6, seed=7, num_workers=workers, emit_c2v=True,
           stats_out=stats, log=lambda *a: None, **SIZES)
    suffixes = (".c2vb", ".c2vb.targets", ".c2v")
    assert _outputs(names["port"], suffixes) == \
        _outputs(names["jax"], suffixes)
    assert _outputs(names["port"], (".c2vb.meta.json",)) == \
        _outputs(names["jax"], (".c2vb.meta.json",))
    assert _read(names["port"] + ".dict.c2v") == \
        _read(names["jax"] + ".dict.c2v")


def test_compile_corpus_same_bytes_at_any_worker_count(raws, tmp_path):
    blobs = []
    for workers in (1, 3):
        name = str(tmp_path / f"w{workers}" / "data")
        os.makedirs(os.path.dirname(name))
        pp.compile_corpus(raws["train"], raws["val"], raws["test"], name,
                          max_contexts=6, seed=7, num_workers=workers,
                          log=lambda *a: None, **SIZES)
        blobs.append((_outputs(name, (".c2vb", ".c2vb.targets")),
                      _read(name + ".dict.c2v")))
    assert blobs[0] == blobs[1]


@pytest.mark.parametrize("max_contexts", [6, 20])
def test_preprocess_matches_jax(raws, tmp_path, max_contexts):
    """The serial text pipeline: the three `.c2v` files byte for byte,
    the `.dict.c2v` equal unpickled and byte for byte; at M 6 the
    sampling tiers engage, at M 20 none does."""
    names, logs = {}, {"jax": [], "port": []}
    for pkg, fn in (("jax", jpp.preprocess), ("port", pp.preprocess)):
        os.makedirs(tmp_path / pkg)
        names[pkg] = str(tmp_path / pkg / "data")
        fn(raws["train"], raws["val"], raws["test"], names[pkg],
           max_contexts=max_contexts, seed=7, log=logs[pkg].append, **SIZES)
    assert _outputs(names["port"], (".c2v",)) == \
        _outputs(names["jax"], (".c2v",))
    dicts = []
    for pkg in ("jax", "port"):
        with open(names[pkg] + ".dict.c2v", "rb") as f:
            dicts.append([pickle.load(f) for _ in range(4)])
    assert dicts[0] == dicts[1]
    assert _read(names["port"] + ".dict.c2v") == \
        _read(names["jax"] + ".dict.c2v")
    assert [m.replace(str(tmp_path / "port"), "{dir}")
            for m in logs["port"]] == \
        [m.replace(str(tmp_path / "jax"), "{dir}") for m in logs["jax"]]


def test_pack_raw_and_pack_c2v_match_jax(raws, tmp_path, monkeypatch,
                                         corpus):
    """`pack_raw` with sampling (3 workers) and `pack_c2v` of text (the
    serial Python loop against its 3-worker sharding), against the JAX
    functions on the same inputs."""
    _, jv, tv = corpus
    freq = load_word_freq_dicts(corpus[0] + ".dict.c2v")
    outs = {}
    for pkg, mod, vocabs in (("jax", jpacked, jv), ("port", packed, tv)):
        outs[pkg] = str(tmp_path / f"{pkg}.raw.c2vb")
        mod.pack_raw(raws["val"], outs[pkg], vocabs, freq.token_to_count,
                     freq.path_to_count, 6, seed=3, num_workers=3)
    for suffix in ("", ".targets"):
        assert _read(outs["port"] + suffix) == _read(outs["jax"] + suffix)
    text = str(tmp_path / "val.c2v")
    pp.process_file(raws["val"], "val", str(tmp_path / "t"),
                    freq.token_to_count, freq.path_to_count, 6,
                    log=lambda *a: None)
    shutil.move(str(tmp_path / "t.val.c2v"), text)
    python_only(monkeypatch)
    for pkg, mod, vocabs, workers in (("jax", jpacked, jv, 0),
                                      ("serial", packed, tv, 0),
                                      ("sharded", packed, tv, 3)):
        outs[pkg] = mod.pack_c2v(text, vocabs, 6,
                                 out_path=str(tmp_path / f"{pkg}.c2vb"),
                                 num_workers=workers)
    for suffix in ("", ".targets"):
        want = _read(outs["jax"] + suffix)
        assert _read(outs["serial"] + suffix) == want
        assert _read(outs["sharded"] + suffix) == want


@pytest.mark.parametrize("case", ["in_memory", "spill", "recursive"])
def test_external_shuffle_matches_jax(tmp_path, case):
    """The same permutation as the JAX function: in memory, through
    spill buckets, and with buckets over the budget shuffled again."""
    n, budget = {"in_memory": (300, 1 << 30), "spill": (1000, 4096),
                 "recursive": (6000, 2048)}[case]
    lines = [f"m{i} " + "x" * 40 for i in range(n)]
    out = {}
    for pkg, fn in (("jax", jpp.external_shuffle),
                    ("port", pp.external_shuffle)):
        path = tmp_path / f"{pkg}.txt"
        path.write_text("\n".join(lines))   # last line unterminated
        fn(str(path), seed=5, mem_budget_bytes=budget, log=lambda *a: None)
        out[pkg] = path.read_bytes()
    assert out["port"] == out["jax"]
    assert sorted(out["port"].decode().splitlines()) == sorted(lines)
    assert not list(tmp_path.glob("c2v_shuf_*"))


# ---------------------------------------------------------------- reader


def _assert_same_stream(got, want, with_strings=False):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if isinstance(w, JaxEpochEnd):
            assert isinstance(g, EpochEnd) and g.epoch == w.epoch
            continue
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name),
                                          err_msg=name)
        if with_strings:
            assert g.target_strings == w.target_strings


TRAIN_GRID = [(seed, start, skip, shards) for seed in (0, 7)
              for start in (0, 3) for skip in (0, 40) for shards in (1, 2)]


@pytest.mark.parametrize("seed,start_epoch,skip_rows,num_shards",
                         TRAIN_GRID)
def test_train_batches_match_jax(corpus, seed, start_epoch, skip_rows,
                                 num_shards):
    name, jv, tv = corpus
    path = name + ".train.c2vb"
    for shard in range(num_shards):
        kw = dict(num_epochs=2, seed=seed, yield_epoch_markers=True,
                  start_epoch=start_epoch, skip_rows=skip_rows)
        jds = jpacked.PackedDataset(path, jv, shard_index=shard,
                                    num_shards=num_shards)
        tds = packed.PackedDataset(path, tv, shard_index=shard,
                                   num_shards=num_shards)
        _assert_same_stream(tds.iter_batches(16, EstimatorAction.Train, **kw),
                            jds.iter_batches(16, JaxAction.Train, **kw))
        for bs in (16, 50):
            assert tds.steps_per_epoch(bs, EstimatorAction.Train,
                                       skip_rows=skip_rows) == \
                jds.steps_per_epoch(bs, JaxAction.Train, skip_rows=skip_rows)


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("role", ["train", "test"])
def test_evaluate_batches_match_jax(corpus, num_shards, role):
    """File order per host shard, the eval row filter, the padded tail
    batch and each row's method name."""
    name, jv, tv = corpus
    path = f"{name}.{role}.c2vb"
    for shard in range(num_shards):
        jds = jpacked.PackedDataset(path, jv, shard_index=shard,
                                    num_shards=num_shards)
        tds = packed.PackedDataset(path, tv, shard_index=shard,
                                   num_shards=num_shards)
        _assert_same_stream(
            tds.iter_batches(16, EstimatorAction.Evaluate,
                             with_target_strings=True),
            jds.iter_batches(16, JaxAction.Evaluate,
                             with_target_strings=True),
            with_strings=True)
        assert tds.steps_per_epoch(16, EstimatorAction.Evaluate) == \
            jds.steps_per_epoch(16, JaxAction.Evaluate)


def _shards(raws, tmp_path, corpus):
    """Three `.c2vb` shards of the corpus's vocabularies (the three raw
    splits packed with sampling) under tmp_path/shards."""
    name, jv, tv = corpus
    freq = load_word_freq_dicts(name + ".dict.c2v")
    os.makedirs(tmp_path / "shards", exist_ok=True)
    paths = []
    for role in ROLES:
        paths.append(str(tmp_path / "shards" / f"{role}.c2vb"))
        packed.pack_raw(raws[role], paths[-1], tv, freq.token_to_count,
                        freq.path_to_count, 6, seed=1)
    return paths


@pytest.mark.parametrize("num_shards", [1, 2])
def test_sharded_corpus_matches_jax(raws, tmp_path, corpus, num_shards):
    _, jv, tv = corpus
    shards = _shards(raws, tmp_path, corpus)
    manifest = str(tmp_path / "shards" / "corpus.manifest.json")
    packed.create_manifest(manifest, shards)
    for shard in range(num_shards):
        jc = jpacked.ShardedCorpus(manifest, jv, shard_index=shard,
                                   num_shards=num_shards)
        tc = packed.ShardedCorpus(manifest, tv, shard_index=shard,
                                  num_shards=num_shards)
        assert tc.num_rows_total == jc.num_rows_total
        assert tc.num_shard_files == jc.num_shard_files == 3
        assert tc.target_strings == jc.target_strings
        kw = dict(num_epochs=2, seed=7, yield_epoch_markers=True,
                  start_epoch=1, skip_rows=32)
        _assert_same_stream(tc.iter_batches(16, EstimatorAction.Train, **kw),
                            jc.iter_batches(16, JaxAction.Train, **kw))
        _assert_same_stream(
            tc.iter_batches(16, EstimatorAction.Evaluate,
                            with_target_strings=True),
            jc.iter_batches(16, JaxAction.Evaluate,
                            with_target_strings=True), with_strings=True)
        assert tc.steps_per_epoch(16, EstimatorAction.Train) == \
            jc.steps_per_epoch(16, JaxAction.Train)
    assert packed.ShardedCorpus.read_manifest_rows(manifest) == \
        jpacked.ShardedCorpus.read_manifest_rows(manifest)


def test_each_package_opens_the_others_files(raws, tmp_path, corpus):
    """A `.c2vb` and a manifest written by either package open in the
    other, with the same header, rows and target strings."""
    name, jv, tv = corpus
    path = name + ".val.c2vb"
    for mod, vocabs in ((jpacked, jv), (packed, tv)):
        ds = mod.PackedDataset(path, vocabs)
        assert (ds.num_rows_total, ds.max_contexts) == \
            packed.PackedDataset.read_header(path) == \
            jpacked.PackedDataset.read_header(path)
    shards = _shards(raws, tmp_path, corpus)
    for writer, reader_mod, vocabs in ((jpacked, packed, tv),
                                       (packed, jpacked, jv)):
        manifest = str(tmp_path / "shards" / f"{writer.__name__}.json")
        writer.create_manifest(manifest, shards)
        assert reader_mod.validate_manifest(manifest, vocabs) == \
            writer.validate_manifest(manifest)
        assert reader_mod.ShardedCorpus(manifest, vocabs).num_rows_total \
            == sum(packed.PackedDataset.read_header(s)[0] for s in shards)


# ------------------------------------------------ manifests, the command


def test_manifest_functions_match_jax(raws, tmp_path, corpus):
    """create, append, validate and their refusals, each package on its
    own copy of the same shards: the same manifest bytes and messages;
    relative paths survive moving the corpus directory."""
    shards = _shards(raws, tmp_path, corpus)
    other = str(tmp_path / "other.c2vb")
    packed.pack_c2v(raws["val"], Code2VecVocabs.from_words(["x"], ["y"],
                                                           ["z"]), 6,
                    out_path=other)
    results = {}
    for pkg, mod in (("jax", jpacked), ("port", packed)):
        d = tmp_path / pkg
        shutil.copytree(tmp_path / "shards", d)
        for suffix in ("", ".meta.json"):
            shutil.copy(other + suffix, str(d / "other.c2vb") + suffix)
        manifest = str(d / "c.manifest.json")
        mod.create_manifest(manifest, [str(d / "train.c2vb"),
                                       str(d / "val.c2vb")])
        mod.append_manifest_shard(manifest, str(d / "test.c2vb"))
        errors = []
        for bad in (str(d / "test.c2vb"), str(d / "other.c2vb")):
            with pytest.raises(ValueError) as e:
                mod.append_manifest_shard(manifest, bad)
            errors.append(str(e.value).replace(str(d), "{dir}"))
        moved = tmp_path / f"{pkg}-moved"
        shutil.move(str(d), str(moved))
        reports = mod.validate_manifest(str(moved / "c.manifest.json"))
        results[pkg] = (_read(str(moved / "c.manifest.json")), errors,
                        reports)
    assert results["port"] == results["jax"]
    assert [r["path"] for r in results["port"][2]] == \
        ["train.c2vb", "val.c2vb", "test.c2vb"]
    assert "mixed-vocab" in results["port"][1][1]


def _corpus_command(pkg, argv):
    """(exit code, log lines) of one package's `corpus` command."""
    logs = []
    if pkg == "jax":
        config = jcli.config_from_args(["corpus"] + argv)
        config.log = logs.append
        rc = jcli.corpus_main(config)
    else:
        _, config = cli.config_from_args(["corpus"] + argv)
        config.log = logs.append
        rc = cli.corpus_main(config)
    return rc, logs


def test_corpus_command_matches_jax(raws, tmp_path, corpus):
    """create, add, list, validate and a refused duplicate append through
    both packages' `corpus` command: the same exit codes and log lines."""
    _shards(raws, tmp_path, corpus)
    runs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        shutil.copytree(tmp_path / "shards", d)
        m = ["--train_corpus_manifest", str(d / "c.manifest.json")]
        steps = [m + ["--corpus_create",
                      f"{d / 'train.c2vb'},{d / 'val.c2vb'}"],
                 m + ["--corpus_add", str(d / "test.c2vb")],
                 m,
                 m + ["--corpus_validate"],
                 m + ["--corpus_add", str(d / "test.c2vb")]]
        runs[pkg] = [(rc, [line.replace(str(d), "{dir}") for line in logs])
                     for rc, logs in (_corpus_command(pkg, a) for a in steps)]
    assert runs["port"] == runs["jax"]
    assert [rc for rc, _ in runs["port"]] == [0, 0, 0, 0, 1]
    with pytest.raises(SystemExit):
        cli.config_from_args(["corpus"])
    with open(tmp_path / "port" / "c.manifest.json") as f:
        assert len(json.load(f)["shards"]) == 3
