"""The port's binding to the native data core (code2vec_tpu_torch/data/
native.py over cpp/build/libc2vdata.so) against its own Python parse,
pack and histogram, and against the JAX package's binding.

Mirrors tests/test_native_dataloader.py. Every comparison is exact: the
native core and the Python loop implement one parse (an empty field is
PAD, an unknown word OOV, a context valid iff any part is not PAD).
`ensure_cpp_built` is the build every port test that needs cpp/build
goes through: it holds an fcntl lock on a file under cpp/build/ around
`make`, so concurrent test workers never run two builds at once, and
checks that the library loads before a test uses it.
"""

import ctypes
import fcntl
import os
import subprocess

import numpy as np
import pytest

from code2vec_tpu.data import native as jnative
from code2vec_tpu.data import packed as jpacked
from code2vec_tpu.data import preprocess as jpp
from code2vec_tpu.vocab import Code2VecVocabs as JaxVocabs
from code2vec_tpu.vocab import Vocab as JaxVocab
from code2vec_tpu.vocab import VocabType as JaxVocabType
from code2vec_tpu.vocab import special_words_for as jax_special
from code2vec_tpu_torch.data import native, packed
from code2vec_tpu_torch.data import preprocess as pp
from code2vec_tpu_torch.data import reader
from code2vec_tpu_torch.vocab import Code2VecVocabs

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP = os.path.join(REPO, "cpp")
BUILD = os.path.join(CPP, "build")
BINARIES = ("c2v-extract", "c2v-extract-cs", "libc2vdata.so")

TOKENS = ["foo", "bar", "baz", "n"]
PATHS = ["111", "222", "-333"]
TARGETS = ["get|x", "set|y"]

LINES = [
    "get|x foo,111,bar bar,222,baz n,-333,foo",
    "set|y foo,111,foo",
    "unknown|target foo,111,bar",          # OOV target
    "get|x zzz,999,qqq",                   # all-OOV context: still valid
    "get|x ,,",                            # all-empty context: invalid
    "get|x",                               # no contexts at all
    "",                                    # empty line
    "get|x foo,111,bar  bar,222,baz",      # double space: empty field
    "get|x malformed_no_commas",
    "get|x a,b,c,d,e extra,222,parts",     # > 3 comma parts
    "set|y foo,111,bar\n",                 # trailing newline kept
    "\n",                                  # blank line (still a row)
]
FIELDS = ("source_token_indices", "path_indices", "target_token_indices",
          "context_valid_mask", "target_index", "example_valid")


def ensure_cpp_built():
    """Build cpp/ under an exclusive lock on cpp/build/.build.lock (a
    no-op where it is up to date), reprobe the port's binding, and check
    that a complete library and extractors exist; skip where no compiler
    can build them."""
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            r = subprocess.run(["make", "-C", CPP, "-j4"],
                               capture_output=True, text=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if r.returncode != 0:
        pytest.skip(f"cannot build cpp/ here: {r.stderr[-500:]}")
    for name in BINARIES:
        path = os.path.join(BUILD, name)
        assert os.path.isfile(path) and os.access(path, os.X_OK), path
    ctypes.CDLL(os.path.join(BUILD, "libc2vdata.so"))
    native._lib_checked = False
    jnative._lib_checked = False
    assert native.load_library() is not None


@pytest.fixture(scope="module", autouse=True)
def built():
    ensure_cpp_built()


def vocab_pair(tokens=TOKENS, paths=PATHS, targets=TARGETS):
    """The same vocabularies in both packages."""
    def jax_vocab(vocab_type, words):
        return JaxVocab(vocab_type, words, jax_special(vocab_type, False))
    jv = JaxVocabs(jax_vocab(JaxVocabType.Token, tokens),
                   jax_vocab(JaxVocabType.Path, paths),
                   jax_vocab(JaxVocabType.Target, targets))
    return jv, Code2VecVocabs.from_words(tokens, paths, targets)


def python_only(monkeypatch):
    """Take the port's (and the JAX package's) Python paths, in this
    process and in the pack workers it starts (both bindings read the
    library's path from C2V_NATIVE_DATALOADER)."""
    monkeypatch.setenv("C2V_NATIVE_DATALOADER",
                       os.path.join(BUILD, "absent", "libc2vdata.so"))
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_lib_checked", True)


def _fuzz_lines(n, seed):
    rng = np.random.default_rng(seed)
    tokens = TOKENS + ["zzz", ""]
    paths = PATHS + ["999", ""]
    targets = TARGETS + ["nope", ""]
    lines = []
    for _ in range(n):
        parts = [str(rng.choice(targets))]
        for _ in range(int(rng.integers(0, 8))):
            parts.append(",".join([str(rng.choice(tokens)),
                                   str(rng.choice(paths)),
                                   str(rng.choice(tokens))]))
        lines.append(" ".join(parts))
    return lines


@pytest.mark.parametrize("case", ["fields", "fuzz"])
def test_parse_lines_matches_python(case, monkeypatch):
    _, vocabs = vocab_pair()
    lines = LINES if case == "fields" else _fuzz_lines(300, 0)
    m = 4 if case == "fields" else 5
    nat = reader.parse_context_lines(lines, vocabs, m, keep_strings=False,
                                     with_target_strings=True)
    python_only(monkeypatch)
    py = reader.parse_context_lines(lines, vocabs, m, keep_strings=False,
                                    with_target_strings=True)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(nat, name), getattr(py, name),
                                      err_msg=name)
    assert nat.target_strings == py.target_strings


def test_parse_lines_takes_python_on_interior_newline():
    _, vocabs = vocab_pair()
    tables = native.tables_for(vocabs)
    assert tables.parse_lines(["get|x foo,111,bar\nset|y"], 4) is None


def test_parse_rows_and_from_tables_match_parse_blob():
    """The pack workers' tables (bytes -> id dicts, no vocab object) and
    the `.c2vb` row-layout parse against the vocab tables' array parse."""
    _, vocabs = vocab_pair()
    m = 4
    ref = native.NativeTables(vocabs)

    def b2i(vocab):
        return {w.encode(): i for w, i in vocab.word_to_index.items()}
    worker = native.NativeTables.from_tables(
        b2i(vocabs.token_vocab), b2i(vocabs.path_vocab),
        b2i(vocabs.target_vocab), token_pad=vocabs.token_vocab.pad_index,
        token_oov=vocabs.token_vocab.oov_index,
        path_pad=vocabs.path_vocab.pad_index,
        path_oov=vocabs.path_vocab.oov_index,
        target_oov=vocabs.target_vocab.oov_index)
    lines = [ln.rstrip("\n") for ln in LINES + _fuzz_lines(100, 1)]
    blob = ("\n".join(lines) + "\n").encode()
    src, pth, tgt, label, _ = ref.parse_blob(blob, len(lines), m)
    rec = worker.parse_rows_blob(blob, len(lines), m)
    np.testing.assert_array_equal(rec[:, 0], label)
    np.testing.assert_array_equal(rec[:, 1:1 + m], src)
    np.testing.assert_array_equal(rec[:, 1 + m:1 + 2 * m], pth)
    np.testing.assert_array_equal(rec[:, 1 + 2 * m:], tgt)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("lines", ["fields", "fuzz"])
def test_pack_file_matches_python_pack_and_jax(lines, tmp_path,
                                                monkeypatch):
    """`pack_c2v` by the native whole-file compile, by the Python chunk
    loop, and the JAX package's: the same `.c2vb`, `.targets` and
    `.meta.json` bytes."""
    jv, vocabs = vocab_pair()
    c2v = tmp_path / "data.c2v"
    text = LINES if lines == "fields" else _fuzz_lines(500, 2)
    c2v.write_text("\n".join(text) + "\n")
    outs = {"native": packed.pack_c2v(str(c2v), vocabs, 4,
                                      out_path=str(tmp_path / "n.c2vb")),
            "jax": jpacked.pack_c2v(str(c2v), jv, 4,
                                    out_path=str(tmp_path / "j.c2vb"))}
    python_only(monkeypatch)
    outs["python"] = packed.pack_c2v(str(c2v), vocabs, 4,
                                     out_path=str(tmp_path / "p.c2vb"))
    for suffix in ("", ".targets", ".meta.json"):
        want = _read(outs["jax"] + suffix)
        for route in ("native", "python"):
            assert _read(outs[route] + suffix) == want, (route, suffix)


def test_histogram_range_matches_python(tmp_path):
    """The native map step against the serial Python loop: every skip
    rule (empty names and fields, contexts of other than three pieces,
    an unterminated last line)."""
    raw = tmp_path / "raw.txt"
    raw.write_text(
        "get|x foo,111,bar foo,111,bar bar,222,baz\n"
        "\n"
        " t,1,t\n"
        "set|y  foo,111,foo ,, a,b\n"
        "get|x a,b,c,d e,111,f\n"
        "solo\n"
        "last f,222,g")
    serial = pp.build_histograms(str(raw))
    assert native.load_library() is not None
    for workers in (1, 2):
        assert tuple(pp.build_histograms(str(raw), num_workers=workers)) == \
            tuple(serial)
    assert tuple(serial) == tuple(jpp.build_histograms(str(raw)))
    outs = [str(tmp_path / n) for n in ("t", "p", "g")]
    native.histogram_range(str(raw), 0, os.path.getsize(raw), *outs)
    for out, want in zip(outs, serial):
        got = pp._read_count_dump(out)
        assert {k.decode(): v for k, v in got.items()} == dict(want)


def test_pack_raw_native_matches_python(tmp_path, monkeypatch):
    """The fused compile's worker core, native and Python, with the
    sampling tiers engaged: the same bytes, and the JAX package's."""
    jv, vocabs = vocab_pair(tokens=["foo", "bar", "baz", "n", "zzz"],
                            paths=["111", "222", "-333", "999"])
    raw = tmp_path / "raw.txt"
    rng = np.random.default_rng(3)
    with open(raw, "w") as f:
        for _ in range(200):
            ctxs = [",".join([str(rng.choice(["foo", "bar", "baz", "n",
                                               "zzz"])),
                              str(rng.choice(["111", "222", "-333", "999"])),
                              str(rng.choice(["foo", "bar", "q"]))])
                    for _ in range(int(rng.integers(1, 9)))]
            f.write(f"get|x {' '.join(ctxs)}\n")
    w2c = {"foo": 5, "bar": 4, "baz": 3, "n": 2}
    p2c = {"111": 5, "222": 4, "-333": 3}
    outs = {}
    for route in ("native", "python"):
        if route == "python":
            python_only(monkeypatch)
        outs[route] = str(tmp_path / f"{route}.c2vb")
        packed.pack_raw(str(raw), outs[route], vocabs, w2c, p2c, 4, seed=11,
                        num_workers=1)
    outs["jax"] = str(tmp_path / "jax.c2vb")
    jpacked.pack_raw(str(raw), outs["jax"], jv, w2c, p2c, 4, seed=11,
                     num_workers=1)
    for suffix in ("", ".targets", ".meta.json"):
        want = _read(outs["jax"] + suffix)
        assert _read(outs["native"] + suffix) == want, suffix
        assert _read(outs["python"] + suffix) == want, suffix
