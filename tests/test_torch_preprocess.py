"""The port's extraction and preprocessing command line
(code2vec_tpu_torch/data/preprocess.py) against the JAX package's, on the
CPU.

`extract_dir` over the native Java and C# extractors must write the raw
lines the JAX function writes for the same source tree, serially and
with parallel project workers (one extractor thread each: with more,
the extractor's own line order varies from run to run). The timeout,
retry and parallel cases of tests/test_preprocess_pipeline.py run
through a fake extractor that hangs or crashes on chosen files, and
both packages must skip, log and keep the same lines. `python -m code2vec_tpu_torch.data.preprocess` must
run from source directories and from raw files, serially and with
--preprocess_workers, and write the JAX command's files.
"""

import os
import stat
import subprocess
import sys

import pytest

from code2vec_tpu.data import preprocess as jpp
from code2vec_tpu_torch.data import preprocess as pp
from experiments import csgen, javagen

from test_torch_native import ensure_cpp_built

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = (("jax", jpp), ("port", pp))


@pytest.fixture(scope="module", autouse=True)
def built():
    ensure_cpp_built()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Small generated Java and C# corpora: role -> source directory."""
    root = tmp_path_factory.mktemp("src")
    sizes = dict(train_files=8, val_files=3, test_files=3,
                 files_per_project=3, log=lambda *a: None)
    return {"java": javagen.generate_corpus(str(root / "java"), **sizes),
            "csharp": csgen.generate_corpus(str(root / "cs"), **sizes)}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("language", ["java", "csharp"])
def test_extract_dir_matches_jax(trees, tmp_path, language, workers):
    out = {}
    for pkg, mod in PKGS:
        out[pkg] = str(tmp_path / f"{pkg}.raw.txt")
        mod.extract_dir(trees[language]["train"], out[pkg],
                        language=language, num_threads=1,
                        num_workers=workers, shuffle=True, seed=3,
                        log=lambda *a: None)
    got = _read(out["port"])
    assert got == _read(out["jax"])
    assert got.count(b"\n") >= 8


def _fake_extractor(tmp_path, dir_case):
    """A shell extractor that hangs on --dir (or on dirs named *bad*),
    hangs on *Hang.java, exits 9 on *Crash.java and prints one line for
    any other file."""
    fake = tmp_path / "fake-extract"
    fake.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        "  case $1 in\n"
        f"    --dir) {dir_case} shift;;\n"
        "    --file) case $2 in *Hang.java) sleep 30;; "
        "*Crash.java) exit 9;; *) echo \"m a,$2,b\";; esac; shift;;\n"
        "  esac\n"
        "  shift\n"
        "done\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    return str(fake)


def _tree(tmp_path, files):
    for rel in files:
        path = tmp_path / "tree" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("class X {}")
    return str(tmp_path / "tree")


@pytest.mark.parametrize("case", ["timeout", "crash", "parallel"])
def test_extraction_timeouts_and_retries_match_jax(tmp_path, case):
    """A hung whole-tree extraction is killed and retried per child; a
    hanging file is skipped, a crashing one skipped during the retry
    descent; parallel workers keep that protection. Both packages skip
    the same targets, keep the same lines and log the same lines."""
    if case == "parallel":
        fake = _fake_extractor(
            tmp_path, 'case $2 in *bad*) sleep 30;; *) echo "m a,$2,b";; '
                      'esac;')
        tree = _tree(tmp_path, ["good/A.java", "bad/Hang.java",
                                "bad/B.java"])
    else:
        fake = _fake_extractor(tmp_path, "sleep 30;")
        bad = "Hang.java" if case == "timeout" else "Crash.java"
        tree = _tree(tmp_path, ["proj/A.java", f"proj/{bad}",
                                "proj/B.java"])
    results = {}
    for pkg, mod in PKGS:
        logs = []
        out = tmp_path / f"{pkg}.txt"
        with open(out, "wb") as f:
            if case == "parallel":
                skipped = mod._extract_tree_parallel(
                    f, fake, "java", tree, 8, 2, 1, timeout=1.0,
                    num_workers=2, log=logs.append)
            else:
                skipped = mod._run_extractor_tree(
                    f, fake, "java", tree, 8, 2, 1, timeout=1.0,
                    log=logs.append)
        results[pkg] = (skipped, out.read_text(), logs)
    assert results["port"] == results["jax"]
    skipped, text, logs = results["port"]
    assert skipped == 1
    assert "Hang" not in text and "Crash" not in text
    assert "B.java" in text
    assert not list((tmp_path / "tree").glob("c2v_extract_*"))


def _cli(pkg, argv):
    mod = "code2vec_tpu" if pkg == "jax" else "code2vec_tpu_torch"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", f"{mod}.data.preprocess"]
                       + argv, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


@pytest.mark.parametrize("source,workers", [("dirs", 0), ("raws", 2)])
def test_preprocess_command_matches_jax(trees, tmp_path, source, workers):
    """`python -m ...data.preprocess` from source directories (serial,
    `.c2v` text) and from raw files (--preprocess_workers 2, `.c2vb`):
    the files the JAX command writes, byte for byte."""
    java = trees["java"]
    if source == "raws":
        inputs = []
        for role in ("train", "val", "test"):
            raw = str(tmp_path / f"{role}.raw.txt")
            pp.extract_dir(java[role], raw, num_threads=1,
                           log=lambda *a: None)
            inputs += [f"--{role}_raw", raw]
    else:
        inputs = [a for role in ("train", "val", "test")
                  for a in (f"--{role}_dir", java[role])]
    names = {}
    for pkg in ("jax", "port"):
        names[pkg] = str(tmp_path / pkg / "mini")
        _cli(pkg, inputs + ["--output_name", names[pkg], "--max_contexts",
                            "16", "--num_threads", "1",
                            "--preprocess_workers", str(workers)])
    suffixes = ((".c2v",) if workers == 0
                else (".c2vb", ".c2vb.targets", ".c2vb.meta.json"))
    for role in ("train", "val", "test"):
        for suffix in suffixes:
            got = _read(f"{names['port']}.{role}{suffix}")
            assert got == _read(f"{names['jax']}.{role}{suffix}"), \
                (role, suffix)
        assert got
    assert _read(names["port"] + ".dict.c2v") == \
        _read(names["jax"] + ".dict.c2v")


def test_preprocess_command_refuses_bad_arguments(tmp_path):
    with pytest.raises(SystemExit):
        pp.main(["--output_name", str(tmp_path / "x")])
    with pytest.raises(SystemExit):
        pp.main(["--output_name", str(tmp_path / "x"), "--train_dir", "a",
                 "--train_raw", "b", "--val_dir", "c", "--test_dir", "d"])
