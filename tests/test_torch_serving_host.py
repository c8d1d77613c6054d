"""The port's serving host path on the CPU against the JAX package's: the
warm extractor pool, the prediction cache, deadlines and admission, both
batchers, and the HTTP server's bodies, statuses and /metrics series.

A fake extractor (tests/test_serving.py's: a Python script speaking both
the one-shot `--file` CLI and the warm `--server` protocol, installed
through the C2V_NATIVE_EXTRACTOR hook) stands in for the C++ parser.
Markers in the "Java" source drive it: NCTX<n> (n contexts),
SLOW_MARKER (sleep), CRASH_ONCE / CRASH_ALWAYS (exit 137),
BOOM_ALWAYS (a parse rejection). Coalescing and riding are proven with a
gate (a threading.Event holding the device call while requests queue),
never with a short delay window. Bodies are held against the JAX
server's under tests/test_torch_server.py's tolerance (bf16: atol 2e-2,
rtol 1e-2; names and paths exact).
"""

import dataclasses
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from code2vec_tpu.obs import metrics as jmetrics
from code2vec_tpu.release import artifact as jart
from code2vec_tpu.release.runtime import ReleaseModel as JaxReleaseModel
from code2vec_tpu.serving import admission as jadmission
from code2vec_tpu.serving import batcher as jbatcher
from code2vec_tpu.serving import cache as jcache
from code2vec_tpu.serving.extractor_pool import ExtractorPool as JaxPool
from code2vec_tpu.serving.server import PredictionServer as JaxServer
from code2vec_tpu_torch import obs
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.release.runtime import ReleaseModel
from code2vec_tpu_torch.serving import admission, batcher, cache
from code2vec_tpu_torch.serving.extractor_bridge import ExtractorCrash
from code2vec_tpu_torch.serving.extractor_pool import ExtractorPool
from code2vec_tpu_torch.serving.server import PredictionServer

from test_torch_release import _tiny_jax_model
from test_torch_server import _close, _post

pytestmark = pytest.mark.torch_port

FAKE_EXTRACTOR = r'''#!/usr/bin/env python3
"""Fake c2v extractor: deterministic output derived from the source."""
import os, re, sys, time


def extract(src):
    if "SLOW_MARKER" in src:
        time.sleep(float(os.environ.get("C2V_FAKE_SLEEP", "1.0")))
    if "CRASH_ALWAYS" in src:
        os._exit(137)
    if "CRASH_ONCE" in src:
        stamp = os.environ.get("C2V_FAKE_STAMP", "")
        if stamp and not os.path.exists(stamp):
            open(stamp, "w").close()
            os._exit(137)  # looks like an OOM SIGKILL exit
    if "BOOM_ALWAYS" in src:
        raise ValueError("fake deterministic parse error")
    m = re.search(r"NCTX(\d+)", src)
    nctx = int(m.group(1)) if m else 3
    names = re.findall(r"(\w+)\s*\(", src) or ["m"]
    lines = []
    for name in names:
        ctxs = " ".join("tok%d,(P%d)^(Q)_(R%d),tok%d" % (i % 6, i, i, i % 6)
                        for i in range(nctx))
        lines.append("%s %s" % (name, ctxs))
    return lines


def main():
    argv = sys.argv[1:]
    if os.environ.get("C2V_FAKE_NO_SERVER") and "--server" in argv:
        sys.stderr.write("unknown flag: --server\n")
        sys.exit(2)
    if "--server" not in argv:
        path = argv[argv.index("--file") + 1]
        try:
            with open(path) as f:
                lines = extract(f.read())
        except ValueError as e:
            sys.stderr.write(str(e) + "\n")
            sys.exit(1)
        sys.stdout.write("".join(l + "\n" for l in lines))
        return
    out = sys.stdout
    out.write("READY\n")
    out.flush()
    stdin = sys.stdin.buffer
    while True:
        header = stdin.readline()
        if not header:
            return
        header = header.decode().strip()
        try:
            if header.startswith("FILE "):
                with open(header[5:]) as f:
                    src = f.read()
            elif header.startswith("SRC "):
                n = int(header[4:])
                src = stdin.read(n).decode()
                stdin.readline()  # frame terminator
            elif not header:
                continue
            else:
                raise ValueError("bad request: " + header)
            lines = extract(src)
        except ValueError as e:
            out.write("ERR %s\n" % e)
            out.flush()
            continue
        out.write("OK %d\n" % len(lines))
        for l in lines:
            out.write(l + "\n")
        out.flush()


if __name__ == "__main__":
    main()
'''

SOURCE = ("class A { int alpha(int n) { return n; } "
          "void beta() { } NCTX7 }")


def _install_fake(directory, mp):
    fake = directory / "fake-c2v-extract"
    fake.write_text(FAKE_EXTRACTOR)
    fake.chmod(0o755)
    mp.setenv("C2V_NATIVE_EXTRACTOR", str(fake))
    mp.delenv("C2V_FAKE_NO_SERVER", raising=False)
    return str(fake)


@pytest.fixture()
def fake_extractor(tmp_path, monkeypatch):
    return _install_fake(tmp_path, monkeypatch)


def _config(**kw):
    return Config(**{"max_contexts": 16, "device": "cpu", "verbose_mode": 0,
                     "extractor_pool_size": 1, **kw})


def _value(registry, name, **labels):
    key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
    child = registry.collect().get(name, {}).get(key)
    return 0.0 if child is None else child.value


def _port_value(name, **labels):
    return _value(obs.default_registry(), name, **labels)


# ------------------------------------------------------------------- pool


def test_pool_warm_extract_matches_reference_pool(fake_extractor, tmp_path):
    src = "class A { int f(int n) { return n; } int g() { } } NCTX2"
    with ExtractorPool(_config(), size=2) as pool, \
            JaxPool(_config_jax(), size=1) as jpool:
        assert pool.warm and jpool.warm
        phases = {}
        got = pool.extract_source(src, phases=phases)
        assert got == jpool.extract_source(src)
        lines, h2s = got
        assert [ln.split(" ")[0] for ln in lines] == ["f", "g"]
        w1, hashed, w2 = lines[0].split(" ")[1].split(",")
        assert h2s[hashed] == "(P0)^(Q)_(R0)"
        assert len(lines[0]) - len(lines[0].rstrip()) == 16 - 2
        assert phases["queue_wait"] >= 0 and phases["extract"] > 0
        # the same resident workers answer a file
        pids = {w.proc.pid for w in pool._idle}
        java = tmp_path / "Second.java"
        java.write_text("class B { int h() { return 2; } }")
        assert pool.extract_file(str(java))[0][0].split(" ")[0] == "h"
        assert {w.proc.pid for w in pool._idle} == pids


def _config_jax():
    from code2vec_tpu.config import Config as JaxConfig
    return JaxConfig(max_contexts=16, verbose_mode=0)


def test_pool_cold_fallback_without_server_mode(fake_extractor,
                                                monkeypatch):
    monkeypatch.setenv("C2V_FAKE_NO_SERVER", "1")
    with ExtractorPool(_config(), size=1) as pool:
        assert not pool.warm
        lines, _ = pool.extract_source("class A { int g() { return 1; } }")
        assert lines[0].split(" ")[0] == "g"
        # a cold slot's rejection is a ValueError too
        with pytest.raises(ValueError, match="deterministic parse error"):
            pool.extract_source("BOOM_ALWAYS")


def test_pool_requeues_a_crashed_worker_counted_once(fake_extractor,
                                                     tmp_path, monkeypatch):
    stamp = tmp_path / "crash-stamp"
    monkeypatch.setenv("C2V_FAKE_STAMP", str(stamp))
    yes = _port_value("extractor_failures_total", retried="yes")
    no = _port_value("extractor_failures_total", retried="no")
    requeues = _port_value("extractor_pool_requeues_total")
    with ExtractorPool(_config(), size=1) as pool:
        lines, _ = pool.extract_source(
            "class A { int h() { return 1; } } CRASH_ONCE")
        assert lines[0].split(" ")[0] == "h" and stamp.exists()
        assert len(pool._idle) == 1 and pool._idle[0].alive
    assert _port_value("extractor_failures_total", retried="yes") == yes + 1
    assert _port_value("extractor_failures_total", retried="no") == no
    assert _port_value("extractor_pool_requeues_total") == requeues + 1


def test_pool_crash_exhausts_retries(fake_extractor):
    no = _port_value("extractor_failures_total", retried="no")
    yes = _port_value("extractor_failures_total", retried="yes")
    with ExtractorPool(_config(extractor_retries=1), size=1) as pool:
        with pytest.raises(ExtractorCrash):
            pool.extract_source("class A { int h() { } } CRASH_ALWAYS")
        assert pool._idle[0].alive   # replaced, capacity kept
    assert _port_value("extractor_failures_total", retried="no") == no + 1
    assert _port_value("extractor_failures_total", retried="yes") == yes + 1


def test_pool_err_frame_is_not_retried(fake_extractor):
    requeues = _port_value("extractor_pool_requeues_total")
    no = _port_value("extractor_failures_total", retried="no")
    with ExtractorPool(_config(), size=1) as pool:
        pid = pool._idle[0].proc.pid
        with pytest.raises(ValueError, match="deterministic parse error"):
            pool.extract_source("BOOM_ALWAYS")
        assert pool._idle[0].alive and pool._idle[0].proc.pid == pid
    assert _port_value("extractor_pool_requeues_total") == requeues
    assert _port_value("extractor_failures_total", retried="no") == no + 1


def test_pool_deadline_kills_the_worker_as_a_504(fake_extractor):
    expired = _port_value("serving_requests_expired_total", stage="extract")
    with ExtractorPool(_config(), size=1) as pool:
        pid = pool._idle[0].proc.pid
        with pytest.raises(admission.DeadlineExceeded):
            pool.extract_source("class S { void s() { } } SLOW_MARKER",
                                deadline=admission.Deadline(0.2))
        with pytest.raises(admission.DeadlineExceeded):
            pool.extract_source("class S { }",
                                deadline=admission.Deadline(1e-9))
        assert pool._idle[0].alive and pool._idle[0].proc.pid != pid
    assert _port_value("serving_requests_expired_total",
                       stage="extract") == expired + 2


# ------------------------------------------------------ cache, admission


@pytest.mark.parametrize("source,knobs", [
    (SOURCE, dict(endpoint="predict", topk=10, model="artifact:0123")),
    ("  class  B {\n\tint f() { return 1; }\n}  ", dict(
        endpoint="neighbors", topk=10, model="ckpt:/x@step3#p9", k=64,
        nprobe=None, index="emb:abc")),
    ("", {}), ("x", dict(endpoint="embed", topk=100, model="m"))])
def test_cache_key_matches_reference(source, knobs):
    assert cache.normalize_source(source) == jcache.normalize_source(source)
    assert cache.cache_key(source, **knobs) == \
        jcache.cache_key(source, **knobs)
    assert cache.cache_key(source + "\n  ", **knobs) == \
        cache.cache_key(source, **knobs)


def test_cache_lru_eviction():
    ev = _port_value("serving_cache_evictions_total")
    lru = cache.PredictionCache(capacity=2)
    k = [cache.cache_key(f"code{i}") for i in range(3)]
    lru.put(k[0], b"0")
    lru.put(k[1], b"1")
    assert lru.get(k[0]) == b"0"   # k[1] is now the least recent
    lru.put(k[2], b"2")
    assert lru.get(k[1]) is None
    assert lru.get(k[0]) == b"0" and lru.get(k[2]) == b"2"
    assert len(lru) == 2
    assert _port_value("serving_cache_evictions_total") == ev + 1
    off = cache.PredictionCache(capacity=0)
    off.put(k[0], b"x")
    assert off.get(k[0]) is None and len(off) == 0


@pytest.mark.parametrize("default_ms,max_ms,header", [
    (2000.0, 30000.0, None), (2000.0, 30000.0, "250"),
    (2000.0, 30000.0, "99999999"), (2000.0, 30000.0, "nope"),
    (2000.0, 30000.0, "-5"), (0.0, 0.0, None), (0.0, 500.0, None),
    (0.0, 500.0, "100")])
def test_deadline_from_request_matches_reference(default_ms, max_ms,
                                                 header):
    cfg = Config(serve_deadline_ms=default_ms, serve_deadline_max_ms=max_ms)
    got = admission.deadline_from_request(cfg, header)
    want = jadmission.deadline_from_request(cfg, header)
    assert got.budget_s == want.budget_s
    assert got.bounded == want.bounded


def test_admission_sheds_like_reference():
    """The same admit/finish sequence through both gates: the same
    depths, estimates and shed reasons."""
    port = admission.AdmissionController(max_depth=2, concurrency=2)
    ref = jadmission.AdmissionController(max_depth=2, concurrency=2)

    def outcome(gate, module, budget):
        try:
            gate.admit(None if budget is None else module.Deadline(budget))
            return "admitted"
        except module.Shed as e:
            assert e.retry_after_s >= 1.0
            return e.reason

    steps = [("admit", None), ("admit", None), ("admit", None),
             ("finish", 0.4), ("admit", 0.05), ("finish", 0.2),
             ("finish", -1.0), ("admit", 10.0), ("admit", 10.0),
             ("admit", 10.0)]
    for op, arg in steps:
        if op == "admit":
            assert outcome(port, admission, arg) == \
                outcome(ref, jadmission, arg)
        else:
            port.finish(arg)
            ref.finish(arg)
        assert port.depth == ref.depth
        assert port.estimated_wait_s() == ref.estimated_wait_s()
    assert admission.retry_after_seconds(1.0) in (1, 2)
    assert admission.retry_after_seconds(3.2, 0.0) == 4


# --------------------------------------------------------------- batchers


class _Gate:
    """A predict_fn whose calls block until `release` is set; `entered`
    is set by the first call that reaches the device."""

    def __init__(self, fn=lambda lines: [f"r:{ln}" for ln in lines]):
        self.fn = fn
        self.calls = []
        self.entered = threading.Event()
        self.release = threading.Event()

    def __call__(self, lines):
        self.calls.append(list(lines))
        self.entered.set()
        assert self.release.wait(30), "the gate was never released"
        return self.fn(lines)


def _wait_for(cond, timeout=30.0):
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, "condition never held"
        time.sleep(0.002)


def test_dynamic_batcher_coalesces_behind_a_gate():
    """Request 1 is on the device; 2-4 queue behind it and ride ONE
    batch when it returns."""
    gate = _Gate()
    b = batcher.DynamicBatcher(gate, max_batch_rows=8, max_delay_s=0.0)
    try:
        f1 = b.submit(["a"])
        assert gate.entered.wait(30)
        rest = [b.submit([f"b{i}"]) for i in range(3)]
        _wait_for(lambda: b._pending_rows == 3)
        gate.release.set()
        assert f1.result(timeout=30) == ["r:a"]
        assert [f.result(timeout=30) for f in rest] == \
            [["r:b0"], ["r:b1"], ["r:b2"]]
        assert gate.calls == [["a"], ["b0", "b1", "b2"]]
        assert b.batches_dispatched == 2
    finally:
        gate.release.set()
        b.drain()


def test_dynamic_batcher_order_errors_and_drain():
    b = batcher.DynamicBatcher(lambda lines: [ln.upper() for ln in lines],
                               max_batch_rows=3, max_delay_s=60.0)
    # three rows fill the batch: dispatched at once, results in order
    futures = [b.submit(["a", "b"]), b.submit(["c"])]
    assert [f.result(timeout=30) for f in futures] == [["A", "B"], ["C"]]
    assert b.submit([]).result(timeout=1) == []
    b.drain()
    with pytest.raises(RuntimeError, match="draining"):
        b.submit(["z"]).result(timeout=5)

    def boom(lines):
        raise RuntimeError("device on fire")

    b = batcher.DynamicBatcher(boom, max_batch_rows=1, max_delay_s=0.0)
    with pytest.raises(RuntimeError, match="device on fire"):
        b.submit(["x"]).result(timeout=30)
    b.drain()


def test_dynamic_batcher_drain_flushes_pending():
    b = batcher.DynamicBatcher(lambda lines: [ln * 2 for ln in lines],
                               max_batch_rows=100, max_delay_s=60.0)
    f = b.submit(["q"])
    b.drain(timeout=30)
    assert f.result(timeout=1) == ["qq"]


def test_batcher_deadlines():
    """An expired request settles as 504 before batching; one whose
    budget is below its bucket's p95 is refused as a 503 shed."""
    b = batcher.DynamicBatcher(lambda lines: list(lines), max_batch_rows=4,
                               max_delay_s=0.0, buckets=(4, 8, 16))
    try:
        with pytest.raises(admission.DeadlineExceeded):
            b.submit(["m a,b,c"],
                     deadline=admission.Deadline(1e-9)).result(timeout=5)
        for _ in range(4):
            b.device_times.record(4, 0.5)
        with pytest.raises(admission.DeadlineInfeasible):
            b.submit(["m a,b,c"],
                     deadline=admission.Deadline(0.3)).result(timeout=5)
        assert b.submit(["m a,b,c"], deadline=admission.Deadline(
            30.0)).result(timeout=30) == ["m a,b,c"]
    finally:
        b.drain()


def test_device_time_tracker_p95_matches_reference():
    port, ref = batcher._DeviceTimeTracker(), jbatcher._DeviceTimeTracker()
    for t in (port, ref):
        assert t.p95(7) is None
        for v in (0.4, 0.1, 0.3, 0.2, 0.05, 0.9, 0.33):
            t.record(7, v)
    assert port.p95(7) == ref.p95(7) == 0.9
    cached = port._sorted[7]
    assert port.p95(7) == 0.9 and port._sorted[7] is cached
    port.record(7, 0.01)
    assert 7 not in port._sorted


def test_continuous_row_rides_step_n_plus_1():
    """A row admitted while step N is on the device rides step N+1 the
    moment the worker frees, not a fresh delay window (60 s here)."""
    gate = _Gate(lambda lines: [ln.upper() for ln in lines])
    b = batcher.ContinuousBatcher(gate, max_batch_rows=4, max_delay_s=60.0,
                                  inflight_steps=1)
    try:
        f1 = b.submit(["a1", "a2", "a3", "a4"])   # a full slot: step N
        assert gate.entered.wait(30)
        f2 = b.submit(["b"])                      # admitted mid-step-N
        assert b.rides == 1
        gate.release.set()
        assert f1.result(timeout=30) == ["A1", "A2", "A3", "A4"]
        assert f2.result(timeout=30) == ["B"]
        assert gate.calls == [["a1", "a2", "a3", "a4"], ["b"]]
        assert b.batches_dispatched == 2
    finally:
        gate.release.set()
        b.drain()


def test_continuous_refusal_against_inflight_eta():
    gate = _Gate(lambda lines: list(lines))
    b = batcher.ContinuousBatcher(gate, max_batch_rows=1, max_delay_s=0.0,
                                  inflight_steps=1)
    try:
        for _ in range(4):
            b.device_times.record(None, 5.0)   # p95 5 s
        f1 = b.submit(["x"])
        assert gate.entered.wait(30)
        _wait_for(lambda: b._inflight == 1)
        # 8 s covers the p95 alone, but the in-flight step is expected
        # to hold the only worker until 5 s after its launch: refused
        # while eta + p95 (10 s less the time since the launch) is above
        # the budget
        f2 = b.submit(["y"], deadline=admission.Deadline(8.0))
        with pytest.raises(admission.DeadlineInfeasible):
            f2.result(timeout=30)
        gate.release.set()
        assert f1.result(timeout=30) == ["x"]
        _wait_for(lambda: b._inflight == 0)
        # the worker is free: eta 0, and the same budget is feasible
        f3 = b.submit(["z"], deadline=admission.Deadline(8.0))
        assert f3.result(timeout=30) == ["z"]
    finally:
        gate.release.set()
        b.drain()


def test_continuous_drain_flushes_partial_slot():
    b = batcher.ContinuousBatcher(lambda lines: [ln * 2 for ln in lines],
                                  max_batch_rows=100, max_delay_s=60.0)
    f = b.submit(["q"])
    b.drain(timeout=30)
    assert f.result(timeout=1) == ["qq"]
    with pytest.raises(RuntimeError, match="draining"):
        b.submit(["z"]).result(timeout=5)


def test_continuous_stale_parse_falls_back_to_lines():
    calls = {"rows": 0, "lines": 0}

    class _Buf:
        def __init__(self, rows):
            self.context_valid_mask = np.zeros((rows, 4), np.float32)
            self.example_valid = np.zeros((rows,), bool)

    class _Backend:
        def supports_rows(self):
            return True

        def alloc(self, rows):
            return _Buf(rows)

        def parse_into(self, lines, buffer, row_offset):
            return "fpOLD"

        def predict_rows(self, buffer, n_rows, fingerprint):
            calls["rows"] += 1
            raise batcher.StaleParse("parsed under another model")

        def predict_lines(self, lines):
            calls["lines"] += 1
            return [f"fpNEW:{ln}" for ln in lines]

    b = batcher.ContinuousBatcher(max_batch_rows=2, max_delay_s=60.0,
                                  backend=_Backend(), inflight_steps=1)
    try:
        futures = [b.submit([f"l{i}"]) for i in range(2)]   # one full slot
        assert [f.result(timeout=30) for f in futures] == \
            [["fpNEW:l0"], ["fpNEW:l1"]]
    finally:
        b.drain(timeout=30)
    assert calls == {"rows": 1, "lines": 1}


@pytest.mark.parametrize("spec,max_contexts,cp", [
    ("32,64,128", 200, 1), ("8,8,300", 200, 1), ("", 200, 1),
    ("30,32,64", 200, 4), ([4, 16, 2], 16, 1), (" 4, 8 ,", 16, 2)])
def test_parse_buckets_matches_reference(spec, max_contexts, cp):
    got = batcher.parse_buckets(spec, max_contexts, cp=cp)
    assert got == jbatcher.parse_buckets(spec, max_contexts, cp=cp)
    for n in range(1, max_contexts + 1):
        assert batcher.bucket_for(n, got) == jbatcher.bucket_for(n, got)


# ------------------------------------------------------------- the server


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The JAX server and the port's two (dynamic, continuous) over one
    artifact, on a warm fake extractor."""
    tmp = tmp_path_factory.mktemp("serving-host")
    mp = pytest.MonkeyPatch()
    _install_fake(tmp, mp)
    jax_model = _tiny_jax_model(tmp)
    art = str(tmp / "artifact")
    jart.export_artifact(jax_model, art, aot=False, log=lambda m: None)
    jcfg = dataclasses.replace(jax_model.config, train_data_path_prefix=None,
                               serve_artifact=art, extractor_pool_size=1)
    jrm = JaxReleaseModel(jcfg, log=lambda m: None)
    jrm.warmup()
    jserver = JaxServer(jrm, jcfg, log=lambda m: None)
    cfg = Config(serve_artifact=art, serve_batch_size=4, device="cpu",
                 serve_max_delay_ms=2.0, verbose_mode=0,
                 extractor_pool_size=1)
    model = ReleaseModel(cfg)
    model.warmup()
    dyn = PredictionServer(model)
    cont = PredictionServer(model, dataclasses.replace(
        cfg, serve_continuous=True, serve_inflight_steps=2))
    urls = {name: f"http://127.0.0.1:{s.start(port=0)}"
            for name, s in (("dynamic", dyn), ("continuous", cont))}
    yield dict(jax=jserver, jax_model=jrm, model=model, dynamic=dyn,
               continuous=cont, urls=urls, art=art, cfg=cfg, jcfg=jcfg)
    dyn.shutdown()
    cont.shutdown()
    jserver.drain(timeout=10)
    mp.undo()


def test_servers_come_up_warm(servers):
    assert servers["dynamic"].pool.warm and servers["continuous"].pool.warm
    assert isinstance(servers["continuous"].batcher,
                      batcher.ContinuousBatcher)
    assert isinstance(servers["dynamic"].batcher, batcher.DynamicBatcher)
    with urllib.request.urlopen(servers["urls"]["continuous"] + "/healthz",
                                timeout=30) as r:
        hz = json.loads(r.read())
    assert hz["extractor_pool"] == {"size": 1, "warm": True}
    assert hz["batcher"]["continuous"] is True
    assert hz["cache"]["capacity"] == 4096
    assert hz["admission"]["max_depth"] == 64
    assert hz["deadlines"] == {"default_ms": 2000.0, "max_ms": 30000.0}
    assert hz["buckets"] == [4, 8, 16]
    assert hz["model_fingerprint"] == servers["jax"].model_fingerprint
    want = servers["jax"].healthz()
    for key in ("extractor_pool", "cache", "admission", "deadlines"):
        assert sorted(hz[key]) == sorted(want[key]), key
    assert hz["buckets"] == want["buckets"]
    assert sorted(want["batcher"]) == sorted(hz["batcher"])


@pytest.mark.parametrize("which", ["dynamic", "continuous"])
@pytest.mark.parametrize("endpoint", ["predict", "embed"])
def test_http_bodies_match_jax_server(servers, which, endpoint):
    source = SOURCE.replace("NCTX7", f"NCTX7 {which}")
    want = json.loads(servers["jax"].handle(endpoint, source))
    status, body = _post(f"{servers['urls'][which]}/{endpoint}", source)
    assert status == 200, body
    got = json.loads(body)
    _close(got, want)
    if endpoint == "predict":
        assert [m["original_name"] for m in got["methods"]] == \
            ["alpha", "beta"]
        assert len(got["methods"][0]["attention_paths"]) == 7
        assert got["methods"][0]["attention_paths"][0]["path"] \
            .startswith("(P")


def test_serial_client_byte_identical_between_batchers(servers):
    """A serial client: the continuous batcher's slot path answers byte
    for byte what the dynamic batcher's lines path answers."""
    cont = servers["continuous"]
    lines_calls = []
    orig = cont._batched_predict
    cont._batched_predict = lambda lines: lines_calls.append(1) or \
        orig(lines)
    try:
        before = cont.batcher.batches_dispatched
        codes = ["class A { int f(int n) { return n; } } NCTX2 serial",
                 "class B { int g() { } int h() { } NCTX5 } serial",
                 "class C { void noop() { } } NCTX1 serial"]
        for endpoint in ("predict", "embed"):
            for code in codes:
                s1, b1, _ = servers["dynamic"].handle_request(endpoint, code)
                s2, b2, _ = cont.handle_request(endpoint, code)
                assert (s1, s2) == (200, 200)
                assert b1 == b2, (endpoint, code)
        assert cont.batcher.batches_dispatched - before == 2 * len(codes)
        assert not lines_calls, "a slot fell back to the lines path"
    finally:
        cont._batched_predict = orig


def test_http_coalesces_behind_a_gate(servers):
    """One request holds the device; three more queue and ride one
    batch."""
    dyn = servers["dynamic"]
    url = servers["urls"]["dynamic"]
    gate = _Gate(dyn.batcher.predict_fn)
    orig = dyn.batcher.predict_fn
    dyn.batcher.predict_fn = gate
    results = {}

    def post(i):
        results[i] = _post(f"{url}/predict",
                           f"class G{i} {{ int g{i}() {{ }} NCTX{i + 2} }}")

    threads = [threading.Thread(target=post, args=(0,))]
    try:
        threads[0].start()
        assert gate.entered.wait(30)
        before = dyn.batcher.batches_dispatched
        threads += [threading.Thread(target=post, args=(i,))
                    for i in (1, 2, 3)]
        for t in threads[1:]:
            t.start()
        _wait_for(lambda: dyn.batcher._pending_rows == 3)
        gate.release.set()
        for t in threads:
            t.join(60)
    finally:
        gate.release.set()
        dyn.batcher.predict_fn = orig
    assert [results[i][0] for i in range(4)] == [200] * 4
    for i in range(4):
        assert json.loads(results[i][1])["methods"][0]["original_name"] \
            == f"g{i}"
    assert dyn.batcher.batches_dispatched - before == 1
    assert [len(c) for c in gate.calls] == [1, 3]


def test_cache_hit_is_byte_equal_to_its_miss(servers):
    url = servers["urls"]["dynamic"]
    code = "class B { int mul(int a, int b) { return a * b; } } NCTX4"
    hits = _port_value("serving_cache_hits_total")
    misses = _port_value("serving_cache_misses_total")
    status, first = _post(f"{url}/predict", code)
    assert status == 200
    again = _post(f"{url}/predict", code)
    reindented = _post(f"{url}/predict",
                       code.replace("{ ", "{\n    ").replace("; ", ";\n"))
    assert again == (200, first) and reindented == (200, first)
    assert _port_value("serving_cache_hits_total") == hits + 2
    assert _port_value("serving_cache_misses_total") == misses + 1
    status, edited = _post(f"{url}/predict", code.replace("NCTX4", "NCTX5"))
    assert status == 200 and edited != first
    # /embed of the same source is another key
    assert _post(f"{url}/embed", code)[1] != first


def _shed_scenario(server, handle, gate_holder, code_a, code_b):
    """Request A holds the device call behind a gate (admitted, depth 1);
    request B arrives at a full queue."""
    gate = _Gate(gate_holder.predict_fn)
    orig = gate_holder.predict_fn
    gate_holder.predict_fn = gate
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "a", handle("predict", code_a)))
    try:
        t.start()
        assert gate.entered.wait(30)
        out["b"] = handle("predict", code_b)
    finally:
        gate.release.set()
        t.join(60)
        gate_holder.predict_fn = orig
    return out["a"], out["b"]


def test_full_queue_sheds_503_like_reference(servers):
    cfg = dataclasses.replace(servers["cfg"], serve_queue_depth=1)
    port = PredictionServer(servers["model"], cfg)
    jcfg = dataclasses.replace(servers["jcfg"], serve_queue_depth=1)
    ref = JaxServer(servers["jax_model"], jcfg, log=lambda m: None)
    shed = _port_value("serving_requests_shed_total", reason="queue_full")
    try:
        got = _shed_scenario(port, port.handle_request, port.batcher,
                             "class Q { int q1() { } }",
                             "class Q { int q2() { } }")
        want = _shed_scenario(ref, ref.handle_request, ref.batcher,
                              "class Q { int q1() { } }",
                              "class Q { int q2() { } }")
    finally:
        port.shutdown()
        ref.drain(timeout=10)
    (sa, _, _), (sb, body, headers) = got
    (jsa, _, _), (jsb, jbody, jheaders) = want
    assert (sa, sb) == (jsa, jsb) == (200, 503)
    assert sorted(headers) == sorted(jheaders) == \
        ["Retry-After", "X-Trace-Id", "traceparent"]
    assert int(headers["Retry-After"]) in (1, 2)
    assert int(jheaders["Retry-After"]) in (1, 2)
    body, jbody = json.loads(body), json.loads(jbody)
    assert sorted(body) == sorted(jbody) == ["error", "shed", "trace_id"]
    assert body["shed"] == jbody["shed"] == "queue_full"
    assert body["trace_id"] == headers["X-Trace-Id"]
    assert _port_value("serving_requests_shed_total",
                       reason="queue_full") == shed + 1


def test_expired_deadline_is_504_like_reference(servers):
    """A 200 ms budget against a 1 s extraction: the pool kills the
    worker at the deadline and the request answers 504, over HTTP with
    the X-Deadline-Ms header as in process with the reference."""
    code = "class S { void slow() { } } SLOW_MARKER"
    req = urllib.request.Request(
        f"{servers['urls']['dynamic']}/predict", data=code.encode(),
        method="POST", headers={"Content-Type": "text/plain",
                                "X-Deadline-Ms": "200"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    status, headers = e.value.code, dict(e.value.headers)
    body = json.loads(e.value.read())
    jstatus, jbody, jheaders = servers["jax"].handle_request(
        "predict", code, deadline=jadmission.Deadline(0.2))
    assert status == jstatus == 504
    assert "Retry-After" not in headers and "Retry-After" not in jheaders
    assert "X-Trace-Id" in headers and "traceparent" in headers
    assert sorted(body) == sorted(json.loads(jbody)) == ["error", "trace_id"]
    assert body["error"].startswith("deadline exceeded")


def test_trace_headers_and_debug_tree(servers):
    url = servers["urls"]["dynamic"]
    parent = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    for body, want in (("class T { int t() { } }", 200), ("   ", 400),
                       ("BOOM_ALWAYS", 422)):
        req = urllib.request.Request(
            f"{url}/predict", data=body.encode(), method="POST",
            headers={"Content-Type": "text/plain", "traceparent": parent})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                status, headers = r.status, dict(r.headers)
        except urllib.error.HTTPError as e:
            status, headers = e.code, dict(e.headers)
        assert status == want
        assert headers["X-Trace-Id"] == "0af7651916cd43dd8448eb211c80319c"
        assert headers["traceparent"].startswith(
            "00-0af7651916cd43dd8448eb211c80319c-")
    # ?debug=trace is honoured only with --serve_debug_trace
    cfg = dataclasses.replace(servers["cfg"], serve_debug_trace=True)
    traced = PredictionServer(servers["model"], cfg)
    turl = f"http://127.0.0.1:{traced.start(port=0)}"
    try:
        status, body = _post(f"{turl}/predict?debug=trace",
                             "class D { int d() { } } NCTX3 traced")
        tree = json.loads(body)["trace"]
        names = {s["name"] for s in tree["spans"]}
        assert {"request", "cache_lookup", "admission", "extract_wait",
                "extract", "batch_wait", "batch", "device",
                "render"} <= names
        status, plain = _post(f"{url}/predict?debug=trace",
                              "class D { int d() { } } NCTX3 traced")
        assert "trace" not in json.loads(plain)
    finally:
        traced.shutdown()


def _series(registry):
    """(name, labels) -> value of every series, a histogram as its
    count."""
    out = {}
    for name, children in registry.collect().items():
        for key, child in children.items():
            out[(name, key)] = (child.count if hasattr(child, "count")
                                and not hasattr(child, "set")
                                else child.value)
    return out


# families of reference modules the port does not have (circuit
# breakers, the flight recorder, the tracer ring's own gauges, and the
# reference runtime's AOT lowerings)
_UNPORTED = ("serving_breaker", "flight_", "obs_span", "release_aot")


def _parse_prometheus(text):
    series = set()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name = line.split("{", 1)[0].split(" ", 1)[0]
            series.add(name)
    return series


def test_metrics_series_match_jax_server(servers):
    """The same requests through both servers touch the same series
    (name and labels), and the port's /metrics renders them."""
    requests = [("predict", "class M { int m1() { } } NCTX3"),
                ("predict", "class M { int m1() { } } NCTX3"),   # a hit
                ("embed", "class M { int m2() { } int m3() { } }"),
                ("predict", "   "), ("predict", "BOOM_ALWAYS"),
                ("predict", "class M { int m4() { } } CRASH_ALWAYS")]
    port_reg, ref_reg = obs.default_registry(), jmetrics.default_registry()
    # the cache-size gauge is shared by every server of the process: a
    # sentinel, so that a put shows whatever size the other servers left
    for reg in (port_reg, ref_reg):
        reg.gauge("serving_cache_entries").set(-1)
    p0, r0 = _series(port_reg), _series(ref_reg)
    got = [servers["continuous"].handle_request(e, c)[0]
           for e, c in requests]
    want = [servers["jax"].handle_request(e, c)[0] for e, c in requests]
    assert got == want == [200, 200, 200, 400, 422, 503]
    p1, r1 = _series(port_reg), _series(ref_reg)
    touched_port = {k for k, v in p1.items() if p0.get(k) != v}
    touched_ref = {k for k, v in r1.items() if r0.get(k) != v
                   and not k[0].startswith(_UNPORTED)}
    assert touched_port == touched_ref
    assert {k[0] for k in touched_port} >= {
        "serving_requests_total", "serving_request_seconds",
        "serving_cache_hits_total", "serving_cache_misses_total",
        "serving_batches_total", "serving_batch_rows",
        "extractor_pool_requests_total", "extractor_failures_total",
        "serving_head_dispatch_total"}
    with urllib.request.urlopen(servers["urls"]["continuous"] + "/metrics",
                                timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    assert text == port_reg.render_prometheus() or \
        _parse_prometheus(text) <= _parse_prometheus(
            port_reg.render_prometheus())
    names = _parse_prometheus(text)
    for name, _ in touched_port:
        assert name in names or f"{name}_count" in names, name


def test_repl_holds_one_warm_worker(servers, tmp_path, monkeypatch, capsys):
    from code2vec_tpu_torch.serving.interactive import InteractivePredictor
    java = tmp_path / "Input.java"
    java.write_text("class A { int addOne(int n) { return n + 1; } }")
    answers = iter(["", "", "q"])
    monkeypatch.setattr("builtins.input", lambda *a: next(answers))
    predictor = InteractivePredictor(servers["cfg"], servers["model"])
    assert predictor.extractor_pool.size == 1
    assert predictor.extractor_pool.warm
    pid = predictor.extractor_pool._idle[0].proc.pid
    seen = []
    orig = predictor.extractor_pool.extract_file

    def spy(path, **kw):
        seen.append(predictor.extractor_pool._idle[0].proc.pid)
        return orig(path, **kw)

    predictor.extractor_pool.extract_file = spy
    predictor.predict(str(java))
    out = capsys.readouterr().out.splitlines()
    assert seen == [pid, pid]
    assert out.count("Original name:\taddOne") == 2
    assert "Starting interactive prediction..." in out
    assert out[-1] == "Exiting..."
    assert predictor.extractor_pool._closed


def test_concurrent_steps_count_every_dispatch_once(servers):
    """The batchers call the model from several threads at once: under a
    short switch interval, no head count is lost and each (rows, bucket)
    step is built once."""
    import sys
    model = ReleaseModel(servers["cfg"])
    built = []
    make = model._make_predict_step

    def counting_make(rows, m):
        built.append((rows, m))
        return make(rows, m)

    model._make_predict_step = counting_make
    before = dict(model.head_dispatches)
    n_threads, calls = 16, 200

    def hammer():
        for i in range(calls):
            model._dispatch_predict_step(4, 4, (4, 8, 16)[i % 3])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert model.head_dispatches["exact"] - before["exact"] == \
        n_threads * calls
    assert sorted(built) == [(4, 4), (4, 8), (4, 16)]


def test_continuous_workers_count_every_batch_once():
    """`inflight_steps` workers dispatch at once: under a short switch
    interval every batch is counted once, as the locked counter is."""
    import sys
    b = batcher.ContinuousBatcher(lambda lines: list(lines),
                                  max_batch_rows=1, max_delay_s=0.0,
                                  inflight_steps=4)
    before = _port_value("serving_batches_total")
    n_threads, calls = 8, 40

    def client(t):
        for i in range(calls):
            assert b.submit([f"{t}:{i}"]).result(timeout=60) == [f"{t}:{i}"]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        b.drain(timeout=30)
    assert b.batches_dispatched == n_threads * calls
    assert _port_value("serving_batches_total") - before == \
        b.batches_dispatched


def test_serve_main_exports_trace_and_metrics(servers, tmp_path):
    """`serve --trace_export F --metrics_file M`: the span ring records
    each request's tree and the batch, written as a Chrome trace at
    exit beside the Prometheus snapshot."""
    import socket
    from code2vec_tpu_torch.serving.server import serve_main
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    trace, prom = tmp_path / "serve.trace.json", tmp_path / "serve.prom"
    cfg = dataclasses.replace(servers["cfg"], serve_port=port,
                              trace_export=str(trace),
                              metrics_file=str(prom))
    stop = threading.Event()
    rc = []
    obs.default_tracer().clear()
    runner = threading.Thread(
        target=lambda: rc.append(serve_main(cfg, servers["model"],
                                            stop=stop)))
    runner.start()
    try:
        def up():
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=5):
                    return True
            except OSError:
                return False
        _wait_for(up)
        status, body = _post(f"http://127.0.0.1:{port}/predict",
                             "class X { int x() { } } exported")
        assert status == 200
    finally:
        stop.set()
        runner.join(60)
    assert rc == [0]
    assert not obs.default_tracer().enabled
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"request", "cache_lookup", "extract", "serving_batch"} <= names
    batch = next(e for e in events if e["name"] == "serving_batch")
    request = next(e for e in events if e["name"] == "request")
    assert request["args"]["trace_id"] in batch["args"]["member_trace_ids"]
    assert "serving_requests_total" in prom.read_text()
    obs.default_tracer().clear()
