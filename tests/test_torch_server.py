"""The port's HTTP server on the CPU against the JAX server.

A fake extractor (a Python script speaking the native extractor's
one-shot `--file ... --no_hash` CLI, installed through the
C2V_NATIVE_EXTRACTOR hook as tests/test_serving.py does) stands in for
the C++ parser, so these tests pin the serving path, not the parser. Both
servers answer the same source from the same artifact; the port's bodies
must match the JAX server's in keys, names and attention paths, with
probabilities, scores and vectors within the bf16 tolerance (atol 2e-2,
rtol 1e-2: the transformed contexts are rounded to bf16, where a
last-bit f32 difference can move a value one bf16 step).
"""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from code2vec_tpu.release import artifact as jart
from code2vec_tpu.release.runtime import ReleaseModel as JaxReleaseModel
from code2vec_tpu.serving.server import PredictionServer as JaxServer
from code2vec_tpu_torch import kernels
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.release.runtime import ReleaseModel
from code2vec_tpu_torch.serving.server import PredictionServer

from test_torch_release import _tiny_jax_model

pytestmark = pytest.mark.torch_port

BF16 = dict(rtol=1e-2, atol=2e-2)

FAKE_EXTRACTOR = r'''#!/usr/bin/env python3
"""Fake c2v-extract: one line per `name(` in the source, NCTX<n> contexts
(default 3); --server is refused, so pools fall back to one-shot runs."""
import re, sys

argv = sys.argv[1:]
if "--server" in argv:
    sys.stderr.write("unknown flag: --server\n")
    sys.exit(2)
src = open(argv[argv.index("--file") + 1]).read()
if "BOOM" in src:
    sys.stderr.write("fake parse error\n")
    sys.exit(1)
m = re.search(r"NCTX(\d+)", src)
nctx = int(m.group(1)) if m else 3
for name in re.findall(r"(\w+)\s*\(", src) or ["m"]:
    print(name + " " + " ".join("tok%d,(P%d)^(Q)_(R%d),tok%d"
                                % (i % 6, i, i, (i + 1) % 6)
                                for i in range(nctx)))
'''

SOURCE = ("class A { int alpha(int n) { return n; } "
          "void beta() { } NCTX7 }")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both servers over one artifact, with the fake extractor installed
    before either starts (the JAX pool resolves the binary at start)."""
    tmp = tmp_path_factory.mktemp("torch-server")
    fake = tmp / "fake-c2v-extract"
    fake.write_text(FAKE_EXTRACTOR)
    fake.chmod(0o755)
    mp = pytest.MonkeyPatch()
    mp.setenv("C2V_NATIVE_EXTRACTOR", str(fake))
    jax_model = _tiny_jax_model(tmp)
    art_dir = str(tmp / "artifact")
    jart.export_artifact(jax_model, art_dir, aot=False, log=lambda m: None)
    jcfg = dataclasses.replace(jax_model.config, train_data_path_prefix=None,
                               serve_artifact=art_dir, extractor_pool_size=1)
    jserver = JaxServer(JaxReleaseModel(jcfg, log=lambda m: None), jcfg)
    cfg = Config(serve_artifact=art_dir, serve_batch_size=4, device="cpu",
                 serve_max_delay_ms=2.0, verbose_mode=0)
    tserver = PredictionServer(ReleaseModel(cfg))
    port = tserver.start(port=0)
    yield jserver, tserver, f"http://127.0.0.1:{port}"
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


def _close(got, want, path="body"):
    """Same structure and strings; floats within the bf16 tolerance."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, err_msg=path, **BF16)
    else:
        assert got == want, path


@pytest.mark.parametrize("endpoint", ["predict", "embed"])
def test_port_server_matches_jax_server(servers, endpoint):
    jserver, _, url = servers
    want = json.loads(jserver.handle(endpoint, SOURCE))
    status, body = _post(f"{url}/{endpoint}", SOURCE)
    assert status == 200, body
    assert body.endswith(b"\n")
    got = json.loads(body)
    _close(got, want)
    if endpoint == "predict":
        assert [m["original_name"] for m in got["methods"]] == \
            ["alpha", "beta"]
        assert len(got["methods"][0]["attention_paths"]) == 7
        assert got["methods"][0]["attention_paths"][0]["path"].startswith("(P")
    else:
        assert len(got["vectors"]) == 2 and len(got["vectors"][0]) == 384


def test_port_server_json_body_healthz_and_errors(servers):
    jserver, tserver, url = servers
    status, body = _post(f"{url}/predict", json.dumps({"code": SOURCE}),
                         ctype="application/json")
    assert status == 200
    assert json.loads(body)["model_fingerprint"] == \
        jserver.model_fingerprint
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        hz = json.loads(r.read())
    assert hz["status"] == "serving" and hz["device"] == "cpu"
    assert hz["model_fingerprint"] == tserver.fingerprint
    # the CPU server ran the plain versions: no kernel launched
    assert hz["kernel_launches"] == {k: 0 for k in kernels.KERNEL_MODULES}
    assert hz["batcher"]["batches_dispatched"] >= 1
    assert _post(f"{url}/predict", "   ")[0] == 400
    assert _post(f"{url}/predict", "class BOOM { }")[0] == 422
    assert _post(f"{url}/predict", "{bad", "application/json")[0] == 400
    assert _post(f"{url}/nope", SOURCE)[0] == 404


def test_concurrent_requests_get_their_own_answers(servers):
    import concurrent.futures
    _, tserver, url = servers
    sources = [f"class C{i} {{ void m{i}() {{ }} NCTX{i + 1} }}"
               for i in range(8)]
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        results = list(ex.map(lambda s: _post(f"{url}/predict", s), sources))
    assert all(status == 200 for status, _ in results)
    names = [json.loads(b)["methods"][0]["original_name"] for _, b in results]
    assert names == [f"m{i}" for i in range(8)]
