"""A minimal prediction server over HTTP.

    POST /predict    Java source (text, or JSON {"code": ...}) -> top-k
                     names and attention paths per method
    POST /embed      the same source -> one code vector per method
    POST /neighbors  the same source (JSON may add "k" and "nprobe") ->
                     the nearest stored methods per method, from the
                     index mounted by `serve --retrieval_index DIR`
    GET  /healthz    status, fingerprint, device, the retrieval mount and
                     kernel launch counts

Each request runs the extractor (a cold subprocess) on its thread, then
joins the dynamic batcher, whose one dispatcher thread runs the model on
the card; /neighbors then searches the index on the request's thread.
Response bodies are those of code2vec_tpu/serving/server.py (:523-560,
:680-765), keys sorted. /neighbors answers 404 without a mount and 503
when the index and the model embed in different spaces. The
reference's cache, admission control, breakers, telemetry, supervisor
and hot swap are not ported.
"""

from __future__ import annotations

import http.server
import json
import os
import signal
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from code2vec_tpu_torch import kernels
from code2vec_tpu_torch.serving.batcher import DynamicBatcher
from code2vec_tpu_torch.serving.extractor_bridge import (
    ExtractionTimeout, PathExtractor,
)
from code2vec_tpu_torch.serving.interactive import parse_prediction_results

MODEL_NAME = "code2vec_tpu"


class _HTTPError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class PredictionServer:
    def __init__(self, model, config=None, log=None):
        self.model = model
        self.config = config or model.config
        self.log = log or self.config.log
        self.fingerprint = model.model_fingerprint()
        self.extractor = PathExtractor(self.config)
        self.batcher = DynamicBatcher(
            self._batched_predict,
            max_batch_rows=self.config.serve_batch_size,
            max_delay_s=self.config.serve_max_delay_ms / 1000.0)
        self.retrieval = None
        if getattr(self.config, "retrieval_index", None):
            from code2vec_tpu_torch.retrieval.api import RetrievalHandle
            self.retrieval = RetrievalHandle.mount(
                self.config.retrieval_index, self.fingerprint,
                default_topk=self.config.retrieval_topk, log=self.log,
                device=model.device)
        self.started_at = time.time()
        self.port: Optional[int] = None
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None

    def _batched_predict(self, lines):
        return self.model.predict(lines,
                                  batch_size=self.config.serve_batch_size,
                                  with_code_vectors=True)

    def _neighbor_knobs(self, params: Optional[Dict]) -> Dict:
        """The request's `k` and `nprobe` (JSON body), defaulted and
        checked: 400 for a malformed value."""
        params = params or {}
        try:
            k = int(params.get("k", self.retrieval.default_topk))
            nprobe = params.get("nprobe")
            nprobe = None if nprobe is None else int(nprobe)
        except (TypeError, ValueError):
            raise _HTTPError(400, "k and nprobe must be integers")
        if k < 1 or (nprobe is not None and nprobe < 1):
            raise _HTTPError(400, "k and nprobe must be >= 1")
        return {"k": k, "nprobe": nprobe}

    def _render_neighbors(self, raw, knobs: Dict) -> dict:
        from code2vec_tpu_torch.retrieval.api import EmbeddingSpaceMismatch
        index = self.retrieval.index
        k, nprobe = knobs["k"], knobs["nprobe"]
        body = {"model": MODEL_NAME, "model_fingerprint": self.fingerprint,
                "embedding_fingerprint": index.fingerprint,
                "index": {"rows": index.rows, "backend": index.backend,
                          "metric": index.metric, "k": k,
                          "nprobe": index.nprobe if nprobe is None
                          else nprobe},
                "methods": []}
        if not raw:
            # zero extracted methods (an empty class, an interface): an
            # empty answer, not a search over a (0, D) batch
            return body
        vectors = np.asarray([r.code_vector for r in raw], dtype=np.float32)
        try:
            neighbor_lists = self.retrieval.neighbors(
                vectors, self.fingerprint, k=k, nprobe=nprobe)
        except EmbeddingSpaceMismatch as e:
            raise _HTTPError(503, str(e))
        body["methods"] = [{"original_name": r.original_name,
                            "neighbors": neighbors}
                           for r, neighbors in zip(raw, neighbor_lists)]
        return body

    def _render(self, endpoint: str, raw, hash_to_string,
                knobs: Optional[Dict] = None) -> dict:
        fp = self.fingerprint
        if endpoint == "neighbors":
            return self._render_neighbors(raw, knobs)
        if endpoint == "embed":
            return {"model": MODEL_NAME, "model_fingerprint": fp,
                    "embedding_fingerprint": fp,
                    "vectors": [([] if r.code_vector is None
                                 else [float(v) for v in r.code_vector])
                                for r in raw],
                    "method_names": [r.original_name for r in raw]}
        oov = self.model.vocabs.target_vocab.special_words.oov
        methods = []
        for r, parsed in zip(raw, parse_prediction_results(
                raw, hash_to_string, oov, topk=10)):
            entry = {"original_name": r.original_name,
                     "predictions": [{"name": p["name"],
                                      "probability": p["probability"]}
                                     for p in parsed.predictions],
                     "attention_paths": parsed.attention_paths}
            if self.config.export_code_vectors and r.code_vector is not None:
                entry["code_vector"] = [float(v) for v in r.code_vector]
            methods.append(entry)
        return {"model": MODEL_NAME, "model_fingerprint": fp,
                "methods": methods}

    def handle(self, endpoint: str, code: str,
               params: Optional[Dict] = None) -> bytes:
        """Body of a 200 response, or raises _HTTPError."""
        if not code.strip():
            raise _HTTPError(400, "empty request body")
        knobs = None
        if endpoint == "neighbors":
            from code2vec_tpu_torch.retrieval.api import (
                EmbeddingSpaceMismatch,
            )
            if self.retrieval is None:
                raise _HTTPError(
                    404, "no retrieval index mounted; start the server "
                         "with serve --retrieval_index DIR")
            try:
                self.retrieval.require_attached()
            except EmbeddingSpaceMismatch as e:
                raise _HTTPError(503, str(e))
            knobs = self._neighbor_knobs(params)
        try:
            lines, hash_to_string = self.extractor.extract_source(code)
        except FileNotFoundError as e:
            raise _HTTPError(503, f"no extractor available: {e}")
        except (ValueError, ExtractionTimeout) as e:
            raise _HTTPError(422, f"extraction failed: {e}")
        raw = self.batcher.submit(lines).result()
        return json.dumps(self._render(endpoint, raw, hash_to_string, knobs),
                          sort_keys=True).encode() + b"\n"

    def handle_request(self, endpoint: str, code: str,
                       params: Optional[Dict] = None) -> Tuple[int, bytes]:
        try:
            return 200, self.handle(endpoint, code, params)
        except _HTTPError as e:
            status, msg = e.code, str(e)
        except Exception as e:  # noqa: BLE001 — 500, not a torn socket
            status, msg = 500, f"{type(e).__name__}: {e}"
        return status, json.dumps({"error": msg}).encode() + b"\n"

    def healthz(self) -> dict:
        return {"status": "serving",
                "uptime_s": time.time() - self.started_at,
                "pid": os.getpid(),
                "model_fingerprint": self.fingerprint,
                "device": str(self.model.device),
                "batcher": {"max_batch_rows": self.batcher.max_batch_rows,
                            "max_delay_ms": self.batcher.max_delay_s * 1e3,
                            "batches_dispatched":
                                self.batcher.batches_dispatched},
                "predict_compile_count": self.model.predict_compile_count(),
                "retrieval": (None if self.retrieval is None
                              else self.retrieval.status()),
                "kernel_launches": kernels.launch_counts()}

    @staticmethod
    def _decode_body(raw: bytes, content_type: str
                     ) -> Tuple[str, Optional[Dict]]:
        """(code, extra params): a JSON body may carry /neighbors' `k`
        and `nprobe` beside "code"; a text body has none."""
        text = raw.decode("utf-8", errors="replace")
        if content_type.split(";")[0].strip() == "application/json":
            try:
                payload = json.loads(text)
            except json.JSONDecodeError as e:
                raise _HTTPError(400, f"bad JSON body: {e}")
            if not isinstance(payload, dict) or "code" not in payload:
                raise _HTTPError(400, 'JSON body must be {"code": "..."}')
            params = {k: v for k, v in payload.items()
                      if k in ("k", "nprobe")}
            return str(payload["code"]), (params or None)
        return text, None

    def start(self, port: Optional[int] = None,
              host: Optional[str] = None) -> int:
        """Bind and serve on a daemon thread; returns the bound port
        (port 0 picks a free one)."""
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _respond(self, code: int, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib API name)
                if self.path.split("?", 1)[0] == "/healthz":
                    self._respond(200, json.dumps(
                        server.healthz(), sort_keys=True).encode() + b"\n")
                else:
                    self._respond(404, json.dumps(
                        {"error": f"no such endpoint: {self.path}"}
                    ).encode() + b"\n")

            def do_POST(self):  # noqa: N802 (stdlib API name)
                endpoint = self.path.split("?", 1)[0].lstrip("/")
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                if endpoint not in ("predict", "embed", "neighbors"):
                    self._respond(404, json.dumps(
                        {"error": f"no such endpoint: /{endpoint}"}
                    ).encode() + b"\n")
                    return
                try:
                    code, params = server._decode_body(
                        raw, self.headers.get("Content-Type") or "")
                except _HTTPError as e:
                    self._respond(e.code, json.dumps(
                        {"error": str(e)}).encode() + b"\n")
                    return
                self._respond(*server.handle_request(endpoint, code,
                                                     params))

        port = self.config.serve_port if port is None else port
        host = self.config.serve_host if host is None else host
        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         name="serving-http", daemon=True).start()
        self.log(f"Serving on http://{host}:{self.port} (POST /predict, "
                 f"POST /embed, "
                 f"{'POST /neighbors, ' if self.retrieval else ''}"
                 f"GET /healthz) on {self.model.device}")
        return self.port

    def shutdown(self) -> None:
        """Stop accepting, flush the batcher."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.batcher.drain()


def serve_main(config, model) -> int:
    """Serve until SIGINT or SIGTERM, then shut down cleanly."""
    server = PredictionServer(model, config)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    stop.wait()
    server.shutdown()
    return 0
