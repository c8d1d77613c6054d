"""Batched prediction server over HTTP.

The counterpart of code2vec_tpu/serving/server.py's request path
(`handle_request` / `_handle` / `_extract` :407-680) and HTTP layer
(:848-1066). A request follows the reference's path:

    POST /predict --cache miss--> admission gate (bounded queue +
    deadline budget) --> warm extractor pool (deadline as timeout) -->
    dynamic or continuous batcher (coalesced, context-bucketed) -->
    the predict step on the card (K1-K4 in the artifact's format, or
    K1, K2 and K11 under the MIPS head) --> JSON response --> LRU cache

Endpoints:

    POST /predict    Java source (text, or JSON {"code": ...}) -> top-k
                     names and attention paths per method
    POST /embed      the same source -> one code vector per method
    POST /neighbors  the same source (JSON may add "k" and "nprobe") ->
                     the nearest stored methods per method, from the
                     index mounted by `serve --retrieval_index DIR`
    GET  /healthz    status, fingerprint, device, the pool, batcher,
                     cache and admission state, the retrieval mount and
                     the kernel launch counts
    GET  /metrics    Prometheus text of the `obs` registry

Every request carries a deadline (`--serve_deadline_ms`, the client's
`X-Deadline-Ms` header, clamped by `--serve_deadline_max_ms`) and a
trace id (an inbound W3C `traceparent` is joined, else one is minted),
echoed in `X-Trace-Id` and `traceparent` on every status. Cache hits are
served before admission; overload sheds with 503 + Retry-After; a
request whose budget runs out mid-pipeline gets 504. Each request is
timed into `serving_request_seconds{phase=queue_wait|extract|batch_wait|
device}` and `{phase=total,status=...}`, and counted in
`serving_requests_total{endpoint,status}`. Response bodies are those of
the reference (:680-765), keys sorted. /neighbors answers 404 without a
mount and 503 when the index and the model embed in different spaces.
The reference's circuit breakers, hot swap, tenancy, traffic sampler,
flight recorder, /admin endpoints and SIGTERM drain with 503 on /healthz
are not ported.
"""

from __future__ import annotations

import http.server
import json
import os
import signal
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Dict, Optional, Tuple

import numpy as np

from code2vec_tpu_torch import kernels, obs
from code2vec_tpu_torch.obs.reqtrace import RequestTrace
from code2vec_tpu_torch.serving.admission import (
    AdmissionController, Deadline, DeadlineExceeded, Shed,
    deadline_from_request, expired_counter, retry_after_seconds,
)
from code2vec_tpu_torch.serving.batcher import (
    ContinuousBatcher, DynamicBatcher, StaleParse,
)
from code2vec_tpu_torch.serving.cache import (
    PredictionCache, cache_key_normalized, normalize_source,
)
from code2vec_tpu_torch.serving.extractor_bridge import (
    ExtractionTimeout, ExtractorCrash,
)
from code2vec_tpu_torch.serving.extractor_pool import ExtractorPool
from code2vec_tpu_torch.serving.interactive import parse_prediction_results

MODEL_NAME = "code2vec_tpu"
_PIPELINE_PHASES = ("queue_wait", "extract", "batch_wait", "device")
_PHASE_HELP = (
    "per-request serving latency by phase: queue_wait (extractor "
    "slot), extract (path extraction), batch_wait (coalescing), "
    "device (model call), total (end to end; carries a `status` label "
    "and is recorded for EVERY terminal status, shed/errored included)")
_H_PHASE = {p: obs.histogram("serving_request_seconds", _PHASE_HELP,
                             phase=p) for p in _PIPELINE_PHASES}


def _total_hist(status: str):
    return obs.histogram("serving_request_seconds", _PHASE_HELP,
                         phase="total", status=status)


def _requests_counter(endpoint: str, status: str):
    return obs.counter("serving_requests_total",
                       "HTTP requests by endpoint and outcome",
                       endpoint=endpoint, status=status)


def _error_body(message: str, **extra) -> bytes:
    return json.dumps(dict({"error": message}, **extra)).encode() + b"\n"


class _HTTPError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class _ContinuousBackend:
    """ContinuousBatcher's model adapter: the zero-copy slot path
    (reference :163-217). Slots parse under the server's fingerprint, and
    `predict_rows` refuses (StaleParse) a slot parsed under another one,
    so that the batcher re-parses it through `predict_lines`."""

    def __init__(self, server: "PredictionServer"):
        self._server = server

    def alloc(self, rows: int):
        return self._server.model.alloc_predict_batch(rows)

    def parse_into(self, lines, buffer, row_offset: int) -> str:
        self._server.model.parse_lines_into(lines, buffer, row_offset)
        return self._server.fingerprint

    def predict_rows(self, buffer, n_rows: int, fingerprint: str):
        server = self._server
        if fingerprint != server.fingerprint:
            raise StaleParse(
                f"slot rows were parsed under fingerprint {fingerprint}; "
                f"the live model is {server.fingerprint}")
        results = server.model.predict_parsed(
            buffer, n_rows, batch_size=server.config.serve_batch_size,
            with_code_vectors=True)
        return [(r, server.fingerprint) for r in results]

    def predict_lines(self, lines):
        return self._server._batched_predict(lines)


class PredictionServer:
    """The pool, batcher, cache and admission gate around one model.

    `handle_request(endpoint, code, ...)` returns (status, body,
    headers), so tests drive the whole path, shedding and deadlines
    included, in process; the HTTP layer is a thin framing shim."""

    def __init__(self, model, config=None, log=None):
        self.model = model
        self.config = config or model.config
        self.log = log or self.config.log
        self.fingerprint = model.model_fingerprint()
        config = self.config
        self.pool = ExtractorPool(config, size=config.extractor_pool_size,
                                  log=self.log)
        # with_code_vectors=True: /predict and /embed rows coalesce into
        # the same batches; _render decides what each endpoint ships
        batcher_kw = dict(max_batch_rows=config.serve_batch_size,
                          max_delay_s=config.serve_max_delay_ms / 1000.0,
                          buckets=model.context_buckets)
        if config.serve_continuous:
            self.batcher = ContinuousBatcher(
                self._batched_predict,
                inflight_steps=config.serve_inflight_steps,
                backend=_ContinuousBackend(self), **batcher_kw)
        else:
            self.batcher = DynamicBatcher(self._batched_predict,
                                          **batcher_kw)
        self.cache = PredictionCache(config.serve_cache_entries)
        self.topk = config.top_k_words_considered_during_prediction
        self.admission = AdmissionController(
            max_depth=config.serve_queue_depth,
            concurrency=config.extractor_pool_size)
        self.retrieval = None
        if getattr(config, "retrieval_index", None):
            from code2vec_tpu_torch.retrieval.api import RetrievalHandle
            self.retrieval = RetrievalHandle.mount(
                config.retrieval_index, self.fingerprint,
                default_topk=config.retrieval_topk, log=self.log,
                device=model.device)
        self.started_at = time.time()
        self.port: Optional[int] = None
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    @property
    def model_fingerprint(self) -> str:
        return self.fingerprint

    def _batched_predict(self, lines):
        """The batchers' lines path: the model's result per line, each
        beside the fingerprint of the weights that computed it."""
        results = self.model.predict(
            lines, batch_size=self.config.serve_batch_size,
            with_code_vectors=True)
        return [(r, self.fingerprint) for r in results]

    # ---------------------------------------------------------- predict

    def handle_request(self, endpoint: str, code: str,
                       deadline: Optional[Deadline] = None,
                       params: Optional[Dict] = None,
                       trace: Optional[RequestTrace] = None
                       ) -> Tuple[int, bytes, Dict[str, str]]:
        """The whole serve path of one request -> (status, body, extra
        headers). Every terminal status lands in
        serving_request_seconds{phase=total,status} and
        serving_requests_total."""
        t0 = time.perf_counter()
        if trace is None:
            trace = RequestTrace()
        root = trace.span("request", endpoint=endpoint)
        root.__enter__()
        phases: Dict[str, float] = {}
        status, body, headers = 500, b"", {}
        try:
            body = self._handle(endpoint, code, deadline, phases,
                                params=params, trace=trace)
            status = 200
        except Shed as e:
            e.count()
            status = 503
            headers["Retry-After"] = str(retry_after_seconds(
                e.retry_after_s))
            body = _error_body(str(e), shed=e.reason,
                               trace_id=trace.trace_id)
        except DeadlineExceeded as e:
            status = 504
            body = _error_body(f"deadline exceeded: {e}",
                               trace_id=trace.trace_id)
        except _HTTPError as e:
            status = e.code
            body = _error_body(str(e), trace_id=trace.trace_id)
        except Exception as e:  # noqa: BLE001 — 500, not a torn socket
            body = _error_body(f"{type(e).__name__}: {e}",
                               trace_id=trace.trace_id)
        finally:
            total = time.perf_counter() - t0
            root.attrs["status"] = status
            root.__exit__(None, None, None)
            # a snapshot: the batcher can still write a phase of a
            # request that left early through the result backstop
            for phase, dur in list(phases.items()):
                _H_PHASE[phase].observe(dur)
            _total_hist(str(status)).observe(total)
            _requests_counter(endpoint, str(status)).inc()
            headers.setdefault("X-Trace-Id", trace.trace_id)
            headers.setdefault("traceparent", trace.traceparent())
        return status, body, headers

    def _neighbor_knobs(self, params: Optional[Dict]) -> Dict:
        """The request's `k` and `nprobe` (JSON body), defaulted and
        checked: 400 for a malformed value. Part of the cache key."""
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

    def _handle(self, endpoint: str, code: str,
                deadline: Optional[Deadline], phases: Dict[str, float],
                params: Optional[Dict] = None,
                trace: Optional[RequestTrace] = None) -> bytes:
        if trace is None:
            trace = RequestTrace()
        if not code.strip():
            raise _HTTPError(400, "empty request body")
        knobs: Dict = {}
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
            knobs["index"] = self.retrieval.fingerprint
        key = cache_key_normalized(normalize_source(code),
                                   endpoint=endpoint, topk=self.topk,
                                   model=self.fingerprint, **knobs)
        with trace.span("cache_lookup") as sp:
            cached = self.cache.get(key)
            sp.attrs["hit"] = cached is not None
        if cached is not None:
            return cached   # before admission: a hit costs no capacity
        with trace.span("admission"):
            self.admission.admit(deadline)
        t_admit = time.perf_counter()
        worked = True
        try:
            lines, hash_to_string = self._extract(code, deadline, phases,
                                                  trace)
            future = self.batcher.submit(lines, phases=phases,
                                         deadline=deadline, trace=trace)
            try:
                if deadline is not None and deadline.bounded:
                    # the batcher settles expired requests itself; this
                    # bounds a wedged device call
                    raw = future.result(
                        timeout=max(deadline.remaining(), 0) + 5.0)
                else:
                    raw = future.result()
            except _FutureTimeout:
                expired_counter("device").inc()
                raise DeadlineExceeded(
                    "request expired waiting on the device step")
            except RuntimeError as e:
                if "draining" in str(e):
                    raise Shed("draining", str(e))
                raise
            results = [r for r, _ in raw]
            result_fp = raw[0][1] if raw else self.fingerprint
            with trace.span("render"):
                body = json.dumps(
                    self._render(endpoint, results, hash_to_string,
                                 result_fp, knobs),
                    sort_keys=True).encode() + b"\n"
            self.cache.put(key, body)
            return body
        except Shed:
            # refused after admission: its ~0 ms turnaround must not feed
            # the queue-wait estimate
            worked = False
            raise
        finally:
            self.admission.finish(
                (time.perf_counter() - t_admit) if worked else -1.0)

    def _extract(self, code: str, deadline: Optional[Deadline],
                 phases: Dict[str, float], trace: RequestTrace):
        """The pool's extraction with the request's remaining budget as
        its timeout, failures mapped to HTTP statuses."""
        try:
            return self.pool.extract_source(code, phases=phases,
                                            deadline=deadline, trace=trace)
        except FileNotFoundError as e:
            raise _HTTPError(503, f"no extractor available: {e}")
        except (ExtractorCrash, OSError) as e:
            # workers dying through every retry: the server's fault, not
            # the client's source (ExtractorCrash subclasses ValueError)
            raise _HTTPError(503, f"extractor unavailable: {e}")
        except (ExtractionTimeout, ValueError) as e:
            raise _HTTPError(422, f"extraction failed: {e}")

    def _render_neighbors(self, raw, fingerprint: str, knobs: Dict) -> dict:
        from code2vec_tpu_torch.retrieval.api import EmbeddingSpaceMismatch
        index = self.retrieval.index
        k, nprobe = knobs["k"], knobs["nprobe"]
        body = {"model": MODEL_NAME, "model_fingerprint": fingerprint,
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
                vectors, fingerprint, k=k, nprobe=nprobe)
        except EmbeddingSpaceMismatch as e:
            raise _HTTPError(503, str(e))
        body["methods"] = [{"original_name": r.original_name,
                            "neighbors": neighbors}
                           for r, neighbors in zip(raw, neighbor_lists)]
        return body

    def _render(self, endpoint: str, raw, hash_to_string, fingerprint: str,
                knobs: Dict) -> dict:
        if endpoint == "neighbors":
            return self._render_neighbors(raw, fingerprint, knobs)
        if endpoint == "embed":
            return {"model": MODEL_NAME, "model_fingerprint": fingerprint,
                    "embedding_fingerprint": fingerprint,
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
        return {"model": MODEL_NAME, "model_fingerprint": fingerprint,
                "methods": methods}

    # ------------------------------------------------------------- http

    def healthz(self) -> dict:
        model, config = self.model, self.config
        wait = self.admission.estimated_wait_s()
        return {"status": "serving",
                "uptime_s": time.time() - self.started_at,
                "pid": os.getpid(),
                "model": {"fingerprint": self.fingerprint},
                "model_fingerprint": self.fingerprint,
                "device": str(model.device),
                "extractor_pool": {"size": self.pool.size,
                                   "warm": self.pool.warm},
                "batcher": {"max_batch_rows": self.batcher.max_batch_rows,
                            "max_delay_ms": self.batcher.max_delay_s * 1e3,
                            "batches_dispatched":
                                self.batcher.batches_dispatched,
                            "continuous":
                                isinstance(self.batcher, ContinuousBatcher),
                            "inflight_rides":
                                getattr(self.batcher, "rides", 0)},
                "cache": {"capacity": self.cache.capacity,
                          "entries": len(self.cache)},
                "admission": {"depth": self.admission.depth,
                              "max_depth": self.admission.max_depth,
                              "estimated_wait_ms": (None if wait is None
                                                    else wait * 1e3)},
                "deadlines": {"default_ms": config.serve_deadline_ms,
                              "max_ms": config.serve_deadline_max_ms},
                "telemetry": {"debug_trace": bool(config.serve_debug_trace)},
                "buckets": list(model.context_buckets),
                "compiled_predict_steps": sum(
                    1 for rows, _ in list(model._predict_steps)
                    if rows == config.serve_batch_size),
                "predict_compile_count": model.predict_compile_count(),
                "retrieval": (None if self.retrieval is None
                              else self.retrieval.status()),
                "inflight": self._inflight,
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

    @staticmethod
    def _inject_trace(body: bytes, trace: RequestTrace) -> bytes:
        """`?debug=trace` (with --serve_debug_trace): the request's span
        tree in the JSON response, added after the cache, so cached
        bytes stay trace-free."""
        try:
            payload = json.loads(body)
        except ValueError:
            return body
        if not isinstance(payload, dict):
            return body
        payload["trace"] = trace.to_dict()
        return json.dumps(payload, sort_keys=True).encode() + b"\n"

    def start(self, port: Optional[int] = None,
              host: Optional[str] = None) -> int:
        """Bind and serve on a daemon thread; returns the bound port
        (port 0 picks a free one)."""
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _respond(self, code: int, body: bytes,
                         ctype: str = "application/json",
                         headers: Optional[Dict[str, str]] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib API name)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/healthz":
                        self._respond(200, json.dumps(
                            server.healthz(), sort_keys=True).encode()
                            + b"\n")
                    elif path in ("/metrics", "/"):
                        self._respond(
                            200, obs.default_registry()
                            .render_prometheus().encode(),
                            ctype="text/plain; version=0.0.4; "
                                  "charset=utf-8")
                    else:
                        self._respond(404, _error_body(
                            f"no such endpoint: {path}"))
                except Exception as e:  # noqa: BLE001 — a probe gets an
                    # answer, never a torn connection
                    self._respond(500, _error_body(
                        f"{type(e).__name__}: {e}"))

            def do_POST(self):  # noqa: N802 (stdlib API name)
                path, _, query = self.path.partition("?")
                endpoint = path.lstrip("/")
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                if endpoint not in ("predict", "embed", "neighbors"):
                    self._respond(404, _error_body(
                        f"no such endpoint: {path}"))
                    return
                trace = RequestTrace.from_headers(
                    self.headers.get("traceparent"))
                deadline = deadline_from_request(
                    server.config, self.headers.get("X-Deadline-Ms"))
                with server._inflight_lock:
                    server._inflight += 1
                try:
                    try:
                        code, params = server._decode_body(
                            raw, self.headers.get("Content-Type") or "")
                    except _HTTPError as e:
                        _requests_counter(endpoint, str(e.code)).inc()
                        self._respond(e.code, _error_body(str(e)), headers={
                            "X-Trace-Id": trace.trace_id,
                            "traceparent": trace.traceparent()})
                        return
                    status, body, headers = server.handle_request(
                        endpoint, code, deadline, params=params,
                        trace=trace)
                    if ("debug=trace" in query.split("&")
                            and server.config.serve_debug_trace):
                        body = server._inject_trace(body, trace)
                    self._respond(status, body, headers=headers)
                finally:
                    with server._inflight_lock:
                        server._inflight -= 1

        class _Listener(http.server.ThreadingHTTPServer):
            # the stdlib's accept backlog of 5 refuses connections in the
            # kernel under a burst; overload must reach the admission
            # gate to be shed honestly
            request_queue_size = 128

        port = self.config.serve_port if port is None else port
        host = self.config.serve_host if host is None else host
        self._httpd = _Listener((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         name="serving-http", daemon=True).start()
        self.log(f"Serving on http://{host}:{self.port} (POST /predict, "
                 f"POST /embed, "
                 f"{'POST /neighbors, ' if self.retrieval else ''}"
                 f"GET /healthz, GET /metrics) on {self.model.device}; "
                 f"{self.pool.size} {'warm' if self.pool.warm else 'cold'} "
                 f"extractor worker(s), "
                 f"{'continuous' if self.config.serve_continuous else 'dynamic'}"
                 f" batcher, cache {self.cache.capacity} entries")
        return self.port

    def shutdown(self) -> None:
        """Stop accepting, flush the batcher, stop the extractor
        workers."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.batcher.drain()
        self.pool.close()


def serve_main(config, model, *, stop: Optional[threading.Event] = None
               ) -> int:
    """Serve until SIGINT or SIGTERM (or the `stop` event, the testable
    form), then shut down cleanly. With --metrics_port the registry is
    also served at /metrics on that port; with --metrics_file a
    Prometheus snapshot is rewritten every 5 s and at exit; with
    --trace_export the span ring records every request's spans and the
    batches', written as Chrome trace-event JSON every 5 s and at exit
    (reference code2vec_tpu/serving/server.py:1286-1342)."""
    server = PredictionServer(model, config)
    if stop is None:
        stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
    metrics_server = (obs.exporters.start_metrics_server(config.metrics_port)
                      if config.metrics_port else None)
    tracer = obs.default_tracer()
    if config.trace_export:
        tracer.enable()
    server.start()

    def _publish(final: bool):
        if config.metrics_file:
            obs.exporters.write_prometheus(config.metrics_file)
        if config.trace_export and (final or len(tracer)):
            tracer.export_chrome_trace(config.trace_export)

    try:
        while not stop.wait(5.0):
            _publish(final=False)
    finally:
        server.shutdown()
        obs.exporters.stop_metrics_server(metrics_server)
        _publish(final=True)
        if config.trace_export:
            tracer.disable()
            config.log(f"Serving span trace written to "
                       f"{config.trace_export}")
    return 0
