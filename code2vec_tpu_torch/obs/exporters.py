"""Exporters: how registry/tracer state leaves the process.

The port's copy of code2vec_tpu/obs/exporters.py.

One sink, crash-tolerant: a Prometheus textfile snapshot
(`write_prometheus`, `--metrics_file`), the node-exporter
textfile-collector pattern — a text-format snapshot written atomically
(tmp + rename), so a scraper never reads a torn file. Plus an optional
localhost HTTP endpoint (`start_metrics_server`, `--metrics_port`)
serving the same text at `/metrics` for a direct Prometheus scrape. The
reference's heartbeat JSON and TensorBoard export have no caller in the
port (the supervisor and trainer that read them are not ported) and
are left out.
"""

from __future__ import annotations

import http.server
import os
import threading
from typing import Optional

from code2vec_tpu_torch.obs import metrics as _metrics


def _atomic_write(path: str, data: str) -> None:
    """tmp + rename so readers never observe a partial file. Deliberately
    NO fsync: these are ephemeral snapshots rewritten every log window,
    and an fsync per window is real step-time (milliseconds on
    virtualized filesystems) bought against a failure mode — losing the
    last few seconds of metrics in a power loss — that costs nothing."""
    path = os.path.abspath(path)
    dirpart = os.path.dirname(path)
    if dirpart:
        os.makedirs(dirpart, exist_ok=True)
    # pid alone is not unique WITHIN a process: the serving ticker and
    # the final write at shutdown can run concurrently, and a shared tmp
    # name lets one thread rename the other's file away
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    with open(tmp, "w") as f:
        f.write(data)
    os.replace(tmp, path)


def write_prometheus(path: str,
                     registry: Optional[_metrics.MetricsRegistry] = None
                     ) -> str:
    """Atomically write a Prometheus text-format snapshot to `path`."""
    reg = registry if registry is not None else _metrics.default_registry()
    _atomic_write(path, reg.render_prometheus())
    return path


# ------------------------------------------------------------- http server

class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    registry: Optional[_metrics.MetricsRegistry] = None

    def do_GET(self):  # noqa: N802 (stdlib API name)
        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        reg = self.registry or _metrics.default_registry()
        body = reg.render_prometheus().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr lines
        pass


def start_metrics_server(port: int,
                         registry: Optional[_metrics.MetricsRegistry] = None,
                         host: str = "127.0.0.1"):
    """Serve `/metrics` on localhost in a daemon thread. Returns the
    server; call `.shutdown()` + `.server_close()` (or
    `stop_metrics_server`) to stop. Port 0 picks a free port —
    `server.server_address[1]` has the real one."""
    handler = type("_BoundMetricsHandler", (_MetricsHandler,),
                   {"registry": registry})
    server = http.server.ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name="obs-metrics-http", daemon=True)
    thread.start()
    return server


def stop_metrics_server(server) -> None:
    if server is None:
        return
    try:
        server.shutdown()
        server.server_close()
    except Exception:
        pass  # teardown must never mask the real exit path
