"""Exporters: how registry/tracer state leaves the process.

The port's copy of code2vec_tpu/obs/exporters.py.

Three sinks, all crash-tolerant:

- Prometheus textfile snapshot (`write_prometheus`, `--metrics_file`):
  the node-exporter textfile-collector pattern — a text-format snapshot
  written atomically (tmp + rename), so a scraper never reads a torn
  file. Plus an optional localhost HTTP endpoint
  (`start_metrics_server`, `--metrics_port`) serving the same text at
  `/metrics` for a direct Prometheus scrape.
- Heartbeat JSON (`write_heartbeat`, `--heartbeat_file`, :62-75): one
  small file rewritten atomically each log window with {step, epoch,
  last_loss, wall clock, ...}. An external watchdog detects a hung
  trainer by the file's `wall_time` going stale.
- TensorBoard (`tb_export`, :77-88): every registered metric through the
  ScalarWriter (utils/tb.py) at log boundaries, so registry metrics and
  the trainer's loss/throughput curves live in one TB run.
"""

from __future__ import annotations

import http.server
import json
import os
import threading
import time
from typing import Optional

from code2vec_tpu_torch.obs import metrics as _metrics

HEARTBEAT_SCHEMA_VERSION = 1


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


def write_heartbeat(path: str, **fields) -> str:
    """Atomically (re)write the JSON heartbeat file. `wall_time` (unix
    seconds) and `pid` are stamped automatically; callers add step/epoch/
    last_loss/whatever else a watchdog should see (the trainer's fields:
    training/loop.py `Trainer.train`'s write_heartbeat)."""
    payload = {
        "schema_version": HEARTBEAT_SCHEMA_VERSION,
        "wall_time": time.time(),
        "pid": os.getpid(),
    }
    payload.update(fields)
    _atomic_write(path, json.dumps(payload, indent=2) + "\n")
    return path


def tb_export(writer, step: int,
              registry: Optional[_metrics.MetricsRegistry] = None,
              prefix: str = "obs/") -> None:
    """Write every registered metric as a TB scalar (utils/tb.py
    ScalarWriter, or anything with a `.scalar(tag, value, step)`)."""
    reg = registry if registry is not None else _metrics.default_registry()
    for tag, value in reg.tb_scalars():
        writer.scalar(prefix + tag, value, step)


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
