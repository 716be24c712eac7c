"""HTTP status server: /status, /health, /config, /region, /fail_point.

A trimmed copy of the JAX package's ``server/status_server.py``: ``GET
/status`` (the node's stores and regions), ``GET /health`` (the read
pool, the raft transport's per-store breakers, the columnar cache, the
coalescer, the fast path's class cache with the pinned readback pool,
the follower reads of ``replica_serving``, the device-state supervisor
and the cold stream), ``GET`` and
``POST /config`` (the live tree; a change goes through the node's
``ConfigController``, which refuses a field that is not online and then
applies nothing), ``GET /region/<id>`` and ``GET``/``POST /fail_point``
(the port's ``utils/failpoint.py``).  Not here: ``/metrics``,
``/debug/trace``, ``/resource_groups``, ``/resource_metering``,
``/resource_control`` and ``/debug/pprof/*`` (they wait for metrics,
tracing, the profiler, resource control and metering).

Reference: src/server/status_server/mod.rs — live config GET/POST
(:699-712), region inspection (/region/{id}) and remote failpoint
control (:716).  Python shape: stdlib ThreadingHTTPServer; runs beside
the gRPC server on ``server.status-addr``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


def health(node) -> dict:
    """The overload and device-state rollup of ``GET /health``."""
    body: dict = {"store_id": node.store_id,
                  "read_pool": node.read_pool.stats(),
                  "peer_breakers": node.transport.breaker_states(),
                  "raft_drops": dict(node.transport.drops),
                  "copr_cache": node.copr_cache.stats(),
                  "device_state": node.device_supervisor.stats()}
    coal = node.endpoint.coalescer
    if coal is not None:
        body["coalescer"] = coal.stats()
    # the fast path: learned classes, hit / miss / bypass / fallback /
    # invalidate counts by reason, and the pinned D2H staging pool
    body["fastpath"] = node.fastpath.stats()
    body["fastpath"]["pinned_readback"] = \
        node.device_runner.pinned_readback_stats()
    body["replica_serving"] = node.replica_serving_stats()
    if node.cold_stream is not None:
        body["cold_stream"] = node.cold_stream.stats()
    return body


class StatusServer:
    """One node's status endpoint.

    ``config_controller``: config.ConfigController for GET/POST /config.
    ``node``: server node for /status, /health and /region/{id}.
    """

    def __init__(self, addr: str, node=None, config_controller=None):
        host, _, port = addr.rpartition(":")
        self._node = node
        self._controller = config_controller
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj) -> None:
                def default(o):
                    if isinstance(o, bytes):
                        return o.decode("utf-8", "backslashreplace")
                    return repr(o)
                self._reply(code, json.dumps(obj, default=default).encode())

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                node = outer._node
                if path == "/status":
                    self._json(200, node.status() if node else {})
                elif path == "/health":
                    self._json(200, health(node) if node
                               else {"healthy": True})
                elif path == "/config":
                    if outer._controller is None:
                        self._json(404, {"error": "no config controller"})
                    else:
                        self._json(200, outer._controller.cfg.to_dict())
                elif path.startswith("/region/"):
                    self._get_region(path)
                elif path == "/fail_point":
                    from ..utils import failpoint
                    self._json(200, failpoint.list_cfg())
                else:
                    self._json(404, {"error": f"no route {path}"})

            def _get_region(self, path: str):
                if outer._node is None:
                    self._json(404, {"error": "no node"})
                    return
                try:
                    rid = int(path.rsplit("/", 1)[1])
                except ValueError:
                    self._json(400, {"error": "bad region id"})
                    return
                for r in outer._node.status().get("regions", ()):
                    if r["region"]["id"] == rid:
                        self._json(200, r)
                        return
                self._json(404, {"error": f"region {rid} not found"})

            def do_POST(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b"{}"
                try:
                    body = json.loads(raw) if raw.strip() else {}
                except json.JSONDecodeError:
                    self._json(400, {"error": "bad json"})
                    return
                if not isinstance(body, dict):
                    self._json(400, {"error": "body must be a JSON object"})
                    return
                if path == "/config":
                    self._post_config(body)
                elif path.startswith("/fail_point/"):
                    from ..utils import failpoint
                    name = path[len("/fail_point/"):]
                    actions = body.get("actions", "")
                    try:
                        if actions:
                            failpoint.cfg(name, actions)
                        else:
                            failpoint.remove(name)
                    except ValueError as e:
                        self._json(400, {"error": str(e)})
                        return
                    self._json(200, {"ok": True})
                else:
                    self._json(404, {"error": f"no route {path}"})

            def _post_config(self, body: dict):
                if outer._controller is None:
                    self._json(404, {"error": "no config controller"})
                    return
                try:
                    applied = outer._controller.update(body)
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                self._json(200, {"applied": applied})

        self._httpd = ThreadingHTTPServer(
            (host or "127.0.0.1", int(port or 0)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="status-server")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            # shutdown() waits on an event only serve_forever sets —
            # calling it before start() would hang forever
            self._httpd.shutdown()
            self._thread.join(timeout=2)
        self._httpd.server_close()
