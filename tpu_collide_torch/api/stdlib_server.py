"""Dependency-free HTTP server for the REST surface.

A thin stdlib transport over the shared route core (api/routes.RouteTable)
— the SAME handlers the FastAPI app serves, for environments without
fastapi/uvicorn (this framework must run anywhere JAX runs). Same JSON
envelope {success, message, data}; same paths as the reference
api.py:88-391.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from tpu_collide_torch.core.utils import get_logger
from tpu_collide_torch.api.scene import Scene
from tpu_collide_torch.api.routes import RouteTable, _err

logger = get_logger(__name__)


class SceneHTTPServer:
    """Threaded stdlib HTTP server around a Scene. The shared RouteTable
    serializes device access internally."""

    def __init__(self, scene: Scene, host: str = "127.0.0.1",
                 port: int = 8000, scheduler=None,
                 routes: Optional[RouteTable] = None):
        self.scene = scene
        self.scheduler = scheduler
        self.routes = routes or RouteTable(scene, scheduler=scheduler)
        self.host, self.port = host, port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def handle(self, method: str, path: str, body: Optional[dict],
               query: Dict[str, str]) -> Tuple[int, Dict[str, Any]]:
        return self.routes.handle(method, path, body, query)

    # ---- server plumbing ----

    def _make_handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _dispatch(self, method):
                from urllib.parse import urlparse, parse_qsl
                u = urlparse(self.path)
                query = dict(parse_qsl(u.query))
                body = None
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    try:
                        body = json.loads(self.rfile.read(length))
                    except json.JSONDecodeError:
                        self._reply(400, _err("invalid JSON body"))
                        return
                try:
                    code, payload = outer.handle(method, u.path, body, query)
                except Exception as e:  # noqa: BLE001
                    logger.error("handler error %s %s: %s", method, u.path, e)
                    code, payload = 500, _err(str(e))
                self._reply(code, payload)

            def _reply(self, code, payload):
                raw = json.dumps(payload, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_DELETE(self):
                self._dispatch("DELETE")

        return Handler

    def start(self) -> int:
        """Start serving in a daemon thread; returns the bound port."""
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           self._make_handler())
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        logger.info("scene HTTP server on %s:%d", self.host, self.port)
        return self.port

    def stop(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
