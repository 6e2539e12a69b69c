"""Inference runner: HTTP serving of a FedMLPredictor (port of
``fedml_tpu.serving.fedml_inference_runner``, a copy: the module is pure
Python).

A stdlib ``ThreadingHTTPServer`` speaking JSON on ``/predict`` (and
``/api/v1/predict``) and ``/ready`` (``/health``), bound to loopback by
default.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .fedml_predictor import FedMLPredictor

log = logging.getLogger(__name__)


class FedMLInferenceRunner:
    def __init__(self, client_predictor: FedMLPredictor,
                 host: str = "127.0.0.1", port: int = 2345):
        # loopback by default: the endpoint is unauthenticated; external
        # exposure requires an explicit host="0.0.0.0"
        self.client_predictor = client_predictor
        self.host = host
        self.port = port
        self._server: Optional[ThreadingHTTPServer] = None

    def _make_handler(self):
        predictor = self.client_predictor

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/ready", "/health"):
                    ok = predictor.ready()
                    self._send(200 if ok else 503, {"ready": bool(ok)})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path not in ("/predict", "/api/v1/predict"):
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    result = predictor.predict(req)
                    self._send(200, {"result": result})
                except Exception as e:  # surface errors as JSON, keep serving
                    log.exception("predict failed")
                    self._send(500, {"error": str(e)})

            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

        return Handler

    def start(self) -> int:
        """Non-blocking start; returns the bound port."""
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           self._make_handler())
        self.port = self._server.server_address[1]
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        log.info("inference runner serving on %s:%d", self.host, self.port)
        return self.port

    def run(self):
        """Blocking serve (reference FedMLInferenceRunner.run surface)."""
        self.start()
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            self.stop()

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server = None
