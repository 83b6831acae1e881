"""HTTP ingress — a proxy actor running a threaded stdlib HTTP server.

Reference analogue: `python/ray/serve/_private/http_proxy.py:873`
(``HTTPProxyActor`` hosting uvicorn+ASGI).  TPU-image constraint: no
uvicorn/starlette wheels are guaranteed, so ingress is
``http.server.ThreadingHTTPServer`` — each request thread routes through
a DeploymentHandle (power-of-two-choices) and blocks on the replica
response; JSON in, JSON out.

Routes: ``POST/GET <route_prefix>`` dispatches to the app bound at that
prefix (longest-prefix match); ``GET /-/routes`` lists the table;
``GET /-/healthz`` liveness.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

PROXY_NAME = "SERVE_PROXY"
_SENTINEL = object()


class HTTPProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        from ray_tpu_torch.serve.router import DeploymentHandle

        self._host = host
        self._port = port
        self._handles: Dict[str, DeploymentHandle] = {}
        self._routes: Dict[str, str] = {}
        self._lock = threading.Lock()
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _dispatch(self, body: Optional[bytes]):
                import time as _time

                from urllib.parse import parse_qs

                from ray_tpu_torch.core.exceptions import (
                    BackPressureError,
                    DeadlineExceededError,
                )

                query = (self.path.split("?", 1) + [""])[1]
                # model id: header (reference contract) or query param
                model_id = self.headers.get(
                    "serve_multiplexed_model_id",
                    parse_qs(query).get("model_id", [""])[0])
                if parse_qs(query).get("stream", ["0"])[0] == "1":
                    return self._dispatch_stream(body, model_id)
                retry_after = None
                t0 = _time.perf_counter()
                try:
                    status, payload = proxy._handle(self.path, body, model_id)
                except BackPressureError as e:
                    # graceful degradation: every replica rejected through
                    # the router's retry budget — shed with 503 and tell
                    # the client when to come back (reference: Serve
                    # overload 503s instead of queueing to death)
                    status, payload = 503, json.dumps(
                        {"error": str(e), "retry_after_s": 1}).encode()
                    retry_after = "1"
                except DeadlineExceededError as e:
                    status, payload = 504, json.dumps(
                        {"error": str(e)}).encode()
                except Exception as e:  # noqa: BLE001
                    status, payload = 500, json.dumps(
                        {"error": str(e)}).encode()
                proxy._observe(self.path, status,
                               _time.perf_counter() - t0)
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                if retry_after is not None:
                    self.send_header("Retry-After", retry_after)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _dispatch_stream(self, body: Optional[bytes],
                                 model_id: str = ""):
                """?stream=1: chunked NDJSON, one line per yielded item —
                items flush as the replica produces them (streaming
                generator returns underneath)."""
                import time as _time

                t0 = _time.perf_counter()
                try:
                    items = proxy._handle_stream(self.path, body, model_id)
                    first = next(items, _SENTINEL)
                except Exception as e:  # noqa: BLE001
                    proxy._observe(self.path, 500,
                                   _time.perf_counter() - t0)
                    payload = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                proxy._observe(self.path, 200, _time.perf_counter() - t0)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(data: bytes):
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                    self.wfile.flush()

                try:
                    if first is not _SENTINEL:
                        chunk(json.dumps(first, default=str).encode() + b"\n")
                        for item in items:
                            chunk(json.dumps(item, default=str).encode()
                                  + b"\n")
                except Exception as e:  # noqa: BLE001 mid-stream failure
                    chunk(json.dumps({"error": str(e)}).encode() + b"\n")
                self.wfile.write(b"0\r\n\r\n")

            def do_GET(self):
                self._dispatch(None)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                self._dispatch(self.rfile.read(n) if n else None)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="serve-http-proxy",
                                        daemon=True)
        self._thread.start()

    # ----------------------------------------------------------------

    def _observe(self, path: str, status: int, seconds: float):
        """Ingress series, labeled by MATCHED route (bounded cardinality
        — arbitrary request paths never become label values)."""
        try:
            from ray_tpu_torch.serve.telemetry import serve_metrics

            match = self._match_route(path)
            route = match[0] if match else "unmatched"
            m = serve_metrics()
            m["http_requests"].inc(
                tags={"route": route, "status": str(status)})
            m["http_latency"].observe(seconds, tags={"route": route})
        except Exception:  # noqa: BLE001 — telemetry never fails a request
            pass

    def _handle(self, path: str, body: Optional[bytes],
                model_id: str = ""):
        path = path.split("?", 1)[0]
        if path == "/-/healthz":
            return 200, b'"ok"'
        if path == "/-/routes":
            with self._lock:
                return 200, json.dumps(self._routes).encode()
        match = self._match_route(path)
        if match is None:
            return 404, json.dumps({"error": f"no route for {path}"}).encode()
        deployment = match[1]
        handle = self._get_handle(deployment)
        if model_id:
            handle = handle.options(multiplexed_model_id=model_id)
        request = json.loads(body) if body else None
        # call() = submit + resolve with replica-reject retries; a
        # saturated deployment raises BackPressureError (mapped to 503 +
        # Retry-After by the dispatcher), an expired request_timeout_s
        # raises DeadlineExceededError (504)
        result = handle.call(request, timeout=120)
        return 200, json.dumps(result, default=str).encode()

    def _match_route(self, path: str):
        path = path.split("?", 1)[0]
        with self._lock:
            match = None
            for prefix, deployment in self._routes.items():
                if path == prefix or path.startswith(
                        prefix.rstrip("/") + "/") or prefix == "/":
                    if match is None or len(prefix) > len(match[0]):
                        match = (prefix, deployment)
        return match

    def _handle_stream(self, path: str, body: Optional[bytes],
                       model_id: str = ""):
        """Yield the deployment's streamed items (resolved values)."""
        import ray_tpu_torch

        match = self._match_route(path)
        if match is None:
            raise ValueError(f"no route for {path}")
        handle = self._get_handle(match[1], stream=True)
        if model_id:
            handle = handle.options(multiplexed_model_id=model_id)
        request = json.loads(body) if body else None
        for ref in handle.remote(request):
            yield ray_tpu_torch.get(ref, timeout=120)

    def _get_handle(self, deployment: str, stream: bool = False):
        from ray_tpu_torch.serve.router import DeploymentHandle

        key = (deployment, stream)
        with self._lock:
            h = self._handles.get(key)
            if h is None:
                h = self._handles[key] = DeploymentHandle(
                    deployment, stream=stream)
            return h

    # ---------------------------------------------------------------- ctrl

    def update_routes(self, routes: Dict[str, str]):
        with self._lock:
            self._routes = dict(routes)
        return True

    def get_port(self) -> int:
        return self._port

    def check_health(self) -> bool:
        return True

    def shutdown(self):
        self._server.shutdown()
        return True
