"""Tiny JSON-over-HTTP server/client helpers (stdlib only; the port's own
copy of ``awq_tpu/serve/http.py``, with the client side on ``urllib``).

The REST surface is built on ``http.server.ThreadingHTTPServer``. Handlers
are plain callables
``(payload: dict) -> dict | iterator-of-dicts`` registered per route;
iterator results stream as NUL-delimited JSON chunks, the wire format of
the JAX package's workers.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterator, Union

Handler = Callable[[dict], Union[dict, Iterator[dict]]]

DELIM = b"\0"


class JsonHTTPServer:
    def __init__(self, host: str, port: int):
        self.routes: Dict[str, Handler] = {}
        outer = self

        class _H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                handler = outer.routes.get(self.path)
                if handler is None:
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self.send_error(400)
                    return
                try:
                    result = handler(payload)
                except Exception as e:  # surface as 500 with message
                    body = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}
                    ).encode()
                    self.send_response(500)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if isinstance(result, dict):
                    if "__html__" in result:  # raw page response
                        body = result["__html__"].encode()
                        ctype = "text/html; charset=utf-8"
                    else:
                        body = json.dumps(result).encode()
                        ctype = "application/json"
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:  # stream
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def chunk(b: bytes):
                        self.wfile.write(f"{len(b):X}\r\n".encode())
                        self.wfile.write(b + b"\r\n")

                    for item in result:
                        chunk(json.dumps(item).encode() + DELIM)
                    chunk(b"")  # terminal chunk

            def do_GET(self):
                self.do_POST()

        self.httpd = ThreadingHTTPServer((host, port), _H)
        self.host, self.port = host, self.httpd.server_address[1]
        self._thread = None

    def route(self, path: str, handler: Handler) -> None:
        self.routes[path] = handler

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def _post(url: str, payload: dict, timeout: float):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def post_json(url: str, payload: dict, timeout: float = 30.0) -> dict:
    with _post(url, payload, timeout) as r:
        return json.loads(r.read())


def post_stream(url: str, payload: dict, timeout: float = 600.0):
    """Yield dicts from a NUL-delimited JSON chunk stream."""
    with _post(url, payload, timeout) as r:
        buf = b""
        while True:
            data = r.read1(65536)
            if not data:
                break
            buf += data
            *items, buf = buf.split(DELIM)
            for raw in items:
                if raw:
                    yield json.loads(raw)
        if buf:
            yield json.loads(buf)
