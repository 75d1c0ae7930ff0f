"""A small HTTP application layer on the standard library's server.

What the backend asks of ``aiohttp.web`` in the JAX package, on
``http.server.ThreadingHTTPServer``: an ``Application`` (a mapping for the
app's state) with GET/POST routes whose ``{name}`` segments match one path
segment each, a static directory, middlewares and cleanup hooks; a
``Request`` (a mapping for per-request state, ``match_info``, ``query``,
``headers``, ``json()``); ``Response``, ``json_response`` and
``FileResponse``. Each request runs on a thread of its own, so handlers are
plain functions and blocking work (sqlite, raster decode, a JWKS fetch)
holds only its own request.
"""

from __future__ import annotations

import json
import logging
import mimetypes
import os
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

_SEGMENT = re.compile(r"\{(\w+)\}")


class Response:
    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "application/octet-stream",
                 text: Optional[str] = None) -> None:
        if text is not None:
            body = text.encode("utf-8")
            content_type += "; charset=utf-8"
        self.body = body
        self.status = status
        self.content_type = content_type


def json_response(data: Any, status: int = 200) -> Response:
    return Response(json.dumps(data).encode("utf-8"), status=status,
                    content_type="application/json; charset=utf-8")


def FileResponse(path: str) -> Response:  # noqa: N802 (aiohttp's name)
    with open(path, "rb") as f:
        body = f.read()
    return Response(body, content_type=mimetypes.guess_type(path)[0]
                    or "application/octet-stream")


def _not_found() -> Response:
    return Response(text="404: Not Found", status=404, content_type="text/plain")


class Request(dict):
    """One request; the mapping holds per-request state (``request["user"]``)."""

    def __init__(self, app: "Application", method: str, target: str,
                 headers, body: bytes) -> None:
        super().__init__()
        url = urllib.parse.urlsplit(target)
        self.app = app
        self.method = method
        self.path = urllib.parse.unquote(url.path)
        self.query = {k: v[0] for k, v in
                      urllib.parse.parse_qs(url.query, keep_blank_values=True).items()}
        self.headers = headers
        self.body = body
        self.match_info: Dict[str, str] = {}

    def json(self) -> Any:
        return json.loads(self.body.decode("utf-8"))


Handler = Callable[[Request], Response]


class Application(dict):
    """Routes, middlewares and cleanup hooks; the mapping holds the app's
    state (``app["db_path"]``)."""

    def __init__(self, middlewares: Tuple[Callable, ...] = ()) -> None:
        super().__init__()
        self.middlewares = list(middlewares)
        self.on_cleanup: List[Callable[["Application"], None]] = []
        self._routes: List[Tuple[str, str, re.Pattern, Handler]] = []
        self._static: List[Tuple[str, str]] = []

    def _add(self, method: str, path: str, handler: Handler) -> None:
        parts = _SEGMENT.split(path)
        regex = "".join(re.escape(p) if i % 2 == 0 else f"(?P<{p}>[^{{}}/]+)"
                        for i, p in enumerate(parts))
        self._routes.append((method, path, re.compile(regex + r"\Z"), handler))

    def add_get(self, path: str, handler: Handler) -> None:
        self._add("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self._add("POST", path, handler)

    def add_static(self, prefix: str, directory: str) -> None:
        self._static.append((prefix.rstrip("/") + "/", os.path.realpath(directory)))

    def routes(self) -> List[Tuple[str, str]]:
        """(method, path pattern) of every route, in the order added."""
        return [(m, p) for m, p, _, _ in self._routes]

    def _static_file(self, request: Request) -> Optional[Response]:
        for prefix, directory in self._static:
            if request.method in ("GET", "HEAD") and request.path.startswith(prefix):
                path = os.path.realpath(os.path.join(directory, request.path[len(prefix):]))
                if not path.startswith(directory + os.sep) or not os.path.isfile(path):
                    return _not_found()
                return FileResponse(path)
        return None

    def handle(self, request: Request) -> Response:
        static = self._static_file(request)
        if static is not None:
            return static
        allowed = False
        wanted = "GET" if request.method == "HEAD" else request.method
        for method, _, regex, handler in self._routes:
            m = regex.match(request.path)
            if m is None:
                continue
            if method != wanted:
                allowed = True
                continue
            request.match_info = m.groupdict()
            call = handler
            for mw in reversed(self.middlewares):
                call = (lambda mw, inner: lambda req: mw(req, inner))(mw, call)
            return call(request)
        if allowed:
            return Response(text="405: Method Not Allowed", status=405, content_type="text/plain")
        return _not_found()

    def cleanup(self) -> None:
        for hook in self.on_cleanup:
            hook(self)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    app: Application  # set on the subclass each server makes

    def _dispatch(self) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        request = Request(self.app, self.command, self.path, self.headers, body)
        try:
            resp = self.app.handle(request)
        except Exception:
            log.exception("%s %s failed", self.command, self.path)
            resp = Response(text="500 Internal Server Error", status=500,
                            content_type="text/plain")
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(resp.body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(resp.body)

    do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = do_HEAD = _dispatch

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        log.debug("%s " + format, self.address_string(), *args)


class AppServer:
    """``app`` served on ``host:port`` by a thread per request, from a
    background thread; ``port=0`` takes a free port (``self.port``)."""

    def __init__(self, app: Application, host: str = "127.0.0.1", port: int = 0) -> None:
        handler = type("Handler", (_Handler,), {"app": app})
        self.app = app
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name=f"http-{self.port}", daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop serving, then run the app's cleanup hooks."""
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join()
        self.app.cleanup()


def run_app(app: Application, host: str = "0.0.0.0", port: int = 8000) -> None:
    """Serve ``app`` until interrupted (SIGINT or SIGTERM), then clean up."""
    import signal

    server = AppServer(app, host, port)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    log.info("Serving on http://%s:%d", host, server.port)
    try:
        stop.wait()
    finally:
        server.close()
