"""Prometheus-text ``/metrics`` (+ JSON ``/health``) HTTP endpoint.

Serves whatever a render callable returns — typically
``registry.prometheus_text`` — on a daemon thread, so the PS serve loop
is never blocked by a scraper. One scrape is one GET; the registry's
collectors refresh instrument values from live server state at render
time, so there is no per-gradient bookkeeping behind this endpoint.

Beyond ``/metrics``, the server takes a ``routes`` dict mapping extra
paths to render callables returning ``(body_str, content_type)`` — the
ops side-channel the diagnosis layer uses for its ``/health`` JSON
(:mod:`.diagnosis`). Routes are resolved at REQUEST time, so a route
registered after construction (a health monitor attached mid-run) is
served without restarting the listener. A route callable that accepts
a positional argument receives the parsed query string as a flat dict
(last value wins) — how ``/history?key=...&window=...`` and
``/fleet?force=1`` take parameters without a second dispatch layer.
"""

from __future__ import annotations

import inspect
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple


def _wants_query(fn: Callable) -> bool:
    """True when ``fn`` can take the query dict as its one positional
    argument (bound methods and lambdas alike); resolved ONCE at
    registration, so request dispatch stays a plain call."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            return True
        if p.kind == p.VAR_POSITIONAL:
            return True
    return False

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsHTTPServer:
    """``GET /metrics`` → the render callable's text; ``GET <route>`` →
    that route's ``(body, content_type)``; anything else 404.

    ``port=0`` auto-assigns (read back via ``.port``). ``close()`` shuts
    the listener down; the object is also a context manager.
    """

    def __init__(self, render: Callable[[], str], port: int = 0,
                 host: str = "0.0.0.0",
                 routes: Optional[
                     Dict[str, Callable[[], Tuple[str, str]]]] = None):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path, _, qs = self.path.partition("?")
                path = path.rstrip("/")
                try:
                    if path in ("/metrics", ""):
                        body, ctype = outer._render(), _CONTENT_TYPE
                    elif path in outer.routes:
                        fn, wants_query = outer.routes[path]
                        if wants_query:
                            query = {k: v[-1] for k, v in
                                     urllib.parse.parse_qs(qs).items()}
                            body, ctype = fn(query)
                        else:
                            body, ctype = fn()
                    else:
                        self.send_error(404)
                        return
                    payload = body.encode()
                except Exception as e:  # a scrape must never kill serving
                    self.send_error(500, f"{type(e).__name__}: {e}")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *a):  # scrapes are not stdout news
                pass

        self._render = render
        # path -> (callable, wants_query) — signature resolved once here
        self.routes: Dict[str, Tuple[Callable, bool]] = {}
        for p, fn in (routes or {}).items():
            self.routes[p.rstrip("/") or p] = (fn, _wants_query(fn))
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name=f"metrics-http:{self.port}",
        )
        self._thread.start()

    def add_route(self, path: str,
                  render: Callable[..., Tuple[str, str]]) -> None:
        """Register ``path`` → ``render([query]) -> (body, content_type)``
        on the live listener (request-time dispatch — no restart)."""
        self.routes[path.rstrip("/")] = (render, _wants_query(render))

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
