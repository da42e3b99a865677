"""Port of dragonfly2_tpu/procworld/origin.py, whole.

The harness origin server: a ThreadingHTTPServer with a Range-aware
handler, under every attribute name the reference's tests use (``gets``
and ``get_count``, ``close`` and ``stop``, ``srv`` and ``_server``). The
handler class is PER-INSTANCE so a caller can rebind ``do_GET`` on one
origin (to hold a download open across a kill window) without poisoning
other origins in the same process.
"""

from __future__ import annotations

import http.server
import threading
import time


class OriginServer:
    """A loopback HTTP origin serving one payload with HEAD + Range GET.

    Attributes:
        payload: the bytes served.
        port: bound TCP port.
        gets: GET count (``get_count`` is a read alias).
        bytes_sent: body bytes the GETs wrote (a ``Range: bytes=0-0``
            probe adds 1, a HEAD nothing).
        srv / _server: the underlying ThreadingHTTPServer (both names
            kept — the per-instance handler class hangs off it).
        delay_s: mutable per-GET sleep applied before writing the body —
            the supported way to throttle serving so a kill lands inside
            a real in-flight window (rebinding ``do_GET`` still works).
    """

    def __init__(self, payload: bytes, *, delay_s: float = 0.0):
        self.payload = payload
        self.gets = 0
        self.bytes_sent = 0
        self._mu = threading.Lock()  # the handler threads add to bytes_sent
        self.delay_s = delay_s
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_HEAD(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(outer.payload)))
                self.end_headers()

            def do_GET(self):
                outer.gets += 1
                if outer.delay_s > 0:
                    time.sleep(outer.delay_s)
                body = outer.payload
                rng = self.headers.get("Range")
                status = 200
                if rng and rng.startswith("bytes="):
                    lo, _, hi = rng[len("bytes="):].partition("-")
                    start = int(lo) if lo else 0
                    end = int(hi) if hi else len(body) - 1
                    body = body[start:end + 1]
                    status = 206
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                with outer._mu:
                    outer.bytes_sent += len(body)

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server = self.srv
        self.port = self.srv.server_address[1]
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    @property
    def get_count(self) -> int:
        return self.gets

    def url(self, name: str = "blob.bin") -> str:
        return f"http://127.0.0.1:{self.port}/{name}"

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()

    # the reference tests' alias
    stop = close
