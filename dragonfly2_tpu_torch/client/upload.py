"""HTTP piece server: parents serve stored pieces to children.

Port of dragonfly2_tpu/client/upload.py, whole. The routes, headers and
the JSON piece list are the reference's bytes, so a child of either
package fetches from a parent of the other.

Capability parity with client/daemon/upload/upload_manager.go:270 (the
peer-to-peer data path — piece bytes move as HTTP range responses, SURVEY
§2.6). Routes:
  GET /download/{task_id}?piece={n}      -> one piece's bytes
  GET /download/{task_id}                -> whole stored file (Range ok)
  GET /pieces/{task_id}                  -> stored piece metadata (JSON) —
                                            the GetPieceTasks/SyncPieceTasks
                                            equivalent children use to learn
                                            what a parent can serve
  GET /pieces/{task_id}?wait_after=N[&timeout=S]
                                         -> LONG-POLL: block until the task
                                            holds MORE than N pieces (or is
                                            done, or S seconds pass), then
                                            answer with the current listing.
                                            This is the push half of piece
                                            announcements: a child subscribes
                                            to an in-progress parent and
                                            learns each new piece within one
                                            notification instead of one
                                            re-poll round trip per wave
                                            (peertask_piecetask_synchronizer
                                            .go's per-parent sync stream)
  GET /healthy                           -> liveness
Headers carry the piece digest so children can verify before commit.
"""

from __future__ import annotations

import http.server
import json
import threading
import time
import urllib.parse

from dragonfly2_tpu_torch.client.storage import StorageManager
from dragonfly2_tpu_torch.utils import dferrors
from dragonfly2_tpu_torch.utils.digest import md5_from_bytes


class UploadServer:
    def __init__(self, storage: StorageManager, host: str = "127.0.0.1", port: int = 0,
                 fault_injector=None, on_piece_rot=None):
        self.storage = storage
        # Verify-on-serve hook: called as on_piece_rot(task_id, number)
        # when a stored piece's bytes no longer match their recorded
        # digest (local disk rot / torn write). The daemon wires this to a
        # self-reported reason="corruption" piece failure so the scheduler
        # stops advertising this peer for the task instead of letting
        # children discover the rot one wasted transfer at a time.
        self.on_piece_rot = on_piece_rot
        # Scenario-lab hook (scenarios/engine.FaultInjector): when set,
        # piece serving consults it per (task, piece, attempt) and may
        # answer 503 or stall before serving — faults injected at the
        # PARENT so the child daemon exercises its real retry path
        # (piece failure -> DownloadPieceFailed -> reschedule), not a
        # simulator-only shortcut. None (production) costs one attribute
        # read per piece request.
        self.fault_injector = fault_injector
        manager = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_GET(self):  # noqa: N802 - stdlib API
                parts = urllib.parse.urlsplit(self.path)
                if parts.path == "/healthy":
                    self._reply(200, b"ok")
                    return
                if parts.path.startswith("/pieces/"):
                    q = urllib.parse.parse_qs(parts.query)
                    wait_after = (
                        int(q["wait_after"][0]) if "wait_after" in q else None
                    )
                    timeout = float(q.get("timeout", ["10.0"])[0])
                    self._serve_piece_list(
                        parts.path[len("/pieces/") :], wait_after, timeout
                    )
                    return
                if not parts.path.startswith("/download/"):
                    self._reply(404, b"not found")
                    return
                task_id = parts.path[len("/download/") :]
                ts = manager.storage.get(task_id)
                if ts is None:
                    self._reply(404, b"task not stored")
                    return
                query = urllib.parse.parse_qs(parts.query)
                if "piece" in query:
                    self._serve_piece(ts, int(query["piece"][0]))
                else:
                    self._serve_file(ts)

            def _serve_piece_list(
                self, task_id: str, wait_after: int | None = None,
                timeout: float = 10.0,
            ):
                ts = manager.storage.get(task_id)
                if ts is None:
                    self._reply(404, b"task not stored")
                    return
                if wait_after is not None:
                    # long-poll: parks THIS handler thread on the task's
                    # piece condition (bounded by the capped timeout) —
                    # ThreadingHTTPServer spawns per-connection threads,
                    # so parked subscribers do not block other uploads
                    ts.wait_for_pieces(wait_after, min(timeout, 30.0))
                meta = ts.meta
                body = json.dumps(
                    {
                        "task_id": meta.task_id,
                        "content_length": meta.content_length,
                        "piece_length": meta.piece_length,
                        "total_pieces": meta.total_pieces,
                        "done": meta.done,
                        "pieces": [
                            {
                                "number": p.number,
                                "offset": p.offset,
                                "length": p.length,
                                "digest": p.digest,
                            }
                            for p in sorted(meta.pieces.values(), key=lambda p: p.number)
                        ],
                    }
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _serve_piece(self, ts, number: int):
                if not ts.has_piece(number):
                    self._reply(404, b"piece not stored")
                    return
                injector = manager.fault_injector
                verdict = None
                if injector is not None:
                    verdict = injector.piece_fault(ts.meta.task_id, number)
                    if verdict == "error":
                        self._reply(503, b"injected fault")
                        return
                    if verdict == "stall":
                        time.sleep(injector.stall_seconds)
                try:
                    piece = ts.meta.pieces[number]
                    data = ts.read_piece(number)
                except (KeyError, dferrors.NotFound):
                    # raced a concurrent eviction (another serve of this
                    # rotted piece, or the conductor's mark_done recovery)
                    # between has_piece and the read
                    self._reply(404, b"piece not stored")
                    return
                digest = piece.digest
                if verdict == "corrupt":
                    # Scenario-lab adversary: serve deterministically
                    # corrupted bytes under a SELF-CONSISTENT advisory
                    # header (a lying parent, not a clumsy one) — only
                    # verification against the scheduler-attested chain
                    # catches this.
                    data = injector.corrupt_bytes(ts.meta.task_id, number, data)
                    digest = md5_from_bytes(data)
                elif digest and md5_from_bytes(data) != digest:
                    # Verify-on-serve: the stored bytes no longer hash to
                    # the digest recorded at commit — local disk rot. Never
                    # serve them; EVICT the piece (it leaves the finished
                    # set so the daemon re-fetches instead of answering 503
                    # for this piece forever) and self-report so the
                    # scheduler quarantines this host rather than keeping
                    # it advertised. Only the thread whose evict actually
                    # removed the piece reports — N concurrent serves of
                    # one rot event must not multiply the quarantine
                    # penalty (the conductor dedups its reports the same
                    # way via _reported_corrupt).
                    if ts.evict_piece(number) and manager.on_piece_rot is not None:
                        manager.on_piece_rot(ts.meta.task_id, number)
                    self._reply(503, b"piece failed integrity check")
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-Dragonfly-Piece-Digest", digest)
                self.send_header("X-Dragonfly-Piece-Offset", str(piece.offset))
                self.end_headers()
                self.wfile.write(data)

            def _serve_file(self, ts):
                size = ts.size_on_disk()
                range_header = self.headers.get("Range")
                offset, length = 0, size
                status = 200
                if range_header and range_header.startswith("bytes="):
                    spec = range_header[len("bytes=") :].split("-")
                    offset = int(spec[0]) if spec[0] else 0
                    end = int(spec[1]) if len(spec) > 1 and spec[1] else size - 1
                    length = end - offset + 1
                    status = 206
                data = ts.read_range(offset, length)
                self.send_response(status)
                if status == 206:
                    self.send_header(
                        "Content-Range", f"bytes {offset}-{offset + len(data) - 1}/{size}"
                    )
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _reply(self, code: int, body: bytes):
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> tuple[str, int]:
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self.host, self.port

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
