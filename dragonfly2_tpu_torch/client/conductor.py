"""Peer-task conductor: the download hot loop.

Port of dragonfly2_tpu/client/conductor.py, whole; its frames are the
port's wire messages, which the reference's scheduler decodes.

Capability parity with client/daemon/peer/peertask_conductor.go — register
with the scheduler (:249), receive candidate parents (:659
receivePeerPacket), learn what each parent holds (the piece-task
synchronizer, peertask_piecetask_synchronizer.go — here the parent's
/pieces JSON), dispatch piece fetches across N workers (:1010
downloadPieceWorker), report piece results on the announce stream
(:1211 ReportPieceResult), fall back to source when the scheduler says so
or parents run dry (backSource paths), finish with
DownloadPeerFinished. Blocking piece IO runs in a thread pool under the
asyncio control loop.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import urllib.request

from dragonfly2_tpu_torch.client.dispatcher import PieceDispatcher, TrafficShaper
from dragonfly2_tpu_torch.client.piece_manager import PieceManager
from dragonfly2_tpu_torch.client.storage import StorageManager, TaskMetadata, TaskStorage
from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.rpc.client import SchedulerConnection
from dragonfly2_tpu_torch.telemetry import default_registry
from dragonfly2_tpu_torch.telemetry import tailtrace
from dragonfly2_tpu_torch.telemetry.series import daemon_series
from dragonfly2_tpu_torch.telemetry.tracing import default_tracer
from dragonfly2_tpu_torch.utils import dferrors

logger = logging.getLogger(__name__)


class PeerTaskConductor:
    def __init__(
        self,
        conn: SchedulerConnection,
        storage: StorageManager,
        host: msg.HostInfo,
        peer_id: str,
        task_id: str,
        url: str,
        piece_length: int = 4 << 20,
        workers: int = 4,
        schedule_timeout: float = 10.0,
        shaper: TrafficShaper | None = None,
        back_source_allowed: bool = True,
        headers: dict[str, str] | None = None,
    ):
        self.conn = conn
        self.storage = storage
        self.host = host
        self.peer_id = peer_id
        self.task_id = task_id
        self.url = url
        self.piece_length = piece_length
        self.workers = workers
        self.schedule_timeout = schedule_timeout
        self.shaper = shaper
        self.back_source_allowed = back_source_allowed
        # request headers forwarded to the back-source client (dfget
        # --header / urlMeta.Header in the reference): auth tokens,
        # x-df-* object-store credentials, etc.
        self.headers = dict(headers) if headers else None
        self.piece_manager = PieceManager()
        self.metrics = daemon_series(default_registry())
        self.dispatcher = PieceDispatcher()
        self._parents: dict[str, msg.CandidateParent] = {}
        self._parent_pieces: dict[str, dict] = {}  # parent peer_id -> /pieces doc
        self._needed: set[int] = set()
        self._inflight: set[int] = set()
        self._failed_parents: set[str] = set()
        # parents whose corruption we already reported (piece_worker):
        # concurrent in-flight failures collapse to ONE attribution
        self._reported_corrupt: set[str] = set()
        # mark_done integrity-recovery attempts (evict suspect pieces +
        # re-fetch). Bounded: with no attested chain the eviction pass is
        # blind (evicts everything), and an unbounded loop against a
        # persistently lying parent would re-transfer the whole task
        # forever.
        self._integrity_recoveries = 0
        # Scheduler-ATTESTED digest chain (NormalTaskResponse): per-piece
        # md5s keyed by piece number + the whole-task sha256. First writer
        # wins so a later response can never weaken a digest we already
        # verified pieces against.
        self._attested_digests: dict[int, str] = {}
        self._attested_task_digest = ""
        self._refreshers: set[asyncio.Task] = set()
        self._done = asyncio.Event()
        self._error: Exception | None = None
        # tail-attribution accumulator (telemetry/tailtrace.py): measured
        # wall-ns per lifecycle phase, indexed by tailtrace.PH_* — a flat
        # float list, never per-piece dicts. The daemon folds in its own
        # failover phases and observes the finished download.
        self.phase_ns = [0.0] * tailtrace.N_PHASES
        self._wave = 0

    # ---------------------------------------------------------------- run

    async def run(self) -> TaskStorage:
        """Drive the task to completion; returns the local TaskStorage."""
        ts = self.storage.register_task(
            TaskMetadata(
                task_id=self.task_id,
                peer_id=self.peer_id,
                url=self.url,
                piece_length=self.piece_length,
            )
        )
        if ts.meta.done:
            return ts  # local reuse, no network (taskManager dedup)
        # reused storage keeps the PREVIOUS attempt's peer_id; this run
        # registers under a fresh one, and rot self-reports must name a
        # peer the scheduler knows or quarantine silently no-ops
        if ts.meta.peer_id != self.peer_id:
            ts.set_peer_id(self.peer_id)
        queue = self.conn.subscribe(self.peer_id)
        try:
            t0 = time.perf_counter_ns()
            # blocking HEAD off-loop: a blackholed origin must not freeze
            # every other conductor/proxy on this daemon
            content_length = await asyncio.to_thread(self._probe_content_length)
            # Mid-task re-announce: pieces already on disk (a previous
            # attempt before scheduler failover/restart) ride the register
            # so the scheduler ADOPTS the partial download — it resumes
            # piece state instead of treating this as a brand-new peer
            # (cluster/scheduler.py register_peer adoption).
            kept = sorted(ts.finished_pieces())
            await self.conn.send(
                msg.RegisterPeerRequest(
                    peer_id=self.peer_id,
                    task_id=self.task_id,
                    host=self.host,
                    url=self.url,
                    content_length=content_length,
                    piece_length=self.piece_length,
                    total_piece_count=max(ts.meta.total_pieces, 0),
                    finished_pieces=kept or None,
                )
            )
            self.phase_ns[tailtrace.PH_REGISTER] += (
                time.perf_counter_ns() - t0
            )
            if self.shaper is not None:
                self.shaper.register_task(self.task_id)
            await self._drive(ts, queue)
            if self._error is not None:
                # dfget LeavePeer parity: a failed attempt's peer leaves the
                # swarm NOW — candidate fill would otherwise keep
                # advertising a peer that will never serve until GC
                # reaps it. Success stays registered: finished peers ARE
                # the swarm's parents.
                try:
                    await self.conn.send(
                        msg.LeavePeerRequest(peer_id=self.peer_id)
                    )
                except (OSError, RuntimeError):
                    pass  # the stream died with the download; GC reaps it
                raise self._error
            return ts
        finally:
            if self.shaper is not None:
                self.shaper.unregister_task(self.task_id)
            self.conn.unsubscribe(self.peer_id)

    def _probe_content_length(self) -> int:
        from dragonfly2_tpu_torch.client import source as source_pkg

        try:
            return source_pkg.content_length(self.url, self.headers)
        except dferrors.DFError:
            return -1

    async def _drive(self, ts: TaskStorage, queue: asyncio.Queue) -> None:
        while not self._done.is_set():
            t0 = time.perf_counter_ns()
            try:
                response = await asyncio.wait_for(queue.get(), self.schedule_timeout)
            except asyncio.TimeoutError:
                self.phase_ns[tailtrace.PH_SCHEDULE_WAIT] += (
                    time.perf_counter_ns() - t0
                )
                if self.back_source_allowed:
                    logger.warning("%s: schedule timeout, back-to-source", self.peer_id)
                    await self._back_to_source(ts)
                    return
                self._error = dferrors.DeadlineExceeded(
                    f"{self.peer_id}: no schedule response in {self.schedule_timeout}s"
                )
                return
            self.phase_ns[tailtrace.PH_SCHEDULE_WAIT] += (
                time.perf_counter_ns() - t0
            )
            if isinstance(response, msg.EmptyTaskResponse):
                ts.mark_done(0, 0)
                await self._finish(ts)
                return
            if isinstance(response, msg.NeedBackToSourceResponse):
                await self._back_to_source(
                    ts, trace_context=getattr(response, "trace_context", None)
                )
                return
            if isinstance(response, msg.ScheduleFailure):
                if response.code == "Unavailable":
                    # synthesized by the client read loop when the announce
                    # stream itself died (rpc/client.py _read_loop) — not a
                    # scheduling verdict. Surface it as retryable so the
                    # daemon redials the restarted scheduler instead of
                    # silently abandoning P2P for the origin (or failing
                    # permanently when back-source is disallowed).
                    self._error = dferrors.Unavailable(
                        f"scheduler stream died: {response.description}"
                    )
                    return
                if self.back_source_allowed:
                    await self._back_to_source(
                        ts,
                        trace_context=getattr(response, "trace_context", None),
                    )
                    return
                self._error = dferrors.FailedPrecondition(
                    f"schedule failed: {response.code} {response.description}"
                )
                return
            if isinstance(response, msg.NormalTaskResponse):
                self._wave += 1
                for number, digest in (response.piece_digests or {}).items():
                    self._attested_digests.setdefault(int(number), digest)
                if response.task_digest and not self._attested_task_digest:
                    self._attested_task_digest = response.task_digest
                done = await self._download_from_parents(
                    ts, response.candidate_parents,
                    trace_context=getattr(response, "trace_context", None),
                )
                if done:
                    await self._finish(ts)
                    return
                # parents exhausted: ask for different ones
                await self.conn.send(
                    msg.RescheduleRequest(
                        peer_id=self.peer_id,
                        candidate_parent_ids=sorted(self._failed_parents),
                        description="parents exhausted",
                    )
                )

    # ------------------------------------------------------------- parents

    async def _download_from_parents(
        self, ts: TaskStorage, parents: list[msg.CandidateParent],
        trace_context: dict | None = None,
    ) -> bool:
        """Pull every needed piece from the given parents; True if the task
        completed. `trace_context` is the scheduling response's propagated
        context (rpc/wire.py envelope): the download span continues the
        SCHEDULER TICK's trace, so one trace id covers the tick and the
        piece downloads it caused."""
        with default_tracer().span(
            "dfdaemon.download_pieces", remote_parent=trace_context,
            task_id=self.task_id, parents=len(parents),
        ):
            return await self._download_from_parents_inner(ts, parents)

    async def _download_from_parents_inner(
        self, ts: TaskStorage, parents: list[msg.CandidateParent]
    ) -> bool:
        for parent in parents:
            self._parents[parent.peer_id] = parent
        live = [p for p in parents if p.peer_id not in self._failed_parents]
        if not live:
            return False
        # sync piece inventories (the synchronizer step)
        docs = await asyncio.gather(
            *(asyncio.to_thread(self._fetch_piece_doc, p) for p in live)
        )
        total_pieces = ts.meta.total_pieces
        content_length = ts.meta.content_length
        for parent, doc in zip(live, docs):
            if doc is None:
                self._failed_parents.add(parent.peer_id)
                continue
            self._parent_pieces[parent.peer_id] = doc
            if doc.get("done") and doc.get("total_pieces", -1) >= 0:
                # a parent's /pieces doc is SELF-attested: only fill
                # metadata we don't already have authoritatively (from
                # registration or the scheduler) — a lying done=true doc
                # must not override known-good totals and push mark_done
                # into a bogus integrity failure
                if total_pieces is None or total_pieces < 0:
                    total_pieces = doc["total_pieces"]
                if content_length is None or content_length < 0:
                    content_length = doc["content_length"]
        if total_pieces is None or total_pieces < 0:
            return False
        have = set(ts.finished_pieces())
        self._needed = set(range(total_pieces)) - have
        if not self._needed:
            return await self._try_mark_done(ts, content_length, total_pieces)

        # queue (piece, parent) jobs for every needed piece a parent holds
        for parent_id, doc in self._parent_pieces.items():
            if parent_id in self._failed_parents:
                continue
            available = {p["number"] for p in doc.get("pieces", [])}
            for number in self._needed & available:
                self.dispatcher.put(number, parent_id)

        # Push-style piece announcements (the reference's per-parent
        # SyncPieceTasks stream, peertask_piecetask_synchronizer.go):
        # every IN-PROGRESS parent gets a subscriber task long-polling
        # its /pieces endpoint — new pieces land in the dispatcher as
        # the parent commits them, instead of waiting for the next
        # whole-wave re-poll. Workers stay alive while any subscription
        # might still produce work.
        self._refreshers = {
            asyncio.create_task(self._piece_refresher(p))
            for p in live
            if not (self._parent_pieces.get(p.peer_id) or {}).get("done")
        }
        try:
            workers = [
                asyncio.create_task(self._piece_worker(ts)) for _ in range(self.workers)
            ]
            await asyncio.gather(*workers)
        finally:
            for r in self._refreshers:
                r.cancel()
            await asyncio.gather(*self._refreshers, return_exceptions=True)
            self._refreshers = set()
        if not self._needed:
            return await self._try_mark_done(ts, content_length, total_pieces)
        return False

    async def _try_mark_done(self, ts, content_length, total_pieces) -> bool:
        """mark_done with recovery, off the event loop (it sha256-hashes
        the whole data file — blocking here would stall every coroutine on
        the daemon for the hash duration of a multi-GiB task).

        A whole-task sha256 mismatch means some committed piece is corrupt
        DESPITE per-piece checks — it was fetched under header-only
        verification before the attested chain arrived (a consistent liar
        slips the header check). Without recovery the task would wedge:
        the corrupt piece sits in the finished set with a matching
        recorded digest, every retry re-adopts it, and mark_done raises
        forever. Evict every piece that is suspect under the NOW-complete
        attested chain (stored digest disagrees with the attested md5, or
        no attested entry to judge by) and return False — the evicted
        pieces rejoin _needed on the next wave and are re-fetched under
        full attestation. A TaskIntegrityError (hole / length mismatch:
        the completion METADATA was wrong, e.g. a lying parent doc on a
        task with no authoritative totals) gets the same eviction pass;
        either way the download stays resumable instead of hard-failing
        unattributed."""
        t0 = time.perf_counter_ns()
        try:
            await asyncio.to_thread(
                ts.mark_done, content_length, total_pieces,
                expected_digest=self._attested_task_digest,
            )
            self.phase_ns[tailtrace.PH_VERIFY] += time.perf_counter_ns() - t0
            return True
        except (dferrors.PieceCorrupted, dferrors.TaskIntegrityError) as e:
            self.phase_ns[tailtrace.PH_VERIFY] += time.perf_counter_ns() - t0
            self._integrity_recoveries += 1
            if self._integrity_recoveries > 2:
                # two eviction+re-fetch rounds already failed: the
                # attestation or the metadata source is persistently
                # inconsistent — fail loudly rather than re-transfer the
                # task forever
                raise
            # snapshot items(): a concurrent verify-on-serve eviction on
            # an upload thread may pop entries while we scan
            suspects = [
                number for number, piece in list(ts.meta.pieces.items())
                if self._attested_digests.get(number) != piece.digest
            ]
            evicted = ts.evict_pieces(suspects)
            logger.warning(
                "task %s failed integrity at mark_done (%s); evicted %d "
                "suspect piece(s) for re-fetch (recovery %d/2)",
                ts.meta.task_id, e, len(evicted), self._integrity_recoveries,
            )
            if not evicted:
                # every piece matches the attested chain yet completion
                # still fails: the attestation or claimed totals are
                # themselves inconsistent — re-fetching cannot fix that
                raise
            return False

    async def _piece_refresher(self, parent: msg.CandidateParent) -> None:
        """Subscribe to one in-progress parent: long-poll its /pieces with
        wait_after = what we already know, feeding each newly announced
        piece into the dispatcher. Ends when the parent completes, fails,
        or nothing is needed anymore."""
        pid = parent.peer_id
        idle_polls = 0
        while self._needed and pid not in self._failed_parents:
            doc = self._parent_pieces.get(pid) or {}
            if doc.get("done"):
                return
            known = len(doc.get("pieces", []))
            new_doc = await asyncio.to_thread(
                self._fetch_piece_doc, parent, known, 5.0
            )
            if new_doc is None:
                self._failed_parents.add(pid)
                return
            if len(new_doc.get("pieces", [])) <= known and not new_doc.get("done"):
                # timed-out long-poll: the parent is alive but idle — not
                # a failure. Give up the subscription after a few idle
                # rounds so a stalled parent ends the wave (and the
                # conductor reschedules) instead of pinning it forever.
                idle_polls += 1
                if idle_polls >= 3:
                    return
                continue
            idle_polls = 0
            self._parent_pieces[pid] = new_doc
            available = {p["number"] for p in new_doc.get("pieces", [])}
            for number in self._needed & available:
                self.dispatcher.put(number, pid)

    def _fetch_piece_doc(
        self, parent: msg.CandidateParent,
        wait_after: int | None = None, timeout: float | None = None,
    ) -> dict | None:
        """GET the parent's /pieces listing. With `wait_after`, long-poll:
        the parent blocks until it holds MORE than that many pieces (or
        completes, or `timeout` seconds pass) and then answers with its
        current listing — the push half of piece announcements
        (upload.py's wait_after route). The transport timeout is the
        long-poll timeout plus slack, so an idle parent's timed-out
        long-poll comes back as "no new pieces yet" (the unchanged
        listing), NOT as a failed parent."""
        url = f"http://{parent.ip}:{parent.download_port}/pieces/{self.task_id}"
        request_timeout = 5.0
        if wait_after is not None:
            poll = 10.0 if timeout is None else timeout
            url += f"?wait_after={int(wait_after)}&timeout={poll:g}"
            request_timeout = poll + 5.0
        try:
            with urllib.request.urlopen(url, timeout=request_timeout) as resp:
                return json.load(resp)
        except Exception:  # noqa: BLE001 - any failure marks the parent bad
            return None

    async def _piece_worker(self, ts: TaskStorage) -> None:
        """downloadPieceWorker: pop jobs until the queue drains AND no
        piece subscription can still announce more work. Returning on the
        first empty poll would orphan the refreshers' pieces in the
        dispatcher — the wave would end with the task incomplete even
        though an in-progress parent was still committing pieces."""
        while True:
            job = self.dispatcher.get()
            if job is None:
                if not self._needed:
                    return
                if not any(not r.done() for r in self._refreshers):
                    return  # no subscription left to produce work
                await asyncio.sleep(0.05)
                continue
            number, parent_id = job
            if number not in self._needed or number in self._inflight:
                continue
            parent = self._parents.get(parent_id)
            if parent is None or parent_id in self._failed_parents:
                continue
            doc = self._parent_pieces.get(parent_id, {})
            piece_meta = next(
                (p for p in doc.get("pieces", []) if p["number"] == number), None
            )
            if piece_meta is None:
                continue
            self._inflight.add(number)
            if self.shaper is not None:
                await asyncio.to_thread(
                    self.shaper.acquire, self.task_id, piece_meta["length"]
                )
            t0 = time.perf_counter_ns()
            try:
                nbytes = await asyncio.to_thread(
                    self.piece_manager.download_piece_from_parent,
                    ts, parent.ip, parent.download_port, number, piece_meta["offset"],
                    self._attested_digests.get(number, ""),
                )
            except dferrors.DFError as e:
                self._inflight.discard(number)
                self._failed_parents.add(parent_id)
                self.metrics.piece_task_failed.labels().inc()
                # Attribution matters: a corrupt piece (bytes failed their
                # scheduler-attested digest) quarantines the parent HOST
                # cluster-wide, a plain transport failure only blocklists
                # it for this child.
                corrupt = isinstance(e, dferrors.PieceCorrupted)
                logger.info("piece %d from %s failed%s: %s", number, parent_id,
                            " (corrupt)" if corrupt else "", e)
                if corrupt:
                    # one corruption attribution per parent: concurrent
                    # in-flight fetches all fail their digest check at
                    # once, and reporting each would multiply the
                    # scheduler's (already immediate) quarantine penalty
                    if parent_id in self._reported_corrupt:
                        continue
                    self._reported_corrupt.add(parent_id)
                await self.conn.send(
                    msg.DownloadPieceFailedRequest(
                        peer_id=self.peer_id, parent_peer_id=parent_id,
                        reason="corruption" if corrupt else "",
                    )
                )
                continue
            cost = time.perf_counter_ns() - t0
            self._inflight.discard(number)
            self._needed.discard(number)
            # first-wave fetches are parent_fetch time; every wave after a
            # reschedule is retry time (disjoint, so the phase vector
            # still sums to the measured total)
            self.phase_ns[
                tailtrace.PH_PARENT_FETCH if self._wave <= 1
                else tailtrace.PH_RETRY
            ] += cost
            self.metrics.piece_task.labels().inc()
            self.dispatcher.report_cost(parent_id, cost)
            if self.shaper is not None:
                self.shaper.record(self.task_id, nbytes)
            await self.conn.send(
                msg.DownloadPieceFinishedRequest(
                    peer_id=self.peer_id,
                    piece_number=number,
                    length=nbytes,
                    cost_ns=cost,
                    parent_peer_id=parent_id,
                )
            )

    # ------------------------------------------------------------- source

    async def _back_to_source(
        self, ts: TaskStorage, trace_context: dict | None = None,
    ) -> None:
        """Origin fallback. ``trace_context`` is the triggering
        response's propagated envelope (NeedBackToSource /
        ScheduleFailure): the fallback span continues the SCHEDULER's
        trace instead of silently truncating it at the hop most likely
        to matter in a tail read (the timeout path has no response and
        stays on the ambient context)."""
        t0 = time.perf_counter_ns()
        try:
            with default_tracer().span(
                "dfdaemon.back_to_source", remote_parent=trace_context,
                task_id=self.task_id,
            ):
                await self._back_to_source_inner(ts)
        finally:
            self.phase_ns[tailtrace.PH_BACK_TO_SOURCE] += (
                time.perf_counter_ns() - t0
            )

    async def _back_to_source_inner(self, ts: TaskStorage) -> None:
        await self.conn.send(
            msg.DownloadPeerBackToSourceStartedRequest(peer_id=self.peer_id)
        )
        loop = asyncio.get_running_loop()

        def on_piece(number: int, length: int, cost_ns: int, digest: str = "") -> None:
            self.metrics.piece_task.labels().inc()
            asyncio.run_coroutine_threadsafe(
                self.conn.send(
                    msg.DownloadPieceFinishedRequest(
                        peer_id=self.peer_id, piece_number=number,
                        length=length, cost_ns=cost_ns,
                        # origin-computed md5: the trust anchor of the
                        # task's digest chain (the scheduler only adopts
                        # digests from back-to-source reports)
                        digest=digest,
                    )
                ),
                loop,
            ).result()

        try:
            content_length, pieces = await asyncio.to_thread(
                self.piece_manager.download_source, ts, self.url, self.headers, on_piece
            )
        except dferrors.DFError as e:
            self._error = e
            await self.conn.send(
                msg.DownloadPeerBackToSourceFailedRequest(
                    peer_id=self.peer_id, description=str(e)
                )
            )
            self._done.set()
            return
        await self.conn.send(
            msg.DownloadPeerBackToSourceFinishedRequest(
                peer_id=self.peer_id, content_length=content_length,
                piece_count=pieces,
                # whole-task sha256 from mark_done: the chain's root
                task_digest=ts.meta.digest,
            )
        )
        self._done.set()

    async def _finish(self, ts: TaskStorage) -> None:
        await self.conn.send(
            msg.DownloadPeerFinishedRequest(
                peer_id=self.peer_id,
                content_length=ts.meta.content_length,
                piece_count=ts.meta.total_pieces,
            )
        )
        self._done.set()
