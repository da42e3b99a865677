"""Typed RPC clients for the cluster edge.

Port of dragonfly2_tpu/rpc/client.py, whole: host code only, over the
port's wire codec (whose frames the reference decodes) and hash ring.

Capability parity with pkg/rpc clients (pkg/rpc/scheduler/client/
client_v2.go GetV2/GetV2ByAddr typed surface, retry/backoff interceptors in
pkg/rpc/interceptor.go) and pkg/balancer's consistent-hashing policy
(consistent_hashing.go:40-57): a peer picks its scheduler by hashing the
task id onto the scheduler ring, so every RPC for one task lands on the
same scheduler — here via utils/hashring + a per-address connection pool.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import typing

from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.rpc import mux, resilience, wire
from dragonfly2_tpu_torch.telemetry.tracing import default_tracer
from dragonfly2_tpu_torch.utils import dferrors
from dragonfly2_tpu_torch.utils.hashring import HashRing

wire.register_module(msg)

logger = logging.getLogger(__name__)


async def _bounded_wait(awaitable: typing.Awaitable[typing.Any],
                        timeout: float | None, what: str,
                        metrics: typing.Any = None) -> typing.Any:
    """await with the caller's timeout bounded by the ambient deadline
    budget (rpc/resilience.py). A timeout that was BUDGET-bound surfaces
    as DeadlineExceeded (and counts in the deadline family), a plain
    per-call timeout stays asyncio.TimeoutError — callers distinguish
    'the budget ran out' from 'this one call was slow'."""
    effective = resilience.bound_timeout(timeout)
    if effective is not None and effective <= 0:
        if metrics is not None:
            metrics.deadline_exceeded.labels().inc()
        raise dferrors.DeadlineExceeded(f"{what}: deadline budget exhausted")
    try:
        return await asyncio.wait_for(awaitable, effective)
    except asyncio.TimeoutError:
        if effective is not None and (timeout is None or effective < timeout):
            if metrics is not None:
                metrics.deadline_exceeded.labels().inc()
            raise dferrors.DeadlineExceeded(
                f"{what}: deadline budget exhausted after {effective:.3f}s"
            ) from None
        raise


class SchedulerConnection:
    """One long-lived announce stream to a scheduler (AnnouncePeer
    semantics: requests flow up, scheduling responses flow back async)."""

    def __init__(self, host: str, port: int, ssl_context: typing.Any = None,
                 resilience_metrics: typing.Any = None):
        self.host = host
        self.port = port
        self.ssl_context = ssl_context  # ssl.SSLContext for mTLS, None = plaintext
        # resilience_series namespace for the deadline_exceeded counter
        # (the pool passes its board's; a bare connection counts nothing)
        self._res_metrics = resilience_metrics
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._responses: dict[str, asyncio.Queue] = {}
        self._stats: asyncio.Queue = asyncio.Queue()
        self._probe_targets: asyncio.Queue = asyncio.Queue()
        self._health: asyncio.Queue = asyncio.Queue()
        self.seed_triggers: asyncio.Queue = asyncio.Queue()
        self._reader_task: asyncio.Task | None = None
        self._send_lock = asyncio.Lock()
        # set by the daemon once AnnounceHost was sent ON THIS connection
        # (announced-ness cannot outlive the connection: a restarted
        # scheduler has fresh state)
        self.announced = False

    @property
    def is_closed(self) -> bool:
        """True once the transport is gone (peer restart, network cut) —
        the pool uses this to evict dead cached connections and redial,
        the behavior the reference gets from gRPC channel reconnects."""
        if self._writer is None or self._reader is None:
            return False  # never connected; nothing to evict
        return self._writer.is_closing() or self._reader.at_eof()

    async def connect(self) -> "SchedulerConnection":
        from dragonfly2_tpu_torch.utils import vsock as vsock_mod

        if vsock_mod.is_vsock(self.host):
            # vsock://<cid> host + port -> AF_VSOCK dial (pkg/rpc/vsock.go
            # VsockDialer; the client_v1.go WithContextDialer path). The
            # ssl_context rides along — TLS clusters stay TLS over vsock.
            self._reader, self._writer = await vsock_mod.open_connection(
                f"{self.host}:{self.port}", ssl_context=self.ssl_context
            )
        else:
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port, ssl=self.ssl_context
            )
        self._enable_tcp_keepalive()
        self._reader_task = asyncio.create_task(self._read_loop())
        return self

    def _enable_tcp_keepalive(self) -> None:
        """Kernel keepalives (~60 s to declare death) so a SILENT network
        cut — no FIN/RST: power loss, stateful firewall drop — surfaces
        as EOF on the read loop and flips `is_closed`. A mostly-idle seed
        connection would otherwise stay half-open forever and never learn
        its scheduler died (grpc's keepalive pings play this role for the
        reference)."""
        import socket as _socket

        sock = self._writer.get_extra_info("socket") if self._writer else None
        if sock is None:
            return
        try:
            sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_KEEPALIVE, 1)
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_KEEPIDLE, 30)
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_KEEPINTVL, 10)
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_KEEPCNT, 3)
        except (OSError, AttributeError):
            pass  # non-TCP transports (vsock) / platforms without the knobs

    async def close(self) -> None:
        if self._reader_task:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except asyncio.CancelledError:
                pass
        if self._writer:
            self._writer.close()

    async def _read_loop(self) -> None:
        assert self._reader is not None
        while True:
            response = await wire.read_frame(self._reader)
            if response is None:
                # connection died: wake every waiter with the failure
                for q in self._responses.values():
                    q.put_nowait(
                        msg.ScheduleFailure(peer_id="", code="Unavailable", description="stream closed")
                    )
                return
            if isinstance(response, msg.StatResponse):
                self._stats.put_nowait(response)
            elif isinstance(response, mux.HealthCheckResponse):
                self._health.put_nowait(response)
            elif isinstance(response, msg.ProbeTargetsResponse):
                self._probe_targets.put_nowait(response)
            elif isinstance(response, msg.TriggerSeedRequest):
                self.seed_triggers.put_nowait(response)
            else:
                peer_id = getattr(response, "peer_id", "")
                q = self._responses.get(peer_id)
                if q is not None:
                    q.put_nowait(response)
                else:
                    logger.debug("dropping response for unknown peer %s", peer_id)

    async def send(self, request: typing.Any) -> None:
        assert self._writer is not None
        async with self._send_lock:
            wire.write_frame(self._writer, request)
            await self._writer.drain()

    def subscribe(self, peer_id: str) -> asyncio.Queue:
        return self._responses.setdefault(peer_id, asyncio.Queue())

    def unsubscribe(self, peer_id: str) -> None:
        self._responses.pop(peer_id, None)

    # ---------------------------------------------------- request/response
    # Per-call deadline enforcement: the caller's own timeout is bounded by
    # the ambient deadline budget (rpc/resilience.py), and the request
    # frame carries the remaining budget for the server's shed check.

    def _check(self, what: str) -> None:
        try:
            resilience.check(what)
        except dferrors.DeadlineExceeded:
            if self._res_metrics is not None:
                self._res_metrics.deadline_exceeded.labels().inc()
            raise

    async def stat_peer(self, peer_id: str, timeout: float = 5.0) -> msg.StatResponse:
        self._check("stat_peer")
        await self.send(msg.StatPeerRequest(peer_id=peer_id))
        return await _bounded_wait(self._stats.get(), timeout, "stat_peer",
                                   metrics=self._res_metrics)

    async def stat_task(self, task_id: str, timeout: float = 5.0) -> msg.StatResponse:
        self._check("stat_task")
        await self.send(msg.StatTaskRequest(task_id=task_id))
        return await _bounded_wait(self._stats.get(), timeout, "stat_task",
                                   metrics=self._res_metrics)

    async def sync_probes(
        self, host_id: str, count: int = 10, timeout: float = 5.0
    ) -> list[msg.ProbeTarget]:
        self._check("sync_probes")
        await self.send(msg.ProbeStartedRequest(host_id=host_id, count=count))
        response = await _bounded_wait(self._probe_targets.get(), timeout,
                                       "sync_probes", metrics=self._res_metrics)
        return response.targets

    async def health(self, timeout: float = 2.0) -> bool:
        """One HealthCheck round trip on the live stream (pkg/rpc/health) —
        the half-open breaker probe rides this instead of inventing a new
        message."""
        await self.send(mux.HealthCheckRequest(service="scheduler"))
        response = await _bounded_wait(self._health.get(), timeout, "health",
                                       metrics=self._res_metrics)
        return response.status == mux.SERVING


class SchedulerClientPool:
    """Task-affine scheduler selection over a scheduler set (the
    consistent-hashing balancer + resolver pair)."""

    def __init__(self, addresses: list[tuple[str, int]],
                 ssl_context: typing.Any = None,
                 breaker_failure_threshold: int = 2,
                 breaker_open_ttl: float = 5.0):
        if not addresses:
            raise ValueError("need at least one scheduler address")
        self.ssl_context = ssl_context
        # (ring, addr) swap as ONE tuple: update_addresses runs on the
        # dynconfig worker thread while the event loop reads in for_task;
        # two separate assignments could pair a new ring with the old addr
        # map and KeyError on a just-added scheduler.
        self._state: tuple[HashRing, dict] = (
            HashRing([f"{h}:{p}" for h, p in addresses]),
            {f"{h}:{p}": (h, p) for h, p in addresses},
        )
        # Per-target dial breakers (rpc/resilience.py): a blackholed
        # scheduler costs `failure_threshold` dial timeouts, then every
        # later dial fast-fails until the open_ttl probe window.
        self.breakers = resilience.BreakerBoard(
            "dfdaemon", failure_threshold=breaker_failure_threshold,
            open_ttl=breaker_open_ttl,
        )
        self._conns: dict[str, SchedulerConnection] = {}
        # (connection, parked_at): closed by for_task only after a grace
        # period, so an RPC already in flight on a just-removed scheduler
        # finishes instead of dying mid-exchange. Guarded by _stale_mu
        # (a THREAD lock, held only across list ops, never an await):
        # the dynconfig worker thread appends while _get swaps, and an
        # unguarded append landing on the just-swapped-out list would
        # leak that connection unclosed forever.
        self._stale_conns: list[tuple[SchedulerConnection, float]] = []
        self._stale_mu = threading.Lock()
        self._lock = asyncio.Lock()

    STALE_CLOSE_GRACE_S = 30.0

    @property
    def _ring(self) -> HashRing:
        return self._state[0]

    @property
    def _addr(self) -> dict:
        return self._state[1]

    def update_addresses(self, addresses: list[tuple[str, int]]) -> None:
        """Dynconfig-driven refresh (pkg/resolver semantics). Thread-safe
        against the event loop: one atomic tuple swap; connections to
        removed schedulers are parked and closed on the loop by the next
        for_task (closing an asyncio transport from this worker thread
        would race the loop)."""
        addr = {f"{h}:{p}": (h, p) for h, p in addresses}
        self._state = (HashRing(list(addr)), addr)
        import time as _time

        for key in list(self._conns):
            if key not in addr:
                # _lock is an asyncio.Lock owned by the event loop; this
                # worker thread cannot await it. The pop is GIL-atomic; a
                # conn _get resurrects concurrently is parked and closed by
                # the next update sweep (docstring above)
                conn = self._conns.pop(key, None)
                if conn is not None:
                    with self._stale_mu:
                        self._stale_conns.append((conn, _time.monotonic()))
        # breakers follow ring membership: a decommissioned scheduler's
        # breaker must not linger as a stuck-open gauge
        for target in self.breakers.targets():
            if target not in addr:
                self.breakers.drop(target)

    async def for_task(self, task_id: str) -> SchedulerConnection:
        """Live connection for a task: the hashring PRIMARY when it is
        healthy, else ring-order failover — breaker-open or dial-dead
        candidates are skipped and the task lands on the next ring node
        (where it would also land if the primary left the ring, so the
        failed-over task keeps scheduler affinity through the outage).
        The happy path pays one O(log n) pick; the full successor walk
        (nodes x replicas) is built only after the primary failed."""
        ring, addr = self._state
        primary = ring.pick(task_id)
        if primary is None:
            raise RuntimeError("scheduler ring is empty")
        try:
            # _get returns a live cached connection without consulting the
            # breaker (it guards DIALS, not established streams), so the
            # healthy-primary fast path costs one dict lookup
            return await self._get(primary, addr)
        except (resilience.BreakerOpen, OSError, asyncio.TimeoutError) as e:
            last_err: Exception = e
        failed = primary
        for key in ring.successors(task_id):
            if key == primary:
                continue
            logger.warning(
                "scheduler %s unavailable (%s); failing over to next "
                "ring node", failed, type(last_err).__name__,
            )
            try:
                return await self._get(key, addr)
            except (resilience.BreakerOpen, OSError, asyncio.TimeoutError) as e:
                last_err = e
                failed = key
                continue
        raise last_err

    def primary_for_task(self, task_id: str) -> str | None:
        """The hashring owner of `task_id` (chaos tests and operators ask
        'which scheduler should this task be on')."""
        return self._state[0].pick(task_id)

    def size(self) -> int:
        """Configured scheduler count (the ring membership, not how many
        connections happen to be open)."""
        return len(self._state[1])

    DIAL_TIMEOUT_S = 5.0

    async def for_address(self, host: str, port: int) -> SchedulerConnection:
        """Live connection to a SPECIFIC scheduler (seed loops are bound
        to the scheduler that owns them, not to a task hash). Raises
        LookupError when that scheduler has left the active set — callers
        must NOT resurrect schedulers dynconfig decommissioned."""
        key = f"{host}:{port}"
        _, addr = self._state
        if key not in addr:
            raise LookupError(f"scheduler {key} no longer in the active set")
        return await self._get(key, addr)

    async def _get(self, key: str, addr: dict) -> SchedulerConnection:
        async with self._lock:
            import time as _time

            now = _time.monotonic()
            # swap the list out under the thread lock: the dynconfig
            # worker appends concurrently, and an append racing the swap
            # would land on the dead list and leak its connection
            with self._stale_mu:
                pending, self._stale_conns = self._stale_conns, []
            for parked, at in pending:
                if now - at < self.STALE_CLOSE_GRACE_S:
                    with self._stale_mu:
                        self._stale_conns.append((parked, at))
                    continue
                try:
                    await parked.close()
                except Exception:  # noqa: BLE001 - best-effort teardown
                    pass
            conn = self._conns.get(key)
            if conn is not None and conn.is_closed:
                # scheduler restarted / connection died: evict and redial
                self._conns.pop(key, None)
                try:
                    await conn.close()
                except Exception:  # noqa: BLE001 - already dead
                    pass
                conn = None
            if conn is not None:
                return conn
        # Dial OUTSIDE the pool lock, bounded: one blackholed scheduler
        # (SYN drop after its connection died) must not stall every
        # download to the healthy ones behind this lock for the kernel's
        # multi-minute connect timeout. The dial runs under the target's
        # circuit breaker: an open breaker raises BreakerOpen in
        # microseconds instead of paying the timeout again, and the first
        # dial after open_ttl runs as the half-open probe — verified with
        # a HealthCheck round trip before the breaker closes.
        breaker_state = self.breakers.acquire(key)
        host, port = addr[key]
        fresh = SchedulerConnection(
            host, port, ssl_context=self.ssl_context,
            resilience_metrics=self.breakers.metrics,
        )
        try:
            await asyncio.wait_for(fresh.connect(), timeout=self.DIAL_TIMEOUT_S)
            if breaker_state == resilience.HALF_OPEN:
                if not await fresh.health():
                    raise ConnectionError(f"{key}: half-open probe NOT_SERVING")
        except BaseException as e:
            # Only a refusal/timeout is evidence against the TARGET; a
            # caller-side cancellation says nothing about its health and
            # must neither open the breaker nor wedge the half-open probe
            # slot (record_outcome classifies). Either way the half-open
            # socket must not leak.
            self.breakers.record_outcome(key, e)
            try:
                await fresh.close()
            except Exception:  # noqa: BLE001 - teardown of a dead dial
                pass
            raise
        self.breakers.record_outcome(key, None)
        async with self._lock:
            raced = self._conns.get(key)
            if raced is not None and not raced.is_closed:
                # another coroutine dialed while we were; keep one
                await fresh.close()
                return raced
            self._conns[key] = fresh
            return fresh

    def connections(self) -> list[SchedulerConnection]:
        return list(self._conns.values())

    async def connect_all(self) -> list[SchedulerConnection]:
        """Open a connection to every reachable scheduler (seed daemons
        must be reachable for triggers before any task touches them). Dead
        schedulers are skipped — the lazy per-task path retries them.
        Dials go through _get so they share the per-target breakers."""
        _, addr = self._state
        for key in list(addr):
            try:
                await self._get(key, addr)
            except (OSError, asyncio.TimeoutError, resilience.BreakerOpen) as e:
                logger.warning("scheduler %s unreachable: %s", key, e)
        async with self._lock:
            return list(self._conns.values())

    async def close(self) -> None:
        async with self._lock:
            for conn in self._conns.values():
                await conn.close()
            self._conns.clear()


class TrainerClient:
    """Client-streaming dataset upload (trainerv1.Trainer/Train)."""

    DIAL_TIMEOUT_S = 5.0

    def __init__(self, host: str, port: int, ssl_context: typing.Any = None):
        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        # the upload runs on the scheduler's announce cadence: a blackholed
        # trainer must cost one bounded dial per open_ttl, not a full
        # kernel connect timeout per cadence tick
        self.breakers = resilience.BreakerBoard("scheduler")

    async def train(
        self, host_id: str, ip: str, hostname: str, datasets: dict,
        chunk_size: int = 128 << 20,
    ) -> msg.TrainResponse:
        """`datasets` maps name -> bytes OR an iterable of bytes parts
        (e.g. one per CSV rotation file), so callers can stream a large
        trace history without materializing it all at once."""
        with default_tracer().span(
            "scheduler.train_upload", host_id=host_id, datasets=len(datasets),
        ):
            return await self._train(host_id, ip, hostname, datasets, chunk_size)

    async def _train(
        self, host_id: str, ip: str, hostname: str, datasets: dict,
        chunk_size: int,
    ) -> msg.TrainResponse:
        # Every frame below inherits the upload span's context through the
        # wire envelope, so the trainer's train_ingest span continues this
        # trace (one trace id across the announce->train edge).
        target = f"{self.host}:{self.port}"
        breaker_state = self.breakers.acquire(target)
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(
                    self.host, self.port, ssl=self.ssl_context
                ),
                timeout=self.DIAL_TIMEOUT_S,
            )
            if breaker_state == resilience.HALF_OPEN:
                # probe the half-open breaker with the trainer's health
                # handler before streaming megabytes at a maybe-dead server
                try:
                    wire.write_frame(writer, mux.HealthCheckRequest(service="trainer"))
                    await writer.drain()
                    probe = await asyncio.wait_for(wire.read_frame(reader), timeout=2.0)
                    if not (
                        isinstance(probe, mux.HealthCheckResponse)
                        and probe.status == mux.SERVING
                    ):
                        raise ConnectionError(f"{target}: half-open probe NOT_SERVING")
                except BaseException:
                    # a failed/timed-out/cancelled probe must not leak the
                    # just-dialed socket (the fd-per-retry leak shape)
                    writer.close()
                    raise
        except BaseException as e:
            # record_outcome classifies: transport failure opens/advances
            # the breaker, cancellation just frees the probe slot
            self.breakers.record_outcome(target, e)
            raise
        self.breakers.record_outcome(target, None)
        try:
            try:
                for dataset, value in datasets.items():
                    parts = [value] if isinstance(value, (bytes, bytearray)) else value
                    sent_any = False
                    for blob in parts:
                        for off in range(0, max(len(blob), 1), chunk_size):
                            wire.write_frame(
                                writer,
                                msg.TrainRequest(
                                    host_id=host_id, ip=ip, hostname=hostname,
                                    dataset=dataset, chunk=blob[off : off + chunk_size],
                                ),
                            )
                            await writer.drain()
                            sent_any = True
                    if not sent_any:
                        wire.write_frame(
                            writer,
                            msg.TrainRequest(host_id=host_id, ip=ip, hostname=hostname,
                                             dataset=dataset, chunk=b""),
                        )
                        await writer.drain()
                # explicit commit marker: bare EOF means "torn", not "done"
                wire.write_frame(writer, msg.TrainEndRequest(host_id=host_id))
                await writer.drain()
                writer.write_eof()
            except (ConnectionError, RuntimeError):
                # The server may have replied with an error and closed its
                # read side mid-upload; fall through and try to collect that
                # response rather than losing it to the broken pipe.
                pass
            response = await wire.read_frame(reader)
            if not isinstance(response, msg.TrainResponse):
                return msg.TrainResponse(ok=False, description="bad trainer reply")
            return response
        finally:
            writer.close()


class SyncSchedulerClient:
    """Blocking request/response client over the scheduler wire protocol
    for NON-asyncio callers — the manager's REST worker threads driving
    the cross-process job edge (JobTriggerSeed / TaskStates /
    SchedulerInfo; the machinery hops the reference runs through Redis +
    asynq, manager/job + internal/job). One short-lived request at a time
    per client; the connection is dialed lazily and redialed after any
    error, so a scheduler restart costs one failed call, not a stuck
    manager."""

    def __init__(self, host: str, port: int, ssl_context: typing.Any = None,
                 timeout: float = 5.0, dial_failure_ttl: float = 5.0):
        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        self.timeout = timeout
        # Per-target circuit breaker (rpc/resilience.py), generalizing the
        # old ad-hoc dial-failure TTL cache: a preheat fans one trigger per
        # task to the owning scheduler, and without it a dead (blackholed)
        # scheduler costs one full connect timeout PER TASK — minutes for a
        # 50-URL job. failure_threshold=1 keeps the old contract (one
        # failed dial → fast-fail), open_ttl=dial_failure_ttl keeps the
        # probe cadence, and the half-open probe now runs the health
        # request before the breaker closes.
        self.breakers = resilience.BreakerBoard(
            "manager", failure_threshold=1, open_ttl=dial_failure_ttl,
        )
        self._target = f"{host}:{port}"
        self._sock = None
        self._mu = threading.Lock()

    def _connect(self) -> typing.Any:
        import socket as _socket

        timeout = resilience.bound_timeout(self.timeout)
        sock = _socket.create_connection((self.host, self.port), timeout=timeout)
        if self.ssl_context is not None:
            sock = self.ssl_context.wrap_socket(sock, server_hostname=self.host)
        return sock

    def _dial(self) -> None:
        """Dial under the breaker; half-open dials are verified with one
        HealthCheck round trip before the breaker closes (pkg/rpc/health —
        the probe the reference's balancer gets from grpc healthchecks)."""
        breaker_state = self.breakers.acquire(self._target)  # BreakerOpen -> Unavailable
        try:
            self._sock = self._connect()
            if breaker_state == resilience.HALF_OPEN:
                self._sock.sendall(wire.encode(mux.HealthCheckRequest()))
                header = self._recv_exact(self._sock, 4)
                probe = wire.decode(
                    self._recv_exact(self._sock, int.from_bytes(header, "big"))
                )
                if not (
                    isinstance(probe, mux.HealthCheckResponse)
                    and probe.status == mux.SERVING
                ):
                    raise ConnectionError("half-open probe NOT_SERVING")
        except BaseException as e:
            # BaseException, not just (OSError, ConnectionError): a codec
            # error from a garbled probe reply (wire.decode TypeError)
            # must still settle the acquire — record_outcome classifies it
            # as release-not-failure — or the probe slot wedges and this
            # target becomes permanently unreachable
            self.breakers.record_outcome(self._target, e)
            sock, self._sock = self._sock, None
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            raise
        self.breakers.record_outcome(self._target, None)

    def call(self, request: typing.Any) -> typing.Any:
        """Send one frame, read one frame. Raises ConnectionError on any
        transport failure (after closing the cached socket), Unavailable
        when the breaker is open, DeadlineExceeded when the ambient budget
        is already spent. The socket is snapshotted into a local: a
        concurrent close() (update_schedulers dropping a departed
        scheduler) nulls self._sock without taking _mu — closing the fd
        mid-recv surfaces as OSError below, never as an AttributeError on
        None escaping the error mapping."""
        with self._mu:
            remaining = resilience.remaining()
            if remaining is not None and remaining <= 0:
                self.breakers.metrics.deadline_exceeded.labels().inc()
                raise dferrors.DeadlineExceeded(
                    f"scheduler rpc {self._target}: deadline budget exhausted"
                )
            try:
                if self._sock is None:
                    self._dial()
                sock = self._sock
                if remaining is not None:
                    # the recv timeout shrinks to the budget; the request
                    # frame itself carries the remaining budget (wire
                    # encode reads the ambient scope) for the server shed
                    sock.settimeout(min(self.timeout, remaining))
                # wire.encode already length-prefixes the frame
                sock.sendall(wire.encode(request))
                header = self._recv_exact(sock, 4)
                return wire.decode(
                    self._recv_exact(sock, int.from_bytes(header, "big"))
                )
            except resilience.BreakerOpen:
                raise  # already Unavailable with the open-state detail
            except (OSError, ConnectionError, ValueError) as e:
                self.close()
                raise ConnectionError(f"scheduler rpc {self.host}:{self.port}: {e}") from e
            finally:
                # snapshot, never re-read: a concurrent close() nulls
                # self._sock and an AttributeError out of a finally would
                # replace the in-flight exception and break the
                # ConnectionError contract this method documents
                sock = self._sock
                if sock is not None and remaining is not None:
                    try:
                        sock.settimeout(self.timeout)
                    except OSError:
                        pass

    def _recv_exact(self, sock: typing.Any, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("scheduler closed the connection")
            buf += chunk
        return buf

    def close(self) -> None:
        # snapshot-swap: two racing closers (a failing call()'s error path
        # and update_schedulers dropping the scheduler) must not leave one
        # of them calling close() on None
        # deliberately lock-free (a GIL-atomic tuple assign): taking _mu
        # here would deadlock a closer invoked from inside call()'s locked
        # error path
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
