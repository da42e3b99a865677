"""The peer daemon: data plane wiring.

Capability parity with client/daemon/daemon.go (New :114-367, Serve
:525-816): piece storage + upload server + scheduler streams + task
manager + announcer + probe loop + GC, one process per host. The task
manager dedups concurrent downloads of the same task
(peertask_manager.go:47-54) and exposes the file/stream entry points.

Port of dragonfly2_tpu/client/daemon.py less its manager edges: the
object-storage listener (``object_storage=True``) and the manager-fed
scheduler list (``manager_address``, the dynconfig loop) need the
manager's RPC and objectstorage/service.py, not ported yet (ROADMAP A9
part 3), and the constructor refuses them. The daemon imports no torch:
its device work is the scheduler's tick, in the scheduler's process.
"""

from __future__ import annotations

import asyncio
import logging
import pathlib
import shutil
import socket
import time

from dragonfly2_tpu_torch.client.conductor import PeerTaskConductor
from dragonfly2_tpu_torch.client.dispatcher import TrafficShaper
from dragonfly2_tpu_torch.client.storage import StorageManager, TaskStorage
from dragonfly2_tpu_torch.client.upload import UploadServer
from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.rpc import resilience
from dragonfly2_tpu_torch.rpc.client import SchedulerClientPool
from dragonfly2_tpu_torch.telemetry import default_registry
from dragonfly2_tpu_torch.telemetry import tailtrace
from dragonfly2_tpu_torch.telemetry.flight import PhaseRecorder
from dragonfly2_tpu_torch.telemetry.tracing import default_tracer
from dragonfly2_tpu_torch.telemetry.series import daemon_series, register_version
from dragonfly2_tpu_torch.utils import dferrors, hoststat, idgen
from dragonfly2_tpu_torch.utils.gc import GC, Task as GCTask

logger = logging.getLogger(__name__)


class Daemon:
    def __init__(
        self,
        data_dir: str | pathlib.Path,
        scheduler_addresses: list[tuple[str, int]],
        hostname: str = "",
        ip: str = "127.0.0.1",
        host_type: str = "normal",
        idc: str = "",
        location: str = "",
        total_rate_bps: float = 0.0,
        gc_interval: float = 60.0,
        probe_interval: float = 0.0,  # 0 disables the probe loop
        object_storage: bool = False,
        proxy: bool = False,
        proxy_rules: list | None = None,
        registry_mirror: str = "",
        sni_proxy: bool = False,
        sni_allowed_hosts: list[str] | None = None,
        ssl_context=None,
        manager_address: tuple[str, int] | None = None,
        fault_injector=None,
    ):
        if object_storage:
            raise NotImplementedError(
                "Daemon(object_storage=True) needs objectstorage/service.py, not "
                "ported yet (ROADMAP A9 part 3)"
            )
        if manager_address is not None:
            raise NotImplementedError(
                "Daemon(manager_address=...) needs the manager's RPC and the "
                "dynconfig scheduler list, not ported yet (ROADMAP A9 part 3)"
            )
        self.hostname = hostname or socket.gethostname()
        self.ip = ip
        self.host_id = idgen.host_id_v2(ip, self.hostname)
        self.host_type = host_type
        self.idc = idc
        self.location = location
        self.data_dir = pathlib.Path(data_dir)
        reg = default_registry()
        self.metrics = daemon_series(reg)
        register_version(reg, "dfdaemon")
        self.storage = StorageManager(data_dir)
        # scenario-lab flaky-parent injection (scenarios/engine.py): this
        # daemon's piece serving errors/stalls per the injected schedule
        self.upload = UploadServer(self.storage, host=ip, fault_injector=fault_injector,
                                   on_piece_rot=self._report_piece_rot)
        self.pool = SchedulerClientPool(scheduler_addresses, ssl_context=ssl_context)
        self.shaper = TrafficShaper(total_rate_bps, mode="sampling" if total_rate_bps else "plain")
        self.gc = GC()
        self.gc.add(
            GCTask(id="storage", interval=gc_interval, timeout=gc_interval,
                   runner=lambda: self.storage.run_gc())
        )
        self.probe_interval = probe_interval
        self.proxy = None
        self.sni_proxy = None
        if proxy:
            # HTTP(S) forward proxy with per-rule P2P hijack — one of the
            # reference daemon's listeners (daemon.go:525-604)
            from dragonfly2_tpu_torch.client.proxy import ProxyServer
            from dragonfly2_tpu_torch.client.transport import P2PTransport

            transport = P2PTransport(self, rules=list(proxy_rules or []))
            self.proxy = ProxyServer(transport, host=ip, registry_mirror=registry_mirror)
        if sni_proxy:
            from dragonfly2_tpu_torch.client.proxy import SNIProxy

            # deny-by-default: with no allowlist the listener refuses all
            self.sni_proxy = SNIProxy(host=ip, allowed_hosts=sni_allowed_hosts)
        # Failover flight recorder (telemetry/flight.py): one committed
        # entry per scheduler-failover recovery with the phase split
        # {backoff, redial, reannounce} in ms — time-to-recover is their
        # sum, served through the same /debug/flight + wire dump as the
        # scheduler's tick phases. Registered under a stable name so the
        # chaos harness reads recovery time from flight data, not from
        # stopwatches around the test.
        self.failover_recorder = PhaseRecorder(maxlen=256, name="dfdaemon.failover")
        self._probe_task: asyncio.Task | None = None
        # event loop captured at start(): verify-on-serve rot reports fire
        # on upload-server handler threads and must hop onto it
        self._loop: asyncio.AbstractEventLoop | None = None
        self._seed_tasks: list[asyncio.Task] = []
        self._seed_downloads: set[asyncio.Task] = set()
        self._running: dict[str, asyncio.Task] = {}  # task dedup

    @property
    def is_seed(self) -> bool:
        """Non-normal host types serve as seed peers (pkg/types HostType:
        super/strong/weak vs normal; client seeder rpcserver/seeder.go)."""
        return self.host_type != "normal"

    # ------------------------------------------------------------ lifecycle

    def host_info(self) -> msg.HostInfo:
        # Live resource sample on every announce (announcer.go:186-252):
        # these become the host feature columns of the scheduler's
        # training traces, so they must be real numbers, not defaults.
        stats = hoststat.collect(str(self.data_dir), upload_port=self.upload.port)
        return msg.HostInfo(
            host_id=self.host_id,
            hostname=self.hostname,
            ip=self.ip,
            host_type=self.host_type,
            idc=self.idc,
            location=self.location,
            port=self.upload.port,
            download_port=self.upload.port,
            cpu=stats.cpu,
            memory=stats.memory,
            disk=stats.disk,
            tcp_connection_count=stats.tcp_connection_count,
            upload_tcp_connection_count=stats.upload_tcp_connection_count,
        )

    async def start(self) -> None:
        # pay the one-time native build here, never on a request path
        from dragonfly2_tpu_torch import native

        self._loop = asyncio.get_running_loop()
        await asyncio.to_thread(native.ensure_built)
        self.upload.start()
        self.gc.start()
        if self.proxy is not None:
            await self.proxy.start()
        if self.sni_proxy is not None:
            await self.sni_proxy.start()
        if self.probe_interval > 0:
            self._probe_task = asyncio.create_task(self._probe_loop())
        if self.is_seed:
            # Seed mode: connect + announce to every scheduler up front so
            # TriggerSeedRequests can reach this host, then serve them
            # (ObtainSeeds, rpcserver/seeder.go:53).
            for conn in await self.pool.connect_all():
                await self._ensure_announced(conn)
                self._seed_tasks.append(asyncio.create_task(self._seed_loop(conn)))
        logger.info("daemon %s up (upload :%d)", self.host_id, self.upload.port)

    async def stop(self, leave: bool = True) -> None:
        for task in (self._probe_task, *self._seed_tasks, *self._seed_downloads):
            if task is None:
                continue
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        self._probe_task = None
        self._seed_tasks.clear()
        if self.proxy is not None:
            await self.proxy.stop()
        if self.sni_proxy is not None:
            await self.sni_proxy.stop()
        self._seed_downloads.clear()
        for task in list(self._running.values()):
            task.cancel()
        if leave:
            # LeaveHost drains this host from every scheduler we touched
            for conn in self.pool.connections():
                try:
                    await conn.send(msg.LeaveHostRequest(host_id=self.host_id))
                except Exception:  # noqa: BLE001 - best-effort drain
                    pass
        await self.pool.close()
        self.gc.stop()
        self.upload.stop()

    # ------------------------------------------------------------ download

    async def download(
        self,
        url: str,
        tag: str = "",
        application: str = "",
        filtered_query_params: str = "",
        piece_length: int = 4 << 20,
        workers: int = 4,
        back_source_allowed: bool = True,
        schedule_timeout: float = 10.0,
        task_id: str | None = None,
        headers: dict[str, str] | None = None,
    ) -> TaskStorage:
        """StartFileTask: dedup on task id — concurrent requests for the
        same task await one conductor. `task_id` overrides derivation when
        the caller already holds the authoritative id (seed triggers)."""
        if task_id is None:
            task_id = idgen.task_id_v1(
                url, tag=tag, application=application,
                filtered_query_params=filtered_query_params,
            )
        existing = self.storage.find_completed_task(task_id)
        if existing is not None:
            self.metrics.peer_task_cache_hit.labels().inc()
            return existing
        running = self._running.get(task_id)
        if running is None:
            self.metrics.peer_task.labels().inc()
            self.metrics.file_task.labels().inc()
            running = asyncio.create_task(
                self._run_conductor(
                    task_id, url, piece_length, workers, back_source_allowed,
                    schedule_timeout, headers,
                )
            )
            self._running[task_id] = running

            def _on_done(t: asyncio.Task) -> None:
                self._running.pop(task_id, None)
                # counted here, once per task — not per awaiting caller
                if not t.cancelled() and t.exception() is not None:
                    self.metrics.peer_task_failed.labels(
                        type(t.exception()).__name__
                    ).inc()

            running.add_done_callback(_on_done)
        return await asyncio.shield(running)

    async def _run_conductor(
        self, task_id: str, url: str, piece_length: int, workers: int,
        back_source_allowed: bool, schedule_timeout: float,
        headers: dict[str, str] | None = None,
    ) -> TaskStorage:
        # one span per task download — the client-boundary trace the
        # reference emits around its peer-task lifecycle (dfdaemon spans);
        # exported when an --otlp-endpoint exporter is registered, a
        # cheap context object otherwise
        with default_tracer().span(
            "dfdaemon.peer_task", task_id=task_id, url=url,
            piece_length=piece_length,
        ) as span:
            last_err: BaseException | None = None
            task_t0 = time.perf_counter_ns()
            # wall time burned by attempts that DIED mid-stream: the
            # conductor those attempts measured into is discarded, so
            # the whole lost attempt is failover time in the tail ledger
            failed_attempt_ns = 0.0
            # One attempt per distinct ring node plus one retry of the
            # (possibly rebinding) primary: each attempt's for_task already
            # fails over across breaker-open/dial-dead candidates, so this
            # outer loop only restarts after MID-STREAM death — the
            # announce stream died while a download was in flight. Sized
            # by the RING (the configured scheduler set), not by how many
            # connections happen to be open right now.
            attempts = min(self.pool.size() + 1, 4)
            for attempt in range(max(attempts, 2)):
                recovering = attempt > 0
                try:
                    # Recovery phases are measured locally and committed in
                    # one call: a scheduler crash severs EVERY stream at
                    # once, so many downloads recover concurrently and a
                    # shared begin/mark cursor would clobber itself
                    # (PhaseRecorder.commit_phases).
                    phases: dict[str, float] = {}
                    attempt_t0 = time.perf_counter_ns()
                    t0 = time.perf_counter()
                    if recovering:
                        # scheduler failover recovery, phase-timed into the
                        # flight recorder: backoff -> redial (ring failover
                        # inside for_task) -> reannounce (fresh scheduler
                        # state). The conductor then resumes its kept
                        # pieces via the finished_pieces re-announce.
                        await asyncio.sleep(0.5)  # let a restarting scheduler rebind
                        phases["backoff"] = (time.perf_counter() - t0) * 1e3
                        t0 = time.perf_counter()
                    # dial + announce INSIDE the retried region: during a
                    # scheduler restart the redial itself is what fails
                    # (ConnectionRefusedError while the port rebinds)
                    conn = await self.pool.for_task(task_id)
                    if recovering:
                        phases["redial"] = (time.perf_counter() - t0) * 1e3
                        t0 = time.perf_counter()
                    await self._ensure_announced(conn)
                    if recovering:
                        phases["reannounce"] = (time.perf_counter() - t0) * 1e3
                        span.attributes["failover_target"] = f"{conn.host}:{conn.port}"
                    conductor = PeerTaskConductor(
                        conn=conn,
                        storage=self.storage,
                        host=self.host_info(),
                        peer_id=idgen.peer_id_v2(),
                        task_id=task_id,
                        url=url,
                        piece_length=piece_length,
                        workers=workers,
                        shaper=self.shaper,
                        back_source_allowed=back_source_allowed,
                        schedule_timeout=schedule_timeout,
                        headers=headers,
                    )
                    ts = await conductor.run()
                except (
                    OSError,  # ConnectionError and friends, dial refusals
                    asyncio.IncompleteReadError,
                    asyncio.TimeoutError,  # bounded pool dial
                    dferrors.Unavailable,
                ) as e:
                    # the announce stream died mid-task (scheduler crash,
                    # restart, network cut): the pool evicts the dead
                    # connection and the next for_task fails over along
                    # the hashring — already-written pieces resume from
                    # the task storage and ride the re-announce
                    last_err = e
                    failed_attempt_ns += time.perf_counter_ns() - attempt_t0
                    span.attributes["retried"] = True
                    continue
                if recovering:
                    # committed only HERE, after the recovered attempt
                    # actually finished: a flapping scheduler that dies
                    # again mid-stream must not count as a recovery, and
                    # a download that ultimately fails must leave no
                    # time-to-recover entry (the chaos harness reads
                    # these as successes)
                    self.failover_recorder.commit_phases(phases)
                    self.metrics.scheduler_failover.labels().inc()
                span.attributes["pieces"] = len(ts.meta.pieces)
                self._observe_tail(conductor, task_t0, failed_attempt_ns, phases)
                return ts
            assert last_err is not None
            raise last_err

    def _observe_tail(
        self, conductor: PeerTaskConductor, task_t0: int,
        failed_attempt_ns: float, recovery_phases: dict[str, float],
    ) -> None:
        """Feed the completed download into the client-plane tail ledger.

        The conductor measured its own lifecycle phases (register,
        schedule waits, per-wave fetches, retries, back-to-source,
        verify); this folds in what only the daemon sees — the wall time
        of attempts that died mid-stream plus the measured recovery
        phases (backoff/redial/reannounce, ms), both failover — and
        reconciles the vector with the measured TTC so the decomposition
        is always a PARTITION of wall time: unmeasured glue (event-loop
        hops, storage open) books as schedule wait, and when concurrent
        piece workers make the raw phase mass EXCEED elapsed time (N
        overlapping fetch walls), the masses are scaled onto the wall
        clock — they stay correct as relative weights, which is what a
        critical-path read uses."""
        ttc_ns = float(time.perf_counter_ns() - task_t0)
        vec = list(conductor.phase_ns)
        vec[tailtrace.PH_FAILOVER] += failed_attempt_ns
        vec[tailtrace.PH_FAILOVER] += sum(recovery_phases.values()) * 1e6
        total = sum(vec)
        if total > ttc_ns > 0.0:
            vec = [v * (ttc_ns / total) for v in vec]
        elif ttc_ns > total:
            vec[tailtrace.PH_SCHEDULE_WAIT] += ttc_ns - total
        tail = tailtrace.default_tailtrace()
        tail.observe(0, tail.next_seq(), ttc_ns, vec)

    def _report_piece_rot(self, task_id: str, number: int) -> None:
        """Verify-on-serve found local disk rot (upload.py; the piece is
        already evicted from the finished set): SELF-report a
        reason="corruption" piece failure — peer_id == parent_peer_id is
        the self-report shape the scheduler maps straight to quarantine,
        so this HOST stops being advertised cluster-wide (quarantine is
        host-scoped, not per-task) instead of letting every child burn a
        transfer discovering the rot. Fire-and-forget off the upload
        handler thread; a dead control plane only costs the report."""
        loop = self._loop
        ts = self.storage.get(task_id)
        if loop is None or loop.is_closed() or ts is None or not ts.meta.peer_id:
            return

        async def report() -> None:
            try:
                conn = await self.pool.for_task(task_id)
                await self._ensure_announced(conn)
                await conn.send(msg.DownloadPieceFailedRequest(
                    peer_id=ts.meta.peer_id, parent_peer_id=ts.meta.peer_id,
                    reason="corruption",
                ))
            except Exception:  # noqa: BLE001 - reporting is best-effort
                logger.warning("piece-rot self-report failed for %s#%d",
                               task_id, number, exc_info=True)

        asyncio.run_coroutine_threadsafe(report(), loop)

    async def export_file(self, ts: TaskStorage, output: str | pathlib.Path) -> None:
        """Copy a completed task's bytes to a user path (dfget output)."""
        await asyncio.to_thread(shutil.copyfile, ts.data_path, output)

    async def _ensure_announced(self, conn) -> None:
        # Announced-ness is a property of the CONNECTION, not the address:
        # after a scheduler restart the pool redials, the new server has
        # fresh state, and an address-keyed set would skip the re-announce
        # forever (stranding seed-host registration in particular).
        if conn.announced:
            return
        await conn.send(msg.AnnounceHostRequest(host=self.host_info()))
        conn.announced = True

    # ---------------------------------------------------------- seed peer

    async def _seed_loop(self, conn) -> None:
        """Serve TriggerSeedRequests from one scheduler ADDRESS: back-
        source the task so the cluster has a parent (ObtainSeeds). Bound
        to the scheduler, not the connection — when the stream dies
        (scheduler restart) the loop redials and RE-ANNOUNCES, otherwise a
        restarted scheduler's triggers would be enqueued on a connection
        nobody reads and preheat would be dead forever. Spawned downloads
        are strongly referenced (the loop holds only weak refs) and
        cancelled on stop."""
        host, port = conn.host, conn.port
        while True:
            if conn.is_closed:
                try:
                    conn = await self.pool.for_address(host, port)
                    await self._ensure_announced(conn)
                except LookupError:
                    # dynconfig removed this scheduler from the active
                    # set: the seed loop must die with it, not resurrect
                    # a decommissioned scheduler every grace period
                    logger.info("seed loop for %s:%d ending: scheduler "
                                "left the active set", host, port)
                    return
                except (OSError, asyncio.TimeoutError, resilience.BreakerOpen):
                    # down or breaker-open: the sleep is the retry cadence,
                    # the breaker keeps each failed probe cheap
                    await asyncio.sleep(2.0)
                    continue
            try:
                trigger = await asyncio.wait_for(conn.seed_triggers.get(), timeout=2.0)
            except asyncio.TimeoutError:
                continue  # periodic liveness recheck
            task = asyncio.create_task(self._obtain_seed(trigger, conn))
            self._seed_downloads.add(task)
            task.add_done_callback(self._seed_downloads.discard)

    async def _announce_completed(self, conn, ts: TaskStorage, trigger) -> None:
        """Re-announce a COMPLETED task to the scheduler that asked for it
        (failover path: a scheduler that just inherited a task's peers has
        never heard of this seed's copy). The register carries every
        finished piece, so the scheduler adopts the seed as a Succeeded
        parent without a byte moving — the cluster regains a parent at
        announce cost instead of a second origin fetch."""
        # persist the fresh id: rot self-reports use ts.meta.peer_id, and
        # the scheduler only knows THIS registration after a failover
        peer_id = idgen.peer_id_v2()
        ts.set_peer_id(peer_id)
        # continue the TRIGGERING scheduler's trace (the wire layer pins
        # its envelope on the decoded trigger): the re-announce after a
        # hashring failover used to start an orphan trace here, cutting
        # exactly the hop a tail investigation needs to follow
        with default_tracer().span(
            "dfdaemon.reannounce",
            remote_parent=getattr(trigger, "trace_context", None),
            task_id=ts.meta.task_id,
        ):
            await conn.send(msg.RegisterPeerRequest(
                peer_id=peer_id,
                task_id=ts.meta.task_id,
                host=self.host_info(),
                url=trigger.url,
                content_length=max(ts.meta.content_length, 0),
                piece_length=ts.meta.piece_length,
                total_piece_count=max(ts.meta.total_pieces, 0),
                priority=1,  # a seed must not re-trigger a seed
                tag=trigger.tag,
                application=trigger.application,
                finished_pieces=sorted(ts.finished_pieces()),
            ))
        self.metrics.seed_task_reannounce.labels().inc()

    async def _obtain_seed(self, trigger, conn=None) -> None:
        held = self.storage.find_completed_task(trigger.task_id)
        if held is not None and conn is not None and not conn.is_closed:
            # already on disk: the triggering scheduler only lacks the
            # ANNOUNCEMENT (it restarted, or the task failed over to it) —
            # re-announce instead of re-downloading
            try:
                await self._announce_completed(conn, held, trigger)
                return
            except (OSError, ConnectionError):
                # the conn died between the is_closed check and the send;
                # a dropped announce leaves the scheduler's waiting peers
                # parentless (the first-peer trigger guard won't re-fire),
                # so retry ONCE over a fresh connection before giving up
                try:
                    fresh = await self.pool.for_address(conn.host, conn.port)
                    await self._ensure_announced(fresh)
                    await self._announce_completed(fresh, held, trigger)
                except (LookupError, OSError, ConnectionError,
                        asyncio.TimeoutError, dferrors.Unavailable):
                    logger.warning("completed-task re-announce for %s failed",
                                   trigger.task_id)
                return
        self.metrics.seed_peer_download.labels().inc()
        already_held = held is not None
        try:
            # the trigger's task id is authoritative: the requesting peer
            # may have derived it with filtered query params the raw URL
            # alone would not reproduce
            ts = await self.download(
                trigger.url,
                tag=trigger.tag,
                application=trigger.application,
                piece_length=trigger.piece_length,
                back_source_allowed=True,
                schedule_timeout=0.5,  # seeds go straight to origin
                task_id=trigger.task_id,
                headers=getattr(trigger, "headers", None) or None,
            )
            if not already_held:  # cache hits moved zero bytes
                self.metrics.seed_peer_download_traffic.labels("back_to_source").inc(
                    max(ts.meta.content_length, 0)
                )
            # The download's conductor registered on the task's hashring
            # pick, which need not be the scheduler that sent THIS trigger
            # (failover skew). Make sure the triggering scheduler learns
            # this seed holds the task, or its waiting peers starve.
            if (
                conn is not None and not conn.is_closed
                and self.pool.primary_for_task(trigger.task_id)
                != f"{conn.host}:{conn.port}"
            ):
                try:
                    await self._announce_completed(conn, ts, trigger)
                except (OSError, ConnectionError):
                    logger.warning("post-seed re-announce for %s failed",
                                   trigger.task_id)
            logger.info("seeded task %s from %s", trigger.task_id, trigger.url)
        except Exception:  # noqa: BLE001 - a failed seed must not kill the loop
            self.metrics.seed_peer_download_failure.labels().inc()
            logger.exception("seed download failed for %s", trigger.url)

    # -------------------------------------------------------------- probes

    async def _probe_loop(self) -> None:
        """client/daemon/networktopology/network_topology.go:71-203: ask the
        scheduler whom to probe, measure RTT, report back. ICMP needs raw
        sockets; a TCP connect to the peer's upload port measures the same
        path."""
        while True:
            await asyncio.sleep(self.probe_interval)
            try:
                await self.sync_probes_once()
            except Exception:  # noqa: BLE001 - probe failures never kill the daemon
                logger.exception("probe cycle failed")

    # One probe round's whole budget: dial + ProbeStarted + N TCP RTT
    # measurements + the finished report. The scope makes every frame
    # carry its remaining budget, so a scheduler digging a stale
    # ProbeStarted out of a backlog sheds it (rpc/server.py) instead of
    # computing probe targets nobody is waiting for.
    PROBE_ROUND_BUDGET_S = 30.0

    async def sync_probes_once(self, count: int = 10) -> int:
        with resilience.deadline(self.PROBE_ROUND_BUDGET_S):
            conn = await self.pool.for_task(self.host_id)
            await self._ensure_announced(conn)
            targets = await conn.sync_probes(self.host_id, count=count)
            if not targets:
                return 0
            results = []
            for target in targets:
                rtt = await asyncio.to_thread(self._tcp_rtt_ns, target.ip, target.port)
                results.append(
                    msg.ProbeResult(host_id=target.host_id, rtt_ns=rtt or 0, ok=rtt is not None)
                )
            await conn.send(msg.ProbeFinishedRequest(host_id=self.host_id, results=results))
            return len(results)

    @staticmethod
    def _tcp_rtt_ns(ip: str, port: int, timeout: float = 1.0) -> int | None:
        t0 = time.perf_counter_ns()
        try:
            with socket.create_connection((ip, port), timeout=timeout):
                return time.perf_counter_ns() - t0
        except OSError:
            return None
