"""Service launchers — the `cmd/{scheduler,trainer,manager,dfdaemon}` tier of the port.

Port of dragonfly2_tpu/cmd.py's scheduler, trainer, manager and dfdaemon
subcommands, with the reference's flags and `READY` lines: one module,
one subcommand per service, a YAML/JSON config via --config plus flag
overrides, graceful SIGINT/SIGTERM shutdown. Each service prints exactly
one `READY <host> <port>` line once its listener is bound (the scheduler
adds `INFER <host> <port>` with --registry-dir; the manager prints
`READY <host> <REST port> RPC <port>`; the dfdaemon prints
`READY <ip> <upload port>` and adds `PROXY <port>` with --proxy and
`SNI <port>` with --sni-proxy; each adds `METRICS <port>` with
--metrics-port), so a parent process can wait on startup without polling.

    python -m dragonfly2_tpu_torch.cmd scheduler --port 8002 --data-dir /var/df
    python -m dragonfly2_tpu_torch.cmd trainer   --port 8004 --data-dir ... --registry-dir ...
    python -m dragonfly2_tpu_torch.cmd manager   --port 8080 --db manager.db
    python -m dragonfly2_tpu_torch.cmd dfdaemon  --data-dir ... --scheduler host:8002

The file/cache/object CLIs (dfget/dfcache/dfstore) live in client/cli.py.

What differs from the reference:

- `--device` (scheduler and trainer): the services' torch device, the
  CUDA card by default. Without a card the process exits non-zero with
  device.py's error unless it is given `--device cpu`; nothing falls back.
  The dfdaemon takes none: it does no tensor work and imports no torch,
  so a machine runs many daemons beside a scheduler on the card.
- `--registry-dir` goes through registry/bucket.py ``open_registry``, as
  the reference's: a path opens the port's filesystem ModelRegistry (the
  bucket layout, registry/registry.py), an ``s3://``/``oss://``/``obs://``
  URL the bucket registry over the signed backend; the scheduler serves
  its gnn, mlp and attention versions through ModelServers built from
  their modules.
- `--network-topology-collect-interval` (scheduler): seconds between
  snapshots of the probe graph into the trace storage, the Go
  scheduler's networkTopology collect ticker (network_topology.go:124-138,
  2 h there), run by SchedulerRPCServer. Off by default, as the
  reference's process writes no topology rows: its uploads then carry no
  networktopology dataset, and the trainer trains no MLP from them.
- the process logs at INFO on stderr (the reference configures no
  handler, so its INFO lines are lost): the scheduler's registry host id
  and each GNN version its ml arm starts serving among them.
- the manager takes no `--device`: it drives no device program, and it
  loads torch only to open its `--registry-dir`. The schedulers it
  registers and configures run on the card unless given `--device cpu`.
- a dfdaemon given `--manager` may omit `--scheduler` (the reference
  requires it): it then takes its first scheduler list from the manager
  before it starts, as the Go dfdaemon's dynconfig loads at construction
  (client/daemon.py).
- a dfdaemon's `--scenario` resolves through scenarios/spec.py's
  `resolve_scenario` (the megascale builtins, then the scenario lab's),
  where the reference imports it from megascale/soak.py: the daemon
  loads no torch.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import logging
import os
import signal
import sys

def idgen_host_id(ip: str, hostname: str) -> str:
    from dragonfly2_tpu_torch.utils import idgen

    return idgen.host_id_v2(ip, hostname)


def _device(args):
    """The services' device: CUDA unless --device names another; no card
    is a refusal to start (device.py's error), never the CPU."""
    from dragonfly2_tpu_torch.device import resolve_device

    try:
        return resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"{args.cmd}: {e}") from None


def _wire_otlp(args, service: str) -> None:
    """--otlp-endpoint: export spans from the default tracer to an OTLP
    collector (the reference's --jaeger flag, dependency.go:263-280)."""
    endpoint = getattr(args, "otlp_endpoint", None)
    if not endpoint:
        return
    from dragonfly2_tpu_torch.telemetry.tracing import OTLPExporter, default_tracer

    default_tracer().add_exporter(OTLPExporter(endpoint, service=service).export)


async def _tls_material(args, common_name: str):
    """Optional cluster mTLS (scheduler.go:180-219): --tls-dir points at
    cert.pem/key.pem/ca.pem; --tls-issue certifies against --manager's
    IssueCertificate RPC first (pkg/issuer flow; issuance itself rides
    plaintext — bootstrap before any cert exists, like the reference's
    insecure certify channel). None = plaintext."""
    tls_dir = getattr(args, "tls_dir", None)
    if not tls_dir:
        return None
    from dragonfly2_tpu_torch.utils.certs import TLSMaterial

    mat = TLSMaterial(tls_dir)
    if not mat.ready:
        if getattr(args, "tls_issue", False) and getattr(args, "manager", ""):
            from dragonfly2_tpu_torch.manager.rpc import obtain_certificate

            mh, mp = _parse_addr(args.manager)
            sans = {"127.0.0.1", "localhost", getattr(args, "host", "") or "",
                    getattr(args, "ip", "") or ""}
            mat = await obtain_certificate(
                mh, mp, common_name, tls_dir, san_hosts=sorted(s for s in sans if s),
                enrollment_token=getattr(args, "tls_enrollment_token", "") or "",
            )
        else:
            raise SystemExit(
                f"--tls-dir {tls_dir} has no cert material; pass --tls-issue "
                "with --manager to certify against the cluster CA"
            )
    return mat


async def _tls_context(args, common_name: str, server: bool):
    mat = await _tls_material(args, common_name)
    if mat is None:
        return None
    return mat.server_context() if server else mat.client_context()


def _parse_addr(value: str) -> tuple[str, int]:
    host, _, port = value.rpartition(":")
    return host or "127.0.0.1", int(port)


async def _run_until_signalled(ready_line: str) -> None:
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    print(ready_line, flush=True)
    await stop.wait()


@contextlib.asynccontextmanager
async def _monitored(args, ready: str):
    """Start the per-service observability HTTP when --metrics-port is
    set (`/metrics`, `/debug/stacks`, `/debug/profile`, `/debug/health` —
    the reference's per-service Prometheus server + InitMonitor pprof,
    cmd/dependency/dependency.go:95-138), append its port to the READY
    line, and shut it down on exit."""
    monitor = None
    if getattr(args, "metrics_port", None) is not None:
        from dragonfly2_tpu_torch.telemetry import serve_metrics

        monitor = serve_metrics(port=args.metrics_port)
        ready += f" METRICS {monitor.server_address[1]}"
    try:
        yield ready
    finally:
        if monitor is not None:
            monitor.shutdown()


async def _serve_scheduler(args) -> int:
    from dragonfly2_tpu_torch.cluster.probes import ProbeStore
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
    from dragonfly2_tpu_torch.config.config import Config
    from dragonfly2_tpu_torch.records.storage import TraceStorage
    from dragonfly2_tpu_torch.rpc.server import SchedulerRPCServer

    device = _device(args)
    config = Config.load(args.config) if args.config else Config()
    if args.algorithm:
        config.evaluator.algorithm = args.algorithm
    storage = TraceStorage(args.data_dir) if args.data_dir else None
    probes = ProbeStore(max_hosts=config.scheduler.max_hosts, device=device)
    service = SchedulerService(config=config, storage=storage, probes=probes, device=device)
    _wire_otlp(args, "scheduler")
    tls_mat = await _tls_material(args, "scheduler")
    tls_server_ctx = tls_mat.server_context() if tls_mat else None
    tls_client_ctx = tls_mat.client_context() if tls_mat else None
    server = SchedulerRPCServer(
        service, host=args.host, port=args.port, ssl_context=tls_server_ctx,
        vsock_port=args.vsock_port,
        topology_collect_interval=args.network_topology_collect_interval,
    )
    host, port = await server.start()
    import socket

    # Overridable identity (the reference's server.host config,
    # scheduler/config/config.go ServerConfig): the manager dedupes
    # scheduler registrations on (host_name, ip, cluster), so two
    # schedulers on one machine MUST register distinct names or the
    # second silently overwrites the first row and the manager's job
    # ring diverges from the daemons' scheduler set.
    hostname = args.hostname or socket.gethostname()
    # ONE identity everywhere: the id the announce loop streams under is
    # the id the trainer publishes models under, which must be the id the
    # serving side looks up — two different defaults would mean training
    # succeeds but the inference endpoint never finds an active version.
    sched_host_id = args.scheduler_host_id or idgen_host_id(host, hostname)
    log = logging.getLogger("dragonfly2.cmd")
    log.info("scheduler registry host id: %s", sched_host_id)
    infer_server = None
    if args.registry_dir:
        # Serve the registry's trained models over the KServe-v2-shaped
        # inference RPC (the scheduler process itself is the inference
        # endpoint). Built after start() so the default registry host id
        # uses the *bound* port, not a pre-bind 0. Each ModelServer takes
        # its family's module (the reference passes template_params=None):
        # a version's metadata and weights set its widths at refresh.
        from dragonfly2_tpu_torch.cluster.trainer_service import (
            ATTENTION_MODEL_NAME, GNN_MODEL_NAME, MLP_MODEL_NAME,
        )
        from dragonfly2_tpu_torch.registry import ModelServer, open_registry
        from dragonfly2_tpu_torch.registry.registry import (
            MODEL_TYPE_ATTENTION, MODEL_TYPE_GNN, MODEL_TYPE_MLP,
        )
        from dragonfly2_tpu_torch.rpc.inference import InferenceRPCServer

        registry = open_registry(args.registry_dir)
        servers = {
            name: ModelServer(registry, name, sched_host_id, mtype, device=device)
            for name, mtype in (
                (GNN_MODEL_NAME, MODEL_TYPE_GNN),
                (MLP_MODEL_NAME, MODEL_TYPE_MLP),
                (ATTENTION_MODEL_NAME, MODEL_TYPE_ATTENTION),
            )
        }
        infer_server = InferenceRPCServer(
            servers, host=args.host, port=args.infer_port, ssl_context=tls_server_ctx
        )
        await infer_server.start()
    bg_tasks: list[asyncio.Task] = []
    ml_eval = None
    if args.registry_dir and config.evaluator.algorithm == "ml":
        # Wire the ml evaluator into the serving tick: score parents with
        # the registry's active GNN, falling back to the rule blend until
        # a version activates. A background loop refreshes (a) the served
        # params when the registry's active version flips and (b) the
        # host embeddings from the scheduler's OWN observed download graph
        # (serving_graph_arrays — the quality signal rides those edges,
        # matching what the trainer trained on).
        from dragonfly2_tpu_torch.registry import MLEvaluator

        ml_eval = MLEvaluator(servers[GNN_MODEL_NAME])
        service.ml_evaluator = ml_eval

        async def ml_refresh_loop():
            gnn = servers[GNN_MODEL_NAME]
            while True:
                try:
                    changed = await asyncio.to_thread(gnn.refresh)
                    if gnn.ready:
                        graph = await asyncio.to_thread(service.serving_graph_arrays)
                        # wait=True: this loop is already off the tick's
                        # critical path; a completed refresh here keeps
                        # the version log below accurate and avoids
                        # double-buffering through BOTH this thread and
                        # the evaluator's own worker. The committed
                        # snapshot carries an event the tick's stream
                        # waits on (registry/serving.py).
                        await asyncio.to_thread(ml_eval.refresh_embeddings, graph, True)
                        if changed:
                            log.info("ml evaluator serving model version %s", gnn.version)
                except Exception:  # noqa: BLE001 - keep refreshing
                    log.exception("ml refresh failed")
                await asyncio.sleep(args.ml_refresh_interval)

        bg_tasks.append(asyncio.create_task(ml_refresh_loop()))
    if args.manager:
        # register with the manager + keepalive until shutdown (the
        # scheduler bootstrap's manager edge, scheduler.go:110-299 +
        # manager keepalive active/inactive flips). Connection handling
        # lives INSIDE the loop: the manager may not be up yet at our
        # startup, and may restart later — both must re-register, not
        # crash or go silently inactive forever.
        from dragonfly2_tpu_torch.manager.rpc import (
            KeepAliveRequest, ManagerClient, RegisterInstanceRequest,
        )

        mh, mp = _parse_addr(args.manager)

        async def manager_loop():
            log = logging.getLogger(__name__)
            client = None
            # This loop holds the ONE persistent connection in the
            # launcher; cancellation must close it, or finalization tears
            # down a live transport under the event loop mid-teardown.
            try:
                while True:
                    try:
                        if client is None:
                            client = await ManagerClient(
                                mh, mp, ssl_context=tls_client_ctx
                            ).connect()
                            await client.call(RegisterInstanceRequest(
                                source_type="scheduler", host_name=hostname,
                                ip=host, port=port, cluster_id=args.cluster_id,
                            ))
                        response = await client.call(KeepAliveRequest(
                            source_type="scheduler", host_name=hostname,
                            ip=host, cluster_id=args.cluster_id,
                        ))
                        if response is None:  # EOF: manager went away
                            raise ConnectionError("manager closed the connection")
                    except (ConnectionError, RuntimeError, OSError) as e:
                        log.warning("manager keepalive/registration failed: %s", e)
                        if client is not None:
                            await client.close()
                            client = None
                    await asyncio.sleep(args.keepalive_interval)
            finally:
                if client is not None:
                    with contextlib.suppress(Exception):
                        await client.close()

        bg_tasks.append(asyncio.create_task(manager_loop()))

        # Live dynconfig loop (scheduler/config/dynconfig.go:457): poll the
        # manager's per-cluster payload on the refresh cadence and hot-apply
        # limit changes into the tick via the service observer. The engine
        # keeps an on-disk snapshot so a manager outage serves stale-but-
        # sane limits instead of failing.
        from dragonfly2_tpu_torch.manager.rpc import GetDynconfigRequest
        from dragonfly2_tpu_torch.utils.dynconfig import Dynconfig

        def fetch_dynconfig() -> dict:
            async def go():
                client = await ManagerClient(mh, mp, ssl_context=tls_client_ctx).connect()
                try:
                    resp = await client.call(
                        GetDynconfigRequest(scheduler_cluster_id=args.cluster_id)
                    )
                    return resp.data
                finally:
                    await client.close()

            # runs on a worker thread (asyncio.to_thread), so a private
            # event loop per fetch is safe and keeps Dynconfig's sync
            # client contract
            return asyncio.run(go())

        # Cache file keyed by cluster id (+ the CONFIGURED port when one
        # was given): different clusters on one host never share limits,
        # while the name stays STABLE across restarts — a
        # bound auto-port in the name would orphan the snapshot exactly
        # when the fallback matters (manager down + scheduler restart).
        # Same-cluster schedulers sharing a data_dir share the file, which
        # is the same payload; concurrent refresh writes are safe because
        # Dynconfig uses a unique temp file per writer.
        suffix = f"-{args.port}" if args.port else ""
        dyn = Dynconfig(
            fetch_dynconfig,
            cache_path=os.path.join(
                args.data_dir or ".",
                f"dynconfig-cluster{args.cluster_id}{suffix}.json",
            ),
            expire=max(args.dynconfig_interval, 1.0),
        )
        dyn.register(service.apply_dynconfig)

        async def dynconfig_loop():
            log = logging.getLogger(__name__)
            while True:
                try:
                    await asyncio.to_thread(dyn.get)
                except Exception as e:  # noqa: BLE001 - manager may be down
                    log.debug("dynconfig refresh failed: %s", e)
                await asyncio.sleep(max(args.dynconfig_interval, 1.0))

        bg_tasks.append(asyncio.create_task(dynconfig_loop()))
    if args.trainer and storage is not None:
        # periodic dataset upload to the trainer (announcer.go:127-235;
        # default cadence is the reference's 7 days). Rotation files are
        # streamed one at a time — concatenating every backup into one
        # bytes object would spike RSS by the full trace history (up to
        # max_size*max_backups per dataset) on every cadence.
        from dragonfly2_tpu_torch.rpc.client import TrainerClient

        th, tp = _parse_addr(args.trainer)

        async def announce_loop():
            client = TrainerClient(th, tp, ssl_context=tls_client_ctx)
            while True:
                await asyncio.sleep(args.announce_interval)
                try:
                    storage.flush()
                    datasets = {}
                    for name, store in (("download", storage.downloads),
                                        ("networktopology", storage.topologies)):
                        paths = store.all_paths()
                        if paths:
                            datasets[name] = (p.read_bytes() for p in paths)
                    if not datasets:
                        continue
                    response = await client.train(sched_host_id, host, hostname, datasets)
                    if not response.ok:
                        log.warning("trainer upload rejected: %s", response.description)
                except Exception as e:  # noqa: BLE001 - next interval retries
                    log.warning("trainer upload failed: %s", e)

        bg_tasks.append(asyncio.create_task(announce_loop()))

    ready = f"READY {host} {port}"
    if infer_server is not None:
        ready += f" INFER {infer_server.host} {infer_server.port}"
    try:
        async with _monitored(args, ready) as line:
            await _run_until_signalled(line)
    finally:
        for task in bg_tasks:
            task.cancel()
        await asyncio.gather(*bg_tasks, return_exceptions=True)
        if storage is not None:
            storage.close()  # flush buffered trace rows FIRST — an RPC
            # stop() that raises must not take the buffered rows with it
        if infer_server is not None:
            await infer_server.stop()
        await server.stop()
        if ml_eval is not None:
            await asyncio.to_thread(ml_eval.close)
    return 0


async def _serve_trainer(args) -> int:
    from dragonfly2_tpu_torch.cluster.trainer_service import TrainerService
    from dragonfly2_tpu_torch.config.config import Config
    from dragonfly2_tpu_torch.records.storage import HostTraceStorage
    from dragonfly2_tpu_torch.registry import open_registry
    from dragonfly2_tpu_torch.rpc.server import TrainerRPCServer

    device = _device(args)
    config = Config.load(args.config) if args.config else Config()
    if args.epochs:
        config.trainer.epochs = args.epochs
    service = TrainerService(
        HostTraceStorage(args.data_dir),
        open_registry(args.registry_dir),
        config.trainer,
        device=device,
    )
    _wire_otlp(args, "trainer")
    server = TrainerRPCServer(
        service, host=args.host, port=args.port,
        ssl_context=await _tls_context(args, "trainer", server=True),
    )
    host, port = await server.start()
    try:
        async with _monitored(args, f"READY {host} {port}") as line:
            await _run_until_signalled(line)
    finally:
        await server.stop()
    return 0


async def _serve_manager(args) -> int:
    from dragonfly2_tpu_torch.manager.models import Database
    from dragonfly2_tpu_torch.manager.rest import ManagerREST
    from dragonfly2_tpu_torch.manager.rpc import ManagerRPCServer
    from dragonfly2_tpu_torch.manager.service import ManagerService

    registry = None
    if args.registry_dir:  # a path or a <vendor>://bucket/prefix?endpoint=... URL
        from dragonfly2_tpu_torch.registry import open_registry

        registry = open_registry(args.registry_dir)
    _wire_otlp(args, "manager")
    db = Database(args.db)

    # Cross-process job edge (manager/job/preheat.go + internal/job): the
    # launched manager fans preheat triggers out to its registered ACTIVE
    # schedulers over their wire RPC (RemoteScheduler), resolved fresh
    # from the DB before every job operation — schedulers register and
    # depart at runtime, and a restarted manager re-adopts durable job
    # records through the same resolver.
    from dragonfly2_tpu_torch.cluster.jobs import JobManager, RemoteScheduler

    tls_sched_client_ctx = await _tls_context(args, "manager", server=False)

    def resolve_schedulers():
        out = {}
        for row in db.list("schedulers"):
            if row.get("state") != "active":
                continue
            host, port = row.get("ip"), int(row.get("port") or 0)
            if not host or not port:
                continue
            out[f"{host}:{port}"] = RemoteScheduler(
                host, port, ssl_context=tls_sched_client_ctx
            )
        return out

    service = ManagerService(
        db=db, registry=registry, cert_dir=args.cert_dir,
        enrollment_token=args.tls_enrollment_token or None,
        jobs=JobManager({}), jobs_resolver=resolve_schedulers,
    )
    rest = ManagerREST(service, host=args.host, port=args.port)
    host, port = rest.start()
    rpc = ManagerRPCServer(
        service, host=args.host, port=args.rpc_port,
        ssl_context=await _tls_context(args, "manager", server=True),
    )
    rpc_host, rpc_port = await rpc.start()
    try:
        async with _monitored(args, f"READY {host} {port} RPC {rpc_port}") as line:
            await _run_until_signalled(line)
    finally:
        await rpc.stop()
        rest.stop()
    return 0


def _proxy_rules(specs: list[str]) -> list:
    from dragonfly2_tpu_torch.client.transport import ProxyRule

    rules = []
    for spec in specs:
        # REGEX[=>REDIRECT_HOST]; prefix with 'direct:' to bypass P2P
        direct = spec.startswith("direct:")
        if direct:
            spec = spec[len("direct:"):]
        # '=>' separates regex from redirect host: a bare '=' is common
        # inside URL-query regexes and must stay part of the pattern
        regex, _, redirect = spec.partition("=>")
        if "=" in regex and not redirect:
            print(
                f"warning: --proxy-rule {spec!r} has '=' but no '=>' — the whole "
                "string is treated as the regex (redirect needs '=>HOST')",
                file=sys.stderr,
            )
        rules.append(ProxyRule(regex=regex, direct=direct, redirect=redirect))
    return rules


def _fault_injector(args):
    """--scenario: the scenario lab's faults in a real daemon process (the
    flaky parent): the spec's FaultInjector on the upload server, so this
    daemon serves pieces on the spec's deterministic error/stall
    schedule."""
    if not args.scenario:
        return None
    from dragonfly2_tpu_torch.scenarios.engine import FaultInjector
    from dragonfly2_tpu_torch.scenarios.spec import (
        builtin_scenarios,
        megascale_scenarios,
        resolve_scenario,
    )

    try:
        spec = resolve_scenario(args.scenario)
    except KeyError:
        known = sorted({*megascale_scenarios(), *builtin_scenarios()})
        raise SystemExit(f"dfdaemon: unknown --scenario {args.scenario!r}; "
                         f"known: {', '.join(known)}") from None
    return FaultInjector(spec, seed=args.scenario_seed)


def _object_storage_options(args) -> dict | None:
    if not args.object_storage_endpoint:
        return None
    access = os.environ.get("DRAGONFLY_OBJ_ACCESS_KEY", "")
    secret = os.environ.get("DRAGONFLY_OBJ_SECRET_KEY", "")
    if not access or not secret:
        # empty creds would boot cleanly and then fail EVERY request with
        # vendor signature errors — refuse at startup with the real cause
        raise SystemExit(
            "--object-storage-endpoint needs DRAGONFLY_OBJ_ACCESS_KEY and "
            "DRAGONFLY_OBJ_SECRET_KEY in the environment"
        )
    return {
        "endpoint": args.object_storage_endpoint,
        "access_key": access,
        "secret_key": secret,
        "region": args.object_storage_region,
    }


async def _serve_dfdaemon(args) -> int:
    from dragonfly2_tpu_torch.client.daemon import Daemon

    if not args.scheduler and not args.manager:
        raise SystemExit("dfdaemon: give --scheduler (repeatable) or --manager")
    injector = _fault_injector(args)
    daemon = Daemon(
        fault_injector=injector,
        data_dir=args.data_dir,
        scheduler_addresses=[_parse_addr(s) for s in args.scheduler or []],
        hostname=args.hostname or "",
        ip=args.ip,
        host_type=args.host_type,
        idc=args.idc,
        location=args.location,
        probe_interval=args.probe_interval,
        object_storage=args.object_storage,
        object_storage_backend=args.object_storage_backend,
        object_storage_options=_object_storage_options(args),
        proxy=args.proxy,
        proxy_rules=_proxy_rules(args.proxy_rule or []),
        registry_mirror=args.registry_mirror,
        sni_proxy=args.sni_proxy,
        sni_allowed_hosts=args.sni_allow or None,
        ssl_context=await _tls_context(args, "dfdaemon", server=False),
        manager_address=_parse_addr(args.manager) if args.manager else None,
        dynconfig_interval=args.dynconfig_interval,
    )
    _wire_otlp(args, "dfdaemon")
    await daemon.start()
    ready = f"READY {daemon.ip} {daemon.upload.port}"
    if daemon.proxy is not None:
        ready += f" PROXY {daemon.proxy.port}"
    if daemon.sni_proxy is not None:
        ready += f" SNI {daemon.sni_proxy.port}"
    if daemon.object_storage is not None:
        ready += f" OBJSTORE {daemon.object_storage.port}"
    try:
        async with _monitored(args, ready) as line:
            await _run_until_signalled(line)
    finally:
        await daemon.stop()
    return 0


def _edges(p: argparse.ArgumentParser, manager_help: str) -> None:
    p.add_argument("--otlp-endpoint", default=None,
                   help="OTLP/HTTP collector base URL for span export (--jaeger parity)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="observability HTTP: /metrics /debug/stacks /debug/profile "
                   "/debug/health")
    p.add_argument("--tls-issue", action="store_true",
                   help="certify into --tls-dir via the manager's IssueCertificate RPC")
    p.add_argument("--tls-enrollment-token",
                   default=os.environ.get("DRAGONFLY_ENROLLMENT_TOKEN", ""),
                   help="shared secret presented to the manager CA when issuing "
                   "(env DRAGONFLY_ENROLLMENT_TOKEN)")
    p.add_argument("--manager", default="", help=manager_help)


def _common(p: argparse.ArgumentParser, manager_help: str) -> None:
    p.add_argument("--device", default=None,
                   help="torch device of the services (default: the CUDA card; "
                   "'cpu' to run without one)")
    p.add_argument("--tls-dir", default=None,
                   help="cert.pem/key.pem/ca.pem dir; serves cluster mTLS when set")
    _edges(p, manager_help)


def build_parser() -> argparse.ArgumentParser:
    from dragonfly2_tpu_torch import version as _version

    p = argparse.ArgumentParser(prog="dragonfly2-tpu-torch", description=__doc__.split("\n\n")[0])
    info = _version.version_info()
    p.add_argument(
        "--version",
        action="version",
        version=(
            f"dragonfly2-tpu-torch {_version.GIT_VERSION} "
            f"(commit {_version.GIT_COMMIT}, {_version.BUILD_PLATFORM}, "
            f"torch {info['torch_version']}, cuda {info['cuda_version']})"
        ),
        help="print build metadata and exit (version/version.go)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("scheduler", help="peer-scheduling control plane")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=0)
    s.add_argument("--config", default=None, help="YAML/JSON config path")
    s.add_argument("--data-dir", default=None, help="trace CSV directory")
    s.add_argument("--algorithm", default=None,
                   help="evaluator override: default|nt|ml")
    s.add_argument("--registry-dir", default=None,
                   help="model registry dir; serves trained models over "
                   "the inference RPC when set")
    s.add_argument("--infer-port", type=int, default=0)
    s.add_argument("--scheduler-host-id", default=None,
                   help="registry host id the trainer published under "
                   "(default: host-id-v2 of this scheduler's ip+hostname, "
                   "utils/idgen.host_id_v2 — logged at startup)")
    s.add_argument("--hostname", default=None,
                   help="identity registered with the manager (default: "
                   "socket.gethostname(); MUST differ between schedulers "
                   "sharing one machine — registrations dedupe on "
                   "hostname+ip+cluster)")
    s.add_argument("--ml-refresh-interval", type=float, default=30.0,
                   help="seconds between ml-evaluator refreshes (active "
                   "model version + host embeddings from the observed "
                   "download graph); used with --algorithm ml")
    s.add_argument("--trainer", default="",
                   help="trainer host:port; streams trace datasets on the cadence")
    s.add_argument("--announce-interval", type=float, default=7 * 24 * 3600.0,
                   help="seconds between trainer uploads (reference default 7d)")
    s.add_argument("--network-topology-collect-interval", type=float, default=0.0,
                   help="seconds between snapshots of the probe graph into the "
                   "trace storage (the Go scheduler's networkTopology collect "
                   "ticker, 2h there); 0, the default, writes none, as the "
                   "reference's process does")
    s.add_argument("--vsock-port", type=int, default=None,
                   help="also listen on this AF_VSOCK port (pkg/rpc/vsock.go; "
                   "VM guests dial vsock://<cid>:<port>)")
    s.add_argument("--cluster-id", type=int, default=1)
    s.add_argument("--keepalive-interval", type=float, default=5.0)
    s.add_argument("--dynconfig-interval", type=float, default=60.0,
                   help="seconds between manager dynconfig refreshes "
                   "(hot-applies cluster scheduling limits)")
    _common(s, "manager RPC host:port; registers + keepalives when set")

    t = sub.add_parser("trainer", help="model training service")
    t.add_argument("--host", default="127.0.0.1")
    t.add_argument("--port", type=int, default=0)
    t.add_argument("--config", default=None, help="YAML/JSON config path")
    t.add_argument("--data-dir", required=True, help="per-host dataset dir")
    t.add_argument("--registry-dir", required=True, help="model registry dir")
    t.add_argument("--epochs", type=int, default=0)
    _common(t, "manager RPC host:port (only needed for --tls-issue)")

    m = sub.add_parser("manager", help="REST control plane")
    m.add_argument("--host", default="127.0.0.1")
    m.add_argument("--port", type=int, default=0)
    m.add_argument("--db", default=":memory:", help="sqlite path")
    m.add_argument("--registry-dir", default=None)
    m.add_argument("--rpc-port", type=int, default=0)
    m.add_argument("--metrics-port", type=int, default=None,
                   help="observability HTTP: /metrics /debug/stacks /debug/profile "
                   "/debug/health")
    m.add_argument("--cert-dir", default=None,
                   help="cluster CA dir; enables the IssueCertificate RPC (pkg/issuer)")
    m.add_argument("--tls-enrollment-token",
                   default=os.environ.get("DRAGONFLY_ENROLLMENT_TOKEN", ""),
                   help="shared secret services must present for cert issuance; "
                   "empty leaves the CA open (bootstrap-only setups)")
    m.add_argument("--tls-dir", default=None,
                   help="cert.pem/key.pem/ca.pem dir; serves the manager RPC over mTLS")
    m.add_argument("--otlp-endpoint", default=None,
                   help="OTLP/HTTP collector base URL for span export")

    d = sub.add_parser("dfdaemon", help="peer data-plane daemon")
    d.add_argument("--data-dir", required=True)
    d.add_argument("--scheduler", action="append", default=[],
                   help="host:port (repeatable); may be left out with --manager")
    d.add_argument("--ip", default="127.0.0.1")
    d.add_argument("--hostname", default=None,
                   help="peer identity (default: socket.gethostname(); MUST "
                   "differ between daemons sharing one machine — the "
                   "scheduler keys hosts on host-id-v2(ip, hostname), so "
                   "two daemons with one identity collapse into one host "
                   "and can never serve each other)")
    d.add_argument("--host-type", default="normal", choices=("normal", "super"))
    d.add_argument("--idc", default="")
    d.add_argument("--location", default="")
    d.add_argument("--probe-interval", type=float, default=0.0)
    d.add_argument("--object-storage", action="store_true")
    d.add_argument("--object-storage-backend", default="fs",
                   choices=("fs", "s3", "oss", "obs"))
    d.add_argument("--object-storage-endpoint", default="",
                   help="vendor endpoint for s3/oss/obs (credentials via "
                   "DRAGONFLY_OBJ_ACCESS_KEY / DRAGONFLY_OBJ_SECRET_KEY env)")
    d.add_argument("--object-storage-region", default="")
    d.add_argument("--proxy", action="store_true",
                   help="serve the HTTP(S) forward proxy listener")
    d.add_argument("--registry-mirror", default="",
                   help="reverse-proxy base URL for relative requests")
    d.add_argument("--sni-proxy", action="store_true",
                   help="serve the raw-TLS SNI passthrough listener "
                   "(refuses every host unless --sni-allow is given)")
    d.add_argument("--sni-allow", action="append", default=[],
                   help="hostname (or suffix) the SNI proxy may dial (repeatable)")
    d.add_argument("--proxy-rule", action="append", default=[],
                   help="P2P hijack rule REGEX[=>REDIRECT_HOST]; prefix "
                   "'direct:' to match-but-bypass (repeatable)")
    d.add_argument("--scenario", default="",
                   help="scenario-lab spec name (scenarios/spec.py); attaches "
                   "the spec's FaultInjector to this daemon's upload server "
                   "so it serves pieces as the deterministic flaky parent")
    d.add_argument("--scenario-seed", type=int, default=0,
                   help="seed for --scenario fault schedules")
    d.add_argument("--tls-dir", default=None,
                   help="cert.pem/key.pem/ca.pem dir; dials schedulers over mTLS")
    d.add_argument("--dynconfig-interval", type=float, default=60.0,
                   help="seconds between manager scheduler-list refreshes")
    _edges(d, "manager RPC host:port; refreshes the scheduler list via "
              "dynconfig when set (also used for --tls-issue)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    runner = {"scheduler": _serve_scheduler, "trainer": _serve_trainer,
              "manager": _serve_manager, "dfdaemon": _serve_dfdaemon}[args.cmd]
    return asyncio.run(runner(args))


if __name__ == "__main__":
    sys.exit(main())
