"""Service launchers — the `cmd/{scheduler,trainer}` tier of the port.

Port of dragonfly2_tpu/cmd.py's scheduler and trainer subcommands, with
the reference's flags and `READY` lines: one module, one subcommand per
service, a YAML/JSON config via --config plus flag overrides, graceful
SIGINT/SIGTERM shutdown. Each service prints exactly one
`READY <host> <port>` line once its listener is bound (the scheduler adds
`INFER <host> <port>` with --registry-dir, and either adds
`METRICS <port>` with --metrics-port), so a parent process can wait on
startup without polling.

    python -m dragonfly2_tpu_torch.cmd scheduler --port 8002 --data-dir /var/df
    python -m dragonfly2_tpu_torch.cmd trainer   --port 8004 --data-dir ... --registry-dir ...

What differs from the reference:

- `--device` (both subcommands): the services' torch device, the CUDA
  card by default. Without a card the process exits non-zero with
  device.py's error unless it is given `--device cpu`; nothing falls back.
- `--registry-dir` opens the port's filesystem ModelRegistry (the bucket
  layout, registry/registry.py), and the scheduler serves its gnn, mlp
  and attention versions through ModelServers built from their modules.
- `--network-topology-collect-interval` (scheduler): seconds between
  snapshots of the probe graph into the trace storage, the Go
  scheduler's networkTopology collect ticker (network_topology.go:124-138,
  2 h there), run by SchedulerRPCServer. Off by default, as the
  reference's process writes no topology rows: its uploads then carry no
  networktopology dataset, and the trainer trains no MLP from them.
- the process logs at INFO on stderr (the reference configures no
  handler, so its INFO lines are lost): the scheduler's registry host id
  and each GNN version its ml arm starts serving among them.
- the manager and dfdaemon subcommands, and the scheduler's and
  trainer's manager edges (`--manager`, `--tls-issue`), exit non-zero
  with a message naming their ROADMAP item (A9 part 3: the manager, its
  dynconfig and certificate issuance; A9 part 2: the dfdaemon). None of
  them starts a process that lacks its edge. `--tls-dir` with the
  material already in place serves mTLS.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import logging
import signal
import sys

NOT_PORTED = {
    "manager": "the manager is not ported yet (ROADMAP A9 part 3)",
    "dfdaemon": "the dfdaemon is not ported yet (ROADMAP A9 part 2)",
    "--manager": "--manager needs the manager's RPC, registration and dynconfig, "
                 "not ported yet (ROADMAP A9 part 3)",
    "--tls-issue": "--tls-issue needs the manager's IssueCertificate RPC, not ported yet "
                   "(ROADMAP A9 part 3); put cert.pem/key.pem/ca.pem in --tls-dir instead",
}


def idgen_host_id(ip: str, hostname: str) -> str:
    from dragonfly2_tpu_torch.utils import idgen

    return idgen.host_id_v2(ip, hostname)


def _refuse_manager_edges(args) -> None:
    for flag, value in (("--manager", getattr(args, "manager", "")),
                        ("--tls-issue", getattr(args, "tls_issue", False))):
        if value:
            raise SystemExit(f"{args.cmd}: {NOT_PORTED[flag]}")


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


def _tls_material(args):
    """Optional cluster mTLS (scheduler.go:180-219): --tls-dir points at
    cert.pem/key.pem/ca.pem already in place. None = plaintext."""
    tls_dir = getattr(args, "tls_dir", None)
    if not tls_dir:
        return None
    from dragonfly2_tpu_torch.utils.certs import TLSMaterial

    mat = TLSMaterial(tls_dir)
    if not mat.ready:
        raise SystemExit(
            f"--tls-dir {tls_dir} has no cert material (cert.pem, key.pem, ca.pem); "
            f"{NOT_PORTED['--tls-issue']}"
        )
    return mat


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

    _refuse_manager_edges(args)
    device = _device(args)
    config = Config.load(args.config) if args.config else Config()
    if args.algorithm:
        config.evaluator.algorithm = args.algorithm
    storage = TraceStorage(args.data_dir) if args.data_dir else None
    probes = ProbeStore(max_hosts=config.scheduler.max_hosts, device=device)
    service = SchedulerService(config=config, storage=storage, probes=probes, device=device)
    _wire_otlp(args, "scheduler")
    tls_mat = _tls_material(args)
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
    # scheduler/config/config.go ServerConfig).
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
        from dragonfly2_tpu_torch.registry import ModelRegistry, ModelServer
        from dragonfly2_tpu_torch.registry.registry import (
            MODEL_TYPE_ATTENTION, MODEL_TYPE_GNN, MODEL_TYPE_MLP,
        )
        from dragonfly2_tpu_torch.rpc.inference import InferenceRPCServer

        registry = ModelRegistry(args.registry_dir)
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
    from dragonfly2_tpu_torch.registry import ModelRegistry
    from dragonfly2_tpu_torch.rpc.server import TrainerRPCServer

    _refuse_manager_edges(args)
    device = _device(args)
    config = Config.load(args.config) if args.config else Config()
    if args.epochs:
        config.trainer.epochs = args.epochs
    service = TrainerService(
        HostTraceStorage(args.data_dir),
        ModelRegistry(args.registry_dir),
        config.trainer,
        device=device,
    )
    _wire_otlp(args, "trainer")
    tls_mat = _tls_material(args)
    server = TrainerRPCServer(
        service, host=args.host, port=args.port,
        ssl_context=tls_mat.server_context() if tls_mat else None,
    )
    host, port = await server.start()
    try:
        async with _monitored(args, f"READY {host} {port}") as line:
            await _run_until_signalled(line)
    finally:
        await server.stop()
    return 0


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device of the services (default: the CUDA card; "
                   "'cpu' to run without one)")
    p.add_argument("--otlp-endpoint", default=None,
                   help="OTLP/HTTP collector base URL for span export (--jaeger parity)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="observability HTTP: /metrics /debug/stacks /debug/profile "
                   "/debug/health")
    p.add_argument("--tls-dir", default=None,
                   help="cert.pem/key.pem/ca.pem dir; serves cluster mTLS when set")
    p.add_argument("--tls-issue", action="store_true",
                   help="refused: certificate issuance is ROADMAP A9 part 3")
    p.add_argument("--manager", default="",
                   help="refused: the manager edge is ROADMAP A9 part 3")


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
                   help="this scheduler's identity (default: socket.gethostname())")
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
    _common(s)

    t = sub.add_parser("trainer", help="model training service")
    t.add_argument("--host", default="127.0.0.1")
    t.add_argument("--port", type=int, default=0)
    t.add_argument("--config", default=None, help="YAML/JSON config path")
    t.add_argument("--data-dir", required=True, help="per-host dataset dir")
    t.add_argument("--registry-dir", required=True, help="model registry dir")
    t.add_argument("--epochs", type=int, default=0)
    _common(t)

    for name, what in (("manager", "REST control plane"), ("dfdaemon", "peer data-plane daemon")):
        sub.add_parser(name, help=f"{what}: {NOT_PORTED[name]}")
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.cmd in ("manager", "dfdaemon"):  # whatever flags the reference's take
        raise SystemExit(f"{args.cmd}: {NOT_PORTED[args.cmd]}")
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    runner = {"scheduler": _serve_scheduler, "trainer": _serve_trainer}[args.cmd]
    return asyncio.run(runner(args))


if __name__ == "__main__":
    sys.exit(main())
