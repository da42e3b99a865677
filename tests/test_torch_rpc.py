"""The port's wire edge against the reference's, over 127.0.0.1.

- The scheduler: tests/torch_wire_script.py's peer sequence played by the
  reference's SchedulerConnection into the port's SchedulerRPCServer (its
  SchedulerService on the CPU) and by the port's client into the
  reference's server, on paired seeds and Configs; the decoded answers
  are identical, parent scores included (one peer a tick, the blend's
  float32 sums agree to the bit at this size).
- The trainer: each package's TrainerClient streams one trace dump to the
  other's TrainerRPCServer, which trains and publishes gnn and mlp; a bad
  dataset and a torn connection abort (tests/test_rpc_wire.py:74-210).
- ``_probe_targets`` under a pinned ``time.time_ns``: the same targets.
- The networktopology collect ticker, a loop the reference's server
  lacks: off by default, and when set it writes the probe graph's rows.
- The mux and the monitor (tests/test_mux.py, test_multiprocess_e2e.py:194):
  wire and HTTP on one port, the ``/debug/health`` verdict equal to the
  reference's on the same SLO engine state, ``/metrics``,
  ``/debug/stacks``, and ``/debug/flight`` naming ROADMAP A10.
- The hash ring's picks against the reference's, native and pure Python.
- TLS with material in place: a round trip, and a plaintext client refused.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dragonfly2_tpu.cluster import messages as ref_msg
from dragonfly2_tpu.cluster.scheduler import SchedulerService as RefService
from dragonfly2_tpu.rpc import client as ref_client
from dragonfly2_tpu.rpc import server as ref_server
from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
from dragonfly2_tpu_torch.rpc import client, server

import torch_wire_script


def _port_service(**kwargs):
    return SchedulerService(device="cpu", **kwargs)


async def _served(svc, server_mod, play):
    srv = server_mod.SchedulerRPCServer(svc)
    host, port = await srv.start()
    try:
        return await play(host, port)
    finally:
        await srv.stop()


# ------------------------------------------------------------ scheduler


def test_scripted_sequence_answers_identically_across_packages():
    port_svc, ref_svc = _port_service(seed=3), RefService(seed=3)
    into_port = asyncio.run(_served(
        port_svc, server,
        lambda h, p: torch_wire_script.play(ref_client, ref_msg, h, p)))
    into_ref = asyncio.run(_served(
        ref_svc, ref_server,
        lambda h, p: torch_wire_script.play(client, msg, h, p)))
    assert len(into_port) == 13
    assert into_port == into_ref
    kinds = [a["type"] for a in into_port]
    assert kinds.count("NormalTaskResponse") == 4 and "EmptyTaskResponse" in kinds
    assert port_svc.counts() == ref_svc.counts()


def test_deadline_shed_and_health_answer_like_the_reference():
    """A RegisterPeer whose propagated budget is already spent is shed
    with DeadlineExceeded; a HealthCheck answers SERVING; both packages
    send the same frames."""
    from dragonfly2_tpu.rpc import wire as ref_wire

    from dragonfly2_tpu_torch.rpc import mux, wire

    async def exchange(host, port):
        reader, writer = await asyncio.open_connection(host, port)
        try:
            writer.write(wire.encode(msg.RegisterPeerRequest(
                peer_id="late", task_id="t", host=msg.HostInfo(host_id="h")), deadline_s=0.0))
            writer.write(wire.encode(mux.HealthCheckRequest(service="scheduler")))
            await writer.drain()
            out = []
            for _ in range(2):
                header = await reader.readexactly(4)
                payload = await reader.readexactly(int.from_bytes(header, "big"))
                out.append((ref_wire.decode(payload), wire.decode(payload)))
            return out
        finally:
            writer.close()

    port_frames = asyncio.run(_served(_port_service(), server, exchange))
    ref_frames = asyncio.run(_served(RefService(), ref_server, exchange))
    for (pr, pp), (rr, rp) in zip(port_frames, ref_frames):
        assert dataclasses.asdict(pp) == dataclasses.asdict(rp)
        assert dataclasses.asdict(pr) == dataclasses.asdict(rr)
    assert port_frames[0][1] == msg.ScheduleFailure(
        peer_id="late", code="DeadlineExceeded", description="deadline expired before dispatch")


@pytest.mark.parametrize("into", ["port", "reference"])
def test_sync_client_job_frames_answer_alike(into):
    """The blocking SyncSchedulerClient (the manager's job edge) of the
    OTHER package against ``into``'s server, on a service holding one
    announced host and one seed trigger: the same TaskStates,
    SchedulerInfo and JobTriggerSeed answers as that package's own client
    gets."""
    import threading

    def ask(client_mod, msg_mod, host, port):
        c = client_mod.SyncSchedulerClient(host, port, timeout=10)
        try:
            return [_plain_msg(c.call(r)) for r in (
                msg_mod.TaskStatesRequest(task_ids=["t-a", "nope"]),
                msg_mod.SchedulerInfoRequest(),
                msg_mod.JobTriggerSeedRequest(task_id="t-b", url="https://o.example/b"),
                msg_mod.TaskStatesRequest(task_ids=["t-b"]))]
        finally:
            c.close()

    def run(svc, server_mod, m, askers):
        svc.announce_host(m.HostInfo(host_id="seed-1", ip="10.0.0.9", host_type="super"))
        svc.register_peer(m.RegisterPeerRequest(
            peer_id="p-a", task_id="t-a", host=m.HostInfo(host_id="h-a", ip="10.0.0.1"),
            url="https://o.example/a", content_length=8 << 20))
        loop, ready, out = asyncio.new_event_loop(), threading.Event(), {}
        srv = server_mod.SchedulerRPCServer(svc)

        def serve():
            asyncio.set_event_loop(loop)
            out["addr"] = loop.run_until_complete(srv.start())
            ready.set()
            loop.run_forever()

        thread = threading.Thread(target=serve, name="sync-client-server")
        thread.start()
        try:
            assert ready.wait(60)
            return [a(*out["addr"]) for a in askers]
        finally:
            asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(60)
            loop.call_soon_threadsafe(loop.stop)
            thread.join(60)
            loop.close()

    if into == "port":
        svc, server_mod, m = _port_service(), server, msg
        mine, other = (client, msg), (ref_client, ref_msg)
    else:
        svc, server_mod, m = RefService(), ref_server, ref_msg
        mine, other = (ref_client, ref_msg), (client, msg)
    from_other, = run(svc, server_mod, m, [lambda h, p: ask(*other, h, p)])
    svc2 = _port_service() if into == "port" else RefService()
    from_mine, = run(svc2, server_mod, m, [lambda h, p: ask(*mine, h, p)])
    assert from_other == from_mine
    assert from_other[0]["states"][1] == -1 and from_other[2]["ok"] is True


def _plain_msg(message) -> dict:
    return {"type": type(message).__name__, **dataclasses.asdict(message)}


def _probe_pair(n_hosts=40):
    from dragonfly2_tpu.cluster.probes import ProbeStore as RefProbeStore

    from dragonfly2_tpu_torch.cluster.probes import ProbeStore

    port_svc = _port_service(probes=ProbeStore(max_pairs=1 << 12, max_hosts=1024, device="cpu"))
    ref_svc = RefService(probes=RefProbeStore(max_pairs=1 << 12, max_hosts=1024))
    for svc, m in ((port_svc, msg), (ref_svc, ref_msg)):
        for i in range(n_hosts):
            svc.announce_host(m.HostInfo(host_id=f"host-{i}", ip=f"10.1.0.{i}", port=9000 + i))
    return port_svc, ref_svc


def test_probe_targets_equal_the_reference_under_a_pinned_clock(monkeypatch):
    port_svc, ref_svc = _probe_pair()
    port_srv, ref_srv = server.SchedulerRPCServer(port_svc), ref_server.SchedulerRPCServer(ref_svc)
    # one probed pair so the counts are not all equal
    port_srv._probe_finished(msg.ProbeFinishedRequest(
        host_id="host-1", results=[msg.ProbeResult(host_id="host-2", rtt_ns=5_000_000)]))
    ref_srv._probe_finished(ref_msg.ProbeFinishedRequest(
        host_id="host-1", results=[ref_msg.ProbeResult(host_id="host-2", rtt_ns=5_000_000)]))
    picks = []
    for now in (1_700_000_000_123_456_789, 1_700_000_000_987_654_321, 42):
        monkeypatch.setattr(time, "time_ns", lambda now=now: now)
        got = port_srv._probe_targets(msg.ProbeStartedRequest(host_id="host-0", count=10))
        want = ref_srv._probe_targets(ref_msg.ProbeStartedRequest(host_id="host-0", count=10))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        ids = [t.host_id for t in got.targets]
        assert len(ids) == 10 and "host-0" not in ids
        picks.append(ids)
    monkeypatch.undo()
    assert len({tuple(p) for p in picks}) > 1  # the clock keys the draw


@pytest.mark.parametrize("interval", [0.0, 0.05], ids=["off", "on"])
def test_topology_collect_ticker_writes_the_probe_graph_only_when_set(tmp_path, interval):
    """SchedulerRPCServer's networktopology collect ticker: off by default,
    as the reference's server writes no topology rows; when set, the probe
    graph reaches the trace storage on its own cadence."""
    from dragonfly2_tpu_torch.cluster.probes import ProbeStore
    from dragonfly2_tpu_torch.records.storage import TraceStorage

    storage = TraceStorage(tmp_path)
    svc = _port_service(storage=storage,
                        probes=ProbeStore(max_pairs=1 << 10, max_hosts=64, device="cpu"))
    for i in range(4):
        svc.announce_host(msg.HostInfo(host_id=f"host-{i}", ip=f"10.1.0.{i}", port=9000 + i))
    srv = server.SchedulerRPCServer(svc, topology_collect_interval=interval)
    srv._probe_finished(msg.ProbeFinishedRequest(
        host_id="host-1", results=[msg.ProbeResult(host_id="host-2", rtt_ns=5_000_000)]))

    async def run():
        await srv.start()
        await asyncio.sleep(0.3)
        await srv.stop()

    asyncio.run(run())
    storage.flush()
    rows = storage.list_network_topologies()
    if interval:
        assert rows and {r.host.id for r in rows} == {"host-1"}
    else:
        assert rows == []


# -------------------------------------------------------------- trainer


@pytest.fixture(scope="module")
def trace_dump(tmp_path_factory):
    """One scheduler's download and topology dumps, from the port's
    simulator with probes (tests/test_rpc_wire.py's recipe)."""
    from dragonfly2_tpu_torch.cluster.probes import ProbeStore
    from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
    from dragonfly2_tpu_torch.records.storage import TraceStorage

    storage = TraceStorage(tmp_path_factory.mktemp("sched-data"))
    svc = _port_service(storage=storage,
                        probes=ProbeStore(max_pairs=1024, max_hosts=128, device="cpu"))
    sim = ClusterSimulator(svc, num_hosts=24, num_tasks=4, seed=11)
    for _ in range(8):
        sim.run_round(new_downloads=6)
        sim.run_probe_round(sources=4)
    assert svc.snapshot_topology(now_ns=1) > 0
    storage.flush()
    return {"download": storage.open_download(),
            "networktopology": storage.open_network_topology()}


def _port_trainer(root, **cfg):
    from dragonfly2_tpu_torch.cluster.trainer_service import TrainerService
    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.records.storage import HostTraceStorage
    from dragonfly2_tpu_torch.registry import ModelRegistry

    registry = ModelRegistry(root / "registry")
    return registry, TrainerService(HostTraceStorage(root / "trainer-data"), registry,
                                    TrainerConfig(**cfg), device="cpu")


async def _upload(server_mod, service, client_mod, datasets, chunk_size=4096):
    srv = server_mod.TrainerRPCServer(service)
    host, port = await srv.start()
    try:
        return await client_mod.TrainerClient(host, port).train(
            "sched-1", "10.0.0.1", "sched-node", datasets=datasets, chunk_size=chunk_size)
    finally:
        await srv.stop()


def test_reference_client_trains_through_the_port_server(tmp_path, trace_dump):
    from dragonfly2_tpu_torch.cluster.trainer_service import GNN_MODEL_NAME, MLP_MODEL_NAME

    registry, trainer = _port_trainer(tmp_path, epochs=2, batch_size=32, hidden_dim=16)
    response = asyncio.run(_upload(server, trainer, ref_client, trace_dump))
    assert isinstance(response, ref_msg.TrainResponse)
    assert response.ok, response.description
    assert response.description == "gnn v1, mlp v1"
    for name in (GNN_MODEL_NAME, MLP_MODEL_NAME):
        active = registry.active_version(registry.model_id(name, "sched-1"))
        assert active is not None and active.version == 1


def test_port_client_trains_through_the_reference_server(tmp_path, trace_dump):
    from dragonfly2_tpu.cluster.trainer_service import GNN_MODEL_NAME, TrainerService
    from dragonfly2_tpu.config.config import TrainerConfig
    from dragonfly2_tpu.records.storage import HostTraceStorage
    from dragonfly2_tpu.registry import ModelRegistry

    registry = ModelRegistry(tmp_path / "registry")
    trainer = TrainerService(HostTraceStorage(tmp_path / "trainer-data"), registry,
                             TrainerConfig(epochs=2, batch_size=32, hidden_dim=16))
    response = asyncio.run(_upload(ref_server, trainer, client, trace_dump))
    assert isinstance(response, msg.TrainResponse)
    assert response.ok, response.description
    assert "gnn" in response.description and "mlp" in response.description
    assert {m["type"] for m in registry.list_models()} >= {"gnn", "mlp"}
    assert registry.active_version(registry.model_id(GNN_MODEL_NAME, "sched-1")) is not None


@pytest.mark.parametrize("client_mod", [ref_client, client], ids=["reference", "port"])
def test_bad_dataset_aborts_on_the_port_server(tmp_path, client_mod):
    _, trainer = _port_trainer(tmp_path, epochs=1, batch_size=8, hidden_dim=8)
    response = asyncio.run(_upload(server, trainer, client_mod, {"bogus": b"xyz"}))
    assert not response.ok and "bogus" in response.description
    assert not trainer.storage.list_downloads()


def test_torn_connection_aborts_on_the_port_server(tmp_path):
    from dragonfly2_tpu.rpc import wire as ref_wire

    registry, trainer = _port_trainer(tmp_path, epochs=1, batch_size=8, hidden_dim=8)

    async def run():
        srv = server.TrainerRPCServer(trainer)
        host, port = await srv.start()
        try:
            reader, writer = await asyncio.open_connection(host, port)
            ref_wire.write_frame(writer, ref_msg.TrainRequest(
                host_id="sched-torn", ip="1.2.3.4", hostname="n", dataset="download",
                chunk=b"id,tag\n"))
            await writer.drain()
            writer.close()  # die mid-upload: no TrainEndRequest
            await writer.wait_closed()
            await asyncio.sleep(0.2)
        finally:
            await srv.stop()

    asyncio.run(run())
    assert not trainer.storage.list_downloads()
    assert not registry.list_models()


# ------------------------------------------------------ mux and monitor


def _http(base, path):
    try:
        with urllib.request.urlopen(f"{base}{path}", timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _engines(slo_mod, monkeypatch):
    """Two SLO engines in one package, fed the same observations, in a
    process registry of their own (the verdict merges every live engine)."""
    monkeypatch.setattr(slo_mod, "_ENGINES", {})
    metrics_mod = __import__(slo_mod.__name__.rsplit(".", 1)[0] + ".metrics", fromlist=["x"])
    specs = slo_mod.scheduler_slo_specs(50.0)
    busy = slo_mod.SLOEngine(specs, name="sched-a", registry=metrics_mod.Registry())
    calm = slo_mod.SLOEngine(specs, name="sched-b", registry=metrics_mod.Registry())
    for minute in range(40):
        busy.observe("tick_latency", good=2.0, bad=8.0)
        calm.observe("tick_latency", good=10.0)
        busy.step(float(minute))
        calm.step(float(minute))
    return busy, calm


def test_health_verdict_equals_the_reference(monkeypatch):
    from dragonfly2_tpu.telemetry import slo as ref_slo

    from dragonfly2_tpu_torch.telemetry import slo

    keep = (_engines(slo, monkeypatch), _engines(ref_slo, monkeypatch))
    for query in ("", "last_n=2", "max_bytes=1024"):
        got = slo.health_verdict(**slo.parse_health_query(query))
        want = ref_slo.health_verdict(**ref_slo.parse_health_query(query))
        assert got == want, query
    assert got["state"] == slo.VERDICT_CRITICAL and got["sources"] == ["sched-a", "sched-b"]
    with pytest.raises(ValueError, match="last_n"):
        slo.parse_health_query("last_n=x")
    del keep


FLIGHT_BOUNDED = "/debug/flight?section=ticks,jit&max_bytes=4096"


def test_mux_serves_wire_and_http_on_one_port(monkeypatch):
    from dragonfly2_tpu.rpc import mux as ref_mux
    from dragonfly2_tpu.telemetry import slo as ref_slo

    from dragonfly2_tpu_torch.rpc import mux
    from dragonfly2_tpu_torch.telemetry import default_registry, slo

    keep = (_engines(slo, monkeypatch), _engines(ref_slo, monkeypatch))

    async def run(server_mod, mux_mod, svc):
        rpc = server_mod.SchedulerRPCServer(svc, tick_interval=0.01)
        await rpc.start()
        front = mux_mod.MuxServer(rpc._serve_conn, metrics_registry=default_registry(),
                                  health_check=lambda: True)
        host, port = await front.start()
        base = f"http://{host}:{port}"
        try:
            loop = asyncio.get_running_loop()
            got = {path: await loop.run_in_executor(None, _http, base, path)
                   for path in ("/healthz", "/metrics", "/debug/health?last_n=4",
                                "/debug/flight", FLIGHT_BOUNDED, "/debug/flight?section=bogus",
                                "/nope")}
            # the wire on the same port, through the port's client
            conn = await client.SchedulerConnection(host, port).connect()
            try:
                assert await conn.health()
                await conn.send(msg.AnnounceHostRequest(host=msg.HostInfo(host_id="mux-host")))
                assert (await conn.stat_task("none")).found is False
            finally:
                await conn.close()
            return got
        finally:
            await front.stop()
            await rpc.stop()

    port_svc = _port_service()
    got = asyncio.run(run(server, mux, port_svc))
    want = asyncio.run(run(ref_server, ref_mux, RefService()))
    assert port_svc.counts()["hosts"] == 1
    assert got["/healthz"] == want["/healthz"] == (200, b"ok")
    assert got["/metrics"][0] == 200 and b"dragonfly_scheduler_announce_peer_total" in got["/metrics"][1]
    assert got["/nope"][0] == want["/nope"][0] == 404
    status, body = got["/debug/health?last_n=4"]
    assert status == want["/debug/health?last_n=4"][0] == 503
    assert json.loads(body) == json.loads(want["/debug/health?last_n=4"][1])
    # the flight recorder's dump (A10, refused before): the process-wide
    # dump with every section the reference's carries
    status, body = got["/debug/flight"]
    assert status == want["/debug/flight"][0] == 200
    assert set(json.loads(body)) == set(json.loads(want["/debug/flight"][1]))
    # its query surface: the sections and the byte cap asked for, and a 400
    status, body = got[FLIGHT_BOUNDED]
    assert status == want[FLIGHT_BOUNDED][0] == 200 and len(body) <= 4096
    assert set(json.loads(body)) == set(json.loads(want[FLIGHT_BOUNDED][1])) == {
        "generated_at_ns", "ticks", "jit"}
    assert got["/debug/flight?section=bogus"][0] == want["/debug/flight?section=bogus"][0] == 400
    del keep


def test_monitor_serves_metrics_stacks_profile_and_names_a10():
    from dragonfly2_tpu_torch.telemetry import metrics

    reg = metrics.Registry()
    reg.counter("dragonfly_test_total", "a counter").labels().inc(3)
    monitor = metrics.serve_metrics(reg, port=0)
    base = f"http://127.0.0.1:{monitor.server_address[1]}"
    try:
        status, body = _http(base, "/metrics")
        assert status == 200 and b"dragonfly_test_total 3.0" in body
        status, body = _http(base, "/debug/stacks")
        assert status == 200 and b"Thread" in body
        status, body = _http(base, "/debug/profile?seconds=0.2")
        assert status == 200 and b"samples over" in body
        status, body = _http(base, "/debug/health")
        assert status in (200, 503) and "state" in json.loads(body)
        # the flight recorder's dump (A10, refused before), its query
        # surface (telemetry/flight.parse_flight_query) and its 400s
        status, body = _http(base, "/debug/flight")
        assert status == 200 and "costcards" in json.loads(body)
        status, body = _http(base, "/debug/flight?section=ticks&max_bytes=2048")
        assert status == 200 and set(json.loads(body)) == {"generated_at_ns", "ticks"}
        assert len(body) <= 2048
        status, body = _http(base, "/debug/flight?section=bogus")
        assert status == 400 and b"unknown section" in body
    finally:
        monitor.shutdown()
    assert monitor._serve_thread is None


def test_flight_request_on_the_wire_fails_naming_a10():
    """The wire FlightRecorderRequest reaches SchedulerService.flight_dump
    (A10, refused before): both packages' servers answer a
    FlightRecorderResponse whose dump has the same sections, this
    service's tick ring among them."""
    from dragonfly2_tpu_torch.rpc import wire

    async def run(host, port):
        reader, writer = await asyncio.open_connection(host, port)
        wire.write_frame(writer, msg.FlightRecorderRequest(last_n=4))
        await writer.drain()
        frame = await asyncio.wait_for(wire.read_frame(reader), 10)
        writer.close()
        return frame

    svc = _port_service()
    assert svc.flight_dump(last_n=4)["ticks"]["ticks_total"] == 0
    got = asyncio.run(_served(svc, server, run))
    want = asyncio.run(_served(RefService(), ref_server, run))
    assert type(got).__name__ == type(want).__name__ == "FlightRecorderResponse"
    assert set(got.dump) == set(want.dump) and "costcards" in got.dump
    assert got.dump["ticks"] == {"ticks_total": 0, "p50_ms": {}, "last": []}


# ------------------------------------------------------------ hash ring


@pytest.mark.parametrize("native_path", [True, False], ids=["native", "python"])
def test_hash_ring_picks_equal_the_reference(monkeypatch, native_path):
    from dragonfly2_tpu import native as ref_native
    from dragonfly2_tpu.utils.hashring import HashRing as RefRing

    from dragonfly2_tpu_torch import native
    from dragonfly2_tpu_torch.utils.hashring import HashRing

    if native_path:
        assert native.available() and ref_native.available()
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    nodes = [f"10.0.{i}.1:8002" for i in range(7)]
    keys = [f"task-{i:04d}" for i in range(400)] + ["", "é-ünïcode"]
    ring, ref = HashRing(nodes), RefRing(nodes)
    assert [ring.pick(k) for k in keys] == [ref.pick(k) for k in keys]
    assert ring.pick_many(keys) == ref.pick_many(keys) == [ring.pick(k) for k in keys]
    assert [ring.successors(k, 3) for k in keys[:50]] == [ref.successors(k, 3) for k in keys[:50]]
    ring.remove(nodes[2])
    ref.remove(nodes[2])
    assert [ring.pick(k) for k in keys] == [ref.pick(k) for k in keys]
    assert native.fnv1a64_batch([k.encode() for k in keys]).tolist() == [
        ref_native.fnv1a64(k.encode()) for k in keys]


def test_hash_ring_native_and_python_paths_agree(monkeypatch):
    from dragonfly2_tpu_torch import native

    keys = [f"key-{i}".encode() for i in range(300)] + [b""]
    fast = [native.fnv1a64(k) for k in keys]
    ring = np.sort(np.asarray(fast[:40], np.uint64))
    picks = native.ring_pick_batch(ring, np.asarray(fast, np.uint64))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert [native.fnv1a64(k) for k in keys] == fast
    assert native.ring_pick_batch(ring, np.asarray(fast, np.uint64)).tolist() == picks.tolist()


# ------------------------------------------------------------------ TLS


def test_tls_dir_round_trip_and_plaintext_refused(tmp_path):
    from dragonfly2_tpu_torch.utils import certs

    mat = certs.self_signed_material(tmp_path / "tls", "scheduler")
    again = certs.TLSMaterial(tmp_path / "tls")  # material already in place
    assert again.ready

    async def run():
        srv = server.SchedulerRPCServer(_port_service(), ssl_context=again.server_context())
        host, port = await srv.start()
        try:
            conn = await client.SchedulerConnection(
                host, port, ssl_context=mat.client_context()).connect()
            try:
                assert await conn.health()
            finally:
                await conn.close()
            plain = await client.SchedulerConnection(host, port).connect()
            try:
                with pytest.raises((asyncio.TimeoutError, ConnectionError, OSError)):
                    await plain.health(timeout=2.0)
            finally:
                await plain.close()
        finally:
            await srv.stop()

    asyncio.run(run())
