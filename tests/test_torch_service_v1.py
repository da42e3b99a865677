"""The port's v1 dialect (cluster/service_v1.py) against the reference's.

Each case of tests/test_service_v1.py runs twice, once over each package
(the port's SchedulerService on the CPU), through the same requests on
default Configs and seeds: the reference's own assertions hold on the
port, and every answer (V1RegisterResult, V1PeerPacket, V1Task, the v2
responses a tick gives) is the reference's, field for field, parent
scores included. The dialect over the wire runs through each package's
SchedulerRPCServer; v1 and v2 peers share one swarm.
"""

from __future__ import annotations

import asyncio
import dataclasses
import types

import pytest

import dragonfly2_tpu.cluster.messages as ref_msg
import dragonfly2_tpu.cluster.service_v1 as ref_sv1
import dragonfly2_tpu.rpc.server as ref_server
import dragonfly2_tpu.rpc.wire as ref_wire
import dragonfly2_tpu.state.fsm as ref_fsm
import dragonfly2_tpu.utils.idgen as ref_idgen
from dragonfly2_tpu.cluster.scheduler import SchedulerService as RefService
import dragonfly2_tpu_torch.cluster.messages as msg
import dragonfly2_tpu_torch.cluster.service_v1 as sv1
import dragonfly2_tpu_torch.rpc.server as server
import dragonfly2_tpu_torch.rpc.wire as wire
import dragonfly2_tpu_torch.state.fsm as fsm
import dragonfly2_tpu_torch.utils.idgen as idgen
from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService

PORT = types.SimpleNamespace(
    name="port", service=lambda: SchedulerService(device="cpu"), sv1=sv1, msg=msg, fsm=fsm,
    idgen=idgen, server=server, wire=wire)
REF = types.SimpleNamespace(
    name="reference", service=RefService, sv1=ref_sv1, msg=ref_msg, fsm=ref_fsm,
    idgen=ref_idgen, server=ref_server, wire=ref_wire)


def _plain(x):
    if x is None:
        return None
    if dataclasses.is_dataclass(x):
        return {"type": type(x).__name__, **dataclasses.asdict(x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _both(case):
    """Run ``case(pkg, out)`` over each package; ``out`` collects the
    answers, which must be equal across the two."""
    got = {}
    for pkg in (PORT, REF):
        out: list = []
        case(pkg, out)
        got[pkg.name] = [_plain(v) for v in out]
    assert got["port"] == got["reference"]
    return got["port"]


def v1_host(pkg, i: int):
    return pkg.sv1.V1PeerHost(
        id=f"host-{i}", ip=f"10.1.0.{i}", rpc_port=8002 + i, down_port=8001,
        host_name=f"h{i}", idc="idc-a", location="region|zone",
    )


def v1_register(pkg, adapter, peer_id: str, task_id: str, i: int, url="https://o.example/f"):
    return adapter.register_peer_task(pkg.sv1.V1PeerTaskRequest(
        url=url, peer_id=peer_id, peer_host=v1_host(pkg, i), task_id=task_id,
        url_meta=pkg.sv1.V1UrlMeta(tag="t", application="app"),
    ))


def _normal(pkg, responses):
    return [r for r in responses if isinstance(r, pkg.msg.NormalTaskResponse)]


def test_register_scopes_and_task_id_derivation():
    def case(pkg, out):
        svc = pkg.service()
        v1 = pkg.sv1.SchedulerServiceV1(svc)
        result = v1_register(pkg, v1, "p-1", "t-1", 1)
        assert result.size_scope == int(pkg.msg.SizeScope.NORMAL)
        assert result.task_id == "t-1"
        assert svc.state.peer_index("p-1") is not None
        result2 = v1.register_peer_task(pkg.sv1.V1PeerTaskRequest(
            url="https://o.example/g", peer_id="p-2", peer_host=v1_host(pkg, 2),
            url_meta=pkg.sv1.V1UrlMeta(tag="t", application="app"),
        ))
        assert result2.task_id == pkg.idgen.task_id_v1(
            "https://o.example/g", tag="t", application="app", filtered_query_params="")
        out += [result, result2]

    _both(case)


def test_piece_stream_drives_state_and_failure_reschedules():
    def case(pkg, out):
        svc = pkg.service()
        v1 = pkg.sv1.SchedulerServiceV1(svc)
        m = pkg.msg
        v1_register(pkg, v1, "parent-1", "t-1", 1)
        svc.handle(m.DownloadPeerBackToSourceStartedRequest(peer_id="parent-1"))
        svc.handle(m.DownloadPeerBackToSourceFinishedRequest(peer_id="parent-1", piece_count=4))
        v1_register(pkg, v1, "child-1", "t-1", 2)
        normal = _normal(pkg, svc.tick())
        assert normal and normal[0].peer_id == "child-1"
        packet = v1.to_peer_packet(normal[0])
        assert packet.main_peer.peer_id == "parent-1" and packet.code == pkg.sv1.CODE_SUCCESS
        begin = v1.report_piece_result(pkg.sv1.V1PieceResult(
            task_id="t-1", src_pid="child-1",
            piece_info=pkg.sv1.V1PieceInfo(piece_num=pkg.sv1.BEGIN_OF_PIECE)))
        assert begin is None
        v1.report_piece_result(pkg.sv1.V1PieceResult(
            task_id="t-1", src_pid="child-1", dst_pid="parent-1", success=True,
            piece_info=pkg.sv1.V1PieceInfo(piece_num=0, range_size=1 << 20, download_cost=12)))
        idx = svc.state.peer_index("child-1")
        svc.flush_piece_reports()
        assert svc.state.peer_finished_count[idx] == 1
        failed = v1.report_piece_result(pkg.sv1.V1PieceResult(
            task_id="t-1", src_pid="child-1", dst_pid="parent-1", success=False,
            piece_info=pkg.sv1.V1PieceInfo(piece_num=1)))
        assert "child-1" in svc._pending
        assert "parent-1" in svc._pending["child-1"].blocklist
        out += [normal, packet, failed, sorted(svc._pending["child-1"].blocklist),
                int(svc.state.peer_finished_count[idx])]
        # the reschedule's answer, as a v1 packet
        out += [v1.to_peer_packet(r) for r in svc.tick()]

    _both(case)


def test_report_peer_result_four_way_dispatch():
    def case(pkg, out):
        svc = pkg.service()
        v1 = pkg.sv1.SchedulerServiceV1(svc)
        PeerState, TaskState = pkg.fsm.PeerState, pkg.fsm.TaskState
        v1_register(pkg, v1, "p-b2s", "t-1", 1)
        svc.handle(pkg.msg.DownloadPeerBackToSourceStartedRequest(peer_id="p-b2s"))
        v1.report_peer_result(pkg.sv1.V1PeerResult(
            task_id="t-1", peer_id="p-b2s", success=True, total_piece_count=3))
        assert svc.state.peer_state[svc.state.peer_index("p-b2s")] == int(PeerState.SUCCEEDED)
        assert svc.state.task_state[svc.state.task_index("t-1")] == int(TaskState.SUCCEEDED)
        v1_register(pkg, v1, "p-ok", "t-1", 2)
        v1.report_peer_result(pkg.sv1.V1PeerResult(task_id="t-1", peer_id="p-ok", success=True))
        assert svc.state.peer_state[svc.state.peer_index("p-ok")] == int(PeerState.SUCCEEDED)
        v1_register(pkg, v1, "p-bad", "t-1", 3)
        v1.report_peer_result(pkg.sv1.V1PeerResult(task_id="t-1", peer_id="p-bad",
                                                    success=False))
        assert svc.state.peer_state[svc.state.peer_index("p-bad")] == int(PeerState.FAILED)
        packet = v1.report_peer_result(pkg.sv1.V1PeerResult(task_id="t-1", peer_id="ghost"))
        assert packet.code == pkg.sv1.CODE_SCHED_PEER_GONE
        out += [packet] + [int(svc.state.peer_state[svc.state.peer_index(p)])
                           for p in ("p-b2s", "p-ok", "p-bad")]

    _both(case)


def test_announce_task_makes_replica_schedulable():
    def case(pkg, out):
        svc = pkg.service()
        v1 = pkg.sv1.SchedulerServiceV1(svc)
        v1.announce_task(pkg.sv1.V1AnnounceTaskRequest(
            task_id="t-c", url="d7y:///cache-key", peer_host=v1_host(pkg, 1),
            peer_id="cache-1", total_piece_count=2, content_length=8 << 20))
        idx = svc.state.peer_index("cache-1")
        assert svc.state.peer_state[idx] == int(pkg.fsm.PeerState.SUCCEEDED)
        stat = v1.stat_task(pkg.msg.StatTaskRequest(task_id="t-c"))
        assert stat.has_available_peer and stat.peer_count == 1
        v1_register(pkg, v1, "child-c", "t-c", 2, url="d7y:///cache-key")
        normal = _normal(pkg, svc.tick())
        assert normal and normal[0].candidate_parents[0].peer_id == "cache-1"
        out += [stat, normal, v1.to_peer_packet(normal[0])]

    _both(case)


def test_leave_task_and_stat_unknown():
    def case(pkg, out):
        svc = pkg.service()
        v1 = pkg.sv1.SchedulerServiceV1(svc)
        v1_register(pkg, v1, "p-1", "t-1", 1)
        v1.leave_task(pkg.sv1.V1PeerTarget(task_id="t-1", peer_id="p-1"))
        assert svc.state.peer_index("p-1") is None
        stat = v1.stat_task(pkg.msg.StatTaskRequest(task_id="nope"))
        assert stat.peer_count == 0 and not stat.has_available_peer
        out += [stat, v1.stat_task(pkg.msg.StatTaskRequest(task_id="t-1"))]

    _both(case)


def test_v1_messages_cross_the_wire_between_packages():
    """Every v1 dataclass the port encodes decodes in the reference to an
    equal message, and back (the Optional main_peer and nested lists
    included)."""
    def samples(pkg):
        s = pkg.sv1
        return [
            s.V1PeerTaskRequest(url="https://e.com/f", peer_id="p", peer_host=v1_host(pkg, 1),
                                url_meta=s.V1UrlMeta(tag="t", priority=3), task_id="t"),
            s.V1RegisterResult(task_id="t", size_scope=2),
            s.V1PieceResult(task_id="t", src_pid="p", dst_pid="q", success=True,
                            piece_info=s.V1PieceInfo(piece_num=7, range_size=512,
                                                     download_cost=9)),
            s.V1PeerPacket(task_id="t", src_pid="p",
                           main_peer=s.V1DestPeer(ip="1.2.3.4", rpc_port=9, peer_id="m"),
                           candidate_peers=[s.V1DestPeer(ip="5.6.7.8", rpc_port=10,
                                                         peer_id="c")]),
            s.V1PeerPacket(task_id="t", src_pid="p", code=s.CODE_SCHED_NEED_BACK_SOURCE),
            s.V1PeerResult(task_id="t", peer_id="p", success=True, traffic=99),
            s.V1PeerTarget(task_id="t", peer_id="p"),
            s.V1AnnounceTaskRequest(task_id="t", url="d7y:///k", peer_host=v1_host(pkg, 2),
                                    peer_id="p", total_piece_count=3, content_length=123),
            s.V1Task(id="t", content_length=5, state="RUNNING", peer_count=2),
        ]

    for mine, theirs in zip(samples(PORT), samples(REF)):
        assert _plain(ref_wire.decode(wire.encode(mine)[4:])) == _plain(theirs)
        assert ref_wire.decode(wire.encode(mine)[4:]) == theirs
        assert wire.decode(ref_wire.encode(theirs)[4:]) == mine


def test_v1_piece_stream_sentinels_and_backsource_pieces():
    def case(pkg, out):
        svc = pkg.service()
        v1 = pkg.sv1.SchedulerServiceV1(svc)
        v1_register(pkg, v1, "p-1", "t-1", 1)
        idx = svc.state.peer_index("p-1")
        before = svc.state.peer_state[idx]
        for sentinel in (pkg.sv1.BEGIN_OF_PIECE, pkg.sv1.END_OF_PIECE):
            assert v1.report_piece_result(pkg.sv1.V1PieceResult(
                task_id="t-1", src_pid="p-1",
                piece_info=pkg.sv1.V1PieceInfo(piece_num=sentinel))) is None
            assert svc.state.peer_state[idx] == before
            assert svc.state.peer_finished_count[idx] == 0
        v1.report_piece_result(pkg.sv1.V1PieceResult(
            task_id="t-1", src_pid="p-1", success=True,
            piece_info=pkg.sv1.V1PieceInfo(piece_num=0, range_size=1 << 20)))
        svc.flush_piece_reports()
        assert svc.state.peer_finished_count[idx] == 1
        out += [int(before), int(svc.state.peer_finished_count[idx])]

    _both(case)


def test_v1_v2_interop_share_one_swarm():
    def case(pkg, out):
        svc = pkg.service()
        v1 = pkg.sv1.SchedulerServiceV1(svc)
        m = pkg.msg
        v1.announce_task(pkg.sv1.V1AnnounceTaskRequest(
            task_id="t-x", url="https://e.com/x", peer_host=v1_host(pkg, 1),
            peer_id="v1-replica", total_piece_count=2, content_length=8 << 20))
        svc.register_peer(m.RegisterPeerRequest(
            peer_id="v2-child", task_id="t-x", host=m.HostInfo(host_id="h-20", ip="10.9.9.1"),
            url="https://e.com/x", content_length=8 << 20))
        first = _normal(pkg, svc.tick())
        assert first and first[0].candidate_parents[0].peer_id == "v1-replica"
        svc.handle(m.DownloadPeerFinishedRequest(peer_id="v2-child"))
        result = v1_register(pkg, v1, "v1-child", "t-x", 3, url="https://e.com/x")
        assert result.size_scope == int(m.SizeScope.NORMAL)
        second = _normal(pkg, svc.tick())
        assert second and second[0].peer_id == "v1-child"
        assert {p.peer_id for p in second[0].candidate_parents} & {"v1-replica", "v2-child"}
        packet = v1.to_peer_packet(second[0])
        assert packet.main_peer is not None and packet.code == pkg.sv1.CODE_SUCCESS
        out += [first, result, second, packet]

    _both(case)


def test_v1_empty_scope_via_v2_known_task():
    def case(pkg, out):
        svc = pkg.service()
        v1 = pkg.sv1.SchedulerServiceV1(svc)
        m = pkg.msg
        svc.register_peer(m.RegisterPeerRequest(
            peer_id="v2-e", task_id="t-e", host=m.HostInfo(host_id="h-30", ip="10.8.8.1"),
            url="https://e.com/empty", content_length=0))
        result = v1_register(pkg, v1, "v1-e", "t-e", 4, url="https://e.com/empty")
        assert result.size_scope in (int(m.SizeScope.NORMAL), int(m.SizeScope.EMPTY))
        out.append(result)

    _both(case)


@pytest.mark.parametrize("into", ["port", "reference"])
def test_v1_dialect_over_the_wire(into):
    """The reference's v1 wire conversation (register, a NeedBackSource
    packet, back-source success, a second peer's packet naming the first),
    sent as the OTHER package's frames into ``into``'s server; the packets
    equal the same conversation's within the server's own package."""
    def conversation(sender, target):
        async def drive():
            svc = target.service()
            srv = target.server.SchedulerRPCServer(svc, tick_interval=0.01)
            host, port = await srv.start()
            s = sender.sv1
            got = []
            try:
                r1, w1 = await asyncio.open_connection(host, port)
                sender.wire.write_frame(w1, s.V1PeerTaskRequest(
                    url="https://o.example/f", peer_id="v1-a", peer_host=v1_host(sender, 1),
                    task_id="t-wire"))
                await w1.drain()
                got.append(await asyncio.wait_for(sender.wire.read_frame(r1), 10))
                got.append(await asyncio.wait_for(sender.wire.read_frame(r1), 10))
                assert got[-1].code == s.CODE_SCHED_NEED_BACK_SOURCE
                sender.wire.write_frame(w1, s.V1PieceResult(
                    task_id="t-wire", src_pid="v1-a", success=True,
                    piece_info=s.V1PieceInfo(piece_num=0, range_size=1 << 20)))
                sender.wire.write_frame(w1, s.V1PeerResult(
                    task_id="t-wire", peer_id="v1-a", success=True, total_piece_count=1))
                await w1.drain()
                succeeded = int(target.fsm.PeerState.SUCCEEDED)
                for _ in range(250):
                    idx = svc.state.peer_index("v1-a")
                    if idx is not None and svc.state.peer_state[idx] == succeeded:
                        break
                    await asyncio.sleep(0.02)
                assert svc.state.peer_state[svc.state.peer_index("v1-a")] == succeeded
                r2, w2 = await asyncio.open_connection(host, port)
                sender.wire.write_frame(w2, s.V1PeerTaskRequest(
                    url="https://o.example/f", peer_id="v1-b", peer_host=v1_host(sender, 2),
                    task_id="t-wire"))
                await w2.drain()
                got.append(await asyncio.wait_for(sender.wire.read_frame(r2), 10))
                got.append(await asyncio.wait_for(sender.wire.read_frame(r2), 10))
                assert got[-1].code == s.CODE_SUCCESS
                assert got[-1].main_peer.peer_id == "v1-a" and got[-1].main_peer.rpc_port == 8003
                w1.close()
                w2.close()
            finally:
                await srv.stop()
            return [_plain(g) for g in got]

        return asyncio.run(drive())

    target = PORT if into == "port" else REF
    sender = REF if into == "port" else PORT
    assert conversation(sender, target) == conversation(target, target)
