"""The port's dynconfig loop (utils/dynconfig.py and its observers)
against the reference's tests/test_dynconfig_loop.py.

On the CPU: apply_dynconfig bounds the next tick of the port's scheduler
(fused and unfused); the scheduler polls the port's manager over the RPC
and hot-applies a patched cluster config, and the disk snapshot serves
while the manager is down; a daemon refreshes its scheduler list from the
manager (an inactive scheduler leaves the ring, an all-inactive answer
keeps it), and a daemon with no static list takes its first list from the
manager; the pool swaps its ring atomically. The Dynconfig engine's
expiry, fallback and observers are pinned against the reference's on the
same script.
"""

from __future__ import annotations

import asyncio
import json

import pytest

from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
from dragonfly2_tpu_torch.config.config import Config
from dragonfly2_tpu_torch.manager import rpc as mrpc
from dragonfly2_tpu_torch.manager.models import Database
from dragonfly2_tpu_torch.manager.service import ManagerService
from dragonfly2_tpu_torch.utils import dferrors
from dragonfly2_tpu_torch.utils.dynconfig import Dynconfig


def host(i, seed=False):
    return msg.HostInfo(host_id=f"host-{i}", hostname=f"node-{i}", ip=f"10.0.0.{i}",
                        host_type="super" if seed else "normal")


def register(svc, peer_id, task_id, h, pieces=4):
    return svc.register_peer(msg.RegisterPeerRequest(
        peer_id=peer_id, task_id=task_id, host=h, url="https://e.com/blob",
        content_length=pieces * (4 << 20), total_piece_count=pieces))


def _run_async(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


@pytest.mark.parametrize("fused", [True, False])
def test_apply_dynconfig_changes_the_next_tick(fused):
    """A manager-pushed candidate_parent_limit bounds the very next
    scheduling batch on the CPU: the observer writes the field tick()
    reads live, on the fused tick and the unfused one alike."""
    cfg = Config()
    cfg.scheduler.fused_tick = fused
    svc = SchedulerService(cfg, device="cpu")
    assert (svc._tick_mirror is not None) == fused
    for i in range(4):
        register(svc, f"parent-{i}", "task-1", host(i, seed=i == 0))
        svc.peer_finished(msg.DownloadPeerFinishedRequest(peer_id=f"parent-{i}", piece_count=4))
    svc.tick()
    register(svc, "child-wide", "task-1", host(10))
    wide = [r for r in svc.tick() if isinstance(r, msg.NormalTaskResponse)]
    assert wide and len(wide[0].candidate_parents) > 1

    svc.apply_dynconfig({"scheduler_cluster_config": {"candidate_parent_limit": 1}})
    assert svc.config.scheduler.candidate_parent_limit == 1
    register(svc, "child-narrow", "task-1", host(11))
    narrow = [r for r in svc.tick() if isinstance(r, msg.NormalTaskResponse)]
    assert narrow and len(narrow[0].candidate_parents) == 1

    # hostile payloads are ignored, not applied
    svc.apply_dynconfig({"scheduler_cluster_config": {
        "candidate_parent_limit": 0, "filter_parent_limit": "bogus"}})
    assert svc.config.scheduler.candidate_parent_limit == 1


def test_scheduler_polls_manager_dynconfig_over_rpc(tmp_path):
    """REST-side write on the scheduler cluster -> GetDynconfig RPC ->
    Dynconfig refresh -> the live service config; with the manager down
    the disk snapshot keeps serving the last limits."""

    async def run():
        mgr = ManagerService(Database())
        mgr.create_cluster({"name": "c1"})
        mgr.register_scheduler({"host_name": "sched-1", "ip": "127.0.0.1", "port": 9000,
                                "scheduler_cluster_id": 1})
        server = mrpc.ManagerRPCServer(mgr)
        mhost, mport = await server.start()
        sched = SchedulerService(device="cpu")
        try:
            def fetch():
                async def go():
                    client = await mrpc.ManagerClient(mhost, mport).connect()
                    try:
                        return (await client.call(
                            mrpc.GetDynconfigRequest(scheduler_cluster_id=1))).data
                    finally:
                        await client.close()
                return asyncio.run(go())

            dyn = Dynconfig(fetch, cache_path=tmp_path / "dyn.json", expire=3600.0)
            dyn.register(sched.apply_dynconfig)
            await asyncio.to_thread(dyn.get)
            default_limit = sched.config.scheduler.candidate_parent_limit
            mgr.db.update("scheduler_clusters", 1, {
                "config": {"candidate_parent_limit": 2, "filter_parent_limit": 9}})
            await asyncio.to_thread(dyn.refresh)
            assert sched.config.scheduler.candidate_parent_limit == 2 != default_limit
            assert sched.config.scheduler.filter_parent_limit == 9
            assert json.loads((tmp_path / "dyn.json").read_text())["scheduler_cluster_config"] == {
                "candidate_parent_limit": 2, "filter_parent_limit": 9}

            await server.stop()
            await asyncio.to_thread(dyn.refresh)
            assert sched.config.scheduler.candidate_parent_limit == 2

            # a scheduler restarted while the manager is down starts from
            # the snapshot
            fresh = SchedulerService(device="cpu")
            again = Dynconfig(fetch, cache_path=tmp_path / "dyn.json", expire=3600.0)
            again.register(fresh.apply_dynconfig)
            await asyncio.to_thread(again.get)
            assert fresh.config.scheduler.candidate_parent_limit == 2
        finally:
            await server.stop()

    _run_async(run())


def test_daemon_refreshes_scheduler_list_from_manager(tmp_path):
    async def run():
        from dragonfly2_tpu_torch.client.daemon import Daemon

        mgr = ManagerService(Database())
        mgr.create_cluster({"name": "c1"})
        for name, ip, port in (("s-a", "10.9.0.1", 9001), ("s-b", "10.9.0.2", 9002)):
            mgr.register_scheduler({"host_name": name, "ip": ip, "port": port,
                                    "scheduler_cluster_id": 1, "state": "active"})
        server = mrpc.ManagerRPCServer(mgr)
        mhost, mport = await server.start()
        try:
            daemon = Daemon(data_dir=tmp_path / "daemon",
                            scheduler_addresses=[("10.9.0.1", 9001)],
                            manager_address=(mhost, mport))
            data = await asyncio.to_thread(daemon._fetch_scheduler_list)
            daemon._apply_scheduler_list(data)
            assert set(daemon.pool._addr.values()) == {("10.9.0.1", 9001), ("10.9.0.2", 9002)}
            mgr.db.update("schedulers", 1, {"state": "inactive"})
            daemon._apply_scheduler_list(await asyncio.to_thread(daemon._fetch_scheduler_list))
            assert set(daemon.pool._addr.values()) == {("10.9.0.2", 9002)}
            # an all-inactive answer must not strand the daemon
            mgr.db.update("schedulers", 2, {"state": "inactive"})
            daemon._apply_scheduler_list(await asyncio.to_thread(daemon._fetch_scheduler_list))
            assert set(daemon.pool._addr.values()) == {("10.9.0.2", 9002)}
        finally:
            await server.stop()

    _run_async(run())


def test_daemon_without_a_static_list_takes_the_managers(tmp_path):
    """Daemon(scheduler_addresses=[], manager_address=...) builds its pool
    from the manager's first answer in start(), then keeps refreshing on
    its dynconfig loop; with no active scheduler start() raises."""

    async def run():
        from dragonfly2_tpu_torch.client.daemon import Daemon

        mgr = ManagerService(Database())
        mgr.create_cluster({"name": "c1"})
        server = mrpc.ManagerRPCServer(mgr)
        mhost, mport = await server.start()
        try:
            lonely = Daemon(tmp_path / "lonely", [], hostname="lonely",
                            manager_address=(mhost, mport))
            assert lonely.pool is None
            with pytest.raises(RuntimeError, match="no active scheduler"):
                await lonely.start()
            lonely.upload.stop()
            lonely.gc.stop()

            mgr.register_scheduler({"host_name": "s-a", "ip": "10.9.0.1", "port": 9001,
                                    "scheduler_cluster_id": 1})
            mgr.keepalive("scheduler", "s-a", "10.9.0.1", 1)
            daemon = Daemon(tmp_path / "daemon", [], hostname="d",
                            manager_address=(mhost, mport), dynconfig_interval=1.0)
            await daemon.start()
            try:
                assert set(daemon.pool._addr.values()) == {("10.9.0.1", 9001)}
                mgr.register_scheduler({"host_name": "s-b", "ip": "10.9.0.2", "port": 9002,
                                        "scheduler_cluster_id": 1})
                mgr.keepalive("scheduler", "s-b", "10.9.0.2", 1)
                for _ in range(60):
                    if len(daemon.pool._addr) == 2:
                        break
                    await asyncio.sleep(0.1)
                assert set(daemon.pool._addr.values()) == {
                    ("10.9.0.1", 9001), ("10.9.0.2", 9002)}
                assert (tmp_path / "daemon" / "dynconfig.json").exists()
            finally:
                await daemon.stop(leave=False)
        finally:
            await server.stop()

    _run_async(run())


def test_pool_update_swaps_atomically_and_prunes_connections():
    async def run():
        from dragonfly2_tpu_torch.rpc.client import SchedulerClientPool

        pool = SchedulerClientPool([("10.0.0.1", 1), ("10.0.0.2", 2)])

        class FakeConn:
            closed = False
            is_closed = False

            async def close(self):
                self.closed = True

        a, b = FakeConn(), FakeConn()
        pool._conns["10.0.0.1:1"] = a
        pool._conns["10.0.0.2:2"] = b
        pool.update_addresses([("10.0.0.2", 2), ("10.0.0.3", 3)])
        ring, addr = pool._state
        assert set(addr) == {"10.0.0.2:2", "10.0.0.3:3"}
        assert all(ring.pick(f"t-{i}") in addr for i in range(32))
        assert "10.0.0.1:1" not in pool._conns
        pool.STALE_CLOSE_GRACE_S = 0.0
        tid = next(t for t in (f"t-{i}" for i in range(1000)) if ring.pick(t) == "10.0.0.2:2")
        assert await pool.for_task(tid) is b
        assert a.closed and not b.closed

    _run_async(run())


def _engine_script(dyn_cls, unavailable, tmp_path, clock):
    """One script through either package's Dynconfig: fetches, expiry,
    a failing source with and without a snapshot, observers."""
    answers = [{"v": 1}, {"v": 1}, {"v": 2}, "down", {"v": 3}]
    calls, seen = [], []

    def source():
        calls.append(1)
        answer = answers.pop(0)
        if answer == "down":
            raise ConnectionError("manager down")
        return answer

    with pytest.raises(ValueError):
        dyn_cls(source, tmp_path / "x.json", expire=0)
    dyn = dyn_cls(source, tmp_path / "dyn.json", expire=10.0)
    dyn.register(seen.append)
    out = [dyn.get()]  # fetch 1
    clock[0] += 5
    out.append(dyn.get())  # cached
    clock[0] += 6
    out.append(dyn.get())  # expired: fetch 2, unchanged, no notify
    out.append(dyn.refresh())  # fetch 3: {"v": 2}
    out.append(dyn.refresh())  # down: the snapshot
    out.append(dyn.refresh())  # fetch 5
    empty = dyn_cls(lambda: (_ for _ in ()).throw(OSError("no")), tmp_path / "none.json")
    with pytest.raises(unavailable):
        empty.get()
    return out, seen, len(calls), json.loads((tmp_path / "dyn.json").read_text())


def test_dynconfig_engine_equals_the_reference(tmp_path, monkeypatch):
    import time

    from dragonfly2_tpu.utils import dferrors as ref_dferrors
    from dragonfly2_tpu.utils.dynconfig import Dynconfig as RefDynconfig

    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    got = _engine_script(Dynconfig, dferrors.Unavailable, tmp_path / "port", clock)
    want = _engine_script(RefDynconfig, ref_dferrors.Unavailable, tmp_path / "ref", clock)
    assert got == want
    out, seen, calls, disk = got
    assert out == [{"v": 1}, {"v": 1}, {"v": 1}, {"v": 2}, {"v": 2}, {"v": 3}]
    assert seen == [{"v": 1}, {"v": 2}, {"v": 3}] and calls == 5 and disk == {"v": 3}
