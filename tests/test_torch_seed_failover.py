"""A task's scheduler dies and the scheduler that inherits the task finds
its seed, over 127.0.0.1: two port schedulers, a seed daemon (a super
host, announced to both at start) and three normal daemons, in one event
loop.

The first download of the task triggers the seed on the task's owner,
and the seed ends up holding the task. The owner then stops (its
connections close, as a SIGKILL closes them). The two fan-out downloads
fail over along the hash ring to the other scheduler, which has never
seen the task: its first registration triggers the seed (the only seed
host it knows), which holds the task and re-announces it without moving
a byte (``daemon.py _obtain_seed`` -> ``_announce_completed``). Both
fan-out downloads then come from parents: the origin sees no GET after
the kill.

The schedulers tick every ``TICK_S``: a pending peer is retried once a
tick, so the three retries before a back-to-source take ``3 * TICK_S``,
far longer than a re-announce between two in-process daemons takes.
"""

from __future__ import annotations

import asyncio

import numpy as np

from dragonfly2_tpu_torch.client.daemon import Daemon
from dragonfly2_tpu_torch.rpc import server
from dragonfly2_tpu_torch.utils import idgen
from tests.test_torch_dfdaemon import PIECE, Origin, _service, _sha

TICK_S = 0.25
WAIT_S = 30.0


async def _until(predicate, what: str) -> None:
    for _ in range(int(WAIT_S / 0.02)):
        if predicate():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"{what} within {WAIT_S} s")


def test_the_inheriting_scheduler_triggers_the_seed_that_holds_the_task(tmp_path):
    origin = Origin(np.random.default_rng(6).integers(0, 256, 300_000, dtype=np.uint8).tobytes())

    async def run():
        servers = [server.SchedulerRPCServer(_service("port", tmp_path / f"s{i}"),
                                             tick_interval=TICK_S) for i in range(2)]
        addrs = [await srv.start() for srv in servers]
        seed = Daemon(tmp_path / "seed", addrs, hostname="seed", host_type="super")
        daemons = [Daemon(tmp_path / f"d{i}", addrs, hostname=f"daemon-{i}") for i in range(3)]
        stopped: set = set()
        try:
            await seed.start()
            await _until(lambda: all(srv.service._seed_hosts == [seed.host_id]
                                     for srv in servers), "the seed announced to both")
            for d in daemons:
                await d.start()
            task_id = idgen.task_id_v1(origin.url())
            owner = daemons[0].pool.primary_for_task(task_id)
            victim = next(i for i, a in enumerate(addrs) if f"{a[0]}:{a[1]}" == owner)
            heir = servers[1 - victim].service

            ts = await daemons[0].download(origin.url(), piece_length=PIECE)
            assert _sha(ts) == origin.sha
            await _until(lambda: seed.storage.find_completed_task(task_id) is not None,
                         "the seed to hold the task")
            metrics = seed.metrics
            before = (origin.get_count, metrics.seed_task_reannounce.value(),
                      metrics.seed_peer_download.value())

            await servers[victim].stop()
            stopped.add(victim)
            got = await asyncio.gather(*(d.download(origin.url(), piece_length=PIECE,
                                                    back_source_allowed=False,
                                                    schedule_timeout=WAIT_S)
                                         for d in daemons[1:]))
            assert [_sha(t) for t in got] == [origin.sha] * 2
            assert heir._seed_hosts == [seed.host_id]
            # the heir's trigger reached the seed, which held the task: one
            # re-announce, no seed download, and no origin GET since the kill
            assert metrics.seed_task_reannounce.value() > before[1]
            assert metrics.seed_peer_download.value() == before[2]
            assert origin.get_count == before[0]
        finally:
            for d in [*daemons, seed]:
                await d.stop()
            for i, srv in enumerate(servers):
                if i not in stopped:
                    await srv.stop()

    try:
        asyncio.run(run())
    finally:
        origin.stop()
