"""A scripted peer sequence over the scheduler's wire protocol, played
through either package's SchedulerConnection against either package's
SchedulerRPCServer; imports neither package, so the card's jax-free tests
use it too.

The sequence is the conductor's: hosts announce, the first peer of a task
back-sources, later peers take the parents the tick picked and report
their pieces, one piece fails and is rescheduled, peers finish, stat, leave.
Each registration waits for its answer before the next frame is sent, so
every tick holds one peer. ``play`` returns every answer the scheduler sent,
decoded, as plain data (class name plus fields), in order.
"""

from __future__ import annotations

import asyncio
import dataclasses

PIECE = 4 << 20
PIECES = 3
COST_NS = 7_000_000


def plain(message) -> dict:
    """A decoded message as package-free data: its type name and fields."""
    return {"type": type(message).__name__, **dataclasses.asdict(message)}


async def _answer(queue: asyncio.Queue, timeout: float):
    return await asyncio.wait_for(queue.get(), timeout)


async def play(client, msg, host: str, port: int, timeout: float = 60.0) -> list[dict]:
    """Run the sequence with ``client`` (an rpc.client module) and ``msg``
    (the same package's cluster.messages) against host:port."""
    conn = await client.SchedulerConnection(host, port).connect()
    answers: list[dict] = []
    try:
        hosts = [
            msg.HostInfo(host_id=f"host-{i}", hostname=f"node-{i}", ip=f"10.0.0.{i + 1}",
                         idc="idc-a" if i % 2 else "idc-b", location="eu|fra|rack-1",
                         port=8002, download_port=8001)
            for i in range(6)
        ]
        for h in hosts:
            await conn.send(msg.AnnounceHostRequest(host=h))

        async def register(peer_id: str, task_id: str, host_i: int, length: int = PIECE * PIECES):
            queue = conn.subscribe(peer_id)
            await conn.send(msg.RegisterPeerRequest(
                peer_id=peer_id, task_id=task_id, host=hosts[host_i],
                url=f"https://origin.example/{task_id}", content_length=length,
                piece_length=PIECE, tag="t", application="app"))
            answer = await _answer(queue, timeout)
            answers.append(plain(answer))
            return queue, answer

        async def stat_peer(peer_id: str):
            answers.append(plain(await conn.stat_peer(peer_id, timeout=timeout)))

        async def pieces(peer_id: str, parent: str, numbers):
            for n in numbers:
                await conn.send(msg.DownloadPieceFinishedRequest(
                    peer_id=peer_id, piece_number=n, length=PIECE, cost_ns=COST_NS + n,
                    parent_peer_id=parent))

        # the first peer of a cold task: no parent anywhere, back to source
        _, first = await register("peer-0", "task-a", 0)
        assert type(first).__name__ == "NeedBackToSourceResponse", first
        await conn.send(msg.DownloadPeerBackToSourceStartedRequest(peer_id="peer-0"))
        await pieces("peer-0", "", range(PIECES))
        await conn.send(msg.DownloadPeerBackToSourceFinishedRequest(
            peer_id="peer-0", content_length=PIECE * PIECES, piece_count=PIECES))
        await stat_peer("peer-0")

        # later peers take the tick's parents and report pieces from them
        for i in (1, 2):
            _, answer = await register(f"peer-{i}", "task-a", i)
            parent = answer.candidate_parents[0].peer_id
            await pieces(f"peer-{i}", parent, range(PIECES))
            await conn.send(msg.DownloadPeerFinishedRequest(
                peer_id=f"peer-{i}", content_length=PIECE * PIECES, piece_count=PIECES))
            await stat_peer(f"peer-{i}")

        # a failed piece blocklists its parent and reschedules the peer
        queue, answer = await register("peer-3", "task-a", 3)
        failed = answer.candidate_parents[0].peer_id
        await pieces("peer-3", failed, [0])
        await conn.send(msg.DownloadPieceFailedRequest(peer_id="peer-3", parent_peer_id=failed))
        answers.append(plain(await _answer(queue, timeout)))
        await stat_peer("peer-3")

        # an empty task answers at register, without a tick
        await register("peer-4", "task-empty", 4, length=0)

        # stat, leave, stat again
        answers.append(plain(await conn.stat_task("task-a", timeout=timeout)))
        await conn.send(msg.LeavePeerRequest(peer_id="peer-3"))
        await stat_peer("peer-3")
        await conn.send(msg.LeaveHostRequest(host_id="host-5"))
        await stat_peer("peer-2")
        return answers
    finally:
        await conn.close()
