"""LLM weight-shard P2P prefetch on the PyTorch/CUDA port (dragonfly2_tpu_torch).

The port's counterpart of tools/llm_prefetch.py (BASELINE.json configs[4]):
a fleet of inference hosts cold-starts one sharded checkpoint (Llama-3-70B
ships as 30 safetensors shards of ~4.6 GiB). One seed daemon fetches each
shard from the model store; then every host prefetches every shard with
back-to-source refused, its pieces from the parents the port's scheduler
picks on the card, and each shard's sha256 is checked on every host.

The rig is in-process over localhost sockets: a synthetic shard repo over
HTTP (tools/http_origin.py), the scheduler behind its RPC server, the seed
and N daemons. Shard count and size are cut by default and go up to the
real layout by flag. One line gives the scheduler's ticks and their p50
(host clock), then one JSON line with the reference's keys and the device:

    {"metric": "llm_prefetch_origin_offload_pct", "value": ...,
     "fleet_offload_pct": ..., "shards": S, "hosts": N, "bytes_total": ...,
     "origin_bytes": ..., "p2p_bytes": ..., "fleet_wall_s": ...,
     "aggregate_mib_s": ..., "algorithm": ..., "device": "cuda"}

origin offload = the share of delivered bytes that did not come from the
model store; fleet_offload_pct leaves the seed's one origin pass out of
both sides.

    python3 tools/torch_llm_prefetch.py [--shards 8] [--shard-mib 4]
        [--hosts 6] [--piece-kib 1024] [--device cuda|cpu]

The scheduler runs on the card unless --device cpu is given; without CUDA
the port's SchedulerService raises and nothing falls back.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import hashlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.torch_stress import TickClock  # noqa: E402


class ShardRepo:
    """In-process model store: /model/model-{i:05d}-of-{S:05d}.safetensors
    served by the shared Range-correct origin (tools/http_origin.py)."""

    def __init__(self, shards: int, shard_bytes: int, seed: int = 0):
        from tools.http_origin import HTTPOrigin

        self.shards = shards
        self.payloads = {}
        rng_state = hashlib.sha256(str(seed).encode()).digest()
        for i in range(shards):
            # deterministic pseudo-random bytes, cheap to regenerate
            block = hashlib.sha256(rng_state + str(i).encode()).digest()
            reps = shard_bytes // len(block) + 1
            self.payloads[self._name(i)] = (block * reps)[:shard_bytes]
        self._shas = [hashlib.sha256(self.payloads[self._name(i)]).hexdigest()
                      for i in range(shards)]
        self._origin = HTTPOrigin(
            {f"/model/{name}": data for name, data in self.payloads.items()})
        self.port = self._origin.port

    @property
    def gets(self) -> int:
        return self._origin.gets

    @property
    def bytes_served(self) -> int:
        return self._origin.bytes_served

    def _name(self, i: int) -> str:
        return f"model-{i + 1:05d}-of-{self.shards:05d}.safetensors"

    def url(self, i: int) -> str:
        return f"http://127.0.0.1:{self.port}/model/{self._name(i)}"

    def sha(self, i: int) -> str:
        return self._shas[i]

    def close(self):
        self._origin.close()


async def run(shards: int, shard_bytes: int, hosts: int, piece_length: int, workdir: str,
              device: str = "cuda") -> tuple[dict, TickClock]:
    """The rig, driven; returns the JSON line's dict and the scheduler's
    tick clock."""
    from dragonfly2_tpu_torch.client.daemon import Daemon
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
    from dragonfly2_tpu_torch.config.config import Config
    from dragonfly2_tpu_torch.rpc.server import SchedulerRPCServer

    cfg = Config()
    cfg.scheduler.max_hosts = max(64, 2 * hosts)
    cfg.scheduler.max_tasks = max(64, 2 * shards)
    svc = SchedulerService(config=cfg, device=device)
    clock = TickClock(svc)
    repo = ShardRepo(shards, shard_bytes)
    server = SchedulerRPCServer(svc, tick_interval=0.005)
    daemons = []
    try:
        host, port = await server.start()
        # the seed host prefetches first (the reference's preheat step): one
        # origin fetch a shard, the fleet rides P2P afterwards
        seed = Daemon(f"{workdir}/seed", [(host, port)], hostname="seed-host")
        await seed.start()
        daemons.append(seed)
        t0 = time.perf_counter()
        for i in range(shards):
            await seed.download(repo.url(i), piece_length=piece_length)
        seed_wall = time.perf_counter() - t0

        fleet = []
        for n in range(hosts):
            d = Daemon(f"{workdir}/h{n}", [(host, port)], hostname=f"infer-{n}")
            await d.start()
            daemons.append(d)
            fleet.append(d)

        t0 = time.perf_counter()

        async def prefetch(d):
            # demand order: a host's shards in index order (the loader maps
            # them in turn), the hosts racing one another
            for i in range(shards):
                ts = await d.download(repo.url(i), piece_length=piece_length,
                                      back_source_allowed=False)
                with open(ts.data_path, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                if digest != repo.sha(i):
                    raise AssertionError(f"shard {i} corrupt on {d.hostname}")

        await asyncio.gather(*(prefetch(d) for d in fleet))
        fleet_wall = time.perf_counter() - t0

        total_delivered = shard_bytes * shards * (hosts + 1)
        origin_bytes = repo.bytes_served
        p2p_bytes = total_delivered - origin_bytes
        offload = 100.0 * p2p_bytes / total_delivered
        # of the fleet's bytes (the seed's one origin pass out of both
        # sides), the share that rode the mesh
        fleet_bytes = shard_bytes * shards * hosts
        fleet_origin = max(origin_bytes - shard_bytes * shards, 0)
        fleet_offload = 100.0 * (fleet_bytes - fleet_origin) / max(fleet_bytes, 1)
        result = {
            "metric": "llm_prefetch_origin_offload_pct",
            "value": round(offload, 2),
            "fleet_offload_pct": round(fleet_offload, 2),
            "unit": "%",
            "shards": shards,
            "shard_mib": round(shard_bytes / (1 << 20), 2),
            "hosts": hosts,
            "bytes_total": total_delivered,
            "origin_bytes": origin_bytes,
            "p2p_bytes": p2p_bytes,
            "seed_wall_s": round(seed_wall, 2),
            "fleet_wall_s": round(fleet_wall, 2),
            "aggregate_mib_s": round(
                shard_bytes * shards * hosts / (1 << 20) / max(fleet_wall, 1e-9), 1),
            "algorithm": svc.algorithm,
            "device": str(svc.device),
        }
        return result, clock
    finally:
        # one failing stop must not leak the rest of the rig
        for d in daemons:
            with contextlib.suppress(Exception):
                await d.stop()
        with contextlib.suppress(Exception):
            await server.stop()
        repo.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--shard-mib", type=float, default=4.0)
    ap.add_argument("--hosts", type=int, default=6)
    ap.add_argument("--piece-kib", type=int, default=1024)
    ap.add_argument("--workdir", default=None,
                    help="the daemons' storage, kept (default: a temporary directory, removed)")
    ap.add_argument("--device", default="cuda",
                    help="the scheduler's device (cuda, or cpu for the tests)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="torch-llm-prefetch-") as scratch:
        result, clock = asyncio.run(run(args.shards, int(args.shard_mib * (1 << 20)), args.hosts,
                                        args.piece_kib << 10, args.workdir or scratch,
                                        args.device))
    print(clock.line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
