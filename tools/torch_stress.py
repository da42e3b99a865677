"""Daemon stress driver on the PyTorch/CUDA port (dragonfly2_tpu_torch).

The port's counterpart of tools/stress.py (the reference's test/tools/stress):
an in-process rig of an origin file server, the port's scheduler on the
card behind its RPC server (tick every 0.01 s), one daemon and its proxy;
one warm fetch puts the task into the mesh, then `--connections` threads
fetch through the proxy for `--duration` seconds. Against an external
proxy, pass --proxy host:port --url http://... to skip the rig.

    python3 tools/torch_stress.py [--connections 16] [--duration 10]
        [--size BYTES] [--device cuda|cpu]

The scheduler runs on the card unless --device cpu is given; without CUDA
the port's SchedulerService raises and nothing falls back. With the rig,
one line gives the scheduler's ticks and their p50 (host clock), so a low
QPS can be traced to the host or to the tick; then one JSON line with the
reference's keys and the device:
  {"metric": "proxy_qps", "value": ..., "p50_ms": ..., "p95_ms": ...,
   "p99_ms": ..., "requests": N, "errors": E, ..., "device": "cuda"}
Exits 1 with no request or with any error.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import pathlib
import statistics
import sys
import tempfile
import threading
import time
import urllib.request

if __name__ == "__main__":  # library imports (tests) already have the repo on sys.path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _fetch_once(proxy_addr: str, url: str) -> float:
    req = urllib.request.Request(url)
    req.set_proxy(proxy_addr, "http")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=30) as resp:
        resp.read()
    return (time.perf_counter() - t0) * 1e3


def _worker(proxy_addr: str, url: str, deadline: float, out: list, errors: list):
    while time.monotonic() < deadline:
        try:
            out.append(_fetch_once(proxy_addr, url))
        except Exception:  # noqa: BLE001 - count, back off, continue
            errors.append(1)
            # an unreachable proxy fails at once: without a pause this loop
            # would spin a core and grow `errors` without bound
            time.sleep(0.2)


class TickClock:
    """Times each of a SchedulerService's ticks (the RPC server calls
    ``tick`` only with peers pending) on the host clock."""

    def __init__(self, svc):
        self.svc, self.ms, self._tick = svc, [], svc.tick
        svc.tick = self._timed

    def _timed(self):
        t0 = time.perf_counter()
        try:
            return self._tick()
        finally:
            self.ms.append((time.perf_counter() - t0) * 1e3)

    def line(self) -> str:
        p50 = f"{statistics.median(self.ms):.3f} ms" if self.ms else "none"
        return (f"scheduler: {len(self.ms)} ticks on {self.svc.device}, tick p50 {p50} "
                "(host clock)")


async def run_inproc(connections: int, duration: float, size: int, device: str = "cuda",
                     workdir: str | None = None) -> tuple[dict, TickClock]:
    """The in-process rig, driven; returns the JSON line's dict and the
    scheduler's tick clock."""
    from dragonfly2_tpu_torch.client.daemon import Daemon
    from dragonfly2_tpu_torch.client.proxy import ProxyRule, ProxyServer
    from dragonfly2_tpu_torch.client.transport import P2PTransport
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
    from dragonfly2_tpu_torch.config.config import Config
    from dragonfly2_tpu_torch.rpc.server import SchedulerRPCServer
    from tools.http_origin import HTTPOrigin

    svc = SchedulerService(config=Config(), device=device)
    clock = TickClock(svc)
    origin = HTTPOrigin({}, default=os.urandom(size))  # the blob at every path
    scratch = tempfile.TemporaryDirectory(prefix="torch-stress-")
    sched = SchedulerRPCServer(svc, tick_interval=0.01)
    shost, sport = await sched.start()
    daemon = proxy = None
    try:
        daemon = Daemon(pathlib.Path(workdir or scratch.name) / "d", [(shost, sport)],
                        hostname="stress-host")
        await daemon.start()
        proxy = ProxyServer(P2PTransport(daemon, rules=[ProxyRule(regex=r".*")]))
        phost, pport = await proxy.start()
        url = f"http://127.0.0.1:{origin.port}/blob.bin"
        # the task into the mesh once, outside the timed window
        await asyncio.to_thread(_fetch_once, f"{phost}:{pport}", url)
        out = await drive(f"{phost}:{pport}", url, connections, duration)
    finally:
        if proxy is not None:
            await proxy.stop()
        if daemon is not None:
            await daemon.stop()
        await sched.stop()
        origin.close()
        scratch.cleanup()
    out["device"] = str(svc.device)
    return out, clock


async def drive(proxy_addr: str, url: str, connections: int, duration: float) -> dict:
    latencies: list = []
    errors: list = []
    deadline = time.monotonic() + duration
    t0 = time.monotonic()
    threads = [threading.Thread(target=_worker, args=(proxy_addr, url, deadline, latencies, errors))
               for _ in range(connections)]
    for t in threads:
        t.start()
    for t in threads:
        await asyncio.to_thread(t.join)
    wall = time.monotonic() - t0
    lat = sorted(latencies)
    return {
        "metric": "proxy_qps",
        "value": round(len(lat) / max(wall, 1e-9), 1),
        "unit": "req/s",
        "p50_ms": round(statistics.median(lat), 2) if lat else None,
        "p95_ms": round(lat[int(0.95 * len(lat))], 2) if lat else None,
        "p99_ms": round(lat[int(0.99 * len(lat))], 2) if lat else None,
        "requests": len(lat),
        "errors": len(errors),
        "connections": connections,
        "duration_s": duration,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--connections", type=int, default=16)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--size", type=int, default=4 << 20, help="in-proc blob size")
    ap.add_argument("--proxy", default=None, help="external proxy host:port")
    ap.add_argument("--url", default=None, help="URL to fetch via --proxy")
    ap.add_argument("--device", default="cuda",
                    help="the scheduler's device (cuda, or cpu for the tests)")
    args = ap.parse_args(argv)
    if args.proxy:
        if not args.url:
            ap.error("--url is required with --proxy")
        result = asyncio.run(drive(args.proxy, args.url, args.connections, args.duration))
        result["device"] = None  # no scheduler of ours behind an external proxy
    else:
        result, clock = asyncio.run(run_inproc(args.connections, args.duration, args.size,
                                               args.device))
        print(clock.line())
    print(json.dumps(result))
    return 0 if result["requests"] and not result["errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
