"""Port of dragonfly2_tpu/procworld/planet.py: ``run_procday`` (with
``device``: the schedulers' device, the card unless asked for the CPU)
and ``real_facts``. Beside the reference's processes the day starts the
spec's seed daemons, and its run records each kill round (``kill_log``).

The compressed scenario day driven through REAL processes.

``run_procday`` is the process planet's answer to
``megascale.soak.run_megascale``: the same ScenarioSpec, the same kill
schedule (``ScenarioEngine.crash_rounds``), the same rolling-upgrade
window arithmetic — but the scheduler that dies is a SIGKILLed child
process, the restarted daemon reloads pieces from a real disk, and
every download rides the real client path (an absolute-URI GET through
a dfdaemon's forward proxy, hijacked into the P2P mesh by
``--proxy-rule``, answered with the ``X-Dragonfly-Via: p2p`` header and
byte-verified against the origin payload's digest).

Each round reduces to a ``RoundObservation``; ``synthesize_timeline``
turns the observation list into the exact megascale timeline schema fed
through the exact SLO plumbing, so the resulting artifact replays
through ``tools/dfslo.py`` UNCHANGED — one verdict plane for the
simulator and the planet, which is what makes the divergence report
(``procworld/divergence.py``) a like-for-like comparison.

Wall clocks are legitimate here (real sockets take real time); the
replay-facing modules (sample.py, divergence.py) are the DET domain.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import time
import types
import urllib.request

from dragonfly2_tpu_torch.procworld.origin import OriginServer
from dragonfly2_tpu_torch.procworld.sample import (
    RoundObservation,
    announce_page_rounds,
    synthesize_timeline,
)
from dragonfly2_tpu_torch.procworld.supervisor import ProcessPlanet

DOWNLOAD_TIMEOUT_S = 60.0
DOWNLOAD_RETRIES = 3
KILL_SETTLE_S = 0.25  # a kill lands once no download has ended for this long
KILL_WAIT_S = 10.0  # the longest a kill waits for the fan-out to settle


def _scrape(port: int | str, timeout: float = 5.0) -> dict:
    """Sum a /metrics exposition by family name — label-blind totals are
    all the round accounting needs (pieces moved, failovers, reannounces
    since the last scrape)."""
    totals: dict = {}
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=timeout
        ) as resp:
            text = resp.read().decode("utf-8", "replace")
    except OSError:
        return totals
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        family = name_part.split("{", 1)[0].strip()
        try:
            totals[family] = totals.get(family, 0.0) + float(value_part)
        except ValueError:
            continue
    return totals


def _daemon_totals(planet: ProcessPlanet, banked: dict | None = None) -> dict:
    """Family totals summed across every live daemon's metrics port, plus
    ``banked``: what daemons restarted earlier in the day had counted."""
    out: dict = dict(banked or {})
    for proc in planet.daemons():
        if not proc.alive():
            continue
        mport = proc.ports.get("METRICS")
        if not mport:
            continue
        for family, value in sorted(_scrape(mport).items()):
            out[family] = out.get(family, 0.0) + value
    return out


def _restart_daemon(planet: ProcessPlanet, name: str, banked: dict) -> None:
    """Restart one daemon, banking its counters first: a restarted
    process counts from zero, and the day's totals (the failovers a kill
    caused, among them) must not lose what it had counted. The reference
    restarts without banking, so a daemon that failed over at a kill and
    restarts in a later round's wave drops its failovers from the day's
    total."""
    proc = planet.procs[name]
    mport = proc.ports.get("METRICS")
    if proc.alive() and mport:
        for family, value in sorted(_scrape(mport).items()):
            banked[family] = banked.get(family, 0.0) + value
    planet.restart(name)


def _registrations(proc) -> float:
    """The peer registrations a scheduler process has answered (its
    /metrics), 0 when it serves no metrics."""
    mport = proc.ports.get("METRICS")
    if not mport:
        return 0.0
    return _scrape(mport).get("dragonfly_scheduler_register_peer_total", 0.0)


def _pick_victim(schedulers: list, before: dict, preferred: int) -> str:
    """The scheduler a kill takes: the round-robin one (``preferred``,
    the reference's choice) when the round's seeders registered there,
    else the next in that order that registered one. ``before`` holds
    each scheduler's registrations ahead of the seeder wave. A scheduler
    that owns none of the round's tasks carries none of its fan-out, and
    killing it shows no failover; the reference kills it all the same."""
    n = len(schedulers)
    order = [schedulers[(preferred + i) % n] for i in range(n)]
    for proc in order:
        if proc.alive() and _registrations(proc) > before.get(proc.name, 0.0):
            return proc.name
    return order[0].name


def _await_settled(futures: list, settle: float = KILL_SETTLE_S,
                   timeout: float = KILL_WAIT_S) -> None:
    """Hold a kill until the fan-out has settled: no download ended for
    ``settle`` seconds (and ``settle`` has passed since the fan-out
    began), every download is done, or ``timeout``. The victim is
    paused meanwhile, so the downloads it serves wait on it and the rest
    run to their end."""
    deadline = time.monotonic() + timeout
    pending = sum(1 for f in futures if not f.done())
    since = time.monotonic()
    while pending and time.monotonic() < deadline:
        time.sleep(0.01)
        now = sum(1 for f in futures if not f.done())
        if now != pending:
            pending, since = now, time.monotonic()
        elif time.monotonic() - since >= settle:
            return


def _fetch_via_proxy(url: str, proxy_port: int,
                     timeout: float = DOWNLOAD_TIMEOUT_S):
    """One real-client download: absolute-URI GET through the daemon's
    forward proxy; the --proxy-rule hijack serves it from the P2P mesh.
    Returns (sha256_hexdigest, via_header, elapsed_ms)."""
    req = urllib.request.Request(url)
    req.set_proxy(f"127.0.0.1:{proxy_port}", "http")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read()
        via = resp.headers.get("X-Dragonfly-Via", "")
    elapsed_ms = (time.perf_counter() - t0) * 1000.0
    return hashlib.sha256(body).hexdigest(), via, elapsed_ms


def run_procday(workdir, *, scenario: str = "procday", seed: int = 7,
                schedulers: int = 2, daemons: int = 3,
                rounds: int | None = None, tasks_per_round: int = 4,
                payload_bytes: int | None = None,
                with_manager: bool = True, registry=None,
                device=None) -> dict:
    """Drive the compressed day through a real process topology and
    return the artifact run dict (timeline + slo + planet accounting).

    The chaos schedule is the SCENARIO's, not the harness's: kill rounds
    from ``ScenarioEngine.crash_rounds``, rolling-restart cohorts from
    ``upgrade_window``, SIGSTOP partitions from ``partitioned_hosts`` —
    the same (spec, seed) arithmetic the simulator replays, which is
    what lets the divergence report line the two days up round by round.

    The schedulers run on ``device`` (``--device``): None is the card
    (``device.resolve_device``), and raises here, before any process
    starts, where there is none; nothing falls back to the CPU.
    """
    from dragonfly2_tpu_torch.device import resolve_device
    from dragonfly2_tpu_torch.scenarios.engine import ScenarioEngine
    from dragonfly2_tpu_torch.scenarios.spec import resolve_scenario

    device = resolve_device(device)

    spec = resolve_scenario(scenario)
    day = spec.traffic.day_rounds or 12
    rounds = int(rounds or day)
    minutes_per_round = 24.0 * 60.0 / day
    regions = [f"region-{i}" for i in range(max(spec.wan.regions, 1))]
    if payload_bytes is None:
        # two default-length pieces plus a ragged tail byte: multi-piece
        # transfers (range requests, per-piece digests) without swamping
        # loopback — and the same order of magnitude as the sim's
        # synthetic task sizes, which the divergence band relies on
        payload_bytes = 2 * (4 << 20) + 1

    payload = os.urandom(payload_bytes)
    digest = hashlib.sha256(payload).hexdigest()
    # default piece length on the proxy-driven download path
    # (client/daemon.py download(piece_length=4<<20))
    pieces_per_payload = -(-payload_bytes // (4 << 20))
    origin = OriginServer(payload)

    wall_start = time.perf_counter()
    planet = ProcessPlanet(workdir, registry=registry, device=device.type)
    try:
        manager_addr = ""
        if with_manager:
            mgr = planet.spawn_manager("manager")
            manager_addr = f"{mgr.host}:{mgr.ports.get('RPC', mgr.port)}"
        for i in range(schedulers):
            planet.spawn_scheduler(
                f"scheduler-{i}", manager=manager_addr,
                extra=("--hostname", f"proc-sched-{i}"),
            )
        sched_addrs = planet.scheduler_addresses()
        daemon_region: dict = {}
        for i in range(daemons):
            region = regions[i % len(regions)]
            name = f"daemon-{i}"
            daemon_region[name] = region
            planet.spawn_daemon(
                name, sched_addrs, location=f"{region}|z0|r{i}",
                scenario=scenario, scenario_seed=seed,
            )
        # The spec's seed peers (WanSpec.seeds_per_region in each
        # region), as the simulator places them (megascale/topology.py):
        # super hosts that announce to every scheduler of their list at
        # start. A task's first peer triggers one, so a scheduler that
        # inherits a task at a kill triggers a seed too, which downloads
        # the task or, holding it, re-announces it (client/daemon.py
        # _obtain_seed) instead of the fan-out going to the origin. They
        # take no part in the rounds' downloads, and carry no fault
        # injector: FlakySpec.parent_fraction (0.25) is the flaky share
        # of parents, which the three injected daemons already exceed.
        seeds = []
        for i, region in enumerate(regions):
            for j in range(spec.wan.seeds_per_region):
                name = f"seed-{i * spec.wan.seeds_per_region + j}"
                planet.spawn_daemon(
                    name, sched_addrs, location=f"{region}|z0|s{j}",
                    host_type="super",
                )
                seeds.append(name)

        # the scenario's deterministic chaos schedule, sampled over the
        # REAL host population (the daemons)
        hosts = [
            types.SimpleNamespace(id=n, idc="", location=f"{r}|z0|r0")
            for n, r in sorted(daemon_region.items())
        ]
        engine = ScenarioEngine(spec, hosts, seed=seed)
        kill_rounds = [r for r in engine.crash_rounds(rounds) if r <= rounds]

        observations: list[RoundObservation] = []
        prev_origin_bytes = origin.bytes_sent
        lost = retries = via_p2p = 0
        upgrade_restarted: set = set()
        banked: dict = {}  # counters of daemons restarted earlier in the day
        paused: set = set()
        kill_counter = 0
        kill_log: list = []

        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(daemons * tasks_per_round, 4)
        )
        try:
            for r in range(1, rounds + 1):
                # -- partitions from the previous round heal first
                for name in sorted(paused):
                    planet.resume(name)
                paused.clear()

                # -- rolling-upgrade wave: restart this round's cohort
                window = engine.upgrade_window(r)
                if window is not None:
                    lo, hi = window
                    for i, proc in enumerate(
                            p for p in planet.daemons() if p.name in daemon_region):
                        frac = i / max(daemons, 1)
                        if lo <= frac < hi and (proc.name, r) not in \
                                upgrade_restarted:
                            _restart_daemon(planet, proc.name, banked)
                            upgrade_restarted.add((proc.name, r))

                # -- issue the round's downloads through every live,
                # un-partitioned daemon's proxy. Two waves per task
                # (fresh task per round+k): a rotating SEEDER daemon
                # back-sources it first, then the rest fan out and ride
                # P2P off the seeder — the swarm shape the simulator
                # models, at M=3 scale
                active = [p for p in planet.daemons()
                          if p.name in daemon_region and p.alive()
                          and p.name not in paused]
                scheds = [planet.procs[f"scheduler-{i}"]
                          for i in range(schedulers)]
                if r in kill_rounds:
                    seeded = {p.name: _registrations(p) for p in scheds}
                futures = []
                fanout = []
                for k in range(tasks_per_round):
                    url = origin.url(f"r{r}-t{k}.bin")
                    seeder = active[(r + k) % len(active)]
                    futures.append((
                        seeder.name, url,
                        pool.submit(_fetch_via_proxy, url,
                                    int(seeder.ports["PROXY"])),
                    ))
                    fanout.extend(
                        (p.name, url) for p in active if p is not seeder
                    )
                # seeders finish before the fan-out starts, so the
                # fan-out's parents actually hold announced pieces
                for _, _, fut in futures:
                    try:
                        fut.result(timeout=DOWNLOAD_TIMEOUT_S)
                    except Exception:
                        pass
                # the victim answers nothing from here to the kill, so
                # the fan-out downloads it serves are waiting on it when
                # it dies: each must fail over. Killed unpaused, as the
                # reference does, a victim whose downloads had their
                # schedule already finishes them over P2P without it
                # (their last reports lost in the dead stream), and the
                # kill shows no failover
                victim = ""
                if r in kill_rounds:
                    victim = _pick_victim(scheds, seeded,
                                          kill_counter % schedulers)
                    planet.pause(victim)
                futures.extend(
                    (name, url,
                     pool.submit(_fetch_via_proxy, url,
                                 int(planet.procs[name].ports["PROXY"])))
                    for name, url in fanout
                )

                # -- the kill lands while the fan-out is in flight
                crashed = 0
                backlog = 0
                if r in kill_rounds:
                    _await_settled([f for _, _, f in futures])
                    backlog = sum(1 for _, _, f in futures if not f.done())
                    before_kill = _daemon_totals(planet)
                    kill_counter += 1
                    planet.kill(victim)
                    crashed = 1

                completed = 0
                ttc_ms: dict = {rg: [] for rg in regions}
                for name, url, fut in futures:
                    ok = False
                    for attempt in range(DOWNLOAD_RETRIES + 1):
                        try:
                            if attempt == 0:
                                got, via, ms = fut.result(
                                    timeout=DOWNLOAD_TIMEOUT_S)
                            else:
                                retries += 1
                                proc = planet.procs[name]
                                got, via, ms = _fetch_via_proxy(
                                    url, int(proc.ports["PROXY"]))
                            if got == digest:
                                ok = True
                                break
                        except Exception:
                            continue
                    if ok:
                        completed += 1
                        if via == "p2p":
                            via_p2p += 1
                        ttc_ms[daemon_region[name]].append(round(ms, 2))
                    else:
                        lost += 1

                if crashed:
                    # what the scheduler that inherited the victim's tasks
                    # made of them, from the kill to the round's end: the
                    # seed triggers it sent (only a seed host gets one; it
                    # downloads the task or, holding it, re-announces it),
                    # the failovers, and the origin copies the round
                    # fetched beyond its seeders' (b)
                    after_kill = _daemon_totals(planet)

                    def delta(family):
                        return int(after_kill.get(family, 0.0) - before_kill.get(family, 0.0))

                    kill_log.append({
                        "round": r,
                        "victim": victim,
                        "backlog": backlog,
                        "b": max(round((origin.bytes_sent - prev_origin_bytes)
                                       / payload_bytes) - tasks_per_round, 0),
                        "failovers": delta("dragonfly_dfdaemon_scheduler_failover_total"),
                        "seed_downloads": delta("dragonfly_dfdaemon_seed_peer_download_total"),
                        "reannounces": delta("dragonfly_dfdaemon_seed_task_reannounce_total"),
                    })

                # -- recovery: the killed scheduler returns on its
                # pinned port before the next round (daemons redial it)
                if crashed:
                    planet.restart(victim)

                # -- SIGSTOP partitions for the inter-round gap: the
                # announce/keepalive plane blackholes, the data plane is
                # idle (no new task routes through a paused daemon)
                for name in sorted(engine.partitioned_hosts(r)):
                    if name in planet.procs and planet.procs[name].alive():
                        planet.pause(name)
                        paused.add(name)

                planet.liveness_sweep(timeout=0.5)

                # -- reduce the round to megascale-schema facts. Piece
                # volume is harness-computed (completions x pieces per
                # payload): the daemon's piece_task counter mixes probe
                # and retry fetches in ways that differ per code path,
                # while the payload's piece count is exact — and the
                # origin's body bytes bound the back-to-source share of
                # that volume (origin_pieces)
                pieces = completed * pieces_per_payload
                sent = origin.bytes_sent
                origin_pieces = min(origin_pieces_of(
                    sent - prev_origin_bytes, payload_bytes, pieces_per_payload), pieces)
                prev_origin_bytes = sent
                observations.append(RoundObservation(
                    round_idx=r,
                    completed=completed,
                    pieces=pieces,
                    origin_pieces=origin_pieces,
                    reannounce_backlog=backlog,
                    scheduler_crash=crashed,
                    ttc_ms=ttc_ms,
                ))
        finally:
            # wait=True: the round loop already drained every future on
            # the happy path, and the tests' resource-leak guard treats
            # an unjoined worker thread as a finding
            pool.shutdown(wait=True, cancel_futures=True)
            for name in sorted(paused):
                planet.resume(name)

        timeline, slo_block = synthesize_timeline(
            observations, minutes_per_round=minutes_per_round,
            regions=regions,
        )
        wall_s = time.perf_counter() - wall_start

        totals = _daemon_totals(planet, banked)
        failovers = int(totals.get(
            "dragonfly_dfdaemon_scheduler_failover_total", 0))
        reannounces = int(totals.get(
            "dragonfly_dfdaemon_seed_task_reannounce_total", 0))
        topology = planet.describe()
    finally:
        exit_codes = planet.stop_all()
        origin.close()

    total_completed = sum(o.completed for o in observations)
    total_pieces = sum(o.pieces for o in observations)
    total_origin = sum(o.origin_pieces for o in observations)
    pooled: dict = {rg: [] for rg in regions}
    for o in observations:
        for rg in regions:
            pooled[rg].extend(o.ttc_ms.get(rg, []))
    from dragonfly2_tpu_torch.procworld.sample import quantile

    run = {
        "scenario": scenario,
        "seed": seed,
        "hosts": daemons,
        "seeds": len(seeds),
        "schedulers": schedulers,
        "rounds": rounds,
        "minutes_per_round": minutes_per_round,
        "timeline": timeline,
        "slo": slo_block,
        "stats": {
            "completed": total_completed,
            "pieces": total_pieces,
            "origin_pieces": total_origin,
            "lost_downloads": lost,
            "retries": retries,
            "via_p2p": via_p2p,
            "kills": len(kill_rounds),
            "failovers": failovers,
            "reannounces": reannounces,
            "restarts": sum(topology["restarts"].values()),
            "escalations": topology["stop_escalations"],
        },
        "timing": {
            "wall_s": round(wall_s, 2),
            "downloads_per_sec": round(
                total_completed / max(wall_s, 1e-9), 2),
        },
        "kill_rounds": [float(r) for r in kill_rounds],
        "kill_log": kill_log,
        "page_rounds": announce_page_rounds(timeline, slo_block),
        "proc": {**topology, "exit_codes": exit_codes},
        "ttc_ms_p95": {rg: quantile(pooled[rg], 0.95) for rg in regions},
        "origin_fraction": round(
            total_origin / total_pieces, 6) if total_pieces else 0.0,
    }
    return run


def origin_pieces_of(nbytes: int, payload_bytes: int, pieces_per_payload: int) -> int:
    """The pieces that ``nbytes`` of origin body bytes make: whole payload
    copies times its pieces, as the simulator accounts its origin share
    in bytes. The reference counts the origin's GETs instead, and so
    counts each back-to-source's 1-byte ``Range: bytes=0-0`` probe
    (client/source.py supports_range) as a piece: 4 origin pieces for a
    3-piece payload, which put a 3-daemon day's origin share at the
    origin_offload SLO's ticket threshold."""
    return round(nbytes * pieces_per_payload / payload_bytes)


def real_facts(run: dict) -> dict:
    """Reduce a planet run to the fact sheet
    ``divergence.compute_divergence`` compares against the simulator."""
    st = run.get("stats", {})
    return {
        "scenario": run.get("scenario"),
        "seed": run.get("seed"),
        "ttc_ms_p95": dict(run.get("ttc_ms_p95", {})),
        "origin_fraction": run.get("origin_fraction", 0.0),
        "pieces": st.get("pieces", 0),
        "completed": st.get("completed", 0),
        "lost_downloads": st.get("lost_downloads", 0),
        "kills": st.get("kills", 0),
        "failovers": st.get("failovers", 0),
        "kill_rounds": list(run.get("kill_rounds", [])),
        "slo": run.get("slo", {}),
    }
