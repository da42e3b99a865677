"""The port's real-process planet (dragonfly2_tpu_torch/procworld) on the
CPU, against the reference's.

- the supervisor: the origin's surface, READY parsing, the
  SIGTERM -> SIGKILL ladder, SIGSTOP/SIGCONT, the schedulers' ``--device``
  from the planet's device;
- the pure functions, against the reference's on the same inputs:
  ``sample.py`` (``quantile``, ``build_sample``, ``synthesize_timeline``,
  ``announce_page_rounds``), ``divergence.py``, and the SLO plane the
  samples feed (``feed_megascale_sample``, ``replay_timeline``,
  ``slo_report``) over one reference-made timeline (the ``procday`` day
  of tools/dfproc.py's simulator leg: 300 hosts, 24 tasks, 16 arrivals);
- the planet day at the reference's tier-1 size (6 rounds, 2 schedulers
  on the CPU, 3 dfdaemons, a manager), within the reference's own 420 s
  bound, its run judged by the unchanged tools/dfslo.judge.
"""

from __future__ import annotations

import copy
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest

from dragonfly2_tpu.megascale import soak as ref_soak
from dragonfly2_tpu.procworld import divergence as ref_divergence
from dragonfly2_tpu.procworld import sample as ref_sample
from dragonfly2_tpu.telemetry import slo as ref_slo
from dragonfly2_tpu_torch.megascale import soak as port_soak
from dragonfly2_tpu_torch.procworld import divergence, sample
from dragonfly2_tpu_torch.telemetry import slo

SIM_KW = dict(num_hosts=300, num_tasks=24, seed=7, rounds=12, arrivals_per_round=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's replays: they are many small
    ops, and the suite runs several workers on the machine's cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# ------------------------------------------------------------- origin


def test_origin_server_superset_surface():
    import urllib.request

    from dragonfly2_tpu_torch.procworld import OriginServer

    payload = bytes(range(256)) * 64
    origin = OriginServer(payload)
    try:
        assert origin.srv is origin._server
        url = origin.url("blob.bin")
        with urllib.request.urlopen(urllib.request.Request(url, method="HEAD"),
                                    timeout=5) as resp:
            assert int(resp.headers["Content-Length"]) == len(payload)
        assert origin.gets == 0  # HEAD is not a GET
        with urllib.request.urlopen(url, timeout=5) as resp:
            assert resp.read() == payload
        ranged = urllib.request.Request(url, headers={"Range": "bytes=256-511"})
        with urllib.request.urlopen(ranged, timeout=5) as resp:
            assert resp.status == 206 and resp.read() == payload[256:512]
        assert origin.gets == 2 and origin.get_count == 2
    finally:
        origin.stop()


# --------------------------------------------------------- supervisor


def _python_child(script: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-u", "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_managed_proc_parses_ready_ports_and_stops_clean():
    from dragonfly2_tpu_torch.procworld import ManagedProc

    popen = _python_child("import time\n"
                          "print('READY 127.0.0.1 1234 PROXY 77 METRICS 88', flush=True)\n"
                          "time.sleep(60)\n")
    proc = ManagedProc(["fake"], popen, None, name="fake")
    proc.wait_ready(20)
    assert (proc.host, proc.port) == ("127.0.0.1", 1234)
    assert proc.ports == {"PROXY": 77, "METRICS": 88}
    assert proc.stop(grace=10) == -signal.SIGTERM
    assert not proc.alive() and proc.escalations == 0


def test_stop_escalation_ladder_sigkills_stubborn_child():
    from dragonfly2_tpu_torch.procworld import ManagedProc, stop_proc

    popen = _python_child("import signal, time\n"
                          "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
                          "print('READY 127.0.0.1 1 ', flush=True)\n"
                          "time.sleep(120)\n")
    proc = ManagedProc(["stubborn"], popen, None, name="stubborn")
    proc.wait_ready(20)
    t0 = time.monotonic()
    stop_proc(proc, grace=0.5)
    assert time.monotonic() - t0 < 10, "the ladder must stay bounded"
    assert not proc.alive() and proc.escalations == 1
    assert proc.returncode == -signal.SIGKILL


def test_pause_resume_freezes_and_thaws_child():
    from dragonfly2_tpu_torch.procworld import ManagedProc, wait_for

    popen = _python_child("import time\nprint('READY 127.0.0.1 1 ', flush=True)\n"
                          "time.sleep(60)\n")
    proc = ManagedProc(["pausy"], popen, None, name="pausy")
    proc.wait_ready(20)

    def state() -> str:
        return pathlib.Path(f"/proc/{proc.pid}/stat").read_text().split()[2]

    try:
        proc.pause()
        wait_for(lambda: state() == "T", 10, what="SIGSTOP to land")
        proc.resume()
        wait_for(lambda: state() != "T", 10, what="SIGCONT to land")
    finally:
        proc.kill()
    with pytest.raises(TimeoutError, match="never"):
        wait_for(lambda: False, 0.05, what="never")


def test_planet_passes_its_device_to_schedulers_only(tmp_path, monkeypatch):
    """A scheduler's argv carries ``--device`` from the planet; the
    manager's and a daemon's carry none, and the launchers' environment
    hides no card."""
    from dragonfly2_tpu_torch.procworld import ProcessPlanet, supervisor

    spawned = []

    class _Fake:
        def __init__(self, args):
            self.args, self.host, self.port, self.ports, self.role = args, "127.0.0.1", 1, {}, ""

    monkeypatch.setattr(supervisor.ManagedProc, "spawn",
                        classmethod(lambda cls, args, cwd, **kw: spawned.append(args)
                                    or _Fake(list(args))))
    for device, want in ((None, None), ("cpu", "cpu"), ("cuda", "cuda")):
        spawned.clear()
        planet = ProcessPlanet(tmp_path / str(device), device=device)
        planet.spawn_manager()
        planet.spawn_scheduler("scheduler-0", manager="127.0.0.1:2")
        planet.spawn_daemon("daemon-0", ["127.0.0.1:1"], scenario="procday")
        manager, scheduler, daemon = spawned
        assert "--device" not in manager and "--device" not in daemon
        got = scheduler[scheduler.index("--device") + 1] if "--device" in scheduler else None
        assert got == want
        assert daemon[daemon.index("--scenario") + 1] == "procday"
    env = supervisor.base_env()
    assert env.pop("PYTHONPATH") == str(supervisor.REPO)
    assert env == {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_restarted_daemons_keep_their_counts_in_the_day_total():
    """A daemon restarted in a later wave starts counting from zero; the
    day's totals bank what it had counted before the restart (the
    reference's planet sums only the live processes, so a daemon that
    failed over at a kill and then restarted dropped out of ``failovers``)."""
    from dragonfly2_tpu_torch.procworld import planet as planet_mod
    from dragonfly2_tpu_torch.telemetry.metrics import Registry, serve_metrics
    from dragonfly2_tpu_torch.telemetry.series import daemon_series

    servers = []

    def daemon(failovers):
        reg = Registry()
        daemon_series(reg).scheduler_failover.labels().inc(failovers)
        srv = serve_metrics(reg, port=0)
        servers.append(srv)

        class _Proc:
            role, ports = "dfdaemon", {"METRICS": srv.server_address[1]}

            def alive(self):
                return True

        return _Proc()

    class _Planet:
        def __init__(self):
            self.procs = {"daemon-0": daemon(2), "daemon-1": daemon(1)}
            self.restarted = []

        def daemons(self):
            return [self.procs[n] for n in sorted(self.procs)]

        def restart(self, name):
            self.restarted.append(name)
            self.procs[name] = daemon(0)  # a fresh process counts from zero

    try:
        planet = _Planet()
        banked: dict = {}
        planet_mod._restart_daemon(planet, "daemon-0", banked)
        assert planet.restarted == ["daemon-0"]
        family = "dragonfly_dfdaemon_scheduler_failover_total"
        assert banked[family] == 2.0
        assert planet_mod._daemon_totals(planet)[family] == 1.0  # the live processes alone
        assert planet_mod._daemon_totals(planet, banked)[family] == 3.0
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()


def test_kill_waits_for_the_fan_out_to_reach_its_victim():
    """The planet's kill waits until the fan-out has settled: the
    downloads that do not wait on the (paused) victim have ended and no
    download has ended for ``settle`` seconds; it does not wait once
    every download is done."""
    import concurrent.futures
    import threading

    from dragonfly2_tpu_torch.procworld import planet as planet_mod

    ends = [concurrent.futures.Future() for _ in range(3)]
    stuck = concurrent.futures.Future()  # a download waiting on the victim
    timers = [threading.Timer(0.1 * (i + 1), ends[i].set_result, (None,))
              for i in range(len(ends))]
    for timer in timers:
        timer.start()
    t0 = time.monotonic()
    planet_mod._await_settled([*ends, stuck], settle=0.25, timeout=10.0)
    waited = time.monotonic() - t0
    assert all(f.done() for f in ends) and not stuck.done()
    assert 0.5 < waited < 5.0, waited  # the last end at 0.3 s, then 0.25 s settled
    t0 = time.monotonic()
    planet_mod._await_settled(ends, settle=0.25, timeout=10.0)
    assert time.monotonic() - t0 < 0.1  # nothing left in flight: no wait


def test_kill_takes_a_scheduler_that_serves_the_round():
    """The kill takes the round-robin scheduler when the round's seeders
    registered there, else the next one that registered a seeder, so the
    victim serves some of the fan-out."""
    from dragonfly2_tpu_torch.procworld import planet as planet_mod
    from dragonfly2_tpu_torch.telemetry.metrics import Registry, serve_metrics
    from dragonfly2_tpu_torch.telemetry.series import scheduler_series

    servers, counters = [], []

    def scheduler(name):
        reg = Registry()
        registered = scheduler_series(reg).register_peer
        srv = serve_metrics(reg, port=0)
        servers.append(srv)
        counters.append(registered.labels(*("normal",) * len(registered.label_names)))

        class _Proc:
            ports = {"METRICS": srv.server_address[1]}

            def alive(self):
                return True

        proc = _Proc()
        proc.name = name
        return proc

    try:
        scheds = [scheduler("scheduler-0"), scheduler("scheduler-1")]
        before = {"scheduler-0": 0.0, "scheduler-1": 0.0}
        counters[1].inc()  # the round's seeders registered at scheduler-1 alone
        assert planet_mod._pick_victim(scheds, before, 0) == "scheduler-1"
        assert planet_mod._pick_victim(scheds, before, 1) == "scheduler-1"
        counters[0].inc(2)
        assert planet_mod._pick_victim(scheds, before, 0) == "scheduler-0"
        assert planet_mod._pick_victim(scheds, before, 1) == "scheduler-1"
        later = {"scheduler-0": 2.0, "scheduler-1": 1.0}  # no seeder registered anywhere
        assert planet_mod._pick_victim(scheds, later, 1) == "scheduler-1"
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()


# ----------------------------------------------- the pure functions


@pytest.fixture(scope="module")
def sims():
    """tools/dfproc.py's simulator leg of the whole procday, through both
    packages: (reference report, port report)."""
    return (ref_soak.run_megascale("procday", **SIM_KW),
            port_soak.run_megascale("procday", device="cpu", **SIM_KW))


def test_procday_sim_leg_matches_the_reference(sims):
    want, got = sims
    for key in ("stats", "mega", "regions", "fault_schedule_digest", "slo",
                "expected_crash_rounds", "failover", "timeline", "timeline_events"):
        assert got[key] == want[key], key


def _observations(mod, regions):
    out = []
    for r in range(1, 13):
        kill = 1 if r in (5, 10) else 0
        out.append(mod.RoundObservation(
            round_idx=r, completed=10 + r, pieces=3 * (10 + r), origin_pieces=r,
            reannounce_backlog=4 * kill, scheduler_crash=kill, breaker_open=int(r == 7),
            corruptions=int(r == 3), refused_registrations=int(r == 2),
            ttc_ms={rg: [100.0 + r * i for i in range(1, 2 + r % 4)] for rg in regions[:2]},
        ))
    return out


def test_sample_functions_equal_the_reference(sims):
    regions = ["region-0", "region-1", "region-2"]
    for values in ([], [5.0], [1, 2, 3, 4], [9.5, 1.25, 3.0, 7.75, 2.0]):
        for q in (0.0, 0.5, 0.95, 1.0):
            assert sample.quantile(values, q) == ref_sample.quantile(values, q)
    got_obs, want_obs = _observations(sample, regions), _observations(ref_sample, regions)
    for g, w in zip(got_obs, want_obs):
        assert sample.build_sample(g, minutes_per_round=120.0, regions=regions) == \
            ref_sample.build_sample(w, minutes_per_round=120.0, regions=regions)
    got = sample.synthesize_timeline(got_obs, minutes_per_round=120.0, regions=regions)
    want = ref_sample.synthesize_timeline(want_obs, minutes_per_round=120.0, regions=regions)
    assert got == want
    assert sample.announce_page_rounds(*got) == ref_sample.announce_page_rounds(*want)
    assert sample.announce_page_rounds(*got) == [5.0, 10.0]
    # the planet's sample carries exactly the keys the megascale engine records
    engine_sample = sims[1]["timeline"][0]
    slo_columns = {"t", "slo_verdict", "slo_alerts_firing", "slo_pages_fired",
                   "slo_tickets_fired"}
    assert set(got[0][0]) == set(engine_sample) and slo_columns <= set(engine_sample)


def test_slo_plane_equals_the_reference_on_a_reference_timeline(sims):
    """``feed_megascale_sample`` step by step, ``replay_timeline`` and
    ``slo_report`` of the port against the reference's over the
    reference-made procday timeline."""
    from dragonfly2_tpu.telemetry.metrics import Registry as RefRegistry
    from dragonfly2_tpu_torch.telemetry.metrics import Registry

    timeline, mpr = sims[0]["timeline"], sims[0]["minutes_per_round"]
    regions = sorted(timeline[0]["ttc_ms_p95"])
    engine = slo.SLOEngine(slo.megascale_slo_specs(regions), minutes_per_unit=mpr,
                           registry=Registry())
    ref_engine = ref_slo.SLOEngine(ref_slo.megascale_slo_specs(regions), minutes_per_unit=mpr,
                                   registry=RefRegistry())
    for s in timeline:
        assert slo.feed_megascale_sample(engine, s) == \
            ref_slo.feed_megascale_sample(ref_engine, s), s["t"]
    assert slo.slo_report(engine) == ref_slo.slo_report(ref_engine)
    replay = slo.replay_timeline(timeline, mpr)
    assert replay == ref_slo.replay_timeline(timeline, mpr)
    assert replay["alert_log"] == sims[0]["slo"]["alert_log"]
    assert replay["pages_fired"] > 0  # the day's kills paged
    assert [(s.name, s.objective) for s in slo.megascale_slo_specs(regions)] == \
        [(s.name, s.objective) for s in ref_slo.megascale_slo_specs(regions)]


def _fake_sim_report():
    return {
        "timeline": [{"t": 1.0, "ttc_ms_p95": {"region-0": 4000.0}},
                     {"t": 2.0, "ttc_ms_p95": {"region-0": 5000.0}}],
        "mega": {"origin_bytes": 20, "p2p_bytes": 80},
        "stats": {"pieces": 1000, "completed": 100, "failed": 0},
        "failover": {"scheduler_crashes": 2, "crash_reannounced_peers": 5},
        "expected_crash_rounds": [5, 10],
        "slo": {"verdict_final": "ok", "alert_log": [
            {"t": 5.0, "slo": "announce_stability", "rule": "fast_burn",
             "severity": "page", "event": "fired"}]},
    }


def _fake_real_facts():
    return {
        "scenario": "procday", "seed": 7, "ttc_ms_p95": {"region-0": 1500.0},
        "origin_fraction": 0.4, "pieces": 300, "completed": 100, "lost_downloads": 0,
        "kills": 2, "failovers": 2, "kill_rounds": [5.0, 10.0],
        "slo": {"verdict_final": "ok", "alert_log": [
            {"t": t, "slo": "announce_stability", "rule": "fast_burn", "severity": "page",
             "event": "fired"} for t in (5.0, 10.0)]},
    }


def _without_arguments(report):
    out = copy.deepcopy(report)
    for entry in out["metrics"].values():
        assert entry.pop("argument")
    return out


def _variants(sims):
    """Agreeing, disagreeing and out-of-band pairs, and the procday sim
    legs of both packages against the fake real day."""
    real, sim = _fake_real_facts(), _fake_sim_report()
    lost = {**copy.deepcopy(real), "lost_downloads": 1,
            "ttc_ms_p95": {"region-0": 9000.0}}
    degraded = copy.deepcopy(sim)
    degraded["slo"]["verdict_final"] = "degraded"
    stray = copy.deepcopy(real)
    stray["slo"]["alert_log"].append({"t": 7.0, "slo": "announce_stability",
                                      "rule": "fast_burn", "severity": "page",
                                      "event": "fired"})
    return [(real, sim), (lost, degraded), (stray, sim), (real, sims[0]), (real, sims[1])]


def test_divergence_equals_the_reference(sims):
    """The report of the port equals the reference's on the same two run
    dicts, field for field but for the argument prose (the port words its
    own); the verdicts hold as the reference's tests hold them."""
    reports = []
    for real, sim in _variants(sims):
        got = divergence.compute_divergence(real, sim)
        want = ref_divergence.compute_divergence(real, sim)
        assert _without_arguments(got) == _without_arguments(want)
        reports.append(got)
    assert {k: v[:2] for k, v in divergence.DEFAULT_BANDS.items()} == \
        {k: v[:2] for k, v in ref_divergence.DEFAULT_BANDS.items()}
    agree, broken, stray = reports[:3]
    assert agree["all_within"] and all(m["argument"] for m in agree["metrics"].values())
    assert not broken["all_within"]
    assert not broken["metrics"]["lost_downloads"]["within"]
    assert not broken["metrics"]["ttc_p95_ratio_region-0"]["within"]
    assert not broken["metrics"]["verdict_match"]["within"]
    assert not stray["metrics"]["paged_at_kill"]["within"]
    from dragonfly2_tpu_torch.telemetry.metrics import Registry
    from dragonfly2_tpu_torch.telemetry.series import proc_series

    ns = proc_series(Registry())
    divergence.publish_divergence(agree, ns)
    assert ns.sim_real_divergence.value("lost_downloads") == 1.0


# ------------------------------------------------- the planet day


@pytest.mark.procworld
def test_planet_day_survives_sigkill_and_rolling_restart(tmp_path, sims, monkeypatch):
    """The reference's tier-1 planet day on the port: 2 scheduler
    processes (``--device cpu``) + 3 dfdaemons + a manager over real
    sockets, 6 rounds of the procday spec through the proxies. Round 5
    SIGKILLs a scheduler mid-download; the restart wave rolls over the
    daemons. Zero lost downloads, completions over P2P, the page at the
    kill cleared the round after, every exit code set; the run, written
    through tools/bench_schema, judged by tools/dfslo with zero drift."""
    import tools.dfslo as dfslo
    from dragonfly2_tpu_torch.procworld import real_facts, run_procday
    from tools.bench_schema import write_artifact

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the planet's processes: one thread each
    t0 = time.monotonic()
    run = run_procday(tmp_path / "planet", rounds=6, schedulers=2, daemons=3,
                      tasks_per_round=4, with_manager=True, device="cpu")
    wall = time.monotonic() - t0
    assert wall < 420, f"planet day blew its time budget: {wall:.0f}s"
    st = run["stats"]
    assert st["lost_downloads"] == 0, st
    assert st["completed"] > 0 and st["via_p2p"] > 0, st
    assert run["kill_rounds"] == [5.0]
    assert st["kills"] == 1 and st["failovers"] >= 1, st
    assert st["restarts"] >= 4, run["proc"]["restarts"]
    # the killed scheduler (the one that served the round's fan-out) came back
    assert sum(n for name, n in run["proc"]["restarts"].items()
               if name.startswith("scheduler-")) == 1, run["proc"]["restarts"]
    assert run["page_rounds"] == [5.0], run["slo"]["alert_log"]
    cleared = [e["t"] for e in run["slo"]["alert_log"]
               if e["slo"] == "announce_stability" and e["severity"] == "page"
               and e["event"] == "cleared"]
    assert cleared == [6.0], run["slo"]["alert_log"]
    assert all(code is not None for code in run["proc"]["exit_codes"].values())
    assert all("--device cpu" in p["cmd"] for p in run["proc"]["processes"].values()
               if p["role"] == "scheduler")

    body = write_artifact(tmp_path / "planet.json", ["test"], {"scenario": "procday"},
                          runs=[run])
    rc, results = dfslo.judge(body)
    assert rc == 2 and len(results) == 1
    assert results[0]["paged"] and results[0]["pages_fired"] == 1
    assert not results[0]["recorded_drift"], results[0]["recorded_drift"]

    # the divergence report of the real day against the whole day's sim
    # leg, in both packages alike; a 6-round day's origin share and final
    # verdict have not settled, so only the invariants are held here
    facts = real_facts(run)
    got = divergence.compute_divergence(facts, sims[1])
    assert _without_arguments(got) == _without_arguments(
        ref_divergence.compute_divergence(facts, sims[0]))
    for name in ("lost_downloads", "paged_at_kill", "failover_per_kill"):
        assert got["metrics"][name]["within"], (name, got["metrics"][name])
