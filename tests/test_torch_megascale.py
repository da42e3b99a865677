"""The port's megascale lab (dragonfly2_tpu_torch/megascale) against the
reference's, on the CPU (``device="cpu"``).

- topology: ``hash_u01``, ``norm_ppf``, ``lognorm_vec``,
  ``make_region_cluster`` and ``WanCostModel.piece_costs`` equal the
  reference's bit for bit (numpy in both packages).
- the event-batch engine against the port's own per-peer
  ``ClusterSimulator`` oracle, for the three topologies of the
  reference's tests/test_megascale.py.
- the 1,500-host soak day (the reference's determinism size: ``soak``,
  32 tasks, seed 7, 24 arrivals a round, retire after 24) through both
  packages' ``run_megascale``. Exact across the packages: every
  selection's parent ids, SimStats, MegaStats, the regions' counts, the
  fault-schedule digest, the timeline's integer columns, the SLO block
  and every integer column of the decision ledger. Within 1e-6: every
  score and every float of the report and the ledger (the reference's
  jitted blend fuses multiply-adds, so scores agree to rounding, not bit
  for bit). The two digests over score-bearing columns (the ledger's
  ``columns_digest``, the tail plane's ``digest``) are held equal only
  between two runs of one package.
- the mixed-version skew soak at the reference's size (800 hosts): the
  port's registry against the golden wire snapshot, zero codec
  mismatches, a report identical to the plain run, and the port's
  ``degrade_payload`` equal to the reference's.
- tools/dftail.py and tools/dfslo.py read the port's soak report
  unchanged, to the reference's verdicts.
- the series families the lab adds: names, types, help, labels and
  buckets equal to the reference's.
- every entry that builds a service refuses a missing card.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import pytest

from dragonfly2_tpu.megascale import soak as ref_soak
from dragonfly2_tpu.megascale import topology as ref_topo
from dragonfly2_tpu.scenarios import engine as ref_engine
from dragonfly2_tpu.scenarios import spec as ref_spec
from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
from dragonfly2_tpu_torch.config.config import Config
from dragonfly2_tpu_torch.megascale import EventBatchEngine, engine as port_engine
from dragonfly2_tpu_torch.megascale import soak as port_soak
from dragonfly2_tpu_torch.megascale import topology as port_topo
from dragonfly2_tpu_torch.scenarios import builtin_scenarios, megascale_scenarios
from dragonfly2_tpu_torch.scenarios import engine as port_scen_engine

SCORE_ATOL = 1e-6
SOAK_KW = dict(num_hosts=1500, num_tasks=32, seed=7, arrivals_per_round=24,
               retire_after_rounds=24)

# digests over score-bearing columns: held within one package only
_SCORE_DIGESTS = {("decisions", "columns_digest"), ("tail", "digest")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's replays: they are many small
    ops, and the suite runs several workers on the machine's cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- topology


def test_spec_builtins_equal_the_reference():
    got, want = megascale_scenarios(), ref_spec.megascale_scenarios()
    assert sorted(got) == sorted(want) == ["fleet", "planet", "procday", "soak"]
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name]), name


@pytest.mark.parametrize("seed,kind", [(7, "kind"), (0, "mega_rtt"), ((1 << 64) - 5, "x")])
def test_hash_u01_bit_for_bit(seed, kind):
    rng = np.random.default_rng(3)
    keys = (rng.integers(0, 1 << 40, 5000), np.full(5000, 3),
            rng.integers(0, 1 << 62, 5000).astype(np.uint64))
    got = port_topo.hash_u01(seed, kind, *keys)
    want = ref_topo.hash_u01(seed, kind, *keys)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert port_topo._kind_code(kind) == ref_topo._kind_code(kind)


def test_norm_ppf_and_lognorm_bit_for_bit():
    u = np.concatenate([np.linspace(0.0, 1.0, 4097), [1e-15, 0.02425, 0.97575, 1.0 - 1e-15]])
    assert np.array_equal(port_topo.norm_ppf(u), ref_topo.norm_ppf(u))
    sigma = np.linspace(0.05, 1.5, u.shape[0])
    assert np.array_equal(port_topo.lognorm_vec(u, sigma), ref_topo.lognorm_vec(u, sigma))
    assert np.array_equal(port_topo.lognorm_vec(u, 0.3), ref_topo.lognorm_vec(u, 0.3))


@pytest.mark.parametrize("name", ["planet", "procday"])
def test_make_region_cluster_bit_for_bit(name):
    got = port_topo.make_region_cluster(997, megascale_scenarios()[name], seed=3)
    want = ref_topo.make_region_cluster(997, ref_spec.megascale_scenarios()[name], seed=3)
    assert [dataclasses.asdict(h) for h in got.hosts] == [dataclasses.asdict(h) for h in want.hosts]
    assert got.rng.getstate() == want.rng.getstate()


def _wan_models(flaky: bool):
    models = []
    for spec_mod, topo, eng in ((ref_spec, ref_topo, ref_engine),
                                (None, port_topo, port_scen_engine)):
        spec = (spec_mod.megascale_scenarios() if spec_mod else megascale_scenarios())["soak"]
        if flaky:
            spec.flaky = type(spec.flaky)(parent_fraction=1.0, piece_error_rate=0.2,
                                          piece_stall_rate=0.2, stall_seconds=0.2,
                                          piece_corrupt_rate=0.2)
        cluster = topo.make_region_cluster(256, spec, seed=3)
        engine = eng.ScenarioEngine(spec, cluster.hosts, seed=3)
        models.append(topo.WanCostModel.from_engine(spec, cluster.hosts, engine, seed=3))
    return models


@pytest.mark.parametrize("flaky", [False, True], ids=["clean", "flaky"])
def test_wan_cost_model_piece_costs_bit_for_bit(flaky):
    want_model, got_model = _wan_models(flaky)
    for field in ("region", "rack", "idc", "bandwidth", "flaky"):
        assert np.array_equal(getattr(got_model, field), getattr(want_model, field)), field
    rng = np.random.default_rng(5)
    n = 20_000
    cols = (rng.integers(0, 256, n), rng.integers(0, 256, n), 4 << 20,
            rng.integers(0, 32, n), rng.integers(0, 63, n), rng.integers(1, 4, n))
    got_cost, got_fault = got_model.piece_costs(*cols)
    want_cost, want_fault = want_model.piece_costs(*cols)
    assert np.array_equal(got_cost, want_cost) and np.array_equal(got_fault, want_fault)
    if flaky:  # every band of the roll was drawn
        assert set(np.unique(got_fault)) == {0, 1, 2, 3}


# ----------------------------------------------------- oracle equivalence


def _run(sim_cls, scenario, seed, rounds=10, hosts=60, tasks=6, arrivals=6):
    svc = SchedulerService(config=Config(), seed=seed + 100, device="cpu")
    extra = {"deterministic_peer_ids": True} if sim_cls is ClusterSimulator else {}
    sim = sim_cls(svc, num_hosts=hosts, num_tasks=tasks, seed=seed, scenario=scenario, **extra)
    for _ in range(rounds):
        sim.run_round(arrivals)
    svc.flush_piece_reports()
    columns = {
        pid: (int(svc.state.peer_finished_count[idx]),
              svc.state.peer_finished_bitset[idx].tobytes(),
              int(svc.state.peer_state[idx]))
        for pid, idx in svc.state._peer_by_id.items()
    }
    return sim, columns, svc.counts()


@pytest.mark.parametrize("topology", [None, "bandwidth_skew", "chaos"])
def test_event_batch_matches_oracle(topology):
    """Paired seeds: the port's engine and the port's per-peer oracle give
    the same SimStats, field for field, and the same final piece columns
    in the scheduler's state (finished bitsets, counts, FSM states)."""
    scenario = builtin_scenarios()[topology] if topology else None
    for seed in (3, 17):
        oracle, o_cols, o_counts = _run(ClusterSimulator, scenario, seed)
        batch, b_cols, b_counts = _run(EventBatchEngine, scenario, seed)
        assert oracle.stats.pieces > 0
        assert dataclasses.asdict(oracle.stats) == dataclasses.asdict(batch.stats), seed
        assert o_cols == b_cols, seed
        assert o_counts == b_counts
        if topology == "chaos":
            assert oracle.stats.injected_piece_failures > 0
            assert oracle.stats.retry_waves > 0
        if topology == "bandwidth_skew":  # no per-piece fallback: every piece was batched
            assert batch.mega.piece_events == batch.stats.pieces


# --------------------------------------------------- the soak day, paired


def _captured_run(run, factory_owner, **kw):
    """``run(**kw)`` with the service its factory built captured and its
    tick's selections recorded: (report, service, selections)."""
    made = {}
    factory = factory_owner.megascale_service

    def capture(*args, **kwargs):
        svc = made["svc"] = factory(*args, **kwargs)
        tick, selections = svc.tick, made.setdefault("selections", [])

        def recorded():
            out = tick()
            selections.extend(
                (r.peer_id, [(p.peer_id, float(p.score)) for p in r.candidate_parents])
                for r in out if hasattr(r, "candidate_parents"))
            return out

        svc.tick = recorded
        return svc

    mp = pytest.MonkeyPatch()
    mp.setattr(factory_owner, "megascale_service", capture)
    try:
        report = run(**kw)
    finally:
        mp.undo()
    return report, made["svc"], made["selections"]


@pytest.fixture(scope="module")
def soak_pair():
    ref = _captured_run(ref_soak.run_megascale, ref_soak, scenario="soak", **SOAK_KW)
    port = _captured_run(port_soak.run_megascale, port_engine, scenario="soak",
                         device="cpu", **SOAK_KW)
    return ref, port


def _assert_close(got, want, path=""):
    """Integers, strings and structure exactly; floats within SCORE_ATOL;
    the score-bearing digests skipped (they are held within a package)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got, key=str) == sorted(want, key=str), path
        for key in want:
            if (path.rsplit("/", 1)[-1], key) in _SCORE_DIGESTS:
                continue
            _assert_close(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
        assert (math.isnan(got) and math.isnan(want)) or abs(got - want) <= SCORE_ATOL, (
            path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_soak_day_matches_the_reference(soak_pair):
    """The port's 1,500-host soak day against the reference's: the same
    selections (ids exactly, scores within 1e-6), the same report (exact
    but for floats within 1e-6 and the two score-bearing digests), and the
    same decision-ledger columns."""
    (want, ref_svc, want_sel), (got, svc, got_sel) = soak_pair
    assert want["stats"]["pieces"] > 60_000 and len(want_sel) > 5_000
    assert [p for p, _ in got_sel] == [p for p, _ in want_sel]
    for (peer, g), (_, w) in zip(got_sel, want_sel):
        assert [pid for pid, _ in g] == [pid for pid, _ in w], peer
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=SCORE_ATOL,
                                   rtol=0, err_msg=peer)
    view, ref_view = port_soak.deterministic_view(got), ref_soak.deterministic_view(want)
    # exact across the packages, spelled out (the walk below holds the rest)
    for key in ("stats", "mega", "regions", "fault_schedule_digest", "fault_families",
                "expected_crash_rounds", "timeline_events", "recovery", "slo",
                "scheduler_counts"):
        assert view[key] == ref_view[key], key
    for g, w in zip(view["timeline"], ref_view["timeline"]):
        assert {k: v for k, v in g.items() if isinstance(v, int)} == \
            {k: v for k, v in w.items() if isinstance(v, int)}
    _assert_close(view, ref_view)

    got_led = svc.decisions.deterministic_columns()
    want_led = ref_svc.decisions.deterministic_columns()
    assert sorted(got_led) == sorted(want_led)
    for name, w in want_led.items():
        g = got_led[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=SCORE_ATOL, rtol=0, equal_nan=True,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert svc.decisions.counters() == ref_svc.decisions.counters()


def test_soak_day_same_seed_deterministic(soak_pair):
    """Two runs of the port on one seed: the whole deterministic view,
    digests included, identical."""
    _, (first, _, first_sel) = soak_pair
    again, _, again_sel = _captured_run(port_soak.run_megascale, port_engine, scenario="soak",
                                        device="cpu", **SOAK_KW)
    assert port_soak.deterministic_view(again) == port_soak.deterministic_view(first)
    assert again["decisions"]["columns_digest"] == first["decisions"]["columns_digest"]
    assert again["tail"]["digest"] == first["tail"]["digest"]
    assert again_sel == first_sel
    assert len(first["timeline"]) == first["rounds"] == 108


def test_soak_day_seed_sensitivity(soak_pair):
    _, (first, _, _) = soak_pair
    other = port_soak.run_megascale("soak", device="cpu", **{**SOAK_KW, "seed": 8})
    assert other["fault_schedule_digest"] != first["fault_schedule_digest"]
    assert other["stats"] != first["stats"]


def test_soak_exercises_every_fault_family_and_pages_at_kills(soak_pair):
    """The reference's soak gates on the port's run: every fault family
    nonzero, each mid-day kill marked, paging AT its round and clearing,
    and the alert log replayed offline from the timeline by both
    packages' ``replay_timeline`` alike."""
    from dragonfly2_tpu.telemetry.slo import replay_timeline as ref_replay
    from dragonfly2_tpu_torch.telemetry.slo import replay_timeline

    _, (r, _, _) = soak_pair
    fam = r["fault_families"]
    assert all(fam[k] > 0 for k in ("chaos", "corruption", "churn", "flash_crowds")), fam
    assert r["mega"]["upgrade_host_restarts"] > 0
    assert r["quarantine"]["corruption_reports"] > 0
    kills = [e["t"] for e in r["timeline_events"] if e["event"] == "scheduler_crash"]
    assert kills and kills == r["expected_crash_rounds"]
    pages = {e["t"] for e in r["slo"]["alert_log"]
             if e["severity"] == "page" and e["event"] == "fired"}
    assert all(float(k) in pages for k in kills if k <= 72), (kills, pages)
    replay = replay_timeline(r["timeline"], r["minutes_per_round"])
    assert replay == ref_replay(r["timeline"], r["minutes_per_round"])
    assert replay["pages_fired"] == r["slo"]["pages_fired"]
    assert replay["alert_log"][-len(r["slo"]["alert_log"]):] == r["slo"]["alert_log"]


def test_offline_readers_take_the_port_report_unchanged(soak_pair):
    """tools/dftail.py and tools/dfslo.py, unchanged, judge the port's
    soak day as they judge the reference's: the same kill windows and
    verdicts, no drift."""
    import json

    import tools.dfslo as dfslo
    from tools import dftail

    (want, _, _), (got, _, _) = soak_pair
    docs = [json.loads(json.dumps({"runs": [r]})) for r in (got, want)]
    (rc, tails), (ref_rc, ref_tails) = (dftail.judge(d) for d in docs)
    assert rc == ref_rc == 0 and not tails[0]["drift"]
    assert tails[0]["windows"] == ref_tails[0]["windows"]
    assert tails[0]["baseline_dominant_phase"] == ref_tails[0]["baseline_dominant_phase"]
    (rc, runs), (ref_rc, ref_runs) = (dfslo.judge(d) for d in docs)
    assert rc == ref_rc == 2 and not runs[0]["recorded_drift"]  # the kills paged
    assert runs[0]["alert_log"] == ref_runs[0]["alert_log"]


# ------------------------------------------------------------ wire skew


@pytest.fixture(scope="module")
def golden():
    from dragonfly2_tpu_torch.rpc import wireskew

    return wireskew.load_golden()


def test_port_registry_matches_the_golden_wire_snapshot(golden):
    """Every message the snapshot names is in the port's registry under
    that name, with the same fields and the same required set, and the
    registry holds nothing the snapshot lacks."""
    from dragonfly2_tpu_torch.rpc import wire, wireskew

    wireskew.ensure_registered()
    assert sorted(wire._REGISTRY) == sorted(golden["messages"])
    for name, cls in wire._REGISTRY.items():
        fields = {f.name: f.default is dataclasses.MISSING
                  and f.default_factory is dataclasses.MISSING
                  for f in dataclasses.fields(cls)}
        want = {k: v["required"] for k, v in golden["messages"][name]["fields"].items()}
        assert fields == want, name


def test_degrade_payload_equals_the_reference(golden):
    from dragonfly2_tpu_torch.rpc import wire, wireskew
    from tools.dflint import wirefuzz

    wireskew.ensure_registered()
    wirefuzz.ensure_registered()
    old = copy.deepcopy(golden)
    for message in old["messages"].values():  # an N-1 snapshot: optional fields dropped
        for fname in [k for k, v in message["fields"].items() if not v["required"]][:1]:
            del message["fields"][fname]
    checked = 0
    for name in sorted(wire._REGISTRY):
        rng = wirefuzz.message_rng(name, salt=7)
        for _ in range(3):
            ref_cls = wirefuzz.wire._REGISTRY[name]
            payload = wirefuzz.wire._to_plain(wirefuzz.fuzz_instance(ref_cls, rng))
            for schema in (golden, old):
                got = wireskew.degrade_payload(copy.deepcopy(payload), schema, name)
                assert got == wirefuzz.degrade_payload(copy.deepcopy(payload), schema, name)
                checked += 1
    assert checked >= 6 * len(wire._REGISTRY)


def test_rolling_upgrade_soak_with_wire_skew_loses_zero_downloads(golden):
    """The skew soak at the reference's size: every control-plane exchange
    round-trips the N-1-degraded codec, zero mismatches, real frames of
    the handshake types, and a deterministic view identical to the plain
    run."""
    kw = dict(num_hosts=800, num_tasks=24, seed=7, arrivals_per_round=16,
              retire_after_rounds=24, device="cpu")
    plain = port_soak.run_megascale("soak", **kw)
    skew = port_soak.run_megascale("soak", wire_skew=golden, **kw)
    ws = skew.pop("wire_skew")
    assert ws["mismatches"] == [], ws["mismatches"][:5]
    assert ws["frames_total"] > 1000
    for handshake in ("RegisterPeerRequest", "NormalTaskResponse",
                      "DownloadPeerFinishedRequest"):
        assert ws["frames"].get(handshake, 0) > 0, ws["frames"]
    assert skew["mega"]["upgrade_host_restarts"] > 0
    assert port_soak.deterministic_view(skew) == port_soak.deterministic_view(plain)
    assert skew["stats"]["completed"] == plain["stats"]["completed"] > 0


# --------------------------------------------------------------- series


def _families(namespace) -> dict:
    return {
        attr: (type(m).__name__, m.name, m.help, tuple(m.label_names),
               getattr(m, "buckets", None))
        for attr, m in vars(namespace).items()
    }


@pytest.mark.parametrize("family", ["megascale_series", "fleet_series", "proc_series"])
def test_series_families_equal_the_reference(family):
    from dragonfly2_tpu.telemetry import series as ref_series
    from dragonfly2_tpu.telemetry.metrics import Registry as RefRegistry
    from dragonfly2_tpu_torch.telemetry import series
    from dragonfly2_tpu_torch.telemetry.metrics import Registry

    got = _families(getattr(series, family)(Registry()))
    assert got and got == _families(getattr(ref_series, family)(RefRegistry()))


# --------------------------------------------------------------- device


def test_entries_refuse_a_missing_card(tmp_path, monkeypatch):
    """Without ``device`` every entry that builds a service takes the
    card, and raises where there is none; nothing falls back."""
    import torch

    from dragonfly2_tpu_torch.megascale import megascale_fleet, megascale_service
    from dragonfly2_tpu_torch.procworld import run_procday

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: megascale_service(64, num_tasks=4),
                  lambda: megascale_fleet(64, num_tasks=4, replicas=2),
                  lambda: port_soak.run_megascale("soak", num_hosts=64, num_tasks=4, rounds=1),
                  lambda: run_procday(tmp_path / "planet", rounds=1)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            build()
    assert not (tmp_path / "planet").exists()  # the planet started no process
    assert megascale_service(64, num_tasks=4, device="cpu").device.type == "cpu"
