"""The port's sharded control plane (dragonfly2_tpu_torch/megascale/fleet.py)
on the CPU (``device="cpu"``), against the port's single service and the
reference's fleet.

- the router: registrations to the ring owner, reports after the
  recorded shard, the bulk register, the seed-trigger view, handoff with
  kept pieces adopted, ring down and up;
- K = 1 against the single service (the reference's equivalence size:
  ``soak``, 2,000 hosts, 24 tasks, seed 11, 40 rounds): SimStats, the
  digests, the decision and SLO blocks, the scheduler counts and every
  shared timeline column identical;
- a small K = 3 ``fleet`` day against the reference's: exact but for
  floats within 1e-6 and the two score-bearing digests, as
  tests/test_torch_megascale.py holds the single service;
- the K = 4 kill gates at the reference's size (``fleet``, 2,000 hosts,
  40 rounds): zero lost downloads, the announce page at each kill round
  and its clear, the alert log replayed offline.
"""

from __future__ import annotations

import dataclasses

import pytest

from dragonfly2_tpu.megascale import soak as ref_soak
from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.megascale.engine import megascale_service
from dragonfly2_tpu_torch.megascale.fleet import FleetDecisionView, megascale_fleet
from dragonfly2_tpu_torch.megascale.soak import deterministic_view, run_megascale

from test_torch_megascale import _assert_close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's replays: they are many small
    ops, and the suite runs several workers on the machine's cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small_fleet(k=3, seed=3):
    return megascale_fleet(64, num_tasks=8, seed=seed, replicas=k, device="cpu")


def _host(hid="host-a"):
    return msg.HostInfo(host_id=hid, ip="10.0.0.1")


def _register(fleet, peer_id, task_id, pieces=None):
    fleet.announce_host(_host())
    return fleet.register_peer(msg.RegisterPeerRequest(
        peer_id=peer_id, task_id=task_id, host=_host(),
        url=f"http://o/{task_id}", content_length=8 << 20,
        total_piece_count=2, finished_pieces=pieces,
    ))


def test_replicas_share_one_device_with_split_peer_tables():
    fleet = _small_fleet(k=3)
    assert fleet.k == 3 and {r.device.type for r in fleet.replicas} == {"cpu"}
    assert [r.config.scheduler.max_peers for r in fleet.replicas] == [2048] * 3


def test_register_routes_to_ring_owner_and_reports_follow():
    fleet = _small_fleet()
    resp = _register(fleet, "peer-1", "task-zzz")
    assert not isinstance(resp, msg.ScheduleFailure)
    owner = fleet.shard_of_task("task-zzz")
    assert fleet.shard_of_peer("peer-1") == owner
    by_shard = fleet.counts_by_shard()
    for shard, name in enumerate(fleet.names):
        assert by_shard[name]["peers"] == (1 if shard == owner else 0), (shard, by_shard)
    out = fleet.peer_finished(msg.DownloadPeerFinishedRequest(peer_id="peer-1"))
    assert not isinstance(out, msg.ScheduleFailure)
    out = fleet.peer_finished(msg.DownloadPeerFinishedRequest(peer_id="peer-nope"))
    assert isinstance(out, msg.ScheduleFailure) and out.code == "NotFound"


def test_batch_register_matches_sequential_routing():
    fleet = _small_fleet()
    fleet.announce_host(_host())
    reqs = [
        msg.RegisterPeerRequest(
            peer_id=f"peer-{i}", task_id=f"task-{i % 5}", host=_host(),
            url=f"http://o/{i % 5}", content_length=8 << 20, total_piece_count=2,
        )
        for i in range(20)
    ]
    out = fleet.register_peers_batch(reqs)
    assert len(out) == len(reqs)
    for resp, req in zip(out, reqs):
        assert not isinstance(resp, msg.ScheduleFailure)
        if resp is not None:  # None: queued pending, answered at the tick
            assert resp.peer_id == req.peer_id
        assert fleet.shard_of_peer(req.peer_id) == fleet.shard_of_task(req.task_id)
    total = fleet.counts()
    assert total["peers"] == sum(c["peers"] for c in fleet.counts_by_shard().values()) == 20


def test_handoff_moves_peer_to_new_ring_owner_with_kept_pieces():
    fleet = _small_fleet()
    assert not isinstance(_register(fleet, "peer-7", "task-move"), msg.ScheduleFailure)
    old_owner = fleet.shard_of_task("task-move")
    fleet.shard_down(old_owner)
    new_owner = fleet.shard_of_task("task-move")
    assert new_owner != old_owner
    out = fleet.handle(msg.PeerHandoffRequest(
        peer_id="peer-7", task_id="task-move", host=_host(),
        url="http://o/task-move", content_length=8 << 20,
        total_piece_count=2, finished_pieces=[0],
        from_scheduler=fleet.names[old_owner], reason="crash",
    ))
    assert not isinstance(out, msg.ScheduleFailure)
    assert fleet.shard_of_peer("peer-7") == new_owner
    assert fleet.handoffs["crash"] == 1
    svc = fleet.replicas[new_owner]
    idx = svc.state._peer_by_id["peer-7"]
    assert int(svc.state.peer_finished_count[idx]) == 1  # the kept piece was adopted
    fleet.shard_up(old_owner)
    assert fleet.down_shards() == [] and fleet.restarts == 1


def test_ring_down_up_round_trips_membership():
    fleet = _small_fleet(k=4)
    assert len(fleet.ring) == 4
    fleet.shard_down(2)
    assert len(fleet.ring) == 3 and fleet.down_shards() == [2]
    fleet.shard_up(2)
    assert len(fleet.ring) == 4 and fleet.restarts == 1
    lone = _small_fleet(k=1)
    lone.shard_down(0)  # a lone replica restarts in place
    assert len(lone.ring) == 1


def test_seed_trigger_queue_view_routes_by_task():
    fleet = _small_fleet()
    t = msg.TriggerSeedRequest(host_id="h", task_id="task-s", url="http://o/s")
    fleet.replicas[0].seed_triggers.append(t)
    assert fleet.seed_triggers == [t]
    fleet.seed_triggers = [t]
    owner = fleet.shard_of_task("task-s")
    for shard, replica in enumerate(fleet.replicas):
        assert len(replica.seed_triggers) == (1 if shard == owner else 0)
    fleet.seed_triggers = []
    assert fleet.seed_triggers == []


def test_k1_factory_builds_the_exact_single_service_config():
    fleet = megascale_fleet(5000, num_tasks=32, seed=9, replicas=1, device="cpu")
    single = megascale_service(5000, num_tasks=32, seed=9, device="cpu")
    assert dataclasses.asdict(fleet.replicas[0].config) == dataclasses.asdict(single.config)
    view = FleetDecisionView(fleet)
    led = fleet.replicas[0].decisions
    assert view.report() == led.report()
    assert view.deterministic_digest() == led.deterministic_digest()


# ----------------------------------------------- K=1 equivalence oracle

_EQ_KW = dict(scenario="soak", num_hosts=2000, num_tasks=24, seed=11, rounds=40,
              device="cpu")
_FLEET_COLS = {"fleet_pieces", "fleet_handoffs", "shards_in_ring", "shards_down"}


def test_k1_fleet_is_bit_identical_to_single_scheduler():
    base = run_megascale(**_EQ_KW)
    one = run_megascale(**_EQ_KW, fleet_replicas=1)
    assert base["stats"]["injected_scheduler_crashes"] > 0
    for key in ("stats", "fault_schedule_digest", "decisions", "slo", "scheduler_counts",
                "failover", "recovery", "regions", "mega"):
        assert one[key] == base[key], key
    assert one["tail"]["digest"] == base["tail"]["digest"]
    assert len(one["timeline"]) == len(base["timeline"])
    for ours, theirs in zip(one["timeline"], base["timeline"]):
        assert {k: v for k, v in ours.items() if k not in _FLEET_COLS} == theirs
    fl = one["fleet"]
    assert fl["replicas"] == 1 and fl["restarts"] == 0
    assert fl["handoffs"]["rebalance"] == fl["handoffs"]["upgrade"] == 0
    assert fl["handoffs"]["crash"] == base["stats"]["crash_reannounced_peers"]


# ------------------------------------------ K=3 against the reference

_K3_KW = dict(scenario="fleet", num_hosts=600, num_tasks=16, seed=11, rounds=24,
              fleet_replicas=3)


def test_k3_fleet_matches_the_reference():
    want = ref_soak.run_megascale(**_K3_KW)
    got = run_megascale(**_K3_KW, device="cpu")
    assert want["stats"]["pieces"] > 0 and want["fleet"]["handoffs_total"] > 0
    view, ref_view = deterministic_view(got), ref_soak.deterministic_view(want)
    for key in ("stats", "mega", "fault_schedule_digest", "slo", "scheduler_counts"):
        assert view[key] == ref_view[key], key
    fleet, ref_fleet = dict(view.pop("fleet")), dict(ref_view.pop("fleet"))
    # per-shard ledger digests cover scores: held within a package only
    assert sorted(fleet.pop("decision_digests_by_shard")) == \
        sorted(ref_fleet.pop("decision_digests_by_shard"))
    fleet["tail_by_shard"].pop("digest")
    ref_fleet["tail_by_shard"].pop("digest")
    _assert_close(fleet, ref_fleet, "/fleet")
    _assert_close(view, ref_view)


# ------------------------------------------------- K=4 fleet soak gates

_FLEET_KW = dict(scenario="fleet", num_hosts=2000, num_tasks=24, seed=11, rounds=40,
                 fleet_replicas=4, device="cpu")


@pytest.fixture(scope="module")
def fleet_run():
    return run_megascale(**_FLEET_KW)


def test_fleet_soak_paired_seed_deterministic(fleet_run):
    again = run_megascale(**_FLEET_KW)
    assert deterministic_view(again) == deterministic_view(fleet_run)


def test_replica_kill_recovers_and_pages_at_the_kill(fleet_run):
    """A K = 4 day: the kills lose zero downloads and stay off origin,
    victims go round-robin, each page fires at a kill round and clears,
    and the alert log replays offline from the timeline."""
    from dragonfly2_tpu_torch.telemetry.slo import replay_timeline

    run = fleet_run
    st, fl = run["stats"], run["fleet"]
    assert st["injected_scheduler_crashes"] >= 2 and st["failed"] == 0
    assert run["origin_traffic_fraction"] < 0.10
    assert st["crash_reannounced_peers"] > 0 and fl["handoffs"]["crash"] > 0
    victims = [v["shard"] for v in fl["crash_victims"]]
    assert victims == [fl["names"][i % 4] for i in range(len(victims))]
    for entry in fl["victim_recovery"]:
        if entry["round"] < run["rounds"] - 8:
            assert entry["recovered"], entry
    assert sum(1 for v in fl["pieces_by_shard"].values() if v > 0) >= 3
    assert sum(fl["pieces_by_shard"].values()) == st["pieces"]
    kill_rounds = [v["round"] for v in fl["crash_victims"]]
    pages = [e for e in run["slo"]["alert_log"]
             if e["slo"] == "announce_stability" and e["severity"] == "page"]
    fired = [e["t"] for e in pages if e["event"] == "fired"]
    cleared = [e["t"] for e in pages if e["event"] == "cleared"]
    assert fired
    for t in fired:
        assert t in kill_rounds and any(c > t for c in cleared), (t, kill_rounds, cleared)
    replay = replay_timeline(run["timeline"], run["minutes_per_round"])
    assert replay["alert_log"] == run["slo"]["alert_log"]
    timing = run["timing"]["fleet"]
    assert timing["sched_critical_s"] <= timing["sched_serial_s"]
    assert set(timing["sched_seconds_by_shard"]) == set(fl["names"])


def test_fleet_soak_with_wire_skew_covers_handoff_frames(fleet_run):
    """The K = 4 day over the N-1-degraded codec moves real
    PeerHandoffRequest frames, with zero mismatches, and equals the plain
    fleet run."""
    from dragonfly2_tpu_torch.rpc import wireskew

    skew = run_megascale(**_FLEET_KW, wire_skew=wireskew.load_golden())
    ws = skew.pop("wire_skew")
    assert ws["mismatches"] == [], ws["mismatches"][:5]
    assert ws["frames"].get("PeerHandoffRequest", 0) > 0, ws["frames"]
    assert deterministic_view(skew) == deterministic_view(fleet_run)
    assert skew["stats"]["failed"] == 0 and skew["fleet"]["handoffs"]["crash"] > 0


def test_upgrade_wave_rolls_replicas_through_the_ring():
    """A whole compressed day drives the upgrade wave across every
    replica: each restarts (down a round, rejoin, rebalance back)."""
    report = run_megascale(scenario="fleet", num_hosts=2000, num_tasks=24, seed=11,
                           fleet_replicas=4, device="cpu")
    fl = report["fleet"]
    events = [e["event"] for e in report["timeline_events"]]
    for shard in range(4):
        assert f"fleet_restart:{shard}" in events, events
    assert fl["handoffs"]["upgrade"] > 0 and fl["handoffs"]["rebalance"] > 0
    assert fl["restarts"] >= 4 and report["stats"]["failed"] == 0
