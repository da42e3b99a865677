"""A seed as the only parent of a task, in both packages alike.

After a preheat the seed's peer is the task's one Succeeded parent: the
peers that fan out from it have no parent yet, and a normal peer without
one is no candidate (scheduling.go:534-544). The bad-node rule
(IsBadNode, evaluator.go:93-129) judges that seed by the origin piece
costs it reported, the newest against the rest (their mean + 3 sigma from
30 costs on). A seed whose newest origin piece came in slow is no
candidate for any child, so every child of the task runs out of
retries and goes back to source: through a proxy whose request carries
no object-store credentials, each one answers 502. The reference's
scheduler does the same on the same sequence, and the port stays equal
to it; these cases pin the sequence and its verdicts, and the
journal-based verdict ``chip_smoke._seed_cost_verdict`` prints beside
the card's fan-out.

The process case drives the fan-out the instant the manager's preheat
job reads SUCCESS: 8 dfdaemon proxies, each answered 200 over P2P, and
the object's bytes fetched from the S3 stub once.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import time

import numpy as np
import pytest

import chip_smoke
from dragonfly2_tpu.cluster import messages as ref_msg
from dragonfly2_tpu.cluster.scheduler import SchedulerService as RefService
from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIECES = 60  # phase 18's object: 240 MiB in 4 MiB pieces
PIECE = 4 << 20
STEADY_MS = [30.0 + (n % 5) for n in range(PIECES - 1)]  # mean 32 ms, sigma 1.4 ms
OUTLIER_MS = 300.0  # the newest cost, far above mean + 3 sigma (~36.2 ms)
WITHIN_MS = 31.0
CHILDREN = 8
MAX_TICKS = 20  # retry_limit is 5: every child is answered well within


def _services():
    return (("port", SchedulerService(seed=1, device="cpu"), msg),
            ("reference", RefService(seed=1), ref_msg))


def _tick_until(svc, peers: set) -> dict:
    """Tick until every peer named has its answer; peer id -> answer."""
    got: dict = {}
    for _ in range(MAX_TICKS):
        for answer in svc.tick():
            if answer.peer_id in peers:
                got.setdefault(answer.peer_id, answer)
        if set(got) == peers:
            return got
    raise AssertionError(f"{sorted(peers - set(got))} unanswered after {MAX_TICKS} ticks")


def _seed_then_fan_out(svc, m, newest_ms: float) -> dict:
    """A super host's peer back-sources the task, reporting PIECES origin
    piece costs (the newest ``newest_ms``), and finishes; then CHILDREN
    normal peers register at once. The children's answers by peer id."""
    url, task, size = "s3://rollout/images/layer.bin", "task-layer", PIECES * PIECE
    seed = m.HostInfo(host_id="seed-host", hostname="seed", ip="10.0.0.1", host_type="super")
    assert svc.handle(m.RegisterPeerRequest(peer_id="seed-peer", task_id=task, host=seed,
                                            url=url, content_length=size)) is None
    first = _tick_until(svc, {"seed-peer"})["seed-peer"]
    assert type(first).__name__ == "NeedBackToSourceResponse", first
    svc.handle(m.DownloadPeerBackToSourceStartedRequest(peer_id="seed-peer"))
    for n, cost_ms in enumerate([*STEADY_MS, newest_ms]):
        svc.handle(m.DownloadPieceFinishedRequest(
            peer_id="seed-peer", piece_number=n, length=PIECE, cost_ns=int(cost_ms * 1e6),
            digest=f"{n:032x}"))
    svc.handle(m.DownloadPeerBackToSourceFinishedRequest(
        peer_id="seed-peer", content_length=size, piece_count=PIECES))
    children = {f"child-{i}" for i in range(CHILDREN)}
    for i in range(CHILDREN):
        host = m.HostInfo(host_id=f"host-{i}", hostname=f"node-{i}", ip=f"10.0.1.{i + 1}")
        assert svc.handle(m.RegisterPeerRequest(peer_id=f"child-{i}", task_id=task, host=host,
                                                url=url, content_length=size)) is None
    return _tick_until(svc, children)


def _kinds(answers: dict) -> dict:
    return {peer: type(a).__name__ for peer, a in sorted(answers.items())}


def test_a_seed_slow_on_its_newest_origin_piece_sends_every_child_to_source():
    """The seed's newest origin cost above mean + 3 sigma of the rest:
    no child gets a parent; each is sent back to source (the task's
    back-to-source allowance first, then the retry limit's failure),
    and the reference answers each child the same."""
    kinds = {}
    for name, svc, m in _services():
        answers = _seed_then_fan_out(svc, m, OUTLIER_MS)
        kinds[name] = _kinds(answers)
        assert set(kinds[name].values()) <= {"NeedBackToSourceResponse", "ScheduleFailure"}, \
            (name, kinds[name])
        assert "NeedBackToSourceResponse" in kinds[name].values(), (name, kinds[name])
    assert kinds["port"] == kinds["reference"]


def test_a_seed_steady_to_its_newest_origin_piece_serves_every_child():
    """The same sequence with the newest cost inside the rule: every
    child's answer names the seed's peer as a parent, in both packages."""
    for name, svc, m in _services():
        answers = _seed_then_fan_out(svc, m, WITHIN_MS)
        assert set(_kinds(answers).values()) == {"NormalTaskResponse"}, (name, _kinds(answers))
        for peer, a in answers.items():
            assert "seed-peer" in [p.peer_id for p in a.candidate_parents], (name, peer, a)


@pytest.mark.parametrize("newest_ms,bad", [(OUTLIER_MS, True), (WITHIN_MS, False)])
def test_the_journal_verdict_is_the_schedulers(tmp_path, newest_ms, bad):
    """``chip_smoke._seed_cost_verdict`` reads a seed's piece journal in
    its write order and judges it as the scheduler's cost ring does:
    the same costs as the cases above, the same verdicts."""
    task = tmp_path / "task-layer"
    task.mkdir()
    costs = [*STEADY_MS, newest_ms]
    task.joinpath("pieces.jsonl").write_text("".join(
        json.dumps({"number": n, "cost_ns": int(c * 1e6)}) + "\n" for n, c in enumerate(costs)))
    got, newest, bound, ring = chip_smoke._seed_cost_verdict(str(tmp_path), "task-layer")
    assert (got, ring) == (bad, 32)
    assert newest == pytest.approx(newest_ms)
    assert bound == pytest.approx(float(np.mean(costs[-32:-1]) + 3 * np.std(costs[-32:-1])))


# ------------------------------------------- the fan-out at SUCCESS


def _launch(name: str, args: list, root):
    return chip_smoke._Process(name, args, REPO, os.path.join(root, f"{name}.log"))


def test_fan_out_at_preheat_success_rides_p2p(tmp_path):
    """A manager, a scheduler on the CPU, a seed (super, its object
    credentials in the preheat's x-df-* headers) and 8 dfdaemons whose
    proxies hijack s3://, all taking their scheduler list from the
    manager. The fan-out starts the instant GET /api/v1/jobs/:id reads
    SUCCESS: every proxy answers 200 with the object's sha256 over P2P,
    and the stub serves the object's bytes once (the seed's pulls). The
    object is 4 pieces of 4 MiB, so the seed is judged by the 20x-mean
    rule, which no steady origin trips."""
    from dragonfly2_tpu_torch.utils import idgen

    daemons, size = 8, 4 * PIECE
    chip_smoke._raise_open_files()
    stub = chip_smoke._S3Stub()
    blob = np.random.default_rng(25).integers(0, 256, size, dtype=np.uint8).tobytes()
    stub.put(chip_smoke.OBJ_BUCKET, chip_smoke.OBJ_KEY, blob)
    url = f"s3://{chip_smoke.OBJ_BUCKET}/{chip_smoke.OBJ_KEY}"
    creds = {"x-df-endpoint": stub.endpoint, "x-df-access-key": chip_smoke.OBJ_ACCESS,
             "x-df-secret-key": chip_smoke.OBJ_SECRET, "x-df-region": chip_smoke.OBJ_REGION}
    root = str(tmp_path)
    procs: list = []
    try:
        mgr = _launch("manager", ["manager", "--db", os.path.join(root, "manager.db"),
                                  "--metrics-port", "0"], root)
        procs.append(mgr)
        rest = chip_smoke._Rest(f"http://{mgr.ready[1]}:{mgr.ready[2]}")
        rpc = f"{mgr.ready[1]}:{mgr.ready[4]}"
        rest.token = rest("POST", "/api/v1/users/signin",
                          {"name": "root", "password": "dragonfly"})["token"]
        cluster = rest("POST", "/api/v1/clusters", {
            "name": "objects", "is_default": True,
            "scheduler_cluster_config": {"candidate_parent_limit": 4}})
        sched = _launch("scheduler", [
            "scheduler", "--device", "cpu", "--data-dir", os.path.join(root, "traces"),
            "--manager", rpc, "--cluster-id", str(cluster["scheduler_cluster_id"]),
            "--hostname", "sched-fanout", "--keepalive-interval", "0.5",
            "--dynconfig-interval", "1", "--metrics-port", "0"], root)
        procs.append(sched)
        port = int(sched.ready[2])
        chip_smoke._wait_for(lambda: [r for r in rest("GET", "/api/v1/schedulers", timed=False)
                                      if r["state"] == "active" and r["port"] == port],
                             30, "the manager to list the scheduler active", procs)
        seed = _launch("seed", ["dfdaemon", "--data-dir", os.path.join(root, "seed"),
                                "--manager", rpc, "--hostname", "seed", "--host-type", "super",
                                "--dynconfig-interval", "1", "--metrics-port", "0"], root)
        procs.append(seed)
        dfs = [_launch(f"df-{i}", [
            "dfdaemon", "--data-dir", os.path.join(root, f"df-{i}"), "--manager", rpc,
            "--hostname", f"df-{i}", "--proxy", "--proxy-rule", "^s3://",
            "--dynconfig-interval", "1", "--metrics-port", "0"], root) for i in range(daemons)]
        procs.extend(dfs)

        job = rest("POST", "/api/v1/jobs", {"type": "preheat", "args": {
            "type": "file", "url": url, "headers": creds}})
        assert job["result"]["task_ids"] == [idgen.task_id_v1(url)]
        deadline = time.monotonic() + 60
        while (state := rest("GET", f"/api/v1/jobs/{job['id']}", timed=False)["state"]) == "PENDING":
            assert time.monotonic() < deadline, "the preheat job stayed PENDING for 60 s"
            time.sleep(0.02)
        assert state == "SUCCESS"
        with concurrent.futures.ThreadPoolExecutor(daemons) as pool:
            fetched = list(pool.map(lambda d: chip_smoke._s3_proxy_fetch(int(d.ready[4]), url),
                                    dfs))
        want = hashlib.sha256(blob).hexdigest()
        assert [(f[0], f[1], f[3]) for f in fetched] == [(200, want, "p2p")] * daemons, \
            [(f[0], f[3], f[4][:200]) for f in fetched]
        assert stub.served[chip_smoke.OBJ_BUCKET, chip_smoke.OBJ_KEY] == size  # the seed's pulls
        assert not chip_smoke._seed_cost_verdict(
            os.path.join(root, "seed"), idgen.task_id_v1(url))[0]
        stops = {p.name: p.stop() for p in reversed(procs)}
        assert max(stops.values()) < 10, stops
    finally:
        for p in procs:
            p.kill()
        stub.stop()
