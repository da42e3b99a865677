"""The port's preheat jobs (cluster/jobs.py, cluster/image_preheat.py)
against the reference's.

The cases of tests/test_jobs.py and tests/test_image_preheat.py run on the
port, its SchedulerService on the CPU: the hash-ring fan-out, a trigger
queued for a late seed, the daemons' task-id derivation, sync_peers into
the manager's peers table, the live job states (a retried task recovers,
SUCCESS latches per task across GC, a failure observation survives GC, a
vanished task expires the job, an undelivered trigger expires it), the
registry manifest walk over a local OCI registry, and an image preheat
warmed by a seed daemon over the wire. Then the parity cases: both
packages' JobManagers, fed the same URLs and the same scripted scheduler
replies, give the same task ids, the same triggers and the same sequence
of job states and details.
"""

from __future__ import annotations

import asyncio
import hashlib
import http.server
import json
import threading
import time

import pytest

from dragonfly2_tpu.cluster import jobs as ref_jobs
from dragonfly2_tpu.utils import idgen as ref_idgen
from dragonfly2_tpu_torch.cluster import image_preheat
from dragonfly2_tpu_torch.cluster import jobs as port_jobs
from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.cluster.jobs import JobManager, JobState, PreheatRequest
from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
from dragonfly2_tpu_torch.state.fsm import TaskEvent, TaskState
from dragonfly2_tpu_torch.utils import dferrors, idgen


def _svc(**kw) -> SchedulerService:
    return SchedulerService(device="cpu", **kw)


def seed_host(i):
    return msg.HostInfo(host_id=f"seed-{i}", hostname=f"seed-{i}", ip=f"10.1.0.{i}",
                        host_type="super")


def _register(svc, peer_id, tid, url="https://e.com/blob"):
    svc.register_peer(msg.RegisterPeerRequest(
        peer_id=peer_id, task_id=tid, host=seed_host(0), url=url, content_length=10 << 20))


# ------------------------------------------------------------------- jobs


def test_preheat_fans_out_by_hash_ring():
    schedulers = {"s1": _svc(), "s2": _svc()}
    jm = JobManager(schedulers, [seed_host(0), seed_host(1)])
    urls = [f"https://reg.example.com/layers/{i}" for i in range(12)]
    result = jm.create_preheat(PreheatRequest(urls=urls, tag="preheat"))
    assert result.state == JobState.PENDING
    assert len(result.task_ids) == 12
    assert sum(len(s.seed_triggers) for s in schedulers.values()) == 12
    assert schedulers["s1"].seed_triggers and schedulers["s2"].seed_triggers
    assert {t.task_id for s in schedulers.values() for t in s.seed_triggers} == set(
        result.task_ids)
    # the seed hosts take turns
    assert {t.host_id for s in schedulers.values() for t in s.seed_triggers} == {
        "seed-0", "seed-1"}
    jm2 = JobManager({"s1": _svc(), "s2": _svc()}, [seed_host(0)])
    assert jm2.create_preheat(PreheatRequest(urls=urls, tag="preheat")).task_ids == (
        result.task_ids)


def test_preheat_without_seeds_queues_for_late_seed():
    svc = _svc()
    jm = JobManager({"s1": svc}, [])
    result = jm.create_preheat(PreheatRequest(urls=["https://e.com/x"]))
    assert result.state == JobState.PENDING
    assert jm.get(result.job_id) is result
    assert len(svc.seed_triggers) == 1 and svc.seed_triggers[0].host_id == ""


def test_preheat_task_id_matches_daemon_derivation():
    url = "https://cdn.example.com/blob?v=1&token=abc&x=2"
    svc = _svc()
    jm = JobManager({"s1": svc}, [seed_host(0)])
    result = jm.create_preheat(
        PreheatRequest(urls=[url], tag="t", filtered_query_params=["v", "token"]))
    want = idgen.task_id_v1(url, tag="t", filtered_query_params="v&token")
    assert result.task_ids == [want]
    assert svc.seed_triggers[0].task_id == want


def test_sync_peers_merges_hosts_into_manager_db():
    from dragonfly2_tpu_torch.manager.models import Database
    from dragonfly2_tpu_torch.manager.service import ManagerService

    svc = _svc()
    svc.announce_host(msg.HostInfo(host_id="h-1", hostname="peer-1", ip="10.0.0.1"))
    svc.announce_host(msg.HostInfo(host_id="h-2", hostname="seed-1", ip="10.0.0.2",
                                   host_type="super"))
    mgr = ManagerService(Database(), jobs=JobManager({"s1": svc}, [seed_host(0)]))
    record = mgr.create_job({"type": "sync_peers"})
    assert record["state"] == "SUCCESS"
    assert record["result"]["s1"]["hosts"] == 2
    assert {h["hostname"] for h in record["result"]["s1"]["announced_hosts"]} == {
        "peer-1", "seed-1"}
    assert {(r["host_name"], r["type"], r["state"]) for r in mgr.db.list("peers")} == {
        ("peer-1", "normal", "active"), ("seed-1", "super", "active")}
    mgr.create_job({"type": "sync_peers"})
    assert len(mgr.db.list("peers")) == 2
    svc.leave_host("h-1")
    mgr.create_job({"type": "sync_peers"})
    by_name = {r["host_name"]: r for r in mgr.db.list("peers")}
    assert by_name["peer-1"]["state"] == "inactive"
    assert by_name["seed-1"]["state"] == "active"


def test_preheat_job_state_recovers_after_task_retry():
    svc = _svc()
    svc.announce_host(seed_host(0))
    jm = JobManager({"s1": svc}, [seed_host(0)])
    result = jm.create_preheat(PreheatRequest(urls=["https://e.com/blob"]))
    tid = result.task_ids[0]
    _register(svc, "p-1", tid)
    idx = svc.state.task_index(tid)
    svc.state.task_event(idx, TaskEvent.DOWNLOAD_FAILED)
    assert jm.get(result.job_id).state == JobState.FAILURE
    svc.back_to_source_started(msg.DownloadPeerBackToSourceStartedRequest(peer_id="p-1"))
    svc.back_to_source_finished(
        msg.DownloadPeerBackToSourceFinishedRequest(peer_id="p-1", piece_count=3))
    assert svc.state.task_state[idx] == int(TaskState.SUCCEEDED)
    assert jm.get(result.job_id).state == JobState.SUCCESS


def test_preheat_empty_url_list_is_immediate_success():
    jm = JobManager({"s1": _svc()}, [seed_host(0)])
    result = jm.create_preheat(PreheatRequest(urls=[]))
    assert result.state == JobState.SUCCESS
    assert jm.get(result.job_id).state == JobState.SUCCESS


def test_preheat_success_is_terminal_after_scheduler_forgets_task():
    svc = _svc()
    svc.announce_host(seed_host(0))
    jm = JobManager({"s1": svc}, [seed_host(0)])
    result = jm.create_preheat(PreheatRequest(urls=["https://e.com/blob"]))
    tid = result.task_ids[0]
    _register(svc, "p-1", tid)
    svc.state.task_event(svc.state.task_index(tid), TaskEvent.DOWNLOAD_SUCCEEDED)
    assert jm.get(result.job_id).state == JobState.SUCCESS
    jm.schedulers["s1"] = _svc()
    assert jm.get(result.job_id).state == JobState.SUCCESS


def test_preheat_per_task_success_latches_across_gc():
    svc = _svc()
    svc.announce_host(seed_host(0))
    jm = JobManager({"s1": svc}, [seed_host(0)])
    result = jm.create_preheat(PreheatRequest(urls=["https://e.com/a", "https://e.com/b"]))
    tid_a, tid_b = result.task_ids
    _register(svc, "p-a", tid_a)
    _register(svc, "p-b", tid_b)
    svc.state.task_event(svc.state.task_index(tid_a), TaskEvent.DOWNLOAD_SUCCEEDED)
    assert jm.get(result.job_id).state == JobState.PENDING
    svc.state.remove_task(tid_a)
    assert svc.state.task_index(tid_a) is None
    svc.state.task_event(svc.state.task_index(tid_b), TaskEvent.DOWNLOAD_SUCCEEDED)
    assert jm.get(result.job_id).state == JobState.SUCCESS


def test_preheat_failure_observation_survives_task_gc():
    svc = _svc()
    svc.announce_host(seed_host(0))
    jm = JobManager({"s1": svc}, [seed_host(0)])
    result = jm.create_preheat(PreheatRequest(urls=["https://e.com/blob"]))
    tid = result.task_ids[0]
    _register(svc, "p-1", tid)
    svc.state.task_event(svc.state.task_index(tid), TaskEvent.DOWNLOAD_FAILED)
    assert jm.get(result.job_id).state == JobState.FAILURE
    jm.schedulers["s1"] = _svc()
    assert jm.get(result.job_id).state == JobState.FAILURE


def test_preheat_expires_when_unfinished_task_vanishes():
    svc = _svc()
    svc.announce_host(seed_host(0))
    jm = JobManager({"s1": svc}, [seed_host(0)])
    result = jm.create_preheat(PreheatRequest(urls=["https://e.com/blob"]))
    _register(svc, "p-1", result.task_ids[0])
    assert jm.get(result.job_id).state == JobState.PENDING
    jm.schedulers["s1"] = _svc()
    assert jm.get(result.job_id).state == JobState.EXPIRED
    result2 = jm.create_preheat(PreheatRequest(urls=["https://e.com/c"]))
    assert jm.get(result2.job_id).state == JobState.PENDING


def test_partially_undelivered_preheat_expires():
    svc = _svc()
    jm = JobManager({"s1": svc}, [seed_host(0)])
    result = jm.create_preheat(PreheatRequest(urls=["https://e.com/a", "https://e.com/b"]))
    trig = svc.seed_triggers[0]
    svc.register_peer(msg.RegisterPeerRequest(
        peer_id="seed-p", task_id=trig.task_id, host=seed_host(0), url=trig.url,
        content_length=8 << 20, piece_length=4 << 20, total_piece_count=2, priority=1))
    svc.back_to_source_started(msg.DownloadPeerBackToSourceStartedRequest(peer_id="seed-p"))
    svc.back_to_source_finished(msg.DownloadPeerBackToSourceFinishedRequest(
        peer_id="seed-p", content_length=8 << 20, piece_count=2))
    assert jm.get(result.job_id).state == JobState.PENDING
    result.created_at = time.monotonic() - 1000  # the start TTL long past
    got = jm.get(result.job_id)
    assert got.state == JobState.EXPIRED
    assert len(got.detail["undelivered_task_ids"]) == 1


def test_update_schedulers_keeps_entries_by_name():
    a, b = _svc(), _svc()
    jm = JobManager({"s1": a}, [])
    jm.update_schedulers({"s1": _svc(), "s2": b})
    assert jm.schedulers["s1"] is a and jm.schedulers["s2"] is b
    adopted = jm.adopt("job-x", ["t1", "t2"])
    assert adopted.state == JobState.PENDING and jm.adopt("job-x", []) is adopted


# ------------------------------------------------------------ image preheat


class FakeRegistry:
    """Minimal OCI distribution server: bearer-token challenge, manifest
    list -> per-platform manifests -> blobs (config + 2 layers), as in
    tests/test_image_preheat.py."""

    TOKEN = "test-token-123"

    def __init__(self, require_auth: bool = True):
        self.require_auth = require_auth
        self.layer_a = b"layer-a " + bytes(range(256)) * 200
        self.layer_b = b"layer-b " + bytes(reversed(range(256))) * 300
        self.config_blob = json.dumps({"architecture": "amd64"}).encode()
        self.blobs = {"sha256:" + hashlib.sha256(b).hexdigest(): b
                      for b in (self.layer_a, self.layer_b, self.config_blob)}
        self.digest_a = "sha256:" + hashlib.sha256(self.layer_a).hexdigest()
        self.digest_b = "sha256:" + hashlib.sha256(self.layer_b).hexdigest()
        self.digest_cfg = "sha256:" + hashlib.sha256(self.config_blob).hexdigest()
        layer = "application/vnd.docker.image.rootfs.diff.tar.gzip"
        self.amd64_manifest = {
            "schemaVersion": 2,
            "mediaType": "application/vnd.docker.distribution.manifest.v2+json",
            "config": {"mediaType": "application/vnd.docker.container.image.v1+json",
                       "digest": self.digest_cfg, "size": len(self.config_blob)},
            "layers": [{"mediaType": layer, "digest": self.digest_a, "size": len(self.layer_a)},
                       {"mediaType": layer, "digest": self.digest_b, "size": len(self.layer_b)}],
        }
        self.amd64_digest = "sha256:" + hashlib.sha256(
            json.dumps(self.amd64_manifest).encode()).hexdigest()
        self.manifest_list = {
            "schemaVersion": 2,
            "mediaType": "application/vnd.docker.distribution.manifest.list.v2+json",
            "manifests": [
                {"mediaType": "application/vnd.docker.distribution.manifest.v2+json",
                 "digest": self.amd64_digest,
                 "platform": {"architecture": "amd64", "os": "linux"}},
                {"mediaType": "application/vnd.docker.distribution.manifest.v2+json",
                 "digest": "sha256:" + "0" * 64,
                 "platform": {"architecture": "s390x", "os": "linux"}},
            ],
        }
        self.token_requests, self.manifest_requests = [], []
        registry = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _authed(self) -> bool:
                return (not registry.require_auth
                        or self.headers.get("Authorization") == f"Bearer {registry.TOKEN}")

            def _challenge(self):
                self.send_response(401)
                self.send_header("WWW-Authenticate",
                                 f'Bearer realm="http://127.0.0.1:{registry.port}/token",'
                                 f'service="registry",scope="repository:testrepo:pull"')
                self.send_header("Content-Length", "0")
                self.end_headers()

            def _json(self, obj, content_type="application/json"):
                body = json.dumps(obj).encode()
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _blob(self, head: bool):
                blob = registry.blobs.get(self.path.rsplit("/", 1)[1])
                if blob is None:
                    self.send_error(404)
                    return
                start, end, status = 0, len(blob) - 1, 200
                rng = self.headers.get("Range")
                if rng and rng.startswith("bytes="):
                    lo, _, hi = rng[len("bytes="):].partition("-")
                    start, end, status = int(lo or 0), int(hi) if hi else len(blob) - 1, 206
                chunk = blob[start:end + 1]
                self.send_response(status)
                self.send_header("Content-Length", str(len(chunk)))
                if status == 206:
                    self.send_header("Content-Range", f"bytes {start}-{end}/{len(blob)}")
                self.end_headers()
                if not head:
                    self.wfile.write(chunk)

            def do_GET(self):
                if self.path.startswith("/token"):
                    registry.token_requests.append(self.headers.get("Authorization"))
                    self._json({"token": registry.TOKEN})
                elif not self._authed():
                    self._challenge()
                elif self.path == "/v2/testrepo/manifests/latest":
                    registry.manifest_requests.append(self.path)
                    self._json(registry.manifest_list, registry.manifest_list["mediaType"])
                elif self.path == f"/v2/testrepo/manifests/{registry.amd64_digest}":
                    registry.manifest_requests.append(self.path)
                    self._json(registry.amd64_manifest, registry.amd64_manifest["mediaType"])
                elif self.path.startswith("/v2/testrepo/blobs/"):
                    self._blob(head=False)
                else:
                    self.send_error(404)

            def do_HEAD(self):
                if not self._authed():
                    self._challenge()
                elif self.path.startswith("/v2/testrepo/blobs/"):
                    self._blob(head=True)
                else:
                    self.send_error(404)

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def manifest_url(self) -> str:
        return f"http://127.0.0.1:{self.port}/v2/testrepo/manifests/latest"

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


@pytest.fixture
def registry():
    r = FakeRegistry()
    yield r
    r.stop()


def test_resolver_walks_list_to_platform_layers(registry):
    layers = image_preheat.resolve_image_layers(
        registry.manifest_url(), username="u", password="p", platform="linux/amd64")
    assert [layer.digest for layer in layers] == [
        registry.digest_cfg, registry.digest_a, registry.digest_b]
    for layer in layers:
        assert layer.url.endswith("/v2/testrepo/blobs/" + layer.digest)
        assert layer.headers["Authorization"] == f"Bearer {registry.TOKEN}"
    assert registry.token_requests and registry.token_requests[0].startswith("Basic ")
    assert len(registry.manifest_requests) == 2


def test_resolver_no_platform_match(registry):
    with pytest.raises(dferrors.NotFound, match="no matching manifest"):
        image_preheat.resolve_image_layers(registry.manifest_url(), platform="linux/riscv64")


def test_resolver_rejects_non_image_url():
    assert not image_preheat.is_image_url("http://example.com/some/file.bin")
    with pytest.raises(dferrors.InvalidArgument):
        image_preheat.resolve_image_layers("http://example.com/some/file.bin")


def test_resolved_layers_equal_the_reference(registry):
    from dragonfly2_tpu.cluster import image_preheat as ref_preheat

    args = (registry.manifest_url(),)
    kw = {"username": "u", "password": "p", "platform": "linux/amd64"}
    got = image_preheat.resolve_image_layers(*args, **kw)
    want = ref_preheat.resolve_image_layers(*args, **kw)
    assert [(g.url, g.digest, g.headers) for g in got] == [
        (w.url, w.digest, w.headers) for w in want]


def test_image_preheat_e2e_through_seed(tmp_path, registry):
    """Fake registry -> image preheat -> the seed daemon warms config and
    layers through the port's scheduler on the CPU; the job reaches
    SUCCESS and every blob's sha256 matches."""
    from dragonfly2_tpu_torch.client.daemon import Daemon
    from dragonfly2_tpu_torch.config.config import Config
    from dragonfly2_tpu_torch.rpc.server import SchedulerRPCServer

    async def run():
        cfg = Config()
        cfg.scheduler.max_hosts = 16
        cfg.scheduler.max_tasks = 16
        service = _svc(config=cfg)
        server = SchedulerRPCServer(service, tick_interval=0.01)
        host, port = await server.start()
        try:
            seed = Daemon(tmp_path / "seed", [(host, port)], hostname="seed-1",
                          host_type="super")
            await seed.start()
            for _ in range(100):
                if service._seed_hosts:
                    break
                await asyncio.sleep(0.05)
            assert service._seed_hosts == [seed.host_id]
            jm = JobManager({"s1": service}, seed_hosts=[
                msg.HostInfo(host_id=seed.host_id, hostname="seed-1")])
            result = jm.create_preheat(PreheatRequest(
                urls=[registry.manifest_url()], preheat_type="image", username="u",
                password="p", platform="linux/amd64", piece_length=64 * 1024))
            assert result.state == JobState.PENDING, result.detail
            assert len(result.task_ids) == 3
            for _ in range(200):
                if jm.get(result.job_id).state == JobState.SUCCESS:
                    break
                await asyncio.sleep(0.1)
            else:
                raise AssertionError(f"preheat never reached SUCCESS: {jm.get(result.job_id)}")
            for tid, blob in zip(result.task_ids,
                                 (registry.config_blob, registry.layer_a, registry.layer_b)):
                ts = seed.storage.find_completed_task(tid)
                with open(ts.data_path, "rb") as f:
                    assert hashlib.sha256(f.read()).digest() == hashlib.sha256(blob).digest()
            await seed.stop()
        finally:
            await server.stop()

    asyncio.run(run())


# ------------------------------------------------------------------ parity


class ScriptedScheduler:
    """A scheduler whose replies are a script: trigger_seed_download
    answers from ``accept`` and records the trigger; each task_states call
    takes the next row of ``polls`` (a dict task-index -> state, or
    "down" for a transport failure); unlisted tasks are unknown."""

    def __init__(self, polls, accept=True):
        self.polls, self.accept = list(polls), accept
        self.triggers, self.task_ids = [], []

    def trigger_seed_download(self, task_id, url, piece_length=4 << 20, tag="",
                              application="", host_id="", headers=None):
        self.triggers.append((task_id, url, piece_length, tag, application, host_id,
                              headers))
        self.task_ids.append(task_id)
        return self.accept

    def task_states(self, task_ids):
        row = self.polls.pop(0) if self.polls else {}
        if row == "down":
            raise ConnectionError("scheduler unreachable")
        return [row.get(self.task_ids.index(t)) for t in task_ids]


P, R, S, F = (int(s) for s in (TaskState.PENDING, TaskState.RUNNING, TaskState.SUCCEEDED,
                              TaskState.FAILED))

SCRIPTS = {
    # every task runs, then succeeds
    "success": [{}, {0: P, 1: R}, "down", {0: S, 1: R, 2: R}, {1: S, 2: S}],
    # one task fails, then a retry recovers it
    "retry": [{0: R, 1: R, 2: R}, {0: F, 1: S, 2: R}, {0: R, 2: S}, {0: S}],
    # a task seen running vanishes: the job expires; then it reappears
    "expire": [{0: R, 1: R, 2: R}, {0: S, 1: S}, {2: R}, {2: S}],
    # a failure observation survives the task's disappearance
    "failure-gc": [{0: F, 1: S, 2: S}, {}, {}],
}


def _play_script(jobs_mod, script, names=("s1", "s2"), accept=True):
    schedulers = {n: ScriptedScheduler(SCRIPTS[script], accept) for n in names}
    seeds = [jobs_mod.msg.HostInfo(host_id=f"seed-{i}", hostname=f"seed-{i}") for i in range(2)]
    jm = jobs_mod.JobManager(schedulers, seeds)
    urls = [f"https://reg.example.com/blob/{i}?token=t{i}&v=2" for i in range(3)]
    result = jm.create_preheat(jobs_mod.PreheatRequest(
        urls=urls, tag="tag-a", application="app", piece_length=1 << 20,
        filtered_query_params=["token"]))
    states = [(result.state.value, dict(result.detail))]
    for _ in SCRIPTS[script]:
        got = jm.get(result.job_id)
        states.append((got.state.value, {k: v for k, v in got.detail.items()}))
    triggers = {n: s.triggers for n, s in schedulers.items()}
    return result.task_ids, triggers, states


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_job_states_equal_the_reference_on_scripted_replies(script):
    got = _play_script(port_jobs, script)
    want = _play_script(ref_jobs, script)
    assert got == want
    task_ids, triggers, states = got
    assert task_ids == [ref_idgen.task_id_v1(
        f"https://reg.example.com/blob/{i}?token=t{i}&v=2", tag="tag-a", application="app",
        filtered_query_params="token") for i in range(3)]
    assert sum(len(t) for t in triggers.values()) == 3
    assert states[0][0] == "PENDING" and len(states) == len(SCRIPTS[script]) + 1


def test_rejected_triggers_fail_the_job_in_both_packages():
    got = _play_script(port_jobs, "success", accept=False)
    want = _play_script(ref_jobs, "success", accept=False)
    assert got == want
    assert {state for state, _ in got[2]} == {"FAILURE"}


@pytest.mark.parametrize("kw,failed", [
    ({"preheat_type": "image"}, 2),  # every URL taken as an image
    ({}, 1),  # the type sniffed per URL: the file URL goes out as a file
])
def test_unresolvable_image_fails_only_its_url_in_both_packages(kw, failed):
    """The manifest URL names a local port no registry answers."""
    urls = ["http://127.0.0.1:9/v2/repo/manifests/latest", "https://e.com/file"]
    out = []
    for jobs_mod in (port_jobs, ref_jobs):
        sched = ScriptedScheduler([])
        jm = jobs_mod.JobManager({"s1": sched}, [])
        result = jm.create_preheat(jobs_mod.PreheatRequest(urls=urls, **kw))
        out.append((result.state.value, sorted(result.detail["failures"]), result.task_ids,
                    sched.triggers))
    assert out[0] == out[1]
    assert out[0][0] == "FAILURE" and out[0][1] == sorted(urls[:failed])
    assert len(out[0][2]) == 2 - failed
