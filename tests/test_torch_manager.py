"""The port's manager (dragonfly2_tpu_torch/manager/) against the reference's.

The cases of tests/test_manager.py run on the port: the SQLite Database,
password hashing, tokens, RBAC and personal access tokens, the searcher,
the service (users, clusters, registration and keepalive, the ranked
scheduler list, the dynconfig payload, the model lifecycle over the
port's ModelRegistry, certificate issuance), REST over HTTP with its auth
matrix, the RPC, OAuth against a local stub provider, the console and the
swagger document. Then the parity cases feed the same seeded inputs to
both packages and require equality: the sqlite_master schema, searcher
scores and rankings (exact: float math in Python), tokens for one secret
under a pinned clock, scheduler_dynconfig payloads and openapi_spec; and
the manager RPC across the packages both ways, each package's
ManagerClient against the other's ManagerRPCServer.
"""

from __future__ import annotations

import asyncio
import json
import sqlite3
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from dragonfly2_tpu.manager import auth as ref_auth
from dragonfly2_tpu.manager import rest as ref_rest
from dragonfly2_tpu.manager import rpc as ref_rpc
from dragonfly2_tpu.manager import searcher as ref_searcher
from dragonfly2_tpu.manager.models import Database as RefDatabase
from dragonfly2_tpu.manager.service import ManagerService as RefManagerService
from dragonfly2_tpu_torch.manager import auth
from dragonfly2_tpu_torch.manager import rest as port_rest
from dragonfly2_tpu_torch.manager import rpc as mrpc
from dragonfly2_tpu_torch.manager import searcher as msearcher
from dragonfly2_tpu_torch.manager.models import Database, DuplicateRecord, RecordNotFound
from dragonfly2_tpu_torch.manager.rest import ManagerREST
from dragonfly2_tpu_torch.manager.service import ManagerService

PINNED_NOW = 1_700_000_000.0


def _run_async(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


# ------------------------------------------------------------------ database


def test_database_crud_roundtrip():
    db = Database()
    rec = db.create("applications", {"name": "app-1", "url": "http://x", "priority": {"value": 3}})
    assert rec["id"] == 1 and rec["priority"] == {"value": 3}
    assert db.get("applications", 1)["name"] == "app-1"
    db.update("applications", 1, {"bio": "hello"})
    assert db.get("applications", 1)["bio"] == "hello"
    assert db.count("applications") == 1
    db.delete("applications", 1)
    with pytest.raises(RecordNotFound):
        db.get("applications", 1)


def test_database_unique_key_enforced():
    db = Database()
    db.create("schedulers", {"host_name": "h", "ip": "1.2.3.4", "scheduler_cluster_id": 1})
    with pytest.raises(DuplicateRecord):
        db.create("schedulers", {"host_name": "h", "ip": "1.2.3.4", "scheduler_cluster_id": 1})
    # the unique key is composite (manager/models/scheduler.go)
    db.create("schedulers", {"host_name": "h", "ip": "1.2.3.4", "scheduler_cluster_id": 2})


def test_database_list_where_and_pagination():
    db = Database()
    for i in range(7):
        db.create("jobs", {"type": "preheat", "state": "PENDING" if i % 2 else "SUCCESS"})
    assert len(db.list("jobs", {"state": "PENDING"})) == 3
    assert len(db.list("jobs", page=2, per_page=5)) == 2
    with pytest.raises(ValueError, match="bad filter key"):
        db.list("jobs", {"state') OR 1=1 --": "x"})


# ---------------------------------------------------------------------- auth


def test_password_hash_and_verify():
    enc = auth.hash_password("s3cret")
    assert auth.verify_password("s3cret", enc)
    assert not auth.verify_password("wrong", enc)
    assert not auth.verify_password("s3cret", "no-dollar-sign")


def test_token_issue_verify_expiry_refresh():
    ta = auth.TokenAuthority(ttl=100)
    token = ta.issue(7, "alice")
    claims = ta.verify(token)
    assert claims["id"] == 7 and claims["name"] == "alice"
    assert ta.verify(token + "x") is None
    assert ta.verify(token, now=time.time() + 200) is None
    assert ta.verify(ta.refresh(token)) is not None


def test_rbac_root_all_guest_read():
    db = Database()
    enforcer = auth.Enforcer(db)
    enforcer.init_policies()
    enforcer.add_role_for_user("admin", auth.ROOT_ROLE)
    enforcer.add_role_for_user("bob", auth.GUEST_ROLE)
    assert enforcer.enforce("admin", "clusters", "*")
    assert enforcer.enforce("bob", "clusters", "read")
    assert not enforcer.enforce("bob", "clusters", "*")
    assert not enforcer.enforce("nobody", "clusters", "read")
    enforcer.delete_role_for_user("bob", auth.GUEST_ROLE)
    assert not enforcer.enforce("bob", "clusters", "read")


def test_personal_access_token_verification():
    db = Database()
    now = time.time()
    db.create("personal_access_tokens",
              {"name": "t", "token": "tok123", "state": "active", "expired_at": now + 60})
    assert auth.verify_personal_access_token(db, "tok123") is not None
    assert auth.verify_personal_access_token(db, "nope") is None
    assert auth.verify_personal_access_token(db, "tok123", now=now + 120) is None


# ------------------------------------------------------------------ searcher


def test_searcher_weights_match_reference():
    # cidr(0.3) + hostname(0.3) + idc(0.25) + location(0.14) + default(0.01)
    scopes = msearcher.Scopes(
        idc="idc-a", location="area|zone|rack", cidrs=["10.0.0.0/8"], hostnames=["worker-.*"]
    )
    score = msearcher.evaluate(
        "10.1.2.3", "worker-7", {"idc": "idc-a", "location": "area|zone|rack"}, scopes, True
    )
    assert score == pytest.approx(1.0)
    partial = msearcher.multi_element_affinity_score("area|zone|other", "area|zone|rack")
    assert partial == pytest.approx(2 / 5)
    assert msearcher.idc_affinity_score("b", "a|b|c") == 1.0
    assert msearcher.cidr_affinity_score("192.168.1.1", ["10.0.0.0/8"]) == 0.0


def test_searcher_ranks_and_filters_clusters():
    s = msearcher.Searcher()
    near = {"name": "near", "scopes": {"idc": "idc-a"}, "is_default": False,
            "schedulers": [{"host_name": "s1"}]}
    far = {"name": "far", "scopes": {"idc": "idc-z"}, "is_default": True,
           "schedulers": [{"host_name": "s2"}]}
    empty = {"name": "empty", "scopes": {}, "is_default": True, "schedulers": []}
    ranked = s.find_scheduler_clusters([far, near, empty], "1.1.1.1", "h", {"idc": "idc-a"})
    assert [c["name"] for c in ranked] == ["near", "far"]
    with pytest.raises(ValueError):
        s.find_scheduler_clusters([empty], "1.1.1.1", "h", {})


SEARCHER_PLUGIN = """
class ByName:
    def find_scheduler_clusters(self, clusters, ip, hostname, conditions=None):
        return sorted(clusters, key=lambda c: c["name"])


def dragonfly_plugin_init(options):
    return ByName()
"""


def test_searcher_plugin_overrides_the_default(tmp_path, monkeypatch):
    """new_searcher loads df_searcher_plugin_<name>.py from the plugin dir
    (searcher.go New: plugin first), falling back to the default when no
    such plugin exists."""
    import sys

    (tmp_path / "df_searcher_plugin_bynamefirst.py").write_text(SEARCHER_PLUGIN)
    plugged = msearcher.new_searcher(str(tmp_path), name="bynamefirst")
    monkeypatch.delitem(sys.modules, "df_searcher_plugin_bynamefirst")
    assert type(plugged).__name__ == "ByName"
    clusters = [{"name": "b"}, {"name": "a"}]
    assert [c["name"] for c in plugged.find_scheduler_clusters(clusters, "", "")] == ["a", "b"]
    fallback = msearcher.new_searcher(str(tmp_path), name="absent")
    assert isinstance(fallback, msearcher.Searcher)


# ------------------------------------------------------------------- service


def make_service(**kw) -> ManagerService:
    return ManagerService(Database(), **kw)


def test_service_root_user_and_signin():
    svc = make_service()
    claims = svc.tokens.verify(svc.sign_in("root", "dragonfly"))
    assert claims["name"] == "root"
    assert svc.enforcer.enforce("root", "users", "*")
    with pytest.raises(PermissionError):
        svc.sign_in("root", "wrong")


def test_service_signup_gets_guest_role():
    svc = make_service()
    user = svc.sign_up("alice", "pw")
    assert "encrypted_password" not in user
    assert svc.enforcer.roles_for_user("alice") == [auth.GUEST_ROLE]


def test_service_cluster_composite():
    svc = make_service()
    cluster = svc.create_cluster({"name": "c1", "scopes": {"idc": "a"}})
    assert svc.db.count("scheduler_clusters") == 1
    assert svc.db.count("seed_peer_clusters") == 1
    svc.delete_cluster(cluster["id"])
    assert svc.db.count("scheduler_clusters") == 0
    assert svc.db.count("clusters") == 0


def test_service_keepalive_flips_state():
    svc = make_service()
    svc.create_cluster({"name": "c1"})
    rec = svc.register_scheduler(
        {"host_name": "sched-1", "ip": "10.0.0.1", "port": 8002, "scheduler_cluster_id": 1})
    assert rec["state"] == "inactive"
    svc.keepalive("scheduler", "sched-1", "10.0.0.1", 1)
    assert svc.db.get("schedulers", rec["id"])["state"] == "active"
    # a silent instance flips back on the sweep
    svc.db.update("schedulers", rec["id"], {"keepalive_at": time.time() - 120})
    assert svc.expire_keepalives(timeout=60) == 1
    assert svc.db.get("schedulers", rec["id"])["state"] == "inactive"
    with pytest.raises(RecordNotFound):
        svc.keepalive("scheduler", "ghost", "0.0.0.0", 1)
    # re-registration upserts by the unique key
    again = svc.register_scheduler(
        {"host_name": "sched-1", "ip": "10.0.0.1", "port": 9002, "scheduler_cluster_id": 1})
    assert again["id"] == rec["id"] and again["port"] == 9002


def test_service_list_schedulers_ranked():
    svc = make_service()
    svc.create_cluster({"name": "a", "scopes": {"idc": "idc-a"}})
    svc.create_cluster({"name": "b", "scopes": {"idc": "idc-b"}})
    for i, cid in ((1, 1), (2, 2)):
        svc.register_scheduler(
            {"host_name": f"s{i}", "ip": f"10.0.0.{i}", "port": 8002, "scheduler_cluster_id": cid})
        svc.keepalive("scheduler", f"s{i}", f"10.0.0.{i}", cid)
    ranked = svc.list_schedulers("1.1.1.1", "host", {"idc": "idc-b"})
    assert [s["host_name"] for s in ranked] == ["s2", "s1"]


def test_service_dynconfig_payload():
    svc = make_service()
    svc.create_cluster({"name": "c1", "scheduler_cluster_config": {"x": 1}})
    svc.register_seed_peer(
        {"host_name": "seed", "ip": "10.0.0.9", "port": 8002, "seed_peer_cluster_id": 1})
    payload = svc.scheduler_dynconfig(1)
    assert payload["scheduler_cluster_config"] == {"x": 1}
    assert payload["seed_peers"][0]["host_name"] == "seed"


def test_service_model_lifecycle(tmp_path):
    from dragonfly2_tpu_torch.registry.registry import ModelEvaluation, ModelRegistry

    registry = ModelRegistry(tmp_path / "models")
    svc = make_service(registry=registry)
    params = {"dense": {"kernel": np.ones((2, 2), np.float32)}}
    svc.create_model("ranker", "gnn", "host-1", params, ModelEvaluation(recall=0.9))
    rec2 = svc.create_model("ranker", "gnn", "host-1", params, ModelEvaluation(recall=0.95))
    assert rec2["version"] == 2 and rec2["evaluation"]["recall"] == 0.95
    svc.activate_model(rec2["model_id"], 2)
    assert {r["version"]: r["state"] for r in svc.db.list("models")} == {
        1: "inactive", 2: "active"}
    assert registry.active_version(rec2["model_id"]).version == 2
    with pytest.raises(RuntimeError, match="no model registry"):
        make_service().create_model("ranker", "gnn", "h", params, ModelEvaluation())


def test_service_issues_certificates_behind_the_enrollment_token(tmp_path):
    from cryptography import x509

    from dragonfly2_tpu_torch.utils import certs

    svc = make_service(cert_dir=str(tmp_path / "ca"), enrollment_token="enroll")
    csr, _ = certs.generate_csr("scheduler", ["127.0.0.1"])
    with pytest.raises(PermissionError, match="enrollment token"):
        svc.issue_certificate(csr, token="wrong")
    leaf, ca = svc.issue_certificate(csr, token="enroll")
    cert = x509.load_pem_x509_certificate(leaf)
    assert cert.subject.get_attributes_for_oid(x509.NameOID.COMMON_NAME)[0].value == "scheduler"
    assert ca == (tmp_path / "ca" / "ca.pem").read_bytes()
    # a restarted manager signs from the same persisted root
    again = make_service(cert_dir=str(tmp_path / "ca"), enrollment_token="enroll")
    assert again.issue_certificate(csr, token="enroll")[1] == ca
    with pytest.raises(RuntimeError, match="cert_dir"):
        make_service().issue_certificate(csr)


def test_flight_recorder_waits_for_its_dump():
    """The manager's flight recorder, refused before A10, now the
    reference's: its own section (every dump section, no scheduler's tick
    ring claimed) and one section a job scheduler, an unreachable one an
    error entry; the same shape as the reference's body."""
    from dragonfly2_tpu_torch.cluster.jobs import JobManager, RemoteScheduler
    from dragonfly2_tpu_torch.telemetry import flight

    svc = make_service()
    out = svc.flight_recorder(8)
    ref = RefManagerService(RefDatabase()).flight_recorder(8)
    assert set(out) == set(ref) == {"manager", "schedulers"}
    assert set(out["manager"]) - {"truncated"} == {"generated_at_ns", *flight.DUMP_SECTIONS}
    assert set(out["manager"]) == set(ref["manager"])
    assert out["manager"]["ticks"] == {"ticks_total": 0, "p50_ms": {}, "last": []}
    svc.jobs = JobManager({"gone": RemoteScheduler("127.0.0.1", 9)})
    assert "error" in svc.flight_recorder(8)["schedulers"]["gone"]


# ---------------------------------------------------------------------- REST


@pytest.fixture()
def rest_server():
    server = ManagerREST(make_service())
    server.start()
    yield server
    server.stop()


def _http(server, method: str, path: str, body=None, token=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://{server.host}:{server.port}{path}", data=data,
                                 method=method)
    req.add_header("Content-Type", "application/json")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _root_token(server) -> str:
    _, out = _http(server, "POST", "/api/v1/users/signin",
                   {"name": "root", "password": "dragonfly"})
    return out["token"]


def test_rest_signin_and_crud(rest_server):
    token = _root_token(rest_server)
    status, cluster = _http(rest_server, "POST", "/api/v1/clusters",
                            {"name": "c1", "is_default": True}, token)
    assert status == 200 and cluster["name"] == "c1"
    status, clusters = _http(rest_server, "GET", "/api/v1/clusters", None, token)
    assert status == 200 and len(clusters) == 1
    status, patched = _http(rest_server, "PATCH", "/api/v1/scheduler-clusters/1",
                            {"config": {"candidate_parent_limit": 2}}, token)
    assert status == 200 and patched["config"] == {"candidate_parent_limit": 2}
    status, _ = _http(rest_server, "DELETE", f"/api/v1/clusters/{cluster['id']}", None, token)
    assert status == 200


def test_rest_requires_auth_and_rbac(rest_server):
    assert _http(rest_server, "GET", "/api/v1/clusters")[0] == 401
    _http(rest_server, "POST", "/api/v1/users/signup", {"name": "bob", "password": "pw"})
    _, out = _http(rest_server, "POST", "/api/v1/users/signin", {"name": "bob", "password": "pw"})
    guest = out["token"]
    assert _http(rest_server, "GET", "/api/v1/clusters", None, guest)[0] == 200
    assert _http(rest_server, "POST", "/api/v1/clusters", {"name": "x"}, guest)[0] == 401


def test_rest_auth_matrix_every_crud_group(rest_server):
    """Every CRUD group behind jwt + RBAC: unauthenticated reads 401 (the
    reference's open GETs 200), guest reads 200, guest writes 401, root
    writes reach the handler."""
    root = _root_token(rest_server)
    _http(rest_server, "POST", "/api/v1/users/signup", {"name": "matrix-guest", "password": "pw"})
    _, out = _http(rest_server, "POST", "/api/v1/users/signin",
                   {"name": "matrix-guest", "password": "pw"})
    guest = out["token"]
    open_gets = {g for (m, g, sub) in port_rest._OPEN_ROUTES if m in ("GET", "*") and sub is None}
    for group in port_rest.CRUD_TABLES:
        path = f"/api/v1/{group}"
        want = 200 if group in open_gets else 401
        assert _http(rest_server, "GET", path)[0] == want, group
        assert _http(rest_server, "GET", path, None, guest)[0] == 200, group
        assert _http(rest_server, "POST", path, {"name": f"x-{group}"}, guest)[0] == 401, group
        assert _http(rest_server, "POST", path, {"name": f"x-{group}"}, root)[0] not in (401, 403)
        assert _http(rest_server, "GET", path, None, "garbage-token")[0] == want, group


def test_rest_duplicate_is_409_and_missing_404(rest_server):
    token = _root_token(rest_server)
    body = {"name": "app"}
    assert _http(rest_server, "POST", "/api/v1/applications", body, token)[0] == 200
    assert _http(rest_server, "POST", "/api/v1/applications", body, token)[0] == 409
    assert _http(rest_server, "GET", "/api/v1/applications/999", None, token)[0] == 404
    assert _http(rest_server, "GET", "/api/v2/nothing", None, token)[0] == 404


def test_rest_list_pagination_and_query_filters(rest_server):
    token = _root_token(rest_server)
    for i in range(130):
        status, _ = _http(rest_server, "POST", "/api/v1/applications",
                          {"name": f"app-{i:03d}", "tier": "a" if i % 2 else "b"}, token)
        assert status == 200
    status, rows = _http(rest_server, "GET", "/api/v1/applications?per_page=1000", None, token)
    assert status == 200 and len(rows) == 130
    assert len(_http(rest_server, "GET", "/api/v1/applications", None, token)[1]) == 100
    page2 = _http(rest_server, "GET", "/api/v1/applications?page=2&per_page=100", None, token)[1]
    assert len(page2) == 30
    odd = _http(rest_server, "GET", "/api/v1/applications?tier=a&per_page=1000", None, token)[1]
    assert len(odd) == 65 and all(r["tier"] == "a" for r in odd)
    assert _http(rest_server, "GET", "/api/v1/applications?per_page=bogus", None, token)[0] == 400
    status, rows = _http(rest_server, "GET", "/api/v1/applications?per_page=-1", None, token)
    assert status == 200 and len(rows) == 1
    _http(rest_server, "POST", "/api/v1/applications", {"name": "int-field-app", "priority": 7},
          token)
    status, pri = _http(rest_server, "GET", "/api/v1/applications?priority=7", None, token)
    assert status == 200 and [r["name"] for r in pri] == ["int-field-app"]


def test_rest_pat_flow_and_oapi(rest_server):
    token = _root_token(rest_server)
    status, pat = _http(rest_server, "POST", "/api/v1/personal-access-tokens", {"name": "ci"},
                        token)
    assert status == 200 and pat["state"] == "active" and pat["user_id"] == 1
    status, job = _http(rest_server, "POST", "/oapi/v1/jobs", {"type": "noop"}, pat["token"])
    assert status == 200 and job["state"] == "PENDING"
    assert _http(rest_server, "GET", "/oapi/v1/clusters", None, "bad-token")[0] == 401


def test_rest_roles_endpoints(rest_server):
    token = _root_token(rest_server)
    status, roles = _http(rest_server, "GET", "/api/v1/roles", None, token)
    assert status == 200 and set(roles) >= {"root", "guest"}
    status, perms = _http(rest_server, "GET", "/api/v1/roles/guest", None, token)
    assert status == 200 and {"object": "clusters", "action": "read"} in perms
    _http(rest_server, "POST", "/api/v1/users/signup", {"name": "bob", "password": "pw"})
    users = _http(rest_server, "GET", "/api/v1/users", None, token)[1]
    bob_id = next(u["id"] for u in users if u["name"] == "bob")
    assert _http(rest_server, "PUT", f"/api/v1/users/{bob_id}/roles/root", None, token)[0] == 200
    assert "root" in _http(rest_server, "GET", f"/api/v1/users/{bob_id}/roles", None, token)[1]


def test_rest_model_patch_activates_through_the_registry(tmp_path):
    from dragonfly2_tpu_torch.registry.registry import ModelEvaluation, ModelRegistry

    registry = ModelRegistry(tmp_path / "models")
    svc = make_service(registry=registry)
    params = {"dense": {"kernel": np.zeros((2, 2), np.float32)}}
    for _ in range(2):
        rec = svc.create_model("ranker", "gnn", "host-1", params, ModelEvaluation())
    server = ManagerREST(svc)
    server.start()
    try:
        token = _root_token(server)
        for version in (1, 2):
            row = next(r for r in svc.db.list("models") if r["version"] == version)
            status, out = _http(server, "PATCH", f"/api/v1/models/{row['id']}",
                                {"state": "active"}, token)
            assert status == 200 and out["state"] == "active"
            assert registry.active_version(rec["model_id"]).version == version
    finally:
        server.stop()


def test_rest_flight_recorder_answers_501_naming_a10(rest_server):
    """The REST route, a 501 before A10, now answers the manager's dump to
    a signed-in caller, and 401 without a token, as the reference's."""
    token = _root_token(rest_server)
    status, out = _http(rest_server, "GET", "/api/v1/flight-recorder?last_n=4", None, token)
    assert status == 200 and set(out) == {"manager", "schedulers"}
    assert "costcards" in out["manager"] and out["manager"]["ticks"]["last"] == []
    assert _http(rest_server, "GET", "/api/v1/flight-recorder")[0] == 401


# ----------------------------------------------------------------------- RPC


def test_manager_rpc_roundtrip(tmp_path):
    from dragonfly2_tpu_torch.registry.registry import ModelRegistry
    from dragonfly2_tpu_torch.training.checkpoint import params_to_bytes

    async def scenario():
        svc = ManagerService(Database(), registry=ModelRegistry(tmp_path / "models"))
        svc.create_cluster({"name": "c1", "scopes": {"idc": "idc-a"}})
        server = mrpc.ManagerRPCServer(svc)
        host, port = await server.start()
        client = await mrpc.ManagerClient(host, port).connect()
        try:
            reg = await client.call(mrpc.RegisterInstanceRequest(
                source_type="scheduler", host_name="s1", ip="10.0.0.1", port=8002, cluster_id=1))
            assert reg.id == 1
            await client.call(mrpc.KeepAliveRequest(
                source_type="scheduler", host_name="s1", ip="10.0.0.1", cluster_id=1))
            got = await client.call(mrpc.GetSchedulersRequest(ip="1.1.1.1", hostname="h",
                                                              idc="idc-a"))
            assert [s.host_name for s in got.schedulers] == ["s1"]
            blob = params_to_bytes({"dense": {"kernel": np.ones((2, 2), np.float32)}})
            created = await client.call(mrpc.CreateModelRequest(
                name="ranker", type="gnn", scheduler_host_id="s1-host", params_blob=blob,
                evaluation={"recall": 0.8}))
            assert created.version == 1
            dyn = await client.call(mrpc.GetDynconfigRequest(scheduler_cluster_id=1))
            assert "scheduler_cluster_config" in dyn.data
            with pytest.raises(RuntimeError):
                await client.call(mrpc.KeepAliveRequest(
                    source_type="scheduler", host_name="ghost", ip="0.0.0.0", cluster_id=1))
            with pytest.raises(RuntimeError, match="unknown request"):
                await client.call(mrpc.Ack())
        finally:
            await client.close()
            await server.stop()

    _run_async(scenario())


def test_manager_rpc_stop_with_connected_client():
    """A manager with a connected keepalive client still stops promptly
    (the handlers are cancelled before wait_closed)."""

    async def scenario():
        server = mrpc.ManagerRPCServer(ManagerService(Database()))
        host, port = await server.start()
        client = await mrpc.ManagerClient(host, port).connect()
        await asyncio.wait_for(server.stop(), timeout=5.0)
        await client.close()

    _run_async(scenario())


def test_obtain_certificate_installs_a_chain(tmp_path):
    async def scenario():
        svc = ManagerService(Database(), cert_dir=str(tmp_path / "ca"))
        server = mrpc.ManagerRPCServer(svc)
        host, port = await server.start()
        try:
            return await mrpc.obtain_certificate(host, port, "dfdaemon", tmp_path / "tls")
        finally:
            await server.stop()

    mat = _run_async(scenario())
    assert mat.ready
    assert (tmp_path / "tls" / "ca.pem").read_bytes() == (tmp_path / "ca" / "ca.pem").read_bytes()
    assert mat.server_context() is not None and mat.client_context() is not None


# --------------------------------------------------------------- oauth2


class _StubIdP:
    """A local provider: /token checks the code and the client's
    credentials, /userinfo the bearer token."""

    CODE = "authcode-42"
    TOKEN = "idp-token-77"

    def __init__(self):
        import http.server
        import threading

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, status=200):
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/token":
                    self.send_error(404)
                    return
                form = urllib.parse.parse_qs(
                    self.rfile.read(int(self.headers.get("Content-Length") or 0)).decode())
                if (form.get("code") == [outer.CODE] and form.get("client_id") == ["cid"]
                        and form.get("client_secret") == ["csecret"]):
                    self._json({"access_token": outer.TOKEN, "token_type": "bearer"})
                else:
                    self._json({"error": "bad_verification_code"})

            def do_GET(self):
                if self.path != "/userinfo":
                    self.send_error(404)
                    return
                if self.headers.get("Authorization") != f"Bearer {outer.TOKEN}":
                    self.send_error(401)
                    return
                self._json({"login": "octo-dev", "email": "octo@example.com",
                            "avatar_url": "http://a/x.png"})

        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever, daemon=True).start()

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *a, **k):
        return None


def test_oauth_signin_full_flow():
    """The authorization-code exchange against a local provider: the
    signin redirect carries state, the callback exchanges the code,
    creates the user on first signin and issues the manager's JWT; a
    replayed state is refused."""
    idp = _StubIdP()
    try:
        svc = ManagerService(Database())
        base = f"http://127.0.0.1:{idp.port}"
        svc.db.create("oauth", {
            "name": "github", "client_id": "cid", "client_secret": "csecret",
            "redirect_url": "http://manager/callback", "auth_url": f"{base}/authorize",
            "token_url": f"{base}/token", "userinfo_url": f"{base}/userinfo"})
        rest = ManagerREST(svc)
        host, port = rest.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as redirect:
                urllib.request.build_opener(_NoRedirect).open(
                    f"http://{host}:{port}/api/v1/users/signin/github")
            assert redirect.value.code == 302
            loc = redirect.value.headers["Location"]
            assert loc.startswith(f"{base}/authorize?")
            q = urllib.parse.parse_qs(urllib.parse.urlsplit(loc).query)
            assert q["client_id"] == ["cid"]
            state = q["state"][0]
            callback = (f"http://{host}:{port}/api/v1/users/signin/github/callback"
                        f"?code={_StubIdP.CODE}&state={state}")
            with urllib.request.urlopen(callback) as r:
                token = json.loads(r.read())["token"]
            assert svc.tokens.verify(token)["name"] == "octo-dev"
            user = svc.db.find_one("users", {"name": "octo-dev"})
            assert user is not None and user["email"] == "octo@example.com"
            with pytest.raises(urllib.error.HTTPError) as replay:
                urllib.request.urlopen(callback)
            assert replay.value.code == 401
        finally:
            rest.stop()
    finally:
        idp.stop()


def test_oauth_display_name_cannot_shadow_local_users(monkeypatch):
    svc = ManagerService(Database())
    svc.db.create("oauth", {"name": "github", "client_id": "c", "client_secret": "s"})
    provider = svc._oauth_provider("github")
    monkeypatch.setattr(provider, "check_state", lambda s: True)
    monkeypatch.setattr(provider, "exchange", lambda code: "tok")
    monkeypatch.setattr(provider, "get_user",
                        lambda tok: {"subject": "9001", "name": "root", "email": "", "avatar": ""})
    token = svc.oauth_signin_callback("github", "code", state="x")
    assert svc.tokens.verify(token)["name"] == "root@github:9001"
    root = svc.db.find_one("users", {"name": "root"})
    assert root is not None and "oauth_subject" not in root
    token2 = svc.oauth_signin_callback("github", "code", state="x")
    assert svc.tokens.verify(token2)["name"] == "root@github:9001"
    assert svc.db.count("users") == 2


def test_oauth_callback_requires_state():
    svc = ManagerService(Database())
    svc.db.create("oauth", {"name": "github", "client_id": "c", "client_secret": "s"})
    with pytest.raises(PermissionError, match="state"):
        svc.oauth_signin_callback("github", "code", state="")


# ------------------------------------------------------ console and swagger


def test_swagger_doc_lists_all_groups():
    rest = ManagerREST(make_service())
    host, port = rest.start()
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/swagger.json") as r:
            spec = json.loads(r.read())
        assert spec["openapi"].startswith("3.")
        tags = {tag for methods in spec["paths"].values()
                for opdef in methods.values() for tag in opdef["tags"]}
        for group in list(port_rest.CRUD_TABLES) + [
                "users", "roles", "permissions", "jobs", "personal-access-tokens"]:
            assert group in tags, group
        assert "/api/v1/users/signin/{name}/callback" in spec["paths"]
    finally:
        rest.stop()


def test_console_served_and_drives_api():
    svc = make_service()
    svc.create_cluster({"name": "c1"})
    rest = ManagerREST(svc)
    host, port = rest.start()
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/") as r:
            assert r.headers["Content-Type"].startswith("text/html")
            html = r.read().decode()
        assert "Dragonfly2-TPU Manager" in html and "users/signin" in html
        req = urllib.request.Request(
            f"http://{host}:{port}/api/v1/users/signin",
            data=json.dumps({"name": "root", "password": "dragonfly"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            token = json.loads(r.read())["token"]
        req = urllib.request.Request(f"http://{host}:{port}/api/v1/clusters",
                                     headers={"Authorization": f"Bearer {token}"})
        with urllib.request.urlopen(req) as r:
            assert [c["name"] for c in json.loads(r.read())] == ["c1"]
        assert "overview" in html and "scheduler health" in html
        assert "activate" in html and "PATCH" in html
    finally:
        rest.stop()


def test_preheat_job_state_refreshes_live():
    """GET /jobs/:id recomputes a preheat's state from the scheduler's
    live task states: PENDING at create, SUCCESS once the seed's download
    succeeded, persisted into the record."""
    from dragonfly2_tpu_torch.cluster import messages as cmsg
    from dragonfly2_tpu_torch.cluster.jobs import JobManager
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService

    sched = SchedulerService(device="cpu")
    seed = cmsg.HostInfo(host_id="seed-0", hostname="seed-0", ip="10.1.0.0", host_type="super")
    sched.announce_host(seed)
    svc = ManagerService(Database(), jobs=JobManager({"s1": sched}, [seed]))
    record = svc.create_job({"type": "preheat", "args": {"url": "https://e.com/blob"}})
    assert record["state"] == "PENDING"
    assert svc.get_job(record["id"])["state"] == "PENDING"
    task_id = record["result"]["task_ids"][0]
    sched.register_peer(cmsg.RegisterPeerRequest(
        peer_id="p-1", task_id=task_id, host=seed, url="https://e.com/blob",
        content_length=10 << 20))
    sched.back_to_source_started(cmsg.DownloadPeerBackToSourceStartedRequest(peer_id="p-1"))
    sched.back_to_source_finished(
        cmsg.DownloadPeerBackToSourceFinishedRequest(peer_id="p-1", piece_count=3))
    assert svc.get_job(record["id"])["state"] == "SUCCESS"
    assert svc.db.get("jobs", record["id"])["state"] == "SUCCESS"


# ------------------------------------------------------------------ parity


def _schema(path) -> list[tuple]:
    with sqlite3.connect(path) as conn:
        return conn.execute(
            "SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY type, name").fetchall()


def test_sqlite_schema_equals_the_reference(tmp_path):
    RefDatabase(str(tmp_path / "ref.db")).close()
    Database(str(tmp_path / "port.db")).close()
    want = _schema(tmp_path / "ref.db")
    assert want and _schema(tmp_path / "port.db") == want


def test_each_package_reads_the_others_database(tmp_path):
    ref = RefDatabase(str(tmp_path / "ref.db"))
    ref.create("schedulers", {"host_name": "h", "ip": "1.2.3.4", "scheduler_cluster_id": 1})
    ref.close()
    port = Database(str(tmp_path / "ref.db"))
    assert port.find_one("schedulers", {"ip": "1.2.3.4"})["host_name"] == "h"
    with pytest.raises(DuplicateRecord):
        port.create("schedulers", {"host_name": "h", "ip": "1.2.3.4", "scheduler_cluster_id": 1})
    port.create("models", {"model_id": "m", "version": 1})
    port.close()
    assert RefDatabase(str(tmp_path / "ref.db")).count("models") == 1


_IDCS = ["idc-a", "idc-b", "idc-a|idc-c", "IDC-B", ""]
_LOCATIONS = ["cn|bj|rack1", "cn|bj|rack2", "cn|sh", "us|ca|sf|r1|u2", ""]
_CIDRS = [["10.0.0.0/8"], ["192.168.0.0/16", "10.1.0.0/16"], ["bogus"], [], ["fd00::/8"]]
_HOSTNAMES = [["worker-.*"], ["^seed"], ["(bad"], [], [".*-7$"]]


def _seeded_clusters(rng) -> list[dict]:
    clusters = []
    for i in range(12):
        clusters.append({
            "name": f"cluster-{i}",
            "scopes": {"idc": _IDCS[rng.integers(5)], "location": _LOCATIONS[rng.integers(5)],
                       "cidrs": _CIDRS[rng.integers(5)], "hostnames": _HOSTNAMES[rng.integers(5)]},
            "is_default": bool(rng.integers(2)),
            "schedulers": [{"host_name": f"s{i}"}] if rng.random() < 0.8 else [],
        })
    return clusters


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_searcher_scores_and_ranking_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    clusters = _seeded_clusters(rng)
    for _ in range(40):
        ip = rng.choice(["10.1.2.3", "192.168.7.7", "fd00::1", "8.8.8.8", "not-an-ip"])
        hostname = rng.choice(["worker-7", "seed-1", "node", ""])
        conditions = {"idc": _IDCS[rng.integers(5)], "location": _LOCATIONS[rng.integers(5)]}
        for c in clusters:
            args = (str(ip), str(hostname), conditions)
            want = ref_searcher.evaluate(*args, ref_searcher._scopes_of(c), bool(c["is_default"]))
            got = msearcher.evaluate(*args, msearcher._scopes_of(c), bool(c["is_default"]))
            assert got == want
        want = ref_searcher.Searcher().find_scheduler_clusters(clusters, str(ip), str(hostname),
                                                               conditions)
        got = msearcher.Searcher().find_scheduler_clusters(clusters, str(ip), str(hostname),
                                                           conditions)
        assert [c["name"] for c in got] == [c["name"] for c in want]


def test_tokens_equal_the_reference_under_a_pinned_clock():
    secret = bytes(range(32))
    ref, port = ref_auth.TokenAuthority(secret, ttl=3600), auth.TokenAuthority(secret, ttl=3600)
    for user_id, name in ((1, "root"), (7, "alice"), (42, "ünïcode")):
        token = port.issue(user_id, name, now=PINNED_NOW)
        assert token == ref.issue(user_id, name, now=PINNED_NOW)
        assert ref.verify(token, now=PINNED_NOW + 1) == port.verify(token, now=PINNED_NOW + 1)
        assert port.verify(token, now=PINNED_NOW + 3601) is None
    salt = b"0123456789abcdef"
    assert auth.hash_password("pw", salt) == ref_auth.hash_password("pw", salt)
    assert auth.verify_password("pw", ref_auth.hash_password("pw"))


def _build_control_plane(service_cls, db_cls):
    """The same operations on either package's service: clusters with
    configs and scopes, schedulers and seed peers registered and kept
    alive, the seed-peer clusters associated."""
    svc = service_cls(db_cls(), token_authority=None)
    for i, cfg in enumerate(({"candidate_parent_limit": 4}, {"filter_parent_limit": 9}, {})):
        svc.create_cluster({"name": f"c{i}", "scheduler_cluster_config": cfg,
                            "peer_cluster_config": {"load_limit": 50 + i},
                            "scopes": {"idc": f"idc-{i}"}, "is_default": i == 0})
    for i in range(5):
        cid = 1 + i % 3
        svc.register_scheduler({"host_name": f"s{i}", "ip": f"10.0.0.{i}", "port": 8002 + i,
                                "scheduler_cluster_id": cid})
        svc.register_seed_peer({"host_name": f"seed{i}", "ip": f"10.1.0.{i}", "port": 65000 + i,
                                "seed_peer_cluster_id": cid})
        if i % 2:
            svc.keepalive("scheduler", f"s{i}", f"10.0.0.{i}", cid)
            svc.keepalive("seed_peer", f"seed{i}", f"10.1.0.{i}", cid)
    spc = svc.db.get("seed_peer_clusters", 1)
    svc.db.update("seed_peer_clusters", 1, {"scheduler_cluster_ids": spc["scheduler_cluster_ids"]
                                            + [2]})
    return svc


def test_dynconfig_payloads_equal_the_reference(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: PINNED_NOW)
    ref = _build_control_plane(RefManagerService, RefDatabase)
    port = _build_control_plane(ManagerService, Database)
    for cid in (1, 2, 3):
        assert port.scheduler_dynconfig(cid) == ref.scheduler_dynconfig(cid)
    for conditions in ({"idc": "idc-1"}, {"idc": "idc-2"}, {}):
        assert (port.list_schedulers("10.9.9.9", "daemon", conditions)
                == ref.list_schedulers("10.9.9.9", "daemon", conditions))
    assert port.scheduler_dynconfig(1)["seed_peers"]


def test_openapi_spec_equals_the_reference():
    from dragonfly2_tpu import version as ref_version
    from dragonfly2_tpu_torch import version as port_version

    want, got = ref_rest.openapi_spec(), port_rest.openapi_spec()
    # each names its own build; everything else is one document
    assert want["info"].pop("version") == ref_version.GIT_VERSION
    assert got["info"].pop("version") == port_version.GIT_VERSION
    assert got == want
    assert port_rest.CRUD_TABLES == ref_rest.CRUD_TABLES
    assert port_rest._OPEN_ROUTES == ref_rest._OPEN_ROUTES
    assert auth.OBJECTS == ref_auth.OBJECTS


def _rpc_session(server_side: str, client_side: str, tmp_path) -> dict:
    """One manager RPC session: ``server_side``'s ManagerRPCServer over its
    own service (a bucket registry, a cluster CA), called by
    ``client_side``'s ManagerClient with RegisterInstance, KeepAlive,
    GetSchedulers, GetDynconfig, CreateModel and IssueCertificate.
    Returns what came back, as plain data."""
    from cryptography import x509

    if server_side == "ref":
        from dragonfly2_tpu.objectstorage.backends import FilesystemBackend as Backend
        from dragonfly2_tpu.registry.bucket import BucketModelRegistry as Registry
        service_cls, db_cls, srv_mod = RefManagerService, RefDatabase, ref_rpc
    else:
        from dragonfly2_tpu_torch.objectstorage.backends import FilesystemBackend as Backend
        from dragonfly2_tpu_torch.registry.bucket import BucketModelRegistry as Registry
        service_cls, db_cls, srv_mod = ManagerService, Database, mrpc
    if client_side == "ref":
        from dragonfly2_tpu.training.checkpoint import params_to_bytes
        from dragonfly2_tpu.utils import certs
        cli = ref_rpc
    else:
        from dragonfly2_tpu_torch.training.checkpoint import params_to_bytes
        from dragonfly2_tpu_torch.utils import certs
        cli = mrpc
    root = tmp_path / f"{server_side}-serves-{client_side}"
    registry = Registry(Backend(root / "bucket"), "models")
    svc = service_cls(db_cls(), registry=registry, cert_dir=str(root / "ca"),
                      enrollment_token="enroll")
    svc.create_cluster({"name": "c1", "scopes": {"idc": "idc-a"},
                        "scheduler_cluster_config": {"candidate_parent_limit": 4}})
    params = {"dense": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
                        "bias": np.ones(3, np.float32)}}

    async def scenario():
        server = srv_mod.ManagerRPCServer(svc)
        host, port = await server.start()
        client = await cli.ManagerClient(host, port).connect()
        out = {}
        try:
            for kind, name, ip, p in (("scheduler", "s1", "10.0.0.1", 8002),
                                      ("seed_peer", "seed1", "10.0.0.2", 65000)):
                r = await client.call(cli.RegisterInstanceRequest(
                    source_type=kind, host_name=name, ip=ip, port=p, cluster_id=1))
                out[f"register-{kind}"] = (type(r).__name__, r.id, r.cluster_id)
                a = await client.call(cli.KeepAliveRequest(
                    source_type=kind, host_name=name, ip=ip, cluster_id=1))
                out[f"keepalive-{kind}"] = (type(a).__name__, a.ok, a.error)
            got = await client.call(cli.GetSchedulersRequest(ip="10.0.0.9", hostname="d",
                                                             idc="idc-a"))
            out["schedulers"] = [(e.id, e.host_name, e.ip, e.port, e.state,
                                  e.scheduler_cluster_id) for e in got.schedulers]
            dyn = await client.call(cli.GetDynconfigRequest(scheduler_cluster_id=1))
            out["dynconfig"] = dyn.data
            for evaluation in ({"recall": 0.5}, {"precision": 0.25, "f1_score": 0.125}):
                created = await client.call(cli.CreateModelRequest(
                    name="parent-ranker", type="gnn", scheduler_host_id="sched-host",
                    params_blob=params_to_bytes(params), evaluation=evaluation))
                out.setdefault("models", []).append((created.model_id, created.version))
            csr, _ = certs.generate_csr("scheduler", ["127.0.0.1", "localhost"])
            with pytest.raises(RuntimeError, match="enrollment token"):
                await client.call(cli.IssueCertificateRequest(csr_pem=csr, token="bad"))
            chain = (await client.call(cli.IssueCertificateRequest(
                csr_pem=csr, validity_days=30, token="enroll"))).certificate_chain
            leaf, ca = (x509.load_pem_x509_certificate(c) for c in chain)
            leaf.verify_directly_issued_by(ca)
            out["certificate"] = (
                len(chain),
                leaf.subject.get_attributes_for_oid(x509.NameOID.COMMON_NAME)[0].value,
                sorted(str(n) for n in leaf.extensions.get_extension_for_class(
                    x509.SubjectAlternativeName).value),
                (leaf.not_valid_after_utc - leaf.not_valid_before_utc).days,
                chain[-1] == (root / "ca" / "ca.pem").read_bytes(),
            )
        finally:
            await client.close()
            await server.stop()
        return out

    out = _run_async(scenario())
    mid, version = out["models"][-1]
    out["db_models"] = [(r["model_id"], r["version"], r["state"], r["evaluation"])
                        for r in svc.db.list("models")]
    out["instances"] = [(r["host_name"], r["state"]) for table in ("schedulers", "seed_peers")
                        for r in svc.db.list(table)]
    # the published params, read back by the OTHER package's registry
    if server_side == "ref":
        from dragonfly2_tpu_torch.objectstorage.backends import FilesystemBackend as Other
        from dragonfly2_tpu_torch.registry.bucket import BucketModelRegistry as OtherRegistry
    else:
        from dragonfly2_tpu.objectstorage.backends import FilesystemBackend as Other
        from dragonfly2_tpu.registry.bucket import BucketModelRegistry as OtherRegistry
    loaded = OtherRegistry(Other(root / "bucket"), "models").load_params(mid, version)
    out["params"] = {k: np.asarray(v).tolist() for k, v in loaded["dense"].items()}
    return out


def test_manager_rpc_crosses_the_packages_both_ways(tmp_path, monkeypatch):
    """Each package's ManagerClient against the other's ManagerRPCServer
    (and each against its own): every answer equal, the CreateModel
    params readable by the other package's registry, the issued chain
    signed by the serving manager's CA."""
    monkeypatch.setattr(time, "time", lambda: PINNED_NOW)
    sessions = {(s, c): _rpc_session(s, c, tmp_path)
                for s in ("ref", "port") for c in ("ref", "port")}
    want = sessions[("ref", "ref")]
    assert want["schedulers"] == [(1, "s1", "10.0.0.1", 8002, "active", 1)]
    assert want["dynconfig"]["scheduler_cluster_config"] == {"candidate_parent_limit": 4}
    assert [v for _, v in want["models"]] == [1, 2]
    assert want["certificate"][:2] == (2, "scheduler") and want["certificate"][4]
    assert want["params"]["kernel"] == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]
    for key, got in sessions.items():
        assert got == want, key


_NO_TORCH = r"""
import sys
import dragonfly2_tpu_torch.manager.rest, dragonfly2_tpu_torch.manager.rpc
import dragonfly2_tpu_torch.cluster.jobs, dragonfly2_tpu_torch.cluster.image_preheat
from dragonfly2_tpu_torch import cmd
cmd.build_parser().parse_args(["manager", "--db", "m.db"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "dragonfly2_tpu"))
print("BAD=" + ",".join(bad))
"""


def test_the_manager_path_loads_no_torch():
    """The control plane drives no device program: without a registry the
    manager's modules load no torch (and never jax or the reference)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-c", _NO_TORCH], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "BAD=", out.stdout
