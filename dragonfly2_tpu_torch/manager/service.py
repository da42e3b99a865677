"""Manager service layer: business logic over the Database.

Capability parity with manager/service/*.go (2,459 LoC of per-entity
logic) + the gRPC-facing parts of manager/rpcserver: user signup/signin,
cluster composites, scheduler/seed-peer registration and keepalive
active/inactive flips (manager_server_v1.go:955-1000), searcher-ranked
scheduler lists for joining daemons (ListSchedulers), model lifecycle
bridging the DB metadata mirror to the native ModelRegistry (CreateModel,
manager_server_v1.go:802-952; activate flip manager/service/model.go:
109-190), preheat job fan-out, and the dynconfig payloads schedulers and
daemons poll.
"""

from __future__ import annotations

import logging
import os
import time

from dragonfly2_tpu_torch.manager import auth
from dragonfly2_tpu_torch.manager.models import Database, DuplicateRecord, RecordNotFound
from dragonfly2_tpu_torch.manager.searcher import Searcher, new_searcher
from dragonfly2_tpu_torch.telemetry import default_registry
from dragonfly2_tpu_torch.telemetry.series import manager_series

# scheduler/seed-peer service states (manager/models/{scheduler,seed_peer}.go)
STATE_ACTIVE = "active"
STATE_INACTIVE = "inactive"

KEEPALIVE_TIMEOUT = 60.0  # mark inactive when silent this long

logger = logging.getLogger(__name__)


class ManagerService:
    def __init__(
        self,
        db: Database | None = None,
        registry=None,
        jobs=None,
        token_authority: auth.TokenAuthority | None = None,
        searcher: Searcher | None = None,
        plugin_dir: str | None = None,
        cert_dir: str | None = None,
        enrollment_token: str | None = None,
        jobs_resolver=None,
    ):
        self.db = db or Database()
        self.registry = registry  # registry.ModelRegistry | None
        self.jobs = jobs  # cluster.jobs.JobManager | None
        # callable -> {name: scheduler-like} rebuilt from live state; the
        # launched manager resolves its DB's ACTIVE scheduler rows into
        # RemoteScheduler proxies before every job operation (schedulers
        # register/depart at runtime; an in-proc JobManager with a fixed
        # scheduler set passes None)
        self.jobs_resolver = jobs_resolver
        self.tokens = token_authority or auth.TokenAuthority()
        self.enforcer = auth.Enforcer(self.db)
        self.searcher = searcher or new_searcher(plugin_dir)
        self.metrics = manager_series(default_registry())
        # cluster CA for mTLS cert issuance (pkg/issuer); lazily created
        # on first use when a cert_dir is configured, never otherwise
        self.cert_dir = cert_dir
        self.enrollment_token = enrollment_token
        self._ca: tuple[bytes, bytes] | None = None
        self._oauth_providers: dict = {}  # name -> (config key, provider)
        self.enforcer.init_policies()
        self._ensure_root_user()

    def _ensure_root_user(self) -> None:
        """First boot creates root/dragonfly with the root role
        (rbac.go InitRBAC)."""
        if self.db.count("users") == 0:
            record = self.db.create(
                "users",
                {
                    "name": "root",
                    "email": "",
                    "encrypted_password": auth.hash_password("dragonfly"),
                    "state": "enable",
                },
            )
            self.enforcer.add_role_for_user(record["name"], auth.ROOT_ROLE)

    # ---------------------------------------------------------------- users

    def sign_up(self, name: str, password: str, email: str = "", **extra) -> dict:
        record = self.db.create(
            "users",
            {
                "name": name,
                "email": email,
                "encrypted_password": auth.hash_password(password),
                "state": "enable",
                **extra,
            },
        )
        self.enforcer.add_role_for_user(name, auth.GUEST_ROLE)
        return _redact_user(record)

    def sign_in(self, name: str, password: str) -> str:
        user = self.db.find_one("users", {"name": name})
        if user is None or user.get("state") != "enable":
            raise PermissionError("unknown or disabled user")
        if not auth.verify_password(password, user["encrypted_password"]):
            raise PermissionError("bad credentials")
        return self.tokens.issue(user["id"], name)

    # ---------------------------------------------------------- oauth signin

    def _oauth_provider(self, name: str):
        """Provider built from the `oauth` table row; cached so the state
        dict survives between signin and callback (handlers/user.go:190
        OauthSignin -> :216 OauthSigninCallback). The cache key covers the
        WHOLE record, so any CRUD update (secret rotation, endpoint change)
        rebuilds the provider instead of serving stale credentials."""
        import json as _json

        from dragonfly2_tpu_torch.manager import oauth as oauth_mod

        record = self.db.find_one("oauth", {"name": name})
        if record is None:
            raise RecordNotFound(f"no oauth provider {name!r} configured")
        cache_key = _json.dumps(record, sort_keys=True, default=str)
        cached = self._oauth_providers.get(name)
        if cached is not None and cached[0] == cache_key:
            return cached[1]
        provider = oauth_mod.provider_from_record(record)
        self._oauth_providers[name] = (cache_key, provider)
        return provider

    def oauth_signin(self, name: str) -> str:
        """-> consent-page URL to redirect the browser to (OauthSignin)."""
        return self._oauth_provider(name).auth_code_url()

    def oauth_signin_callback(self, name: str, code: str, state: str = "") -> str:
        """Code exchange -> userinfo -> create-or-get user -> manager JWT
        (OauthSigninCallback + gin-jwt LoginHandler).

        Account linking keys on the provider's STABLE subject id stored in
        (oauth_provider, oauth_subject) — never on the display name, which
        the IdP lets users edit freely (a display name of "root" must not
        sign in as the bootstrap root account). The state parameter is
        mandatory: an absent state is a forged/replayed callback."""
        provider = self._oauth_provider(name)
        if not provider.check_state(state):
            raise PermissionError("oauth state missing, mismatched, or expired")
        token = provider.exchange(code)
        info = provider.get_user(token)
        user = self.db.find_one(
            "users", {"oauth_provider": name, "oauth_subject": info["subject"]}
        )
        if user is None:
            username = info["name"]
            if self.db.find_one("users", {"name": username}) is not None:
                # never collide with (and thereby shadow) an existing local
                # account; scope the visible name by provider+subject
                username = f"{info['name']}@{name}:{info['subject']}"
            user = self.db.create(
                "users",
                {
                    "name": username,
                    "email": info["email"],
                    "avatar": info["avatar"],
                    "oauth_provider": name,
                    "oauth_subject": info["subject"],
                    # oauth users have no local password; a random one
                    # keeps the password path closed without a schema fork
                    "encrypted_password": auth.hash_password(os.urandom(16).hex()),
                    "state": "enable",
                },
            )
            self.enforcer.add_role_for_user(username, auth.GUEST_ROLE)
        elif user.get("state") != "enable":
            raise PermissionError("user disabled")
        return self.tokens.issue(user["id"], user["name"])

    def reset_password(self, user_id: int, new_password: str) -> None:
        self.db.update("users", user_id, {"encrypted_password": auth.hash_password(new_password)})

    def get_user(self, user_id: int) -> dict:
        return _redact_user(self.db.get("users", user_id))

    def get_users(self) -> list[dict]:
        return [_redact_user(u) for u in self.db.list("users")]

    def update_user(self, user_id: int, patch: dict) -> dict:
        patch.pop("encrypted_password", None)
        return _redact_user(self.db.update("users", user_id, patch))

    # ------------------------------------------------------------- clusters

    def create_cluster(self, body: dict) -> dict:
        """The composite Cluster entity: one scheduler cluster + one
        seed-peer cluster created together (manager/service/cluster.go
        CreateCluster creates+associates both)."""
        name = body["name"]
        sc = self.db.create(
            "scheduler_clusters",
            {
                "name": f"{name}-scheduler",
                "bio": body.get("bio", ""),
                "config": body.get("scheduler_cluster_config", {}),
                "client_config": body.get("peer_cluster_config", {}),
                "scopes": body.get("scopes", {}),
                "is_default": bool(body.get("is_default", False)),
            },
        )
        spc = self.db.create(
            "seed_peer_clusters",
            {
                "name": f"{name}-seed-peer",
                "bio": body.get("bio", ""),
                "config": body.get("seed_peer_cluster_config", {}),
                "scheduler_cluster_ids": [sc["id"]],
            },
        )
        return self.db.create(
            "clusters",
            {
                "name": name,
                "bio": body.get("bio", ""),
                "scheduler_cluster_id": sc["id"],
                "seed_peer_cluster_id": spc["id"],
                "is_default": bool(body.get("is_default", False)),
            },
        )

    def delete_cluster(self, cluster_id: int) -> None:
        cluster = self.db.get("clusters", cluster_id)
        for table, key in (
            ("scheduler_clusters", "scheduler_cluster_id"),
            ("seed_peer_clusters", "seed_peer_cluster_id"),
        ):
            try:
                self.db.delete(table, cluster[key])
            except RecordNotFound:
                pass
        self.db.delete("clusters", cluster_id)

    # -------------------------------------------- schedulers and seed peers

    def register_scheduler(self, body: dict) -> dict:
        """Create-or-refresh by unique key, the UpdateScheduler/
        CreateScheduler pair the gRPC GetScheduler path uses."""
        body.setdefault("state", STATE_INACTIVE)
        try:
            return self.db.create("schedulers", body)
        except DuplicateRecord:
            existing = self.db.find_one(
                "schedulers",
                {k: body[k] for k in ("host_name", "ip", "scheduler_cluster_id")},
            )
            assert existing is not None
            return self.db.update("schedulers", existing["id"], body)

    def register_seed_peer(self, body: dict) -> dict:
        body.setdefault("state", STATE_INACTIVE)
        try:
            return self.db.create("seed_peers", body)
        except DuplicateRecord:
            existing = self.db.find_one(
                "seed_peers",
                {k: body[k] for k in ("host_name", "ip", "seed_peer_cluster_id")},
            )
            assert existing is not None
            return self.db.update("seed_peers", existing["id"], body)

    def keepalive(self, source_type: str, host_name: str, ip: str, cluster_id: int) -> None:
        """Mark the instance active and stamp it (KeepAlive stream recv,
        manager_server_v1.go:955-1000)."""
        table, key = _SOURCE_TABLES[source_type]
        record = self.db.find_one(table, {"host_name": host_name, "ip": ip, key: cluster_id})
        if record is None:
            raise RecordNotFound(f"{source_type} {host_name}/{ip} not registered")
        self.db.update(table, record["id"], {"state": STATE_ACTIVE, "keepalive_at": time.time()})

    def expire_keepalives(self, timeout: float = KEEPALIVE_TIMEOUT) -> int:
        """Sweep: instances silent > timeout flip inactive (the reference
        flips on stream disconnect; polling covers crashed hosts too)."""
        expired = 0
        deadline = time.time() - timeout
        for table in ("schedulers", "seed_peers"):
            for record in self.db.list(table, {"state": STATE_ACTIVE}, per_page=100000):
                if record.get("keepalive_at", 0) < deadline:
                    self.db.update(table, record["id"], {"state": STATE_INACTIVE})
                    expired += 1
        return expired

    def list_schedulers(self, ip: str, hostname: str, conditions: dict | None = None) -> list[dict]:
        """Searcher-ranked active schedulers for a joining daemon
        (manager_server_v1.go ListSchedulers → searcher.FindSchedulerClusters),
        flattened best-cluster-first — the daemon dynconfig payload."""
        clusters = []
        for sc in self.db.list("scheduler_clusters"):
            active = self.db.list(
                "schedulers",
                {"scheduler_cluster_id": sc["id"], "state": STATE_ACTIVE},
            )
            clusters.append({**sc, "schedulers": active})
        self.metrics.search_scheduler_cluster.labels().inc()
        try:
            ranked = self.searcher.find_scheduler_clusters(clusters, ip, hostname, conditions)
        except ValueError:
            self.metrics.search_scheduler_cluster_failure.labels().inc()
            return []
        return [s for cluster in ranked for s in cluster["schedulers"]]

    # ---------------------------------------------------------------- models

    def create_model(
        self, name: str, model_type: str, scheduler_host_id: str, params, evaluation, metadata=None
    ) -> dict:
        """CreateModel: artifacts to the registry, metadata mirrored in the
        DB (manager_server_v1.go:802-952)."""
        if self.registry is None:
            raise RuntimeError("manager has no model registry attached")
        mv = self.registry.create_model_version(
            name, model_type, scheduler_host_id, params, evaluation, metadata
        )
        return self.db.create(
            "models",
            {
                "model_id": mv.model_id,
                "name": mv.name,
                "type": mv.type,
                "version": mv.version,
                "state": mv.state,
                "evaluation": vars(mv.evaluation),
                "scheduler_host_id": scheduler_host_id,
            },
        )

    def activate_model(self, model_id: str, version: int) -> None:
        if self.registry is None:
            raise RuntimeError("manager has no model registry attached")
        self.registry.activate(model_id, version)
        for record in self.db.list("models", {"model_id": model_id}, per_page=100000):
            state = "active" if record["version"] == version else "inactive"
            self.db.update("models", record["id"], {"state": state})

    # ------------------------------------------------------------------ pki

    def _cluster_ca(self) -> tuple[bytes, bytes]:
        """Load-or-create the cluster CA under cert_dir (pkg/issuer roots).
        (cert_pem, key_pem); persisted so restarts keep issuing from the
        same root and existing leaf certs stay valid."""
        if self._ca is not None:
            return self._ca
        if self.cert_dir is None:
            raise RuntimeError("manager has no cert_dir configured; mTLS issuance is off")
        import pathlib

        from dragonfly2_tpu_torch.utils import certs

        d = pathlib.Path(self.cert_dir)
        d.mkdir(parents=True, exist_ok=True)
        ca_cert_p, ca_key_p = d / "ca.pem", d / "ca_key.pem"
        if ca_cert_p.exists() and ca_key_p.exists():
            self._ca = (ca_cert_p.read_bytes(), ca_key_p.read_bytes())
        else:
            cert_pem, key_pem = certs.generate_ca()
            ca_cert_p.write_bytes(cert_pem)
            ca_key_p.write_bytes(key_pem)
            ca_key_p.chmod(0o600)
            self._ca = (cert_pem, key_pem)
        return self._ca

    def issue_certificate(
        self, csr_pem: bytes, validity_days: int = 365, token: str = ""
    ) -> list[bytes]:
        """Sign a service CSR with the cluster CA -> [leaf, ca] chain
        (manager-side of the security client's IssueCertificate).

        Issuance is the cluster's trust anchor, so it is gated: when the
        manager is configured with an enrollment token, a request must
        present it or the CA refuses to sign — otherwise anyone who can
        reach the RPC port could mint cluster-trusted certs. Every issued
        (and refused) CN/SAN set is logged for audit either way."""
        import hmac

        from dragonfly2_tpu_torch.utils import certs
        from dragonfly2_tpu_torch.utils import dflog

        log = dflog.get("manager.ca")
        cn, sans = certs.csr_identity(csr_pem)
        if self.enrollment_token:
            if not token or not hmac.compare_digest(self.enrollment_token, token):
                log.warning("refused certificate issuance cn=%r sans=%r: bad enrollment token", cn, sans)
                raise PermissionError("certificate issuance requires a valid enrollment token")
        ca_cert, ca_key = self._cluster_ca()
        leaf = certs.sign_csr(ca_cert, ca_key, csr_pem, validity_days=validity_days)
        log.info("issued certificate cn=%r sans=%r validity_days=%d", cn, sans, validity_days)
        return [leaf, ca_cert]

    # ------------------------------------------------------- observability

    def flight_recorder(self, last_n: int = 64) -> dict:
        """Flight-recorder dump for the operator (GET /api/v1/
        flight-recorder): this manager process's own recorder state plus
        every known scheduler's, collected over the same job RPC edge
        sync_peers uses (RemoteScheduler) or directly from in-proc
        services. A dead scheduler contributes an error entry, never a
        failed request — diagnosing a slow tick is exactly when parts of
        the cluster may be unhealthy."""
        from dragonfly2_tpu_torch.telemetry import flight

        # registry_fallback=False: with an in-proc scheduler the global
        # recorder lookup would attribute ITS tick ring to the manager,
        # duplicating the per-scheduler sections below under a wrong label
        out: dict = {
            "manager": flight.dump(last_n=last_n, registry_fallback=False),
            "schedulers": {},
        }
        self._refresh_job_schedulers()
        if self.jobs is not None:
            for name, sched in self.jobs.schedulers.items():
                try:
                    if hasattr(sched, "flight_recorder"):
                        out["schedulers"][name] = sched.flight_recorder(last_n)
                    elif hasattr(sched, "flight_dump"):
                        out["schedulers"][name] = sched.flight_dump(last_n)
                except ConnectionError as e:
                    out["schedulers"][name] = {"error": str(e)}
        return out

    # ----------------------------------------------------------------- jobs

    def _refresh_job_schedulers(self) -> None:
        if self.jobs is not None and self.jobs_resolver is not None:
            try:
                self.jobs.update_schedulers(self.jobs_resolver())
            except Exception:  # noqa: BLE001 - job ops proceed on the old set
                logger.exception("job scheduler refresh failed")

    def create_job(self, body: dict) -> dict:
        job_type = body.get("type", "preheat")
        record = self.db.create(
            "jobs",
            {
                "type": job_type,
                "state": "PENDING",
                "args": body.get("args", {}),
                "user_id": body.get("user_id"),
                "result": {},
            },
        )
        self._refresh_job_schedulers()
        if self.jobs is not None and job_type == "preheat":
            from dragonfly2_tpu_torch.cluster.jobs import PreheatRequest

            args = body.get("args", {})
            urls = args.get("urls") or ([args["url"]] if args.get("url") else [])
            result = self.jobs.create_preheat(
                PreheatRequest(
                    urls=urls,
                    tag=args.get("tag", ""),
                    application=args.get("application", ""),
                    piece_length=args.get("piece_length", 4 << 20),
                    # image-type preheat (manager/job/preheat.go PreheatArgs:
                    # type/username/password/platform/headers)
                    preheat_type=args.get("type", ""),
                    username=args.get("username", ""),
                    password=args.get("password", ""),
                    platform=args.get("platform", ""),
                    headers=args.get("headers"),
                )
            )
            record = self.db.update(
                "jobs",
                record["id"],
                {
                    "state": result.state.value,
                    "result": {"job_id": result.job_id, "task_ids": result.task_ids, **result.detail},
                },
            )
        elif self.jobs is not None and job_type == "sync_peers":
            result = self.jobs.sync_peers()
            self._merge_sync_peers(result)
            record = self.db.update(
                "jobs", record["id"], {"state": "SUCCESS", "result": result}
            )
        return record

    def get_job(self, record_id: int) -> dict:
        """Job record with LIVE state: a preheat stays PENDING until every
        fanned-out task completed on its scheduler, so GET /jobs/:id polls
        real progress (the reference's machinery group-state polling,
        test/e2e/manager/preheat.go)."""
        record = self.db.get("jobs", record_id)
        job_id = (record.get("result") or {}).get("job_id")
        # A persisted SUCCESS is terminal — never let a live recompute
        # (e.g. after a scheduler restart forgot the tasks) regress it.
        if record["state"] == "SUCCESS":
            return record
        if self.jobs is not None and record["type"] == "preheat" and job_id:
            self._refresh_job_schedulers()
            live = self.jobs.get(job_id)
            if live is None and record["result"].get("task_ids"):
                # durable record, no in-proc state: this manager restarted
                # since the job was created. Adopt the task list and poll
                # live task states — the job converges after recovery
                # instead of pending forever.
                self.jobs.adopt(job_id, record["result"]["task_ids"])
                live = self.jobs.get(job_id)
            if live is not None and live.state.value != record["state"]:
                record = self.db.update(
                    "jobs", record_id,
                    {"state": live.state.value,
                     "result": {**record["result"], **live.detail}},
                )
        return record

    def _merge_sync_peers(self, result: dict) -> None:
        """Merge the schedulers' announced hosts into the peers table
        (manager/job/sync_peers.go:230-255): upsert present hosts as
        active, flip departed ones inactive. Race-safe under the threaded
        REST server via the create/except-DuplicateRecord idiom the other
        registration paths use."""
        seen: set[tuple[str, str]] = set()
        for data in result.values():
            for h in data.get("announced_hosts", []):
                row = {
                    "host_name": h["hostname"],
                    "type": h["type"],
                    "ip": h["ip"],
                    "port": h["port"],
                    "download_port": h["download_port"],
                    "idc": h["idc"],
                    "location": h["location"],
                    "state": "active",
                }
                seen.add((h["hostname"], h["ip"]))
                try:
                    self.db.create("peers", row)
                except DuplicateRecord:
                    existing = self.db.find_one(
                        "peers", {"host_name": h["hostname"], "ip": h["ip"]}
                    )
                    if existing is not None:
                        self.db.update("peers", existing["id"], row)
        for r in self.db.list("peers", per_page=1_000_000):
            if (r["host_name"], r["ip"]) not in seen and r.get("state") == "active":
                self.db.update("peers", r["id"], {"state": "inactive"})

    # --------------------------------------------------- personal access tokens

    def create_personal_access_token(self, body: dict) -> dict:
        token = os.urandom(20).hex()
        return self.db.create(
            "personal_access_tokens",
            {
                "name": body["name"],
                "bio": body.get("bio", ""),
                "token": token,
                "scopes": body.get("scopes", []),
                "state": "active",
                "expired_at": body.get("expired_at", time.time() + 365 * 24 * 3600),
                "user_id": body.get("user_id"),
            },
        )

    # ------------------------------------------------------------ dynconfig

    def scheduler_dynconfig(self, scheduler_cluster_id: int) -> dict:
        """What a scheduler polls: its cluster config + client config +
        the cluster's seed peers (scheduler/config/dynconfig.go get)."""
        sc = self.db.get("scheduler_clusters", scheduler_cluster_id)
        seed_peers = []
        for spc in self.db.list("seed_peer_clusters", per_page=100000):
            if scheduler_cluster_id in spc.get("scheduler_cluster_ids", []):
                seed_peers += self.db.list("seed_peers", {"seed_peer_cluster_id": spc["id"]})
        return {
            "scheduler_cluster_config": sc.get("config", {}),
            "client_config": sc.get("client_config", {}),
            "seed_peers": seed_peers,
        }


_SOURCE_TABLES = {
    "scheduler": ("schedulers", "scheduler_cluster_id"),
    "seed_peer": ("seed_peers", "seed_peer_cluster_id"),
}


def _redact_user(record: dict) -> dict:
    return {k: v for k, v in record.items() if k != "encrypted_password"}
