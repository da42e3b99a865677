"""Manager REST API.

Port of dragonfly2_tpu/manager/rest.py, whole.

Capability parity with manager/router/router.go:101-246 + manager/handlers
(gin): `/api/v1` groups — users (signup/signin/refresh_token/reset_password/
roles), roles, permissions, oauth, clusters, scheduler-clusters, schedulers,
seed-peer-clusters, seed-peers, peers, buckets, configs, jobs, applications,
models, personal-access-tokens — JWT-authenticated with RBAC enforcement per
object group, plus `/oapi/v1` mirrors authenticated by personal access
token. Built on stdlib ThreadingHTTPServer: the control plane is pure host
code; nothing here touches the device.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dragonfly2_tpu_torch.manager import auth
from dragonfly2_tpu_torch.manager.models import DuplicateRecord, RecordNotFound
from dragonfly2_tpu_torch.manager.service import ManagerService
from dragonfly2_tpu_torch.telemetry import default_registry
from dragonfly2_tpu_torch.telemetry.series import manager_series, register_version

# Route-group -> Database table for the plain CRUD entities.
CRUD_TABLES = {
    "oauth": "oauth",
    "clusters": "clusters",
    "scheduler-clusters": "scheduler_clusters",
    "schedulers": "schedulers",
    "seed-peer-clusters": "seed_peer_clusters",
    "seed-peers": "seed_peers",
    "peers": "peers",
    "buckets": "buckets",
    "configs": "configs",
    "applications": "applications",
    "models": "models",
}

# Groups the reference leaves unauthenticated (router.go: signup/signin,
# GET /configs, all /jobs — "TODO Add auth").
_OPEN_ROUTES = {
    ("POST", "users", "signup"),
    ("POST", "users", "signin"),
    ("GET", "users", "signin"),  # oauth signin + callback (router.go:108-109)
    ("POST", "users", "refresh_token"),
    ("GET", "configs", None),
    ("*", "jobs", None),
}


class _Request:
    def __init__(
        self,
        method: str,
        group: str,
        parts: list[str],
        body: dict,
        user: dict | None,
        query: dict | None = None,
    ):
        self.method = method
        self.group = group
        self.parts = parts  # path segments after the group
        self.body = body
        self.user = user
        self.query = query or {}  # first value per query param


class ManagerREST:
    def __init__(self, service: ManagerService, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        reg = default_registry()
        self.metrics = manager_series(reg)
        register_version(reg, "manager")
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _run(self):
                # The console page is served here, OUTSIDE handle(): an
                # in-band sentinel key in JSON payloads would let any
                # attacker-controlled record (e.g. the open /jobs CRUD)
                # smuggle text/html bytes into a response — stored XSS.
                if self.command == "GET" and self.path.partition("?")[0].rstrip("/") in ("", "/console"):
                    from dragonfly2_tpu_torch.manager.console import CONSOLE_HTML

                    raw = CONSOLE_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(raw)))
                    self.end_headers()
                    self.wfile.write(raw)
                    return
                try:
                    status, payload = outer.handle(
                        self.command, self.path, self._body(), self.headers
                    )
                except DuplicateRecord as e:
                    status, payload = 409, {"error": str(e)}
                except (RecordNotFound, KeyError) as e:
                    status, payload = 404, {"error": str(e)}
                except PermissionError as e:
                    status, payload = 401, {"error": str(e)}
                except ValueError as e:
                    status, payload = 400, {"error": str(e)}
                except Exception as e:  # noqa: BLE001 - surface as 500
                    status, payload = 500, {"error": f"{type(e).__name__}: {e}"}
                # totals and failures derive the group label the same way,
                # so failure/total ratios are well-formed per label set
                gm = re.match(r"^/(?:api|oapi)/v1/([-a-z_]+)", self.path)
                group = gm.group(1) if gm else ""
                outer.metrics.request.labels(self.command, group).inc()
                if status >= 400:
                    outer.metrics.request_failure.labels(self.command, group).inc()
                raw = json.dumps(payload).encode()
                self.send_response(status)
                if status in (301, 302) and isinstance(payload, dict) and payload.get("location"):
                    # oauth signin redirects the browser to the provider's
                    # consent page (handlers/user.go:204 ctx.Redirect)
                    self.send_header("Location", payload["location"])
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length") or 0)
                if not length:
                    return {}
                try:
                    return json.loads(self.rfile.read(length))
                except json.JSONDecodeError:
                    return {}

            do_GET = do_POST = do_PATCH = do_PUT = do_DELETE = _run

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> tuple[str, int]:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.host, self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    # ------------------------------------------------------------- dispatch

    def handle(self, method: str, path: str, body: dict, headers) -> tuple[int, object]:
        path, _, query_string = path.partition("?")
        path = path.rstrip("/")
        query = {
            k: v[0] for k, v in urllib.parse.parse_qs(query_string).items()
        }
        if method == "GET" and path in ("/swagger.json", "/swagger/doc.json"):
            # machine-readable API spec from the route table (the
            # reference ships generated swagger, api/manager/docs.go).
            # (The console SPA at "/" is served directly by the HTTP
            # handler — handle() only ever returns JSON payloads.)
            return 200, openapi_spec()
        m = re.match(r"^/(api|oapi)/v1/([-a-z_]+)(?:/(.*))?$", path)
        if not m:
            return 404, {"error": f"no route for {path}"}
        surface, group, rest = m.group(1), m.group(2), m.group(3) or ""
        parts = [p for p in rest.split("/") if p]

        user = self._authenticate(surface, method, group, parts, headers)
        req = _Request(method, group, parts, body, user, query)
        if group == "users":
            return self._users(req)
        if group == "roles":
            return self._roles(req)
        if group == "permissions":
            return 200, [{"object": o, "actions": ["read", "*"]} for o in auth.OBJECTS]
        if group == "jobs":
            return self._jobs(req)
        if group == "flight-recorder":
            # JWT-authenticated ("flight-recorder" read permission, granted
            # to guest+root by init_policies): the dump fans one RPC out to
            # every scheduler, so anonymous callers must not drive it
            if method != "GET" or parts:
                return 405, {"error": "method not allowed"}
            try:
                last_n = min(max(int(req.query.get("last_n", 64) or 64), 1), 4096)
            except ValueError:
                return 400, {"error": "last_n must be an integer"}
            return 200, self.service.flight_recorder(last_n)
        if group == "models" and method == "PATCH" and len(parts) == 1:
            return self._update_model(req)
        if group == "personal-access-tokens":
            return self._pats(req)
        table = CRUD_TABLES.get(group)
        if table is None:
            return 404, {"error": f"unknown group {group}"}
        return self._crud(table, req)

    def _authenticate(self, surface, method, group, parts, headers) -> dict | None:
        sub = parts[0] if parts else None
        if surface == "api":
            for om, og, osub in _OPEN_ROUTES:
                if og == group and (om in ("*", method)) and (osub is None or osub == sub):
                    return None
        header = headers.get("Authorization", "")
        token = header.removeprefix("Bearer ").strip()
        if surface == "oapi":
            record = auth.verify_personal_access_token(self.service.db, token)
            if record is None:
                raise PermissionError("invalid personal access token")
            return record
        claims = self.service.tokens.verify(token)
        if claims is None:
            raise PermissionError("invalid or expired token")
        action = auth.http_method_action(method)
        if not self.service.enforcer.enforce(claims["name"], group, action):
            raise PermissionError(f"{claims['name']} lacks {action} on {group}")
        return claims

    # -------------------------------------------------------------- handlers

    def _crud(self, table: str, req: _Request) -> tuple[int, object]:
        svc = self.service
        if req.method == "POST" and not req.parts:
            if table == "clusters":
                return 200, svc.create_cluster(req.body)
            return 200, svc.db.create(table, req.body)
        if req.method == "GET" and not req.parts:
            try:
                page, per_page, where = self._list_params(req)
            except ValueError as e:
                return 400, {"error": str(e)}
            return 200, svc.db.list(table, where or None, page=page, per_page=per_page)
        if not req.parts:
            return 405, {"error": "method not allowed"}
        record_id = int(req.parts[0])
        if req.method == "GET":
            return 200, svc.db.get(table, record_id)
        if req.method == "PATCH":
            return 200, svc.db.update(table, record_id, req.body)
        if req.method == "DELETE":
            if table == "clusters":
                svc.delete_cluster(record_id)
            else:
                svc.db.delete(table, record_id)
            return 200, {}
        if req.method == "PUT" and len(req.parts) == 3:
            # association routes: /:id/<child-group>/:child_id (router.go
            # AddSchedulerToSchedulerCluster and friends)
            child_group, child_id = req.parts[1], int(req.parts[2])
            return self._associate(table, record_id, child_group, child_id)
        return 405, {"error": "method not allowed"}

    def _associate(self, table, record_id, child_group, child_id) -> tuple[int, object]:
        svc = self.service
        if table == "scheduler_clusters" and child_group == "schedulers":
            svc.db.update("schedulers", child_id, {"scheduler_cluster_id": record_id})
        elif table == "seed_peer_clusters" and child_group == "seed-peers":
            svc.db.update("seed_peers", child_id, {"seed_peer_cluster_id": record_id})
        elif table == "seed_peer_clusters" and child_group == "scheduler-clusters":
            spc = svc.db.get("seed_peer_clusters", record_id)
            ids = set(spc.get("scheduler_cluster_ids", []))
            ids.add(child_id)
            svc.db.update("seed_peer_clusters", record_id, {"scheduler_cluster_ids": sorted(ids)})
        else:
            return 404, {"error": f"no association {table}/{child_group}"}
        return 200, {}

    def _users(self, req: _Request) -> tuple[int, object]:
        svc = self.service
        if req.method == "POST" and req.parts == ["signup"]:
            return 200, svc.sign_up(req.body["name"], req.body["password"], req.body.get("email", ""))
        if req.method == "POST" and req.parts == ["signin"]:
            token = svc.sign_in(req.body["name"], req.body["password"])
            return 200, {"token": token}
        if req.method == "POST" and req.parts == ["refresh_token"]:
            token = svc.tokens.refresh(req.body.get("token", ""))
            if token is None:
                raise PermissionError("cannot refresh")
            return 200, {"token": token}
        # oauth2 authorization-code flow (router.go:108-109)
        if req.method == "GET" and len(req.parts) == 2 and req.parts[0] == "signin":
            return 302, {"location": svc.oauth_signin(req.parts[1])}
        if (
            req.method == "GET"
            and len(req.parts) == 3
            and req.parts[0] == "signin"
            and req.parts[2] == "callback"
        ):
            token = svc.oauth_signin_callback(
                req.parts[1], req.query.get("code", ""), req.query.get("state", "")
            )
            return 200, {"token": token}
        if req.method == "GET" and not req.parts:
            return 200, svc.get_users()
        if not req.parts:
            return 405, {"error": "method not allowed"}
        user_id = int(req.parts[0])
        if req.method == "POST" and req.parts[1:] == ["reset_password"]:
            svc.reset_password(user_id, req.body["new_password"])
            return 200, {}
        if req.method == "GET" and req.parts[1:] == ["roles"]:
            return 200, svc.enforcer.roles_for_user(svc.get_user(user_id)["name"])
        if req.parts[1:2] == ["roles"] and len(req.parts) == 3:
            name = svc.get_user(user_id)["name"]
            if req.method == "PUT":
                svc.enforcer.add_role_for_user(name, req.parts[2])
                return 200, {}
            if req.method == "DELETE":
                svc.enforcer.delete_role_for_user(name, req.parts[2])
                return 200, {}
        if req.method == "GET":
            return 200, svc.get_user(user_id)
        if req.method == "PATCH":
            return 200, svc.update_user(user_id, req.body)
        return 405, {"error": "method not allowed"}

    def _roles(self, req: _Request) -> tuple[int, object]:
        enforcer = self.service.enforcer
        if req.method == "POST" and not req.parts:
            role = req.body["role"]
            for perm in req.body.get("permissions", []):
                enforcer.add_permission(role, perm["object"], perm["action"])
            return 200, {}
        if req.method == "GET" and not req.parts:
            return 200, enforcer.roles()
        role = req.parts[0]
        if req.method == "GET":
            return 200, [
                {"object": o, "action": a} for o, a in enforcer.permissions_for_role(role)
            ]
        if req.method == "DELETE" and len(req.parts) == 1:
            self.service.db.remove_rules("p", [role])
            return 200, {}
        if req.parts[1:] == ["permissions"]:
            perm = req.body
            if req.method == "POST":
                enforcer.add_permission(role, perm["object"], perm["action"])
                return 200, {}
            if req.method == "DELETE":
                enforcer.delete_permission(role, perm["object"], perm["action"])
                return 200, {}
        return 405, {"error": "method not allowed"}

    @staticmethod
    def _list_params(req: _Request) -> tuple[int, int, dict]:
        """?page/?per_page pagination (bounded BOTH ways — SQLite treats a
        negative LIMIT as unlimited, so an unclamped per_page=-1 would
        dump the whole table) + query-by-example filters from the
        remaining query params (the handlers' GORM listing parity; the DB
        layer matches numeric-looking strings against integer JSON
        fields). The old fixed per_page=100 silently truncated every list
        and any count derived from one."""
        query = dict(req.query)
        try:
            page = max(int(query.pop("page", 1) or 1), 1)
            per_page = min(max(int(query.pop("per_page", 100) or 100), 1), 10_000)
        except ValueError:
            raise ValueError("page/per_page must be integers") from None
        where = {k: v for k, v in req.body.items()} if req.body else {}
        where.update(query)
        return page, per_page, where

    def _jobs(self, req: _Request) -> tuple[int, object]:
        svc = self.service
        if req.method == "POST" and not req.parts:
            return 200, svc.create_job(req.body)
        if req.method == "GET" and not req.parts:
            try:
                page, per_page, where = self._list_params(req)
            except ValueError as e:
                return 400, {"error": str(e)}
            return 200, svc.db.list("jobs", where or None, page=page, per_page=per_page)
        job_id = int(req.parts[0])
        if req.method == "GET":
            return 200, svc.get_job(job_id)
        if req.method == "PATCH":
            return 200, svc.db.update("jobs", job_id, req.body)
        if req.method == "DELETE":
            svc.db.delete("jobs", job_id)
            return 200, {}
        return 405, {"error": "method not allowed"}

    def _update_model(self, req: _Request) -> tuple[int, object]:
        """PATCH /models/:id with {"state": "active"} activates that version
        everywhere (registry + DB mirror), matching
        manager/service/model.go:109-190."""
        record = self.service.db.get("models", int(req.parts[0]))
        if req.body.get("state") == "active" and self.service.registry is not None:
            self.service.activate_model(record["model_id"], record["version"])
            return 200, self.service.db.get("models", record["id"])
        return 200, self.service.db.update("models", record["id"], req.body)

    def _pats(self, req: _Request) -> tuple[int, object]:
        svc = self.service
        if req.method == "POST" and not req.parts:
            body = dict(req.body)
            if req.user is not None:
                body.setdefault("user_id", req.user.get("id"))
            return 200, svc.create_personal_access_token(body)
        return self._crud("personal_access_tokens", req)


def openapi_spec() -> dict:
    """OpenAPI 3.0 document generated from the live route table — the
    machine-readable twin of api/manager/docs.go (5.3k generated LoC in
    the reference), built from CRUD_TABLES + the special routes so it can
    never drift from what `handle()` actually serves."""
    from dragonfly2_tpu_torch import version as _version

    def op(summary, group, *, body=False, params=()):
        entry = {
            "summary": summary,
            "tags": [group],
            "responses": {"200": {"description": "OK"}},
        }
        if body:
            entry["requestBody"] = {
                "content": {"application/json": {"schema": {"type": "object"}}}
            }
        if params:
            entry["parameters"] = [
                {
                    "name": p,
                    "in": "path",
                    "required": True,
                    "schema": {"type": "string"},
                }
                for p in params
            ]
        return entry

    paths: dict = {}
    for group in sorted(CRUD_TABLES):
        paths[f"/api/v1/{group}"] = {
            "get": op(f"list {group}", group),
            "post": op(f"create one of {group}", group, body=True),
        }
        paths[f"/api/v1/{group}/{{id}}"] = {
            "get": op(f"get one of {group}", group, params=("id",)),
            "patch": op(f"update one of {group}", group, body=True, params=("id",)),
            "delete": op(f"delete one of {group}", group, params=("id",)),
        }
    paths["/api/v1/users/signup"] = {"post": op("sign up", "users", body=True)}
    paths["/api/v1/users/signin"] = {"post": op("sign in -> JWT", "users", body=True)}
    paths["/api/v1/users/refresh_token"] = {
        "post": op("refresh JWT", "users", body=True)
    }
    paths["/api/v1/users/signin/{name}"] = {
        "get": op("oauth signin redirect", "users", params=("name",))
    }
    paths["/api/v1/users/signin/{name}/callback"] = {
        "get": op("oauth signin callback -> JWT", "users", params=("name",))
    }
    paths["/api/v1/users/{id}/reset_password"] = {
        "post": op("reset password", "users", body=True, params=("id",))
    }
    paths["/api/v1/users/{id}/roles"] = {
        "get": op("roles for user", "users", params=("id",))
    }
    paths["/api/v1/users/{id}/roles/{role}"] = {
        "put": op("grant role", "users", params=("id", "role")),
        "delete": op("revoke role", "users", params=("id", "role")),
    }
    paths["/api/v1/roles"] = {
        "get": op("list roles", "roles"),
        "post": op("create role with permissions", "roles", body=True),
    }
    paths["/api/v1/roles/{role}"] = {
        "get": op("permissions of role", "roles", params=("role",)),
        "delete": op("delete role", "roles", params=("role",)),
    }
    paths["/api/v1/roles/{role}/permissions"] = {
        "post": op("add permission", "roles", body=True, params=("role",)),
        "delete": op("remove permission", "roles", body=True, params=("role",)),
    }
    paths["/api/v1/permissions"] = {"get": op("list permission objects", "permissions")}
    paths["/api/v1/jobs"] = {
        "get": op("list jobs", "jobs"),
        "post": op("create job (preheat / sync_peers)", "jobs", body=True),
    }
    paths["/api/v1/flight-recorder"] = {
        "get": op(
            "flight-recorder dump: last-N scheduler tick phase breakdowns, "
            "jit compile/retrace counters, open spans (?last_n=64)",
            "flight-recorder",
        )
    }
    paths["/api/v1/jobs/{id}"] = {"get": op("get job", "jobs", params=("id",))}
    paths["/api/v1/personal-access-tokens"] = {
        "get": op("list PATs", "personal-access-tokens"),
        "post": op("create PAT", "personal-access-tokens", body=True),
    }
    paths["/api/v1/personal-access-tokens/{id}"] = {
        "delete": op("revoke PAT", "personal-access-tokens", params=("id",)),
    }
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "Dragonfly2-TPU Manager API",
            "version": _version.GIT_VERSION,
            "description": "REST control plane (manager/router/router.go parity)",
        },
        "components": {
            "securitySchemes": {
                "bearerAuth": {"type": "http", "scheme": "bearer", "bearerFormat": "JWT"}
            }
        },
        "security": [{"bearerAuth": []}],
        "paths": paths,
    }
