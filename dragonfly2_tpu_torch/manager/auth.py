"""Manager auth: password hashing, signed tokens, RBAC, PATs.

Port of dragonfly2_tpu/manager/auth.py, whole: the same token bytes for one secret and clock.

Capability parity with the reference's auth stack — gin-jwt signin/refresh
(manager/auth), casbin RBAC with the `r.sub/obj/act` exact-object model
(manager/permission/rbac/rbac.go modelText: `g(r.sub,p.sub) && r.obj ==
p.obj && (r.act == p.act || p.act == "*")`, roles `root`/`guest`, actions
`read`/`*`), bcrypt passwords, and personal access tokens with scopes +
expiry (manager/models/personal_access_token.go). Implemented on stdlib:
pbkdf2 for passwords, HMAC-SHA256 compact tokens (JWT-shaped:
base64url(header).payload.signature), policy rules persisted in the same
sqlite `casbin_rules` table the Database migrates.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time

from dragonfly2_tpu_torch.manager.models import Database

ROOT_ROLE = "root"
GUEST_ROLE = "guest"
ALL_ACTION = "*"
READ_ACTION = "read"

# The REST object groups (manager/router/router.go route groups — what the
# reference derives at runtime from the gin route table).
OBJECTS = (
    "users", "roles", "permissions", "oauth", "clusters", "scheduler-clusters",
    "schedulers", "seed-peer-clusters", "seed-peers", "peers", "buckets",
    "configs", "jobs", "applications", "models", "personal-access-tokens",
    "flight-recorder",
)

_PBKDF2_ITERS = 100_000


def hash_password(password: str, salt: bytes | None = None) -> str:
    salt = salt or os.urandom(16)
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, _PBKDF2_ITERS)
    return f"{salt.hex()}${digest.hex()}"


def verify_password(password: str, encrypted: str) -> bool:
    try:
        salt_hex, digest_hex = encrypted.split("$", 1)
    except ValueError:
        return False
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(), bytes.fromhex(salt_hex), _PBKDF2_ITERS)
    return hmac.compare_digest(digest.hex(), digest_hex)


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(data: str) -> bytes:
    return base64.urlsafe_b64decode(data + "=" * (-len(data) % 4))


class TokenAuthority:
    """HS256 compact tokens: issue on signin, verify per request, refresh
    extends expiry (gin-jwt LoginHandler/RefreshHandler semantics)."""

    def __init__(self, secret: bytes | None = None, ttl: float = 2 * 3600.0):
        self.secret = secret or os.urandom(32)
        self.ttl = ttl

    def issue(self, user_id: int, name: str, now: float | None = None) -> str:
        now = time.time() if now is None else now
        header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
        payload = _b64(
            json.dumps({"id": user_id, "name": name, "iat": now, "exp": now + self.ttl}).encode()
        )
        signing_input = f"{header}.{payload}".encode()
        sig = _b64(hmac.new(self.secret, signing_input, hashlib.sha256).digest())
        return f"{header}.{payload}.{sig}"

    def verify(self, token: str, now: float | None = None) -> dict | None:
        """Claims dict, or None if the signature or expiry fails."""
        now = time.time() if now is None else now
        try:
            header, payload, sig = token.split(".")
            signing_input = f"{header}.{payload}".encode()
            expect = _b64(hmac.new(self.secret, signing_input, hashlib.sha256).digest())
            if not hmac.compare_digest(sig, expect):
                return None
            claims = json.loads(_unb64(payload))
        except (ValueError, json.JSONDecodeError):
            return None
        if claims.get("exp", 0) < now:
            return None
        return claims

    def refresh(self, token: str) -> str | None:
        claims = self.verify(token)
        if claims is None:
            return None
        return self.issue(claims["id"], claims["name"])


class Enforcer:
    """casbin-equivalent RBAC over Database.casbin_rules.

    Rules: p=(role, object, action); g=(user, role). Matcher is the
    reference's: role membership AND exact object AND (exact action or
    policy action "*").
    """

    def __init__(self, db: Database):
        self.db = db

    def init_policies(self) -> None:
        """InitRBAC: root gets `*` and guest gets `read` on every object."""
        existing = {tuple(f) for _, f in self.db.rules("p")}
        for obj in OBJECTS:
            if (ROOT_ROLE, obj, ALL_ACTION) not in existing:
                self.db.add_rule("p", ROOT_ROLE, obj, ALL_ACTION)
            if (GUEST_ROLE, obj, READ_ACTION) not in existing:
                self.db.add_rule("p", GUEST_ROLE, obj, READ_ACTION)

    # roles

    def add_role_for_user(self, user: str, role: str) -> bool:
        if role in self.roles_for_user(user):
            return False
        self.db.add_rule("g", user, role)
        return True

    def delete_role_for_user(self, user: str, role: str) -> bool:
        return self.db.remove_rules("g", [user, role]) > 0

    def roles_for_user(self, user: str) -> list[str]:
        return [f[1] for _, f in self.db.rules("g") if f[0] == user]

    def roles(self) -> list[str]:
        return sorted({f[0] for _, f in self.db.rules("p")})

    # permissions

    def add_permission(self, role: str, obj: str, action: str) -> None:
        self.db.add_rule("p", role, obj, action)

    def delete_permission(self, role: str, obj: str, action: str) -> bool:
        return self.db.remove_rules("p", [role, obj, action]) > 0

    def permissions_for_role(self, role: str) -> list[tuple[str, str]]:
        return [(f[1], f[2]) for _, f in self.db.rules("p") if f[0] == role]

    def enforce(self, user: str, obj: str, action: str) -> bool:
        subjects = {user, *self.roles_for_user(user)}
        for _, fields in self.db.rules("p"):
            role, pobj, pact = fields
            if role in subjects and pobj == obj and (pact == action or pact == ALL_ACTION):
                return True
        return False


def http_method_action(method: str) -> str:
    """GET/HEAD -> read, everything else -> *(write) — the reference's
    middleware mapping (manager/middlewares/rbac.go semantics)."""
    return READ_ACTION if method.upper() in ("GET", "HEAD") else ALL_ACTION


def verify_personal_access_token(db: Database, token: str, now: float | None = None) -> dict | None:
    """PAT middleware: token exists, active, unexpired
    (manager/middlewares/personal_access_token.go semantics)."""
    now = time.time() if now is None else now
    record = db.find_one("personal_access_tokens", {"token": token})
    if record is None or record.get("state") != "active":
        return None
    if record.get("expired_at", 0) < now:
        return None
    return record
