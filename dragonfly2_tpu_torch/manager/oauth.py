"""OAuth2 sign-in providers — the authorization-code flow.

Port of dragonfly2_tpu/manager/oauth.py, whole.

Capability parity with manager/auth/oauth/{oauth,github,google}.go: a
provider wraps client id/secret + the three endpoint URLs; `signin`
redirects the browser to the provider's consent page, the callback
exchanges the code for a token and fetches the user profile, and the
manager then issues its normal JWT for that (created-on-first-signin)
user. Endpoint URLs are constructor arguments with github/google
defaults, so tests (and self-hosted IdPs) can point a provider at any
token/userinfo server — the reference hard-wires golang.org/x/oauth2's
endpoint tables instead.

State parameter: generated per signin and validated at the callback with
a TTL (the reference generates but never checks it, oauth/github.go:50-56;
checking is strictly safer and costs one dict).
"""

from __future__ import annotations

import json
import secrets
import threading
import time
import urllib.parse
import urllib.request

GITHUB_AUTH_URL = "https://github.com/login/oauth/authorize"
GITHUB_TOKEN_URL = "https://github.com/login/oauth/access_token"
GITHUB_USERINFO_URL = "https://api.github.com/user"
GOOGLE_AUTH_URL = "https://accounts.google.com/o/oauth2/auth"
GOOGLE_TOKEN_URL = "https://oauth2.googleapis.com/token"
GOOGLE_USERINFO_URL = "https://www.googleapis.com/oauth2/v2/userinfo"

_STATE_TTL_S = 120.0  # oauth.go timeout = 2 minutes


class OAuthError(Exception):
    pass


class OAuthProvider:
    """One configured provider speaking the authorization-code flow."""

    def __init__(
        self,
        name: str,
        client_id: str,
        client_secret: str,
        redirect_url: str = "",
        auth_url: str = "",
        token_url: str = "",
        userinfo_url: str = "",
        scopes: list[str] | None = None,
        timeout: float = 120.0,
    ):
        if name == "github":
            auth_url = auth_url or GITHUB_AUTH_URL
            token_url = token_url or GITHUB_TOKEN_URL
            userinfo_url = userinfo_url or GITHUB_USERINFO_URL
            scopes = scopes if scopes is not None else ["user", "public_repo"]
        elif name == "google":
            auth_url = auth_url or GOOGLE_AUTH_URL
            token_url = token_url or GOOGLE_TOKEN_URL
            userinfo_url = userinfo_url or GOOGLE_USERINFO_URL
            scopes = scopes if scopes is not None else [
                "https://www.googleapis.com/auth/userinfo.email",
                "https://www.googleapis.com/auth/userinfo.profile",
            ]
        elif not (auth_url and token_url and userinfo_url):
            raise OAuthError(
                f"unknown oauth provider {name!r} needs explicit auth/token/userinfo urls"
            )
        self.name = name
        self.client_id = client_id
        self.client_secret = client_secret
        self.redirect_url = redirect_url
        self.auth_url = auth_url
        self.token_url = token_url
        self.userinfo_url = userinfo_url
        self.scopes = scopes or []
        self.timeout = timeout
        self._states: dict[str, float] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- signin

    def auth_code_url(self) -> str:
        """Consent-page URL with a fresh state (AuthCodeURL)."""
        state = secrets.token_urlsafe(16)
        now = time.monotonic()
        with self._lock:
            self._states[state] = now + _STATE_TTL_S
            for s, exp in list(self._states.items()):
                if exp < now:
                    del self._states[s]
        query = {
            "client_id": self.client_id,
            "response_type": "code",
            "state": state,
        }
        if self.redirect_url:
            query["redirect_uri"] = self.redirect_url
        if self.scopes:
            query["scope"] = " ".join(self.scopes)
        return f"{self.auth_url}?{urllib.parse.urlencode(query)}"

    def check_state(self, state: str) -> bool:
        with self._lock:
            exp = self._states.pop(state, None)
        return exp is not None and exp >= time.monotonic()

    # ----------------------------------------------------------- exchange

    def exchange(self, code: str) -> str:
        """Authorization code -> access token (Exchange)."""
        body = urllib.parse.urlencode(
            {
                "client_id": self.client_id,
                "client_secret": self.client_secret,
                "code": code,
                "grant_type": "authorization_code",
                **({"redirect_uri": self.redirect_url} if self.redirect_url else {}),
            }
        ).encode()
        req = urllib.request.Request(
            self.token_url,
            data=body,
            headers={
                "Accept": "application/json",
                "Content-Type": "application/x-www-form-urlencoded",
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = json.loads(resp.read())
        except (urllib.error.URLError, ValueError) as e:
            raise OAuthError(f"token exchange against {self.token_url} failed: {e}") from e
        token = payload.get("access_token")
        if not token:
            raise OAuthError(f"provider returned no access_token: {payload}")
        return token

    def get_user(self, token: str) -> dict:
        """Access token -> {name, email, avatar} (GetUser)."""
        req = urllib.request.Request(
            self.userinfo_url,
            headers={"Authorization": f"Bearer {token}", "Accept": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = json.loads(resp.read())
        except (urllib.error.URLError, ValueError) as e:
            raise OAuthError(f"userinfo against {self.userinfo_url} failed: {e}") from e
        # `subject` is the provider's STABLE identity (github numeric id /
        # google sub) — account linking must key on it, never on the
        # user-editable display name (anyone can rename themselves "root").
        subject = payload.get("id") or payload.get("sub") or payload.get("login") or ""
        name = payload.get("login") or payload.get("name") or ""
        if not subject or not name:
            raise OAuthError(f"provider userinfo has no usable identity: {payload}")
        return {
            "subject": str(subject),
            "name": str(name),
            "email": payload.get("email") or "",
            "avatar": payload.get("avatar_url") or payload.get("picture") or "",
        }


def provider_from_record(record: dict) -> OAuthProvider:
    """Build a provider from an `oauth` table row (manager/models Oauth:
    name/client_id/client_secret/redirect_url; the *_url extension columns
    let tests and self-hosted IdPs override the endpoints)."""
    return OAuthProvider(
        name=record["name"],
        client_id=record.get("client_id", ""),
        client_secret=record.get("client_secret", ""),
        redirect_url=record.get("redirect_url", ""),
        auth_url=record.get("auth_url", ""),
        token_url=record.get("token_url", ""),
        userinfo_url=record.get("userinfo_url", ""),
    )
