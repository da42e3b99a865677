"""P2P transport: route matching requests through the mesh.

Port of dragonfly2_tpu/client/transport.py, whole.

Capability parity with client/daemon/transport/transport.go:458 — a
RoundTripper that sends requests matching the hijack rules through the P2P
stream task and everything else direct. Here: `fetch(url)` returns the
bytes, P2P when a rule matches (daemon.download + local piece store read),
direct urllib otherwise.
"""

from __future__ import annotations

import dataclasses
import re
import urllib.request


@dataclasses.dataclass
class ProxyRule:
    """One hijack rule (client/config proxy rules: regx, useHTTPS, direct,
    redirect)."""

    regex: str
    use_https: bool = False
    direct: bool = False
    redirect: str = ""

    def matches(self, url: str) -> bool:
        return re.search(self.regex, url) is not None

    def rewrite(self, url: str) -> str:
        if self.redirect:
            # reference semantics: redirect replaces the host
            url = re.sub(r"^(https?://)[^/]+", rf"\g<1>{self.redirect}", url)
        if self.use_https:
            url = re.sub(r"^http://", "https://", url)
        return url


class P2PTransport:
    def __init__(self, daemon, rules: list[ProxyRule] | None = None, timeout: float = 60.0):
        self.daemon = daemon
        self.rules = rules or []
        self.timeout = timeout

    def route(self, url: str) -> tuple[str, ProxyRule | None]:
        for rule in self.rules:
            if rule.matches(url):
                return rule.rewrite(url), rule
        return url, None

    async def fetch(self, url: str, headers: dict | None = None) -> "FetchResult":
        """The p2p path honors a `Range: bytes=a-b` request header by
        slicing the cached task (the reference serves ranged requests out
        of the piece store, transport.go + storage reuse-by-range); the
        direct path forwards Range and reports the origin's own status."""
        headers = headers or {}
        target, rule = self.route(url)
        if rule is not None and not rule.direct:
            ts = await self.daemon.download(target)
            total = max(ts.meta.content_length, 0)
            rng = parse_range(_header(headers, "range"), total)
            if rng is not None:
                start, end = rng
                return FetchResult(
                    status=206,
                    body=ts.read_range(start, end - start + 1),
                    via="p2p",
                    content_range=f"bytes {start}-{end}/{total}",
                )
            return FetchResult(status=200, body=ts.read_range(0, total), via="p2p")
        status, resp_headers, body = await self._direct_full(target, headers)
        return FetchResult(
            status=status,
            body=body,
            via="direct",
            content_range=resp_headers.get("Content-Range", ""),
        )

    async def _direct(
        self,
        url: str,
        headers: dict | None,
        method: str = "GET",
        body: bytes | None = None,
    ) -> bytes:
        _, _, data = await self._direct_full(url, headers, method, body)
        return data

    async def _direct_full(
        self,
        url: str,
        headers: dict | None,
        method: str = "GET",
        body: bytes | None = None,
    ) -> tuple[int, dict, bytes]:
        import asyncio

        def run():
            req = urllib.request.Request(url, data=body, headers=headers or {}, method=method)
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, dict(resp.headers), resp.read()

        return await asyncio.to_thread(run)


@dataclasses.dataclass
class FetchResult:
    status: int
    body: bytes
    via: str
    content_range: str = ""


def parse_range(header: str | None, total: int) -> tuple[int, int] | None:
    """`bytes=a-b` -> inclusive (start, end) clamped to total; None when
    absent/unsatisfiable. Suffix form `bytes=-n` means the last n bytes."""
    if not header:
        return None
    m = re.fullmatch(r"bytes=(\d*)-(\d*)", header.strip())
    if m is None or total <= 0:
        return None
    start_s, end_s = m.group(1), m.group(2)
    if start_s == "" and end_s == "":
        return None
    if start_s == "":  # suffix: last n bytes
        n = min(int(end_s), total)
        return (total - n, total - 1) if n > 0 else None
    start = int(start_s)
    if start >= total:
        return None
    end = min(int(end_s), total - 1) if end_s else total - 1
    if end < start:
        return None
    return start, end


def _header(headers: dict, name: str) -> str | None:
    for k, v in headers.items():
        if k.lower() == name:
            return v
    return None
