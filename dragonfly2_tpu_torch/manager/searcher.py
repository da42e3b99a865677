"""Searcher: score scheduler clusters for a joining daemon.

Port of dragonfly2_tpu/manager/searcher.py, whole.

Capability parity with manager/searcher/searcher.go:94-276 — the exact
affinity blend: 0.3·CIDR + 0.3·hostname-regex + 0.25·IDC + 0.14·location +
0.01·cluster-type, with the same semantics: CIDR containment via parsed
networks, hostname tested against each regex in scopes, IDC matches any
`|`-separated source element, location scored as matching leading elements
/ 5 (maxElementLen), default cluster scores the type point. Clusters with
no active schedulers are filtered out first (FilterSchedulerClusters).
Plugin override supported via utils.plugins (the reference loads a .so
searcher plugin, manager/searcher/plugin.go).
"""

from __future__ import annotations

import ipaddress
import re
from dataclasses import dataclass, field

CIDR_AFFINITY_WEIGHT = 0.3
HOSTNAME_AFFINITY_WEIGHT = 0.3
IDC_AFFINITY_WEIGHT = 0.25
LOCATION_AFFINITY_WEIGHT = 0.14
CLUSTER_TYPE_WEIGHT = 0.01

MAX_ELEMENT_LEN = 5  # searcher.go maxElementLen
AFFINITY_SEPARATOR = "|"  # pkg/types AffinitySeparator

CONDITION_IDC = "idc"
CONDITION_LOCATION = "location"


@dataclass
class Scopes:
    """Scheduler-cluster scopes (searcher.go:79-84)."""

    idc: str = ""
    location: str = ""
    cidrs: list[str] = field(default_factory=list)
    hostnames: list[str] = field(default_factory=list)


def cidr_affinity_score(ip: str, cidrs: list[str]) -> float:
    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return 0.0
    for cidr in cidrs:
        try:
            if addr in ipaddress.ip_network(cidr, strict=False):
                return 1.0
        except ValueError:
            continue
    return 0.0


def hostname_affinity_score(hostname: str, patterns: list[str]) -> float:
    if not hostname or not patterns:
        return 0.0
    for pattern in patterns:
        try:
            if re.search(pattern, hostname):
                return 1.0
        except re.error:
            continue
    return 0.0


def idc_affinity_score(dst: str, src: str) -> float:
    if not dst or not src:
        return 0.0
    if dst.casefold() == src.casefold():
        return 1.0
    return float(
        any(dst.casefold() == el.casefold() for el in src.split(AFFINITY_SEPARATOR))
    )


def multi_element_affinity_score(dst: str, src: str) -> float:
    """Matching leading `|`-elements / 5 (searcher.go:243-271)."""
    if not dst or not src:
        return 0.0
    if dst.casefold() == src.casefold():
        return 1.0
    dst_elements = dst.split(AFFINITY_SEPARATOR)
    src_elements = src.split(AFFINITY_SEPARATOR)
    n = min(len(dst_elements), len(src_elements), MAX_ELEMENT_LEN)
    score = 0
    for i in range(n):
        if dst_elements[i].casefold() != src_elements[i].casefold():
            break
        score += 1
    return score / MAX_ELEMENT_LEN


def evaluate(ip: str, hostname: str, conditions: dict, scopes: Scopes, is_default: bool) -> float:
    return (
        CIDR_AFFINITY_WEIGHT * cidr_affinity_score(ip, scopes.cidrs)
        + HOSTNAME_AFFINITY_WEIGHT * hostname_affinity_score(hostname, scopes.hostnames)
        + IDC_AFFINITY_WEIGHT * idc_affinity_score(conditions.get(CONDITION_IDC, ""), scopes.idc)
        + LOCATION_AFFINITY_WEIGHT
        * multi_element_affinity_score(conditions.get(CONDITION_LOCATION, ""), scopes.location)
        + CLUSTER_TYPE_WEIGHT * (1.0 if is_default else 0.0)
    )


class Searcher:
    def find_scheduler_clusters(
        self,
        scheduler_clusters: list[dict],
        ip: str,
        hostname: str,
        conditions: dict | None = None,
    ) -> list[dict]:
        """Rank cluster records (Database rows: `scopes` dict, `is_default`
        bool, `schedulers` list of active scheduler rows) best-first.
        Raises ValueError when nothing is eligible, matching the
        reference's error returns (searcher.go:105-117)."""
        if not scheduler_clusters:
            raise ValueError("empty scheduler clusters")
        conditions = conditions or {}
        eligible = [c for c in scheduler_clusters if c.get("schedulers")]
        if not eligible:
            raise ValueError(f"conditions {conditions!r} does not match any scheduler cluster")
        return sorted(
            eligible,
            key=lambda c: evaluate(
                ip, hostname, conditions, _scopes_of(c), bool(c.get("is_default"))
            ),
            reverse=True,
        )


def _scopes_of(cluster: dict) -> Scopes:
    raw = cluster.get("scopes") or {}
    return Scopes(
        idc=raw.get("idc", ""),
        location=raw.get("location", ""),
        cidrs=list(raw.get("cidrs") or []),
        hostnames=list(raw.get("hostnames") or []),
    )


def new_searcher(plugin_dir: str | None = None, name: str = "default") -> Searcher:
    """Plugin-overridable constructor (searcher.go New: try plugin, fall
    back to the default)."""
    if plugin_dir:
        from dragonfly2_tpu_torch.utils import plugins

        try:
            return plugins.load(plugin_dir, "searcher", name)
        except FileNotFoundError:
            pass
    return Searcher()
