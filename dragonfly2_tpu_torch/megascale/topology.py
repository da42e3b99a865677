"""Port of dragonfly2_tpu/megascale/topology.py, whole and in numpy: the
splitmix64 mixer wraps in uint64 arithmetic, which numpy keeps and torch
would not, so every draw, cost and fault here equals the reference's bit
for bit.

Megascale topology: region/WAN host populations and the vectorized
counter-hashed link cost model.

Two deterministic samplers coexist in the scenario lab:

- ``scenarios/engine.ScenarioEngine`` draws per EVENT through blake2b
  over string keys — exact, but a Python call per piece. The per-peer
  oracle (``cluster/simulator.ClusterSimulator``) and the event-batch
  engine's oracle-compat mode both use it, so paired runs match draw for
  draw.
- This module's ``hash_u01`` draws per event BATCH through a splitmix64
  mixer over integer key columns — the same counter-based philosophy
  (a decision is a pure function of (seed, kind, event identity), never
  a stream position or a clock), vectorized. The WAN cost model uses it,
  which is what lets a 10^5–10^6-host scenario price millions of piece
  transfers in numpy instead of a blake2b loop. The two streams are
  intentionally distinct: WAN scenarios have no per-peer oracle to pair
  against (the oracle cannot express them), so the contract is
  run-to-run determinism, which the mixer gives exactly.

The link model itself follows the model-based characterization approach
of arXiv 2103.10515: parameterized RTT/bandwidth tiers per
topology relation (rack / IDC / region / WAN), not packet simulation.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from dragonfly2_tpu_torch.records import synth
from dragonfly2_tpu_torch.scenarios.spec import ScenarioSpec
from dragonfly2_tpu_torch.utils import idgen

NS_PER_MS = 1_000_000

# fault codes shared with megascale/engine.py (0 completes silently,
# 1 completes with the stall folded into cost, 2/3 abort the wave)
FAULT_NONE = 0
FAULT_STALL = 1
FAULT_ERROR = 2
FAULT_CORRUPT = 3

_FAULT_CODE = {None: FAULT_NONE, "stall": FAULT_STALL,
               "error": FAULT_ERROR, "corrupt": FAULT_CORRUPT}

# ------------------------------------------------------ vectorized hashing

_GOLD = np.uint64(0x9E3779B97F4A7C15)
_SM_A = np.uint64(0xBF58476D1CE4E5B9)
_SM_B = np.uint64(0x94D049BB133111EB)
_KIND_CODES: dict[str, np.uint64] = {}


def _kind_code(kind: str) -> np.uint64:
    """Stable 64-bit code for a decision kind — blake2b of the name, so
    codes never depend on interpreter hash randomization."""
    code = _KIND_CODES.get(kind)
    if code is None:
        code = np.uint64(int.from_bytes(
            hashlib.blake2b(kind.encode(), digest_size=8).digest(), "big"
        ))
        _KIND_CODES[kind] = code
    return code


def _mix(h: np.ndarray) -> np.ndarray:
    h = (h ^ (h >> np.uint64(30))) * _SM_A
    h = (h ^ (h >> np.uint64(27))) * _SM_B
    return h ^ (h >> np.uint64(31))


def hash_u01(seed: int, kind: str, *keys) -> np.ndarray:
    """Vectorized deterministic uniform in [0, 1): one sample per row of
    the broadcast key columns, a pure function of (seed, kind, key...).
    The batch-order-independent twin of ``scenarios/engine._u``."""
    with np.errstate(over="ignore"):
        h = _mix(np.uint64(seed & 0xFFFFFFFFFFFFFFFF) ^ _kind_code(kind))
        for k in keys:
            col = np.asarray(k)
            if col.dtype.kind != "u":
                col = col.astype(np.int64).astype(np.uint64)
            h = _mix((h ^ col) * _GOLD)
        return (h >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


# Acklam's rational approximation of the standard normal inverse CDF —
# |relative error| < 1.15e-9 over (0, 1); vectorized so the lognormal
# jitter transform stays one numpy pass (stdlib NormalDist.inv_cdf is a
# scalar Python call, scipy is not a dependency).
_PPF_A = (-3.969683028665376e+01, 2.209460984245205e+02,
          -2.759285104469687e+02, 1.383577518672690e+02,
          -3.066479806614716e+01, 2.506628277459239e+00)
_PPF_B = (-5.447609879822406e+01, 1.615858368580409e+02,
          -1.556989798598866e+02, 6.680131188771972e+01,
          -1.328068155288572e+01)
_PPF_C = (-7.784894002430293e-03, -3.223964580411365e-01,
          -2.400758277161838e+00, -2.549732539343734e+00,
          4.374664141464968e+00, 2.938163982698783e+00)
_PPF_D = (7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00)


def norm_ppf(u: np.ndarray) -> np.ndarray:
    u = np.clip(np.asarray(u, np.float64), 1e-12, 1.0 - 1e-12)
    out = np.empty_like(u)
    lo = u < 0.02425
    hi = u > 1.0 - 0.02425
    mid = ~(lo | hi)
    if mid.any():
        q = u[mid] - 0.5
        r = q * q
        num = ((((_PPF_A[0] * r + _PPF_A[1]) * r + _PPF_A[2]) * r
                + _PPF_A[3]) * r + _PPF_A[4]) * r + _PPF_A[5]
        den = ((((_PPF_B[0] * r + _PPF_B[1]) * r + _PPF_B[2]) * r
                + _PPF_B[3]) * r + _PPF_B[4]) * r + 1.0
        out[mid] = num * q / den
    for mask, sign, q_of in ((lo, 1.0, lambda v: v), (hi, -1.0, lambda v: 1.0 - v)):
        if mask.any():
            q = np.sqrt(-2.0 * np.log(q_of(u[mask])))
            num = ((((_PPF_C[0] * q + _PPF_C[1]) * q + _PPF_C[2]) * q
                    + _PPF_C[3]) * q + _PPF_C[4]) * q + _PPF_C[5]
            den = (((_PPF_D[0] * q + _PPF_D[1]) * q + _PPF_D[2]) * q
                   + _PPF_D[3]) * q + 1.0
            out[mask] = sign * num / den
    return out


def lognorm_vec(u: np.ndarray, sigma: float | np.ndarray) -> np.ndarray:
    """Deterministic lognormal(0, sigma) from uniforms — the vectorized
    twin of ``scenarios/engine._lognorm``."""
    return np.exp(np.asarray(sigma, np.float64) * norm_ppf(u))


# ------------------------------------------------------- region topology


def make_region_cluster(
    num_hosts: int, spec: ScenarioSpec, seed: int = 0
) -> synth.SynthCluster:
    """Region-structured host population for the WAN hierarchy: hosts
    partition into `spec.wan.regions` CONTIGUOUS index blocks (so a
    rolling-upgrade sweep over host order is a region-by-region rollout),
    each region carries `seeds_per_region` seed peers at its block head,
    and locations encode ``region-R|zone-Z|rack-K`` so the scenario
    engine's rack/IDC/region tiers and the scheduler's location-match
    features both see the hierarchy. Latent per-host quality keeps the
    synth model's Beta(4, 2) so learned rankers still have signal."""
    wan = spec.wan
    regions = max(wan.regions, 1)
    rng = np.random.default_rng(seed)
    quality = rng.beta(4.0, 2.0, num_hosts)
    upload_count = rng.integers(0, 5000, num_hosts)
    upload_failed_frac = rng.random(num_hosts) * 0.3
    region_of = (np.arange(num_hosts, dtype=np.int64) * regions) // max(num_hosts, 1)
    region_start = np.searchsorted(region_of, np.arange(regions))
    local = np.arange(num_hosts) - region_start[region_of]
    zone = local % max(wan.zones_per_region, 1)
    rack = (local // max(wan.zones_per_region, 1)) % max(wan.racks_per_zone, 1)
    hosts = []
    for i in range(num_hosts):
        r, z, k = int(region_of[i]), int(zone[i]), int(rack[i])
        hostname = f"host-{i}"
        ip = f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"
        hosts.append(synth.SynthHost(
            id=idgen.host_id_v2(ip, hostname),
            hostname=hostname,
            ip=ip,
            idc=f"idc-r{r}z{z}",
            location=f"region-{r}|zone-{z}|rack-{k}",
            is_seed=bool(local[i] < wan.seeds_per_region),
            quality=float(quality[i]),
            upload_count=int(upload_count[i]),
            upload_failed_count=int(upload_count[i] * upload_failed_frac[i]),
            concurrent_upload_limit=50,
            concurrent_upload_count=0,
        ))
    # the cluster rng drives task construction + arrival draws in the
    # simulator superclass — seeded like synth.make_cluster's
    import random

    return synth.SynthCluster(hosts=hosts, rng=random.Random(seed))


# -------------------------------------------------------- WAN cost model


@dataclasses.dataclass
class WanCostModel:
    """Vectorized piece-transfer cost + fault model over the region/WAN
    hierarchy. Per-host assignments (bandwidth modes, flaky membership)
    come from the ScenarioEngine so the WAN model and the per-event
    engine agree on WHO is slow/flaky; per-event jitter and fault rolls
    use the `hash_u01` mixer so a million-event batch prices in a few
    numpy passes."""

    seed: int
    spec: ScenarioSpec
    region: np.ndarray      # (H,) int64 region index per host
    rack: np.ndarray        # (H,) int64 globally-unique rack code
    idc: np.ndarray         # (H,) int64 globally-unique idc code
    bandwidth: np.ndarray   # (H,) float64 NIC bytes/s (engine assignment)
    flaky: np.ndarray       # (H,) bool flaky-parent membership

    @classmethod
    def from_engine(cls, spec: ScenarioSpec, hosts, engine, seed: int
                    ) -> "WanCostModel":
        h = len(hosts)
        region = np.empty(h, np.int64)
        rack = np.empty(h, np.int64)
        idc = np.empty(h, np.int64)
        band = np.empty(h, np.float64)
        flaky = np.zeros(h, bool)
        rack_codes: dict[str, int] = {}
        idc_codes: dict[str, int] = {}
        for i, host in enumerate(hosts):
            loc = host.location.split("|", 1)[0]
            region[i] = int(loc.rsplit("-", 1)[1]) if "-" in loc else 0
            rack[i] = rack_codes.setdefault(host.location, len(rack_codes))
            idc[i] = idc_codes.setdefault(host.idc, len(idc_codes))
            band[i] = engine.bandwidth.get(host.id, spec.link.base_bandwidth_bps)
            flaky[i] = host.id in engine.flaky_hosts
        return cls(seed=seed, spec=spec, region=region, rack=rack, idc=idc,
                   bandwidth=band, flaky=flaky)

    def rtt_ns(self, child: np.ndarray, parent: np.ndarray, *key
               ) -> np.ndarray:
        """Tiered RTT with deterministic jitter, one batch draw."""
        link, wan = self.spec.link, self.spec.wan
        same_rack = self.rack[child] == self.rack[parent]
        same_idc = self.idc[child] == self.idc[parent]
        same_region = self.region[child] == self.region[parent]
        base_ms = np.where(
            same_rack & (child != parent), link.same_rack_rtt_ms,
            np.where(same_idc, link.same_idc_rtt_ms,
                     np.where(same_region, link.same_region_rtt_ms,
                              wan.wan_rtt_ms)),
        )
        sigma = np.where(same_region, link.rtt_jitter_sigma,
                         wan.wan_jitter_sigma)
        jitter = lognorm_vec(hash_u01(self.seed, "mega_rtt", child, parent, *key),
                             sigma)
        return np.maximum(1, (base_ms * jitter * NS_PER_MS)).astype(np.int64)

    def piece_costs(
        self,
        child: np.ndarray,
        parent: np.ndarray,
        piece_length: int,
        task: np.ndarray,
        piece: np.ndarray,
        wave: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(cost_ns int64, fault int8) per event — the vectorized twin of
        ``ScenarioEngine.piece_cost_ns`` extended with the WAN tier:
        cross-region transfers pay ``wan_rtt_ms`` latency and are capped
        at ``wan_bandwidth_bps``; intra-region keeps the LinkSpec tiers
        including the spine-oversubscription divisor on cross-rack
        paths. Fault thresholds mirror the engine's roll ordering
        (error < stall < corrupt bands of one uniform)."""
        link, wan, flaky_spec = self.spec.link, self.spec.wan, self.spec.flaky
        key = (task, piece, wave)
        rtt = self.rtt_ns(child, parent, *key)
        bw = self.bandwidth[parent].copy()
        cross_rack = self.rack[child] != self.rack[parent]
        if link.spine_oversubscription > 1.0:
            bw[cross_rack] /= link.spine_oversubscription
        cross_region = self.region[child] != self.region[parent]
        np.minimum(bw, wan.wan_bandwidth_bps, out=bw, where=cross_region)
        bw = np.maximum(bw, 1.0)
        svc_jitter = lognorm_vec(
            hash_u01(self.seed, "mega_svc", child, parent, *key),
            link.bandwidth_jitter_sigma,
        )
        cost = rtt + (piece_length / bw * svc_jitter * 1e9).astype(np.int64)
        fault = np.zeros(child.shape[0], np.int8)
        p_err = flaky_spec.piece_error_rate
        p_stall = flaky_spec.piece_stall_rate
        p_corrupt = flaky_spec.piece_corrupt_rate
        if (p_err or p_stall or p_corrupt) and self.flaky.any():
            is_flaky = self.flaky[parent]
            if is_flaky.any():
                roll = hash_u01(self.seed, "mega_flake",
                                child[is_flaky], parent[is_flaky],
                                task[is_flaky], piece[is_flaky],
                                wave[is_flaky])
                codes = np.zeros(roll.shape[0], np.int8)
                codes[roll < p_err + p_stall + p_corrupt] = FAULT_CORRUPT
                codes[roll < p_err + p_stall] = FAULT_STALL
                codes[roll < p_err] = FAULT_ERROR
                fault[is_flaky] = codes
                stall_ns = np.int64(flaky_spec.stall_seconds * 1e9)
                stalled = np.flatnonzero(is_flaky)[codes == FAULT_STALL]
                cost[stalled] += stall_ns
        return cost, fault
