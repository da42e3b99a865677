"""The port's tail plane against the reference's on the same inputs.

- ``_mix64`` and ``hash_u01_scalar``: the reference's bits on a grid of
  seeds, kinds and keys (64-bit integer mixes, so exact equality).
- ``QuantileSketch``: the same buckets and quantiles.
- ``TailTrace`` fed the same phase vectors: the same report (quantiles,
  shares, windows, exemplars) and digest, the same dump.
- The daemon's ``_observe_tail`` folds failover and the residual, and
  scales overlapping workers, as the reference's does.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from dragonfly2_tpu.client.daemon import Daemon as RefDaemon
from dragonfly2_tpu.telemetry import metrics as ref_metrics
from dragonfly2_tpu.telemetry import tailtrace as ref_tail
from dragonfly2_tpu.telemetry import timeline as ref_timeline
from dragonfly2_tpu_torch.client.daemon import Daemon
from dragonfly2_tpu_torch.telemetry import metrics, tailtrace, timeline


def _pair(regions=("r0", "r1"), **kw):
    ours = tailtrace.TailTrace(regions, registry=metrics.Registry(), **kw)
    theirs = ref_tail.TailTrace(regions, registry=ref_metrics.Registry(), **kw)
    return ours, theirs


def _feed(tracers, n: int, seed: int, regions: int = 2, rounds: int = 40):
    rng = np.random.default_rng(seed)
    for seq in range(n):
        vec = rng.exponential(1e6, tailtrace.N_PHASES) * (rng.random(tailtrace.N_PHASES) < 0.6)
        region, round_idx = int(rng.integers(regions)), int(rng.integers(rounds))
        for t in tracers:
            t.observe(region, seq, float(vec.sum()), vec.tolist(), round_idx)


def test_phases_equal_the_reference():
    assert tailtrace.PHASES == ref_tail.PHASES
    assert [tailtrace.PH_REGISTER, tailtrace.PH_SCHEDULE_WAIT, tailtrace.PH_PARENT_FETCH,
            tailtrace.PH_RETRY, tailtrace.PH_FAILOVER, tailtrace.PH_BACK_TO_SOURCE,
            tailtrace.PH_VERIFY] == [ref_tail.PH_REGISTER, ref_tail.PH_SCHEDULE_WAIT,
                                     ref_tail.PH_PARENT_FETCH, ref_tail.PH_RETRY,
                                     ref_tail.PH_FAILOVER, ref_tail.PH_BACK_TO_SOURCE,
                                     ref_tail.PH_VERIFY]
    assert tailtrace.DEFAULT_TOLERANCE == ref_tail.DEFAULT_TOLERANCE


def test_mix64_and_hash_u01_give_the_reference_bits():
    rng = np.random.default_rng(0)
    values = [0, 1, (1 << 64) - 1, 1 << 63, *rng.integers(0, 1 << 63, 200, dtype=np.int64).tolist()]
    for v in values:
        assert tailtrace._mix64(int(v)) == ref_tail._mix64(int(v))
    for seed in (0, 1, 7, -3, (1 << 64) + 5):
        for kind in ("tail_exemplar", "x", ""):
            for keys in ((), (0,), (5, 9), (-1, 1 << 40, 3)):
                got = tailtrace.hash_u01_scalar(seed, kind, *keys)
                want = ref_tail.hash_u01_scalar(seed, kind, *keys)
                assert np.float64(got).tobytes() == np.float64(want).tobytes()
                assert 0.0 <= got < 1.0


def test_quantile_sketch_equals_the_reference():
    rng = np.random.default_rng(2)
    ours = timeline.QuantileSketch(relative_accuracy=0.02, max_buckets=64)
    theirs = ref_timeline.QuantileSketch(relative_accuracy=0.02, max_buckets=64)
    values = np.concatenate([rng.lognormal(0, 3, 3000), np.zeros(10), [1e-9]])
    ours.extend(values)
    theirs.extend(values)
    assert ours._buckets == theirs._buckets and ours._zero == theirs._zero
    for q in np.linspace(0, 1, 21):
        assert ours.quantile(q) == theirs.quantile(q)
    assert ours.to_dict() == theirs.to_dict()
    assert timeline.QuantileSketch().quantile(0.5) is None
    with pytest.raises(ValueError):
        timeline.QuantileSketch(relative_accuracy=1.0)


@pytest.mark.parametrize("seed,n", [(0, 50), (1, 2000), (3, 700)])
def test_tail_trace_reports_equal_the_reference(seed, n):
    ours, theirs = _pair(seed=seed, slowest_k=4, exemplar_capacity=32, sample_rate=0.25)
    _feed((ours, theirs), n, seed)
    crashes = (3, 17, 33)
    assert ours.report(crashes, window_rounds=6) == theirs.report(crashes, window_rounds=6)
    assert ours.deterministic_digest() == theirs.deterministic_digest()
    assert ours.dump(last_n=8) == theirs.dump(last_n=8)
    assert ours.round_phase_matrix_ms() == theirs.round_phase_matrix_ms()
    assert ours.round_slow_matrix_ms() == theirs.round_slow_matrix_ms()
    for r in range(45):
        assert ours.round_dominant(r) == theirs.round_dominant(r)
    region = ours.report()["regions"]["r0"]
    assert region["decomp_ratio"] == 1.0


def test_tail_trace_metrics_and_registry():
    reg = metrics.Registry()
    tracer = tailtrace.TailTrace(("local",), name="torch-test.tail", registry=reg)
    tracer.observe(0, tracer.next_seq(), 3e6, [1e6, 2e6, 0, 0, 0, 0, 0])
    tracer.observe(5, 7, 1e6, [1e6] + [0.0] * 6)  # an unknown region is dropped whole
    assert tracer.next_seq() == 1 and tracer.report()["completions"] == 1
    assert tailtrace.live_tracers()["torch-test.tail"] is tracer
    tracer.mirror_metrics()
    text = reg.expose()
    assert 'dragonfly_tail_completions_total{source="torch-test.tail",region="local"} 1.0' in text
    assert "dragonfly_tail_phase_share" in text


def test_default_tailtrace_is_the_daemons_singleton(monkeypatch):
    monkeypatch.setattr(tailtrace, "_DEFAULT", None)
    first = tailtrace.default_tailtrace()
    assert tailtrace.default_tailtrace() is first
    assert first.name == "dfdaemon.tail" and first.regions == ("local",)


def _vec(**ms):
    v = [0.0] * tailtrace.N_PHASES
    for name, val in ms.items():
        v[tailtrace.PHASES.index(name)] = val * 1e6
    return v


@pytest.mark.parametrize("phases,failed_ns,recovery", [
    ({"register": 1.0, "parent_fetch": 5.0, "verify": 0.5}, 2e6, {"backoff": 1.0, "redial": 0.5}),
    ({"parent_fetch": 120.0, "verify": 2.0}, 0.0, {}),
])
def test_observe_tail_folds_like_the_reference(monkeypatch, phases, failed_ns, recovery):
    """Both daemons' fold of one conductor's vector into their tracers:
    failover and the residual booked, overlapping workers scaled onto the
    wall clock; the shares agree (the TTCs differ by the clock's read)."""
    ours, theirs = _pair(regions=("local",))
    monkeypatch.setattr(tailtrace, "_DEFAULT", ours)
    monkeypatch.setattr(ref_tail, "_DEFAULT", theirs)

    class _Cond:
        phase_ns = _vec(**phases)

    task_t0 = time.perf_counter_ns() - int(40e6)
    Daemon._observe_tail(object.__new__(Daemon), _Cond(), task_t0, failed_ns, recovery)
    RefDaemon._observe_tail(object.__new__(RefDaemon), _Cond(), task_t0, failed_ns, recovery)
    got = ours.report()["regions"]["local"]
    want = theirs.report()["regions"]["local"]
    assert got["completed"] == want["completed"] == 1
    assert got["decomp_ratio"] == want["decomp_ratio"] == 1.0
    assert got["dominant_phase"] == want["dominant_phase"]
    assert got["phase_share"].keys() == want["phase_share"].keys()
    for phase, share in want["phase_share"].items():
        assert got["phase_share"][phase] == pytest.approx(share, rel=0.05, abs=2e-3)
    if recovery:
        assert got["phase_share"]["failover"] == pytest.approx(3.5 / 40.0, rel=0.2)
