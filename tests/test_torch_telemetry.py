"""The port's telemetry against the reference's: ``Registry``,
``PhaseRecorder``, ``DecisionLedger`` and ``SLOEngine``, each fed the same
script in both packages (cases from tests/test_decisions.py and
tests/test_slo.py) and held to the same outputs: exposition text, phase
rings and medians, ledger columns, digests, divergence and regret, SLO
dumps, alert logs, verdicts and metric families. All of it is host code, so equal means
equal."""

from __future__ import annotations

import numpy as np
import pytest

from dragonfly2_tpu.telemetry import decisions as ref_decisions
from dragonfly2_tpu.telemetry import flight as ref_flight
from dragonfly2_tpu.telemetry import metrics as ref_metrics
from dragonfly2_tpu.telemetry import slo as ref_slo
from dragonfly2_tpu_torch.telemetry import decisions, flight, metrics, slo

PACKAGES = {
    "ref": (ref_metrics, ref_flight, ref_decisions, ref_slo),
    "port": (metrics, flight, decisions, slo),
}


def _both(script):
    """The script's result in the reference and in the port."""
    return script(*PACKAGES["ref"]), script(*PACKAGES["port"])


# ---------------------------------------------------------------- Registry


def test_registry_exposition_matches():
    def script(m, *_):
        reg = m.Registry()
        c = reg.counter("dragonfly_test_total", "a counter", ("kind",))
        g = reg.gauge("dragonfly_test_gauge", "a gauge")
        h = reg.histogram("dragonfly_test_seconds", "a histogram", ("op",))
        for i in range(7):
            c.labels("a" if i % 3 else "b").inc(i)
            h.labels("get").observe(i * 0.003)
        g.labels().set(4.5)
        h.labels("put").observe(12.0)
        return reg.expose(), c.value("a"), c.value("b")

    want, got = _both(script)
    assert got == want
    assert "dragonfly_test_seconds_bucket" in got[0]


# ----------------------------------------------------------- PhaseRecorder


def test_phase_recorder_ring_medians_and_histogram_match():
    def script(m, f, *_):
        reg = m.Registry()
        hist = reg.histogram("dragonfly_scheduler_phase_seconds", "phases", ("phase",))
        rec = f.PhaseRecorder(histogram=hist, maxlen=4)
        for tick in range(6):
            rec.begin()
            rec.add("pack", 0.5 + tick)
            rec.add("dispatch", 2.0 * tick)
            rec.add("pack", 0.25)
            if tick % 2:
                rec.add("overlap", 1.0)
            rec.commit()
        rec.begin()  # an open tick is never in the ring
        rec.add("pack", 99.0)
        off = f.PhaseRecorder(enabled=False)
        off.begin()
        off.add("pack", 1.0)
        off.commit()
        return (rec.ticks, rec.snapshot(), rec.snapshot(0), rec.phase_p50s(),
                rec.dump(last_n=2), rec.value("pack"), off.ticks, reg.expose())

    want, got = _both(script)
    assert got == want
    assert got[0] == 6 and len(got[1]) == 4


@pytest.mark.parametrize("track", [False, True])
def test_entry_wrapper_counts_calls_and_signatures_only_when_asked(monkeypatch, track):
    """The port's stand-in for instrument_jit counts every call under the
    reference's family names; distinct signatures (two shapes here, one
    repeated) only under TRACK_SIGNATURES."""
    monkeypatch.setattr(flight, "TRACK_SIGNATURES", track)
    reg = metrics.Registry()
    wrapper = flight.instrument_entry(lambda x, scale=1: x * scale, "test.scale",
                                      service="unit", registry=reg)
    for x in (np.ones(3), np.ones(3), np.ones((2, 2))):
        np.testing.assert_array_equal(wrapper(x, scale=2), 2 * x)
    assert wrapper.stats() == {"calls": 3, "signatures": 2 if track else 0}
    assert wrapper.__name__ == "<lambda>"  # unknown attributes forward to the function
    text = reg.expose()
    assert 'dragonfly_unit_jit_calls_total{fn="test.scale"} 3' in text
    assert ('dragonfly_unit_jit_retraces_total{fn="test.scale"} 2' in text) == track


# ---------------------------------------------------------- DecisionLedger


def _ledger_script(m, f, d, s):
    """tests/test_decisions.py's divergence/regret math, ring bound and
    shadow-overwrite cases on one ledger each."""
    out = {}
    led = d.DecisionLedger(capacity=64, k=4, limit=3, registry=m.Registry())
    n = 4
    slots, seqs = led.record_batch(
        7, d.ARM_CODES["ml"], np.arange(n), np.arange(n),
        np.tile(np.arange(4), (n, 1)), np.tile(np.arange(4), (n, 1)),
        np.full(n, 4), np.arange(n * 4 * 8, dtype=np.float32).reshape(n, 4, 8),
        np.tile(np.asarray([0, 1, 2]), (n, 1)),
        np.tile(np.asarray([3.0, 2.0, 1.0], np.float32), (n, 1)),
        np.ones((n, 3), bool), np.zeros(n, np.int64),
        [f"pr{i}" for i in range(n)], ["t"] * n, ["x"] * n,
    )
    out["shadow"] = led.record_shadow(
        slots, seqs, np.asarray([[0, 1, 2], [0, 2, 1], [1, 0, 2], [1, 2, 0]]),
        np.zeros((n, 3), np.float32), d.ARM_CODES["default"], 7,
    )
    for peer in ("pr0", "pr1", "pr2"):
        led.join_outcome(peer, d.OUTCOME_FAILED)
    led.record_batch(
        8, d.ARM_CODES["ml"], np.asarray([9]), np.asarray([9]),
        np.asarray([[0, 1, 2, 3]]), np.asarray([[1, 1, 1, 1]]),
        np.asarray([4]), np.zeros((1, 4, 8), np.float32),
        np.asarray([[0, -1, -1]]), np.asarray([[1.0, np.nan, np.nan]], np.float32),
        np.asarray([[True, False, False]]), np.asarray([0]), ["pr9"], ["t"], ["y"],
    )
    out["join"] = led.join_outcome("pr9", d.OUTCOME_COMPLETED)
    regret = led.regret()
    out["regret"] = {arm: {k: v for k, v in e.items() if "ttc" not in k}
                     for arm, e in regret["by_arm"].items()}
    out["n"] = (regret["n_joined"], regret["n_disagreements"])
    out["summary"] = {k: v for k, v in led.divergence_summary().items() if k != "regret"}
    out["counters"] = led.counters()
    out["digest"] = led.deterministic_digest()
    out["columns"] = {k: v.tolist() for k, v in led.deterministic_columns().items()}

    ring = d.DecisionLedger(capacity=8, k=4, limit=2, registry=m.Registry())
    one = lambda v: np.asarray([v])  # noqa: E731
    for i in range(20):
        ring.record_batch(
            1, d.ARM_CODES["default"], one(i), one(i), np.asarray([[0, 1, 2, 3]]),
            np.asarray([[0, 1, 2, 3]]), one(4), np.zeros((1, 4, 8), np.float32),
            np.asarray([[0, 1]]), np.asarray([[1.0, 0.5]], np.float32),
            np.asarray([[True, False]]), one(0), [f"p{i}"], ["t"], [f"par{i}"],
        )
    out["ring_peers"] = [r["peer"] for r in ring.dump()["rows"]]
    out["ring_joins"] = (ring.join_outcome("p3", d.OUTCOME_COMPLETED),
                         ring.join_outcome("p19", d.OUTCOME_COMPLETED))
    out["ring_digest"] = ring.deterministic_digest()
    return out


def test_decision_ledger_matches():
    want, got = _both(_ledger_script)
    assert got["shadow"] == want["shadow"] and got["shadow"]["compared"] == 4
    assert got["regret"] == want["regret"]
    assert got["regret"]["ml"]["regret_fail_rate"] == pytest.approx(1.0)
    for key in ("join", "n", "summary", "counters", "digest", "ring_peers", "ring_joins",
                "ring_digest"):
        assert got[key] == want[key], key
    assert got["columns"].keys() == want["columns"].keys()
    for name in want["columns"]:
        np.testing.assert_array_equal(np.asarray(got["columns"][name]),
                                      np.asarray(want["columns"][name]), err_msg=name)


# --------------------------------------------------------------- SLOEngine


def _slo_script(m, f, d, s, feed, objective=0.999, **spec_kw):
    reg = m.Registry()
    eng = s.SLOEngine([s.SLOSpec("x", sli="s", objective=objective, **spec_kw)],
                      name=None, minutes_per_unit=15.0, registry=reg)
    steps = []
    for t, (good, bad) in enumerate(feed, start=1):
        eng.observe("s", good=good, bad=bad)
        steps.append(eng.step(t))
    return (steps, eng.dump(), eng.verdict(), list(eng.alert_log), eng.pages_fired,
            eng.tickets_fired, reg.expose())


@pytest.mark.parametrize(
    "feed,spec_kw",
    [
        # a spike on both windows pages, the next clean interval clears it
        ([(100, 0)] * 8 + [(50, 50), (100, 0)], {}),
        # thin windows abstain
        ([(4, 0)] * 2 + [(0, 4)], dict(min_events=64)),
        # budget accounting over a day's window
        ([(90, 0)] * 4 + [(0, 18)], dict(objective=0.9, window_minutes=24 * 60.0)),
        # the determinism feed of tests/test_slo.py
        ([(100, 0)] * 8 + [(60, 40)] + [(100, 0)] * 6 + [(70, 30)], {}),
    ],
)
def test_slo_engine_matches(feed, spec_kw):
    want, got = _both(lambda *p: _slo_script(*p, feed, **spec_kw))
    assert got == want


def test_scheduler_slo_specs_match():
    want, got = ref_slo.scheduler_slo_specs(250.0), slo.scheduler_slo_specs(250.0)
    assert [repr(x) for x in got] == [repr(x) for x in want]
    assert [x.name for x in got] == ["tick_latency", "shadow_regret", "breaker_health"]
