"""The port's flight recorder dump, cost cards and soak timelines
(dragonfly2_tpu_torch/telemetry/{flight,costcard,timeline}.py) against
the reference's: parse_flight_query over seeded query strings (the same
kwargs, or the same error class), _truncate_dump on the same bodies, the
timelines' dumps and recovery_time on seeded series, all exact; the cost
card's counting rules on a Dense chain (exact against 2·M·N·K plus the
bias adds, and within CARD_RTOL of the reference's XLA card) and on a
two-op program (bytes against a hand count); the capture discipline (a
tick never captures; a note holds no tensor; the replay routes no call);
and the cases of the reference's tests/test_flight_recorder.py,
tests/test_costcard.py and tests/test_timeline.py on the port."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from dragonfly2_tpu.telemetry import flight as ref_flight
from dragonfly2_tpu.telemetry import timeline as ref_timeline
from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
from dragonfly2_tpu_torch.config.config import Config
from dragonfly2_tpu_torch.telemetry import costcard, flight, metrics, timeline
from dragonfly2_tpu_torch.telemetry.costcard import CostCard

CARD_RTOL = 0.05  # the Dense chain's counted flops against XLA's cost_analysis


def _service(**overrides):
    cfg = Config()
    cfg.scheduler.max_hosts = 64
    cfg.scheduler.max_tasks = 8
    for key, value in overrides.items():
        setattr(cfg.scheduler, key, value)
    return SchedulerService(config=cfg, device="cpu", metrics_registry=metrics.Registry())


@pytest.fixture(autouse=True)
def fresh_ledger():
    """An empty ledger, and entry wrappers that have seen no signature and
    no key (so a warmup notes each one again)."""
    costcard.ledger().reset()
    for wrapper in flight.entry_wrappers().values():
        wrapper._seen.clear()
        wrapper._keyed.clear()
    yield
    costcard.ledger().reset()


# ---------------------------------------------------------------- parity


def _seeded_queries(n: int = 200):
    rng = np.random.default_rng(18)
    names = list(flight.DUMP_SECTIONS) + ["", "bogus", " ticks ", "TICKS"]
    values = {"last_n": ["0", "4", "-3", "x", "1e3", "64", ""],
              "max_bytes": ["10", "4096", "5000", "-1", "y", ""],
              "section": None, "other": ["1"]}
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(0, 4))):
            key = list(values)[int(rng.integers(len(values)))]
            if key == "section":
                k = int(rng.integers(1, 4))
                value = ",".join(names[int(i)] for i in rng.integers(0, len(names), k))
            else:
                value = values[key][int(rng.integers(len(values[key])))]
            parts.append(f"{key}={value}")
        yield "&".join(parts)


def test_parse_flight_query_equals_the_reference():
    seen_errors = 0
    for query in _seeded_queries():
        try:
            got = flight.parse_flight_query(query)
        except ValueError as e:
            with pytest.raises(ValueError) as want:
                ref_flight.parse_flight_query(query)
            assert str(e) == str(want.value), query
            seen_errors += 1
            continue
        assert got == ref_flight.parse_flight_query(query), query
    assert seen_errors > 10
    assert flight.DUMP_SECTIONS == ref_flight.DUMP_SECTIONS
    assert flight.DUMP_MAX_BYTES == ref_flight.DUMP_MAX_BYTES


def _seeded_body(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def rows(n, width):
        return [{f"c{j}": float(rng.integers(0, 10**6)) for j in range(width)} for _ in range(n)]

    return {
        "generated_at_ns": 1,
        "ticks": {"ticks_total": 500, "p50_ms": {"emit": 1.5}, "last": rows(64, 6)},
        "jit": {"scheduler.x": {"calls": 3.0, "signatures": 1}},
        "active_spans": [{"name": f"s{i}", "attributes": {"k": i}} for i in range(20)],
        "costcards": {"cards": rows(int(rng.integers(3, 12)), 9), "pending": 0,
                      "capture_errors": {}},
        "timelines": {"soak": {"name": "soak", "events": [], "samples": rows(80, 4)}},
        "decisions": {"scheduler.decisions": {"rows": rows(100, 5), "counters": {"d": 1}}},
        "slo": {"scheduler.slo": {"alert_log": rows(30, 3), "state": "ok"}},
        "tail": {f"tr{i}": {"exemplars": rows(10, 3), "counts": rows(1, 40)}
                 for i in range(int(rng.integers(1, 4)))},
    }


def test_truncate_dump_equals_the_reference():
    for seed in range(6):
        body = _seeded_body(seed)
        size = flight._dump_nbytes(body)
        assert size == ref_flight._dump_nbytes(body)
        for cap in (size + 1, size // 2, size // 8, 4096, 1024, 300):
            got = flight._truncate_dump(copy.deepcopy(body), cap)
            want = ref_flight._truncate_dump(copy.deepcopy(body), cap)
            assert got == want, (seed, cap)
            if cap >= 4096:
                assert flight._dump_nbytes(got) <= cap


def _seeded_timeline(seed: int) -> list:
    rng = np.random.default_rng(seed)
    base = float(rng.integers(50, 150))
    values = [base + float(rng.normal(0, 3)) for _ in range(int(rng.integers(4, 12)))]
    values += [base * float(rng.uniform(0.0, 0.9)) for _ in range(int(rng.integers(0, 5)))]
    values += [base * float(rng.uniform(0.5, 1.2)) for _ in range(int(rng.integers(0, 8)))]
    return [{"t": i, "pieces": round(v, 3), "origin_fraction": 0.1} for i, v in enumerate(values)]


def test_timelines_and_recovery_time_equal_the_reference():
    for seed in range(40):
        series = _seeded_timeline(seed)
        rng = np.random.default_rng(1000 + seed)
        got_rec = timeline.TimelineRecorder(f"port.{seed}", maxlen=16,
                                            registry=metrics.Registry())
        want_rec = ref_timeline.TimelineRecorder(f"ref.{seed}", maxlen=16)
        for sample in series:
            values = {k: v for k, v in sample.items() if k != "t"}
            got_rec.sample(sample["t"], values)
            want_rec.sample(sample["t"], values)
        event = float(rng.integers(0, len(series)))
        got_rec.mark_event(event, "scheduler_crash")
        want_rec.mark_event(event, "scheduler_crash")
        got_dump, want_dump = got_rec.dump(), want_rec.dump()
        assert got_dump["samples"] == want_dump["samples"]
        assert got_dump["events"] == want_dump["events"]
        kwargs = dict(baseline_window=int(rng.integers(1, 8)),
                      threshold=float(rng.choice([0.5, 0.9, 1.0])),
                      horizon=[None, 3, 8][int(rng.integers(3))])
        assert (timeline.recovery_time(series, "pieces", event, **kwargs)
                == ref_timeline.recovery_time(series, "pieces", event, **kwargs))


def test_recorder_ring_gauges_and_registry():
    reg = metrics.Registry()
    rec = timeline.TimelineRecorder("test.timeline", maxlen=4, registry=reg)
    for t in range(6):
        rec.sample(t, {"pieces": t * 10, "origin_fraction": 0.1, "nested": {"a": 1}})
    rec.mark_event(3, "scheduler_crash")
    tl = rec.timeline()
    assert len(tl) == 4 and tl[-1] == {"t": 5, "pieces": 50, "origin_fraction": 0.1,
                                       "nested": {"a": 1}}
    assert rec.dump()["events"] == [{"t": 3, "event": "scheduler_crash"}]
    text = reg.expose()
    assert 'dragonfly_timeline_value{source="test.timeline",metric="pieces"} 50.0' in text
    assert 'metric="nested"' not in text
    assert 'dragonfly_timeline_samples_total{source="test.timeline"} 6.0' in text
    assert timeline.live_timelines().get("test.timeline") is rec
    assert flight.dump(sections=("timelines",))["timelines"]["test.timeline"]["samples"] == tl


def _tl(values, start=0):
    return [{"t": start + i, "pieces": v} for i, v in enumerate(values)]


def test_recovery_time_measures_dip_and_recovery():
    r = timeline.recovery_time(_tl([100] * 8 + [40, 60, 80, 95, 100]), "pieces", event_t=8,
                               baseline_window=4, threshold=0.9)
    assert (r["baseline"], r["dip"], r["dip_ratio"]) == (100.0, 40, 0.4)
    assert r["recovered"] and r["recovery_t"] == 11 and r["recovery_intervals"] == 3
    r = timeline.recovery_time(_tl([100] * 8 + [40] * 10), "pieces", event_t=8,
                               baseline_window=4, threshold=0.9, horizon=6)
    assert not r["recovered"] and r["recovery_t"] is None and r["dip"] == 40
    r = timeline.recovery_time(_tl([100] * 12), "pieces", event_t=0, baseline_window=4)
    assert r["baseline"] is None and not r["recovered"]


# ------------------------------------------------------------ cost cards


def _dense_chain(m, k, widths, seed):
    g = torch.Generator().manual_seed(seed)
    layers, fan_in = [], k
    for n in widths:
        lin = torch.nn.Linear(fan_in, n)
        with torch.no_grad():
            lin.weight.copy_(torch.randn(n, fan_in, generator=g) / fan_in ** 0.5)
            lin.bias.copy_(torch.randn(n, generator=g))
        layers.append(lin)
        fan_in = n
    return torch.nn.Sequential(*layers), torch.randn(m, k, generator=g)


def test_dense_chain_card_counts_products_and_bias_adds():
    """2·M·N·K a product plus M·N bias adds, exactly; and within CARD_RTOL
    of the reference's XLA card (cost_analysis) for the same program."""
    import jax
    import jax.numpy as jnp

    from dragonfly2_tpu.telemetry import costcard as ref_costcard

    m, k, widths = 64, 96, (128, 80, 64)
    model, x = _dense_chain(m, k, widths, seed=0)
    entry = flight.instrument_entry(lambda net, a: net(a), "test.dense_chain",
                                    service="test", registry=metrics.Registry(),
                                    costcards=True)
    with torch.no_grad():
        entry(model, x)
    (card,) = costcard.capture_pending()
    want, fan_in = 0, k
    for n in widths:
        want += 2 * m * n * fan_in + m * n
        fan_in = n
    assert card.flops == want
    assert card.entry == "test.test.dense_chain" and card.kernels == ()
    assert card.argument_bytes == x.numel() * 4 and card.output_bytes == m * widths[-1] * 4

    weights = [(jnp.asarray(layer.weight.detach().numpy().T),
                jnp.asarray(layer.bias.detach().numpy())) for layer in model]

    @jax.jit
    def chain(a, ws):
        for w, b in ws:
            a = a @ w + b
        return a

    led = ref_costcard.CostCardLedger()
    led.note_pending("test.dense_chain", chain.lower, (x.numpy(), weights), {})
    (ref_card,) = led.capture_pending()
    assert ref_card.flops > 0
    assert abs(card.flops - ref_card.flops) <= CARD_RTOL * ref_card.flops


def test_two_op_program_bytes_equal_a_hand_count():
    """(x + y) * 0.5 over n floats: the add reads x and y and writes its
    sum, the multiply reads the sum and writes the result (a Python
    scalar moves nothing): 5·n·4 bytes; flops one per output element of
    each op, 2·n."""
    n = 4096
    x, y = torch.ones(n), torch.full((n,), 2.0)
    with costcard.counting() as count:
        (x + y) * 0.5
    assert count.bytes_accessed == 5 * n * 4
    assert count.flops == 2 * n and count.transcendentals == 0 and not count.data_dependent


def test_counting_names_data_dependent_ops():
    x = torch.arange(10.0)
    with costcard.counting() as count:
        x[x > 4].sum().item()
    assert {"aten.index", "aten._local_scalar_dense"} <= count.data_dependent
    with costcard.counting() as count:
        x[torch.tensor([1, 2])]  # an integer index is no data-dependent shape
    assert not count.data_dependent


def test_hand_kernel_launches_count_their_bound(monkeypatch):
    """A flash launch inside a count adds its PERF.md §6 bound: 4·D (the
    forward), 8·D (dK/dV) or 6·D (dQ) a valid pair, and its inputs and
    outputs once. The launcher is replaced by a recorder on CPU tensors."""
    from dragonfly2_tpu_torch.ops import flash

    b, h, l, d = 2, 3, 10, 32
    q, k, v = (torch.randn(b, h, l, d) for _ in range(3))
    mask = torch.ones(b, l, dtype=torch.bool)
    mask[1, 7:] = False
    outputs = (torch.empty(b, h, l, d), torch.empty(b, h, l))
    monkeypatch.setattr(flash, "_launch", lambda name, q, *args: outputs)
    counters = {c: getattr(flash, c) for c in ("LSE_LAUNCHES",)}
    with costcard.counting() as count:
        flash._kernel("lse", q, k, v, mask, True, 0.125)
    pairs = h * int(flash._valid_pairs(mask, True, b, l, "cpu").sum())
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, mask, *outputs))
    assert count.kernels == {"dfly_flash_fwd_lse": 1}
    assert count.flops == 4 * d * pairs and count.bytes_accessed == nbytes
    assert flash.LSE_LAUNCHES == counters["LSE_LAUNCHES"] + 1
    do, delta = torch.randn(b, h, l, d), torch.randn(b, h, l)
    monkeypatch.setattr(flash, "_launch", lambda name, q, *args: (q, q))
    with costcard.counting() as count:
        flash._kernel("dkv", q, k, v, do, outputs[1], delta, mask, False, 0.125)
    assert count.flops == 8 * d * h * l * int(mask.sum())


def test_warmup_captures_a_card_per_bucket_signature():
    from dragonfly2_tpu_torch.cluster.scheduler import _EVAL_BUCKETS

    svc = _service(fused_tick=False)
    svc.warmup()
    cards = costcard.ledger().cards("scheduler.evaluator.schedule_from_packed")
    limit = svc.config.scheduler.candidate_parent_limit
    by_out = {c.output_bytes: c for c in cards}
    for bucket in _EVAL_BUCKETS:
        card = by_out[4 * bucket * limit * 2]  # packed f32 selection
        assert card.flops > 0 and card.bytes_accessed > card.argument_bytes > 0
    svc = _service()
    svc.warmup()
    assert len(costcard.ledger().cards("scheduler.tick.fused_tick_chunk")) == len(_EVAL_BUCKETS)


def test_a_cpu_tick_never_captures(monkeypatch):
    """After warmup, rounds of ticks on both transports run with the
    ledger's drain patched to raise: no tick captures."""
    for fused in (True, False):
        svc = _service(fused_tick=fused)
        svc.warmup()

        def boom(*a, **k):
            raise AssertionError("a capture ran inside a tick")

        with monkeypatch.context() as mp:
            mp.setattr(costcard, "capture_pending", boom)
            mp.setattr(costcard.CostCardLedger, "capture_pending", boom)
            sim = ClusterSimulator(svc, num_hosts=30, num_tasks=3, seed=1,
                                   deterministic_peer_ids=True)
            for _ in range(6):
                sim.run_round(new_downloads=6)
        assert svc.recorder.ticks > 0


def test_capture_routes_no_call_and_no_signature():
    svc = _service()
    wrapper = flight.entry_wrappers()["scheduler.tick.fused_tick_chunk"]
    calls = wrapper.stats()["calls"]
    svc.warmup()  # notes each bucket's signature; its drain replays them
    per_warmup = wrapper.stats()["calls"] - calls
    seen = set(wrapper._seen)
    assert per_warmup > 0 and len(costcard.ledger().cards(
        "scheduler.tick.fused_tick_chunk")) == len(seen)
    costcard.ledger().reset()
    svc.warmup()  # notes nothing new: the signatures were seen
    assert costcard.ledger().pending_count() == 0 and not costcard.ledger().cards()
    wrapper._seen.clear()
    wrapper._keyed.clear()
    calls = wrapper.stats()["calls"]
    svc.warmup()  # notes again; its drain replays the unwrapped function
    assert wrapper.stats()["calls"] == calls + per_warmup and set(wrapper._seen) == seen
    flight.dump()
    assert wrapper.stats()["calls"] == calls + per_warmup


def test_chunk_key_tells_apart_what_the_full_signature_does(monkeypatch):
    """The fused entry's cheap key (ops/tick._chunk_key) against hashing
    every argument, over the warm and the real chunks of services of three
    sizes: one key for each full signature and one full signature for
    each key."""
    from dragonfly2_tpu_torch.cluster.scheduler import _EVAL_BUCKETS
    from dragonfly2_tpu_torch.ops import tick

    wrapper = flight.entry_wrappers()["scheduler.tick.fused_tick_chunk"]
    pairs = set()

    def both(*args, **kwargs):
        key = tick._chunk_key(*args, **kwargs)
        pairs.add((key, (flight._sig_of(args), flight._sig_of(tuple(sorted(kwargs.items()))))))
        return key

    monkeypatch.setattr(wrapper, "_key", both)
    for hosts, tasks in ((64, 8), (128, 8), (64, 16)):
        svc = _service(max_hosts=hosts, max_tasks=tasks)
        svc.warmup()
        sim = ClusterSimulator(svc, num_hosts=30, num_tasks=3, seed=1, deterministic_peer_ids=True)
        for _ in range(4):
            sim.run_round(new_downloads=6)
    keys, fulls = {k for k, _ in pairs}, {f for _, f in pairs}
    assert len(keys) == len(fulls) == len(pairs) >= 3 * len(_EVAL_BUCKETS)


def test_pending_note_holds_shapes_not_tensors():
    led = costcard.CostCardLedger(registry=metrics.Registry())
    net = torch.nn.Linear(8, 4)
    x = torch.ones(2, 8)
    led.note_pending("test.specs", lambda m, a, scale=1: m(a) * scale, (net, x), {"scale": 2})
    (pending,) = led._pending.values()
    leaves = [pending.args[1], pending.kwargs["scale"]]
    assert isinstance(leaves[0], costcard._Spec) and leaves[1] == 2
    assert not any(isinstance(v, torch.Tensor) for v in (*pending.args, *leaves))
    import weakref

    assert isinstance(pending.args[0], weakref.ref)
    del x
    (card,) = led.capture_pending()
    assert card.output_bytes == 2 * 4 * 4 and card.flops == 2 * 2 * 8 * 4 + 2 * 4 + 2 * 4
    led.note_pending("test.specs", lambda m, a: m(a), (torch.nn.Linear(3, 3), torch.ones(1, 3)),
                     {})
    import gc

    gc.collect()
    assert led.capture_pending() == [] and led.dump()["capture_errors"] == {}


def test_distinct_static_kwarg_values_get_distinct_cards():
    led = costcard.CostCardLedger(registry=metrics.Registry())

    def f(a, mode="a"):
        return a + 1 if mode == "a" else a * 2

    x = torch.ones(4)
    led.note_pending("test.kw", f, (x,), {"mode": "a"})
    led.note_pending("test.kw", f, (x,), {"mode": "b"})
    cards = led.capture_pending()
    assert len({c.signature for c in cards}) == 2


def test_capture_errors_are_recorded_not_raised():
    led = costcard.CostCardLedger(registry=metrics.Registry())

    def boom(a):
        raise RuntimeError("no replay")

    led.note_pending("test.boom", boom, (np.ones(2, np.float32),), {})
    assert led.capture_pending() == []
    dump = led.dump()
    assert dump["cards"] == [] and "RuntimeError" in next(iter(dump["capture_errors"].values()))


def test_costcard_roofline_verdicts_at_the_h100_peaks():
    card = CostCard(entry="e", signature="s", signature_repr="r", flops=1e9,
                    bytes_accessed=1e6, transcendentals=0, argument_bytes=500_000,
                    output_bytes=1000, temp_bytes=2000, generated_code_bytes=0)
    assert card.arithmetic_intensity() == 1000.0 and card.bound() == "compute"
    mem = CostCard(entry="e", signature="s2", signature_repr="r", flops=1e6, bytes_accessed=1e9,
                   transcendentals=0, argument_bytes=0, output_bytes=0, temp_bytes=0,
                   generated_code_bytes=0)
    assert mem.bound() == "memory"
    assert card.mfu_pct(1e-3) == pytest.approx(100.0 * 1e9 / (989e12 * 1e-3))
    assert mem.time_lower_bound_s() == pytest.approx(1e9 / 3.35e12)
    from dragonfly2_tpu_torch.training import train

    assert train.H100_PEAK_FLOPS_BF16 is costcard.H100_PEAK_FLOPS_BF16 == 989e12


def test_dump_and_gauges_export():
    svc = _service()
    svc.warmup()
    dump = flight.dump()
    entries = {c["entry"] for c in dump["costcards"]["cards"]}
    assert {"scheduler.evaluator.schedule_from_packed", "scheduler.tick.fused_tick_chunk"} & entries
    text = metrics.default_registry().expose()
    assert "# TYPE dragonfly_costcard_flops gauge" in text
    assert 'dragonfly_costcard_flops{entry="scheduler.' in text


def test_trainer_registers_an_epoch_card():
    """train_mlp registers the trainer.epoch_indexed card from its first
    step (no replay): a card of the block's steps, and the epoch entry
    counted its calls."""
    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.training.train import train_mlp

    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 6)).astype(np.float32)
    y = rng.standard_normal(256).astype(np.float32)
    wrapper = flight.entry_wrappers()["trainer.trainer.epoch_indexed"]
    calls = wrapper.stats()["calls"]
    result = train_mlp(x, y, TrainerConfig(hidden_dim=16, batch_size=32, epochs=2),
                       device="cpu")
    (card,) = costcard.ledger().cards("trainer.trainer.epoch_indexed")
    assert card.flops > 0 and card.bytes_accessed > 0
    assert wrapper.stats()["calls"] > calls
    per_sample = card.flops / (result.steps // (wrapper.stats()["calls"] - calls) * 32)
    assert 0.5 < per_sample / result.analytic_flops_per_sample < 20


def test_trainer_registration_stays_out_of_the_timing(monkeypatch):
    """A one-block training times none of its counted step: with the count
    made 5 s slower, the block's samples/s still leaves it out (and
    the counted step's samples), every step still trains; a second
    training at the same signature counts nothing, so the registration is
    once per (entry, signature) per process."""
    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.training.train import train_mlp

    slow = 5.0  # a timed registration reads at least this; untimed steps take far less
    real = costcard.counting

    class slow_counting(real):
        def __exit__(self, *exc):
            import time

            time.sleep(slow)
            return super().__exit__(*exc)

    monkeypatch.setattr(costcard, "counting", slow_counting)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 6)).astype(np.float32)
    y = rng.standard_normal(256).astype(np.float32)
    cfg = TrainerConfig(hidden_dim=16, batch_size=32, epochs=1, epoch_fusion=1)
    registered = train_mlp(x, y, cfg, device="cpu")
    (card,) = costcard.ledger().cards("trainer.trainer.epoch_indexed")
    steps = registered.steps
    assert steps > 1 and len(registered.losses) == steps
    timed = (steps - 1) * 32
    assert timed / registered.samples_per_sec < slow

    def no_count():
        raise AssertionError("the card is there: nothing may count again")

    monkeypatch.setattr(costcard, "counting", no_count)
    again = train_mlp(x, y, cfg, device="cpu")
    assert costcard.ledger().cards("trainer.trainer.epoch_indexed") == [card]
    assert again.steps == steps and len(again.losses) == steps
    assert steps * 32 / again.samples_per_sec < slow


# --------------------------------------------------------------- the dump


def test_flight_dump_sections_and_size_cap():
    svc = _service()
    sim = ClusterSimulator(svc, num_hosts=30, num_tasks=3, seed=2, deterministic_peer_ids=True)
    for _ in range(8):
        sim.run_round(new_downloads=8)
    only_ticks = flight.dump(recorder=svc.recorder, sections=("ticks",))
    assert set(only_ticks) == {"generated_at_ns", "ticks"}
    full = flight.dump(recorder=svc.recorder, max_bytes=None)
    assert set(full) == {"generated_at_ns", *flight.DUMP_SECTIONS}
    assert full["decisions"]["scheduler.decisions"]["rows"]
    assert flight._dump_nbytes(full) > 4096
    capped = flight.dump(recorder=svc.recorder, max_bytes=4096)
    assert len(json.dumps(capped, separators=(",", ":"), default=str)) <= 4096
    assert capped["truncated"]["max_bytes"] == 4096 and capped["truncated"]["dropped"]
    assert "jit" in capped
    assert "truncated" not in flight.dump(recorder=svc.recorder, max_bytes=64 << 20)
    zero = flight.dump(recorder=svc.recorder, last_n=0, max_bytes=None)
    assert zero["ticks"]["last"] == []
    assert all(led["rows"] == [] for led in zero["decisions"].values())
    mine = flight.dump(registry_fallback=False, sections=("ticks",))
    assert mine["ticks"] == {"ticks_total": 0, "p50_ms": {}, "last": []}
