"""The port's records, trace store, synth, quarantine and scenario engine
against the reference's: the CSV codec row for row, ``TraceStorage``
round trips and ``numeric_matrix`` through the native parse and through
the csv module, the synthetic cluster and its record streams draw for
draw, ``QuarantineBoard`` on one scripted clock, and the scenario engine's
samples and ``FaultInjector`` verdicts. All host code: equal means equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from dragonfly2_tpu.cluster import quarantine as ref_quarantine
from dragonfly2_tpu.records import schema as ref_schema
from dragonfly2_tpu.records import storage as ref_storage
from dragonfly2_tpu.records import synth as ref_synth
from dragonfly2_tpu.scenarios import engine as ref_engine
from dragonfly2_tpu.scenarios import spec as ref_spec
from dragonfly2_tpu_torch import native
from dragonfly2_tpu_torch.cluster import quarantine
from dragonfly2_tpu_torch.records import schema, storage, synth
from dragonfly2_tpu_torch.scenarios import engine, spec


def _records(pkg_synth, n=24, seed=5):
    cluster = pkg_synth.make_cluster(30, seed=seed)
    return (cluster, pkg_synth.gen_download_records(cluster, n),
            pkg_synth.gen_network_topology_records(cluster, n // 2))


def _peer_id_columns(header: list[str]) -> list[int]:
    """Download columns holding a peer id: drawn from uuid4 (utils/idgen)
    in both packages, so never paired."""
    return [i for i, name in enumerate(header)
            if name == "id" or (name.startswith("parents.") and name.endswith(".id")
                                and name.count(".") == 2)]


def _port_copy(records):
    """The reference's records as the port's, through the CSV codec."""
    cls = getattr(schema, type(records[0]).__name__)
    return [schema.from_row(cls, [str(x) for x in ref_schema.to_row(r)]) for r in records]


# ------------------------------------------------------------------ synth


def test_synth_cluster_and_records_match_draw_for_draw():
    ref_cluster, ref_dl, ref_nt = _records(ref_synth)
    cluster, dl, nt = _records(synth)
    assert [dataclasses.asdict(h) for h in cluster.hosts] == [
        dataclasses.asdict(h) for h in ref_cluster.hosts]
    ids = _peer_id_columns(schema.header(type(dl[0])))
    assert ids and len(ids) == 21

    def masked(row):
        return [None if i in ids else v for i, v in enumerate(row)]

    assert [masked(schema.to_row(r)) for r in dl] == [masked(ref_schema.to_row(r)) for r in ref_dl]
    assert [schema.to_row(r) for r in nt] == [ref_schema.to_row(r) for r in ref_nt]
    assert cluster.rng.random() == ref_cluster.rng.random()  # the stream stays paired


def test_synth_ranking_dataset_matches():
    want = ref_synth.gen_ranking_dataset(ref_synth.make_cluster(20, seed=2), 40, seed=3)
    got = synth.gen_ranking_dataset(synth.make_cluster(20, seed=2), 40, seed=3)
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert dataclasses.is_dataclass(w) and type(g).__name__ == type(w).__name__
        for name, value in vars(w).items():
            np.testing.assert_array_equal(np.asarray(getattr(g, name)), np.asarray(value),
                                          err_msg=name)


# -------------------------------------------------------------- the codec


@pytest.mark.parametrize("kind", ["download", "topology"])
def test_csv_codec_matches_row_for_row(kind):
    _, ref_dl, ref_nt = _records(ref_synth, seed=7)
    want_recs = ref_dl if kind == "download" else ref_nt
    got_recs = _port_copy(want_recs)
    cls, ref_cls = type(got_recs[0]), type(want_recs[0])
    assert schema.header(cls) == ref_schema.header(ref_cls)
    for got, want in zip(got_recs, want_recs):
        row = schema.to_row(got)
        assert row == ref_schema.to_row(want)
        assert schema.to_line(got) == ref_schema.to_line(want)
        assert schema.flatten(got) == ref_schema.flatten(want)
        back = schema.from_row(cls, [str(x) for x in row])
        assert dataclasses.asdict(back) == dataclasses.asdict(got)
        assert dataclasses.asdict(schema.unflatten(cls, schema.flatten(got))) == \
            dataclasses.asdict(got)


# ---------------------------------------------------------- TraceStorage


_, STORED_DL, STORED_NT = _records(ref_synth, n=40, seed=11)


def _write(pkg_storage, path):
    """The same records into either package's store (the port's through
    the codec)."""
    port = pkg_storage is storage
    dl = _port_copy(STORED_DL) if port else STORED_DL
    nt = _port_copy(STORED_NT) if port else STORED_NT
    store = pkg_storage.TraceStorage(path, max_size_mb=1, max_backups=3)
    for r in dl:
        store.create_download(r)
    for r in nt:
        store.create_network_topology(r)
    store.flush()
    return store


@pytest.mark.parametrize("parse", ["native", "csv"])
def test_trace_storage_round_trip_and_numeric_matrix(parse, tmp_path, monkeypatch):
    want = _write(ref_storage, tmp_path / "ref")
    if parse == "native":
        assert native.ensure_built(), "native/dfnative.cpp did not build"
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    got = _write(storage, tmp_path / "port")
    assert got.open_download() == want.open_download()
    assert got.downloads.count() == want.downloads.count() == 40
    assert [dataclasses.asdict(r) for r in got.list_downloads()] == [
        dataclasses.asdict(r) for r in want.list_downloads()]
    assert [dataclasses.asdict(r) for r in got.list_network_topologies()] == [
        dataclasses.asdict(r) for r in want.list_network_topologies()]
    for matrix in ("download_matrix", "topology_matrix"):
        g, w = getattr(got, matrix)(), getattr(want, matrix)()
        assert g.shape == w.shape and g.shape[0] > 0
        np.testing.assert_array_equal(g, w, err_msg=matrix)
    cols = ["finished_piece_count", "task.total_piece_count"]
    np.testing.assert_array_equal(got.download_matrix(cols), want.download_matrix(cols))


def test_native_and_csv_parses_agree(tmp_path, monkeypatch):
    store = _write(storage, tmp_path / "port")
    fast = store.download_matrix()
    monkeypatch.setattr(native, "get_lib", lambda: None)
    slow = store.download_matrix()
    np.testing.assert_array_equal(fast, slow)


# -------------------------------------------------------- QuarantineBoard


def test_quarantine_board_matches_on_one_clock():
    def script(mod):
        now = [0.0]
        board = mod.QuarantineBoard(threshold=3.0, half_life_s=10.0, clock=lambda: now[0])
        out = []
        for t, host, weight in [(0, "a", 1.0), (1, "a", 2.5), (2, "b", 5.0), (3, "c", 0.5),
                                (30, "a", 0.1), (31, "b", 0.0), (60, "c", 3.0)]:
            now[0] = float(t)
            out.append((board.report(host, weight), board.is_quarantined("a"),
                        board.is_quarantined("b"), round(board.penalty(host), 12),
                        board.active_count(), sorted(board.active())))
        board.drop("c")
        out.append((board.active_count(), board.is_quarantined("c")))
        return out

    assert script(quarantine) == script(ref_quarantine)


# ------------------------------------------------------- scenario engine


@pytest.mark.parametrize("name", sorted(spec.builtin_scenarios()))
def test_scenario_engine_matches(name):
    got_spec, want_spec = spec.builtin_scenarios()[name], ref_spec.builtin_scenarios()[name]
    assert got_spec.to_dict() == want_spec.to_dict()
    assert got_spec.to_toml() == want_spec.to_toml()
    hosts = synth.make_cluster(24, seed=4).hosts
    got, want = engine.ScenarioEngine(got_spec, hosts, seed=9), ref_engine.ScenarioEngine(
        want_spec, hosts, seed=9)
    assert got.bandwidth == want.bandwidth and got.flaky_hosts == want.flaky_hosts
    for i in range(6):
        src, dst = hosts[i], hosts[-1 - i]
        assert got.rtt_ns(src, dst, key=(i,)) == want.rtt_ns(src, dst, key=(i,))
        assert got.pair_bandwidth(src, dst) == want.pair_bandwidth(src, dst)
        assert got.offline_hosts(i) == want.offline_hosts(i)
        assert got.partitioned_hosts(i) == want.partitioned_hosts(i)
        assert got.scheduler_crashed(i) == want.scheduler_crashed(i)
        assert got.crash_point(i, 16) == want.crash_point(i, 16)
        assert got.flash_crowds(i, 5) == want.flash_crowds(i, 5)
    assert got.task_weights(5) == want.task_weights(5)
    assert got.crash_rounds(12) == want.crash_rounds(12)
    assert got.schedule_digest() == want.schedule_digest()
    fi, rfi = got.fault_injector(), want.fault_injector()
    verdicts = [(fi.piece_fault("t", p % 4), rfi.piece_fault("t", p % 4)) for p in range(16)]
    assert all(a == b for a, b in verdicts)
    assert fi.injected == rfi.injected
    data = bytes(range(64))
    assert fi.corrupt_bytes("t", 1, data) == rfi.corrupt_bytes("t", 1, data)
