"""The port's filesystem ModelRegistry, TrainerService, Announcer, decision
exporters, scenario A/B harness and the whole trace -> trainer -> registry
-> ml arm loop, against the reference package where it has the same
surface. Every trainer runs on the CPU (``device="cpu"``)."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from dragonfly2_tpu.cluster.scheduler import SchedulerService as RefService
from dragonfly2_tpu.cluster.simulator import ClusterSimulator as RefSimulator
from dragonfly2_tpu.cluster.trainer_service import TrainerService as RefTrainerService
from dragonfly2_tpu.config.config import TrainerConfig as RefTrainerConfig
from dragonfly2_tpu.objectstorage.backends import FilesystemBackend as RefBackend
from dragonfly2_tpu.records import synth as ref_synth
from dragonfly2_tpu.records.storage import HostTraceStorage as RefHostStorage
from dragonfly2_tpu.registry import BucketModelRegistry as RefBucketRegistry
from dragonfly2_tpu.registry import ModelRegistry as RefRegistry
from dragonfly2_tpu.registry import open_registry as ref_open_registry
from dragonfly2_tpu.registry.registry import ModelEvaluation as RefEvaluation
from dragonfly2_tpu.scenarios import ab as ref_ab
from dragonfly2_tpu.scenarios.spec import builtin_scenarios as ref_scenarios
from dragonfly2_tpu.telemetry import metrics as ref_metrics
from dragonfly2_tpu.training import data as ref_data
from dragonfly2_tpu_torch.cluster.announcer import Announcer, _chunks
from dragonfly2_tpu_torch.cluster.probes import ProbeStore
from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
from dragonfly2_tpu_torch.cluster.trainer_service import (
    ATTENTION_MODEL_NAME,
    GNN_MODEL_NAME,
    MLP_MODEL_NAME,
    TrainerService,
)
from dragonfly2_tpu_torch.config.config import Config, TrainerConfig
from dragonfly2_tpu_torch.models import convert
from dragonfly2_tpu_torch.models.attention import AttentionRanker
from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker
from dragonfly2_tpu_torch.models.mlp import ProbeRTTRegressor
from dragonfly2_tpu_torch.records import synth
from dragonfly2_tpu_torch.records.storage import HostTraceStorage, TraceStorage
from dragonfly2_tpu_torch.registry import (
    MLEvaluator,
    ModelEvaluation,
    ModelRegistry,
    ModelServer,
    open_registry,
)
from dragonfly2_tpu_torch.registry import GNN_MODEL_NAME as REEXPORTED_GNN_MODEL_NAME
from dragonfly2_tpu_torch.registry.registry import (
    MODEL_TYPE_ATTENTION,
    MODEL_TYPE_GNN,
    MODEL_TYPE_MLP,
)
from dragonfly2_tpu_torch.scenarios import ab
from dragonfly2_tpu_torch.scenarios.spec import builtin_scenarios
from dragonfly2_tpu_torch.training import data

HIDDEN = 16


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_leaves(value, f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# --------------------------------------------------------------- registry


def _publish_sequence(reg, evaluation_cls, params):
    """create v1-v3, activate v2, mark v1 (inactive) and v2 (active) bad, the
    active one refused deletion, delete v1, activate-bad refused, create and
    activate v4. Returns the model id."""
    mid = reg.model_id("ranker", "sched-1")
    for i in (1, 2, 3):
        reg.create_model_version("ranker", MODEL_TYPE_GNN, "sched-1", params,
                                 evaluation_cls(precision=0.25 * i, recall=0.5),
                                 metadata={"hidden_dim": HIDDEN, "i": i})
    reg.activate(mid, 2)
    reg.mark_version_bad(mid, 1, "canary failed")
    reg.mark_version_bad(mid, 2, "corrupt params")  # the active one: falls back to v3
    assert reg.active_version(mid).version == 3
    with pytest.raises(ValueError, match="active"):
        reg.delete_version(mid, 3)
    reg.delete_version(mid, 1)
    with pytest.raises(ValueError, match="bad"):
        reg.activate(mid, 2)
    with pytest.raises(FileNotFoundError):
        reg.activate(mid, 1)
    reg.create_model_version("ranker", MODEL_TYPE_GNN, "sched-1", params,
                             evaluation_cls(mse=0.5), metadata={"hidden_dim": HIDDEN, "i": 4})
    reg.activate(mid, 4)
    return mid


def _manifests(base, mid):
    def read(path):
        data = json.loads(path.read_text())
        data.pop("created_at", None)
        return data

    return (read(base / mid / "model.json"),
            {p.parent.name: read(p) for p in sorted((base / mid).glob("*/version.json"))})


def _graphsage_tree():
    model = GraphSAGERanker(HIDDEN, 2, torch.float32).reset_parameters(
        torch.Generator().manual_seed(0))
    return convert.graphsage_params_to_flax(model)


def test_registry_state_machine_matches_the_reference(tmp_path):
    """The same sequence of create, activate, mark_bad (the active one and
    another), delete and activate-bad on the port's filesystem registry and
    the reference's orbax one leaves equal model.json and version.json
    contents (created_at aside), equal listings and the same active
    version. The port's params sit in the bucket layout beside them."""
    params = _graphsage_tree()
    port, ref = ModelRegistry(tmp_path / "port"), RefRegistry(tmp_path / "ref")
    mid = _publish_sequence(port, ModelEvaluation, params)
    assert _publish_sequence(ref, RefEvaluation, params) == mid
    assert _manifests(tmp_path / "port", mid) == _manifests(tmp_path / "ref", mid)
    assert port.list_models() == ref.list_models()
    strip = lambda versions: [dataclasses.replace(v, created_at=0.0) for v in versions]  # noqa: E731
    assert ([dataclasses.asdict(v) for v in strip(port.list_versions(mid))]
            == [dataclasses.asdict(v) for v in strip(ref.list_versions(mid))])
    assert port.active_version(mid).version == ref.active_version(mid).version == 4
    assert sorted(p.name for p in (tmp_path / "port" / mid).iterdir()
                  if p.is_dir()) == ["2", "3", "4"]  # a deleted version goes whole
    for version in ("2", "3", "4"):
        names = {p.name for p in (tmp_path / "port" / mid / version).iterdir()
                 if not p.name.endswith(".etag")}
        assert names == {"version.json", "params.msgpack", "params.sha256"}
    _assert_trees_equal(port.load_params(mid, 4, template=params), params)
    _assert_trees_equal(port.load_params(mid, 4), ref.load_params(mid, 4))
    assert isinstance(open_registry(str(tmp_path / "port")), ModelRegistry)


def test_registries_read_each_other(tmp_path):
    """The reference's bucket registry (``open_registry("fs://<name>?
    base_dir=<parent>")``) reads every version the port's ModelRegistry
    publishes, params equal; the port's ModelRegistry reads a version the
    reference's bucket registry publishes."""
    params = _graphsage_tree()
    port = ModelRegistry(tmp_path / "models")
    mid = _publish_sequence(port, ModelEvaluation, params)
    ref = ref_open_registry(f"fs://models?base_dir={tmp_path}")
    assert ref.active_version(mid).version == 4
    for v in port.list_versions(mid):
        _assert_trees_equal(ref.load_params(mid, v.version), params)
    assert ([dataclasses.asdict(v) for v in ref.list_versions(mid)]
            == [dataclasses.asdict(v) for v in port.list_versions(mid)])

    ref_bucket = RefBucketRegistry(RefBackend(tmp_path), "theirs")
    rv = ref_bucket.create_model_version("mlp", MODEL_TYPE_MLP, "h", jax.device_get(params),
                                         RefEvaluation(mse=0.25))
    ref_bucket.activate(rv.model_id, rv.version)
    mine = ModelRegistry(tmp_path / "theirs")
    assert mine.active_version(rv.model_id).evaluation.mse == 0.25
    _assert_trees_equal(mine.load_params(rv.model_id, rv.version, template=params), params)


# --------------------------------------------------------- trainer service


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """Download and topology CSVs of tests/test_registry.py:204's cluster
    (synth.make_cluster(24, seed=1), 120 downloads over 8 tasks) and 60
    topology records, written by the port's TraceStorage. Small: the
    reference's trainer storage decodes each row through its column dict."""
    cluster = synth.make_cluster(24, seed=1)
    store = TraceStorage(tmp_path_factory.mktemp("traces"))
    for rec in synth.gen_download_records(cluster, 120, num_tasks=8):
        store.create_download(rec)
    for rec in synth.gen_network_topology_records(cluster, 60):
        store.create_network_topology(rec)
    store.flush()
    return store.open_download(), store.open_network_topology()


def _train_config(cls, **kw):
    return cls(epochs=1, batch_size=32, hidden_dim=HIDDEN, **kw)


def test_trainer_service_publishes_what_the_reference_publishes(tmp_path, traces):
    """Both packages' services train the GNN and the MLP on the same uploads
    and publish active versions whose evaluation fields and metadata keys
    are the reference's, with the same steps and dataset counts."""
    downloads, topology = traces
    outcomes = {}
    for name, service, storage, registry, cfg in (
        ("port", TrainerService, HostTraceStorage, ModelRegistry, TrainerConfig),
        ("ref", RefTrainerService, RefHostStorage, RefRegistry, RefTrainerConfig),
    ):
        kwargs = {"device": "cpu"} if name == "port" else {}
        svc = service(storage(tmp_path / name / "data"), registry(tmp_path / name / "reg"),
                      _train_config(cfg), **kwargs)
        svc.train_mlp_chunk("h1", downloads)
        svc.train_gnn_chunk("h1", topology)
        outcomes[name] = (svc.train_finish("h1"), svc.registry)
    (port, port_reg), (ref, _) = outcomes["port"], outcomes["ref"]
    assert port.attention is None and ref.attention is None
    for family in ("gnn", "mlp"):
        got, want = getattr(port, family), getattr(ref, family)
        assert got is not None and got.version == want.version == 1, family
        assert got.model_id == want.model_id and got.type == want.type
        assert set(got.metadata) == set(want.metadata), family
        for key in ("steps", "hidden_dim", "num_downloads", "num_hosts", "num_pairs"):
            assert got.metadata.get(key) == want.metadata.get(key), (family, key)
        assert (dataclasses.asdict(got.evaluation).keys()
                == dataclasses.asdict(want.evaluation).keys())
        assert port_reg.active_version(got.model_id).version == 1
        result = getattr(port, f"{family}_result")
        assert result.steps == getattr(ref, f"{family}_result").steps > 0
        assert np.isfinite(result.losses).all()
    assert port.gnn.evaluation.precision > 0 and port.mlp.evaluation.mse > 0
    assert REEXPORTED_GNN_MODEL_NAME == GNN_MODEL_NAME == "parent-ranker"


def test_trainer_service_publishes_the_attention_family(tmp_path, traces):
    """tests/test_registry.py:204: with train_attention on, the service
    publishes all three families, each active and loading against the
    serving module's shapes (the attention version's evaluation is the
    GNN's kind: the ranker's top-1 metrics)."""
    downloads, topology = traces
    svc = TrainerService(HostTraceStorage(tmp_path / "data"), ModelRegistry(tmp_path / "reg"),
                         _train_config(TrainerConfig, train_attention=True), device="cpu")
    svc.train_mlp_chunk("h1", downloads)
    svc.train_gnn_chunk("h1", topology)
    outcome = svc.train_finish("h1")
    port_reg = svc.registry
    assert outcome.attention is not None and outcome.attention_result.steps == 3  # 96 rows / 32
    assert outcome.attention.metadata["num_downloads"] == 120
    assert 0.0 <= outcome.attention.evaluation.precision <= 1.0
    templates = {
        GNN_MODEL_NAME: GraphSAGERanker(HIDDEN),
        ATTENTION_MODEL_NAME: AttentionRanker(HIDDEN, in_features=26),
        MLP_MODEL_NAME: ProbeRTTRegressor(HIDDEN),
    }
    for name, module in templates.items():
        mid = port_reg.model_id(name, "h1")
        port_reg.load_params(mid, 1, template=convert.params_to_flax(module))
    assert {m["type"] for m in port_reg.list_models()} == {
        MODEL_TYPE_GNN, MODEL_TYPE_MLP, MODEL_TYPE_ATTENTION}
    assert all(port_reg.active_version(m["model_id"]).version == 1 for m in port_reg.list_models())


def test_trainer_service_checkpoint_lifecycle(tmp_path, traces, monkeypatch):
    """tests/test_training.py:204-238: with checkpoint_dir set, checkpoints
    are written during training and CLEARED on success, so a later
    train_finish on fresh uploads trains from scratch instead of resuming
    past its final epoch and republishing stale params."""
    from dragonfly2_tpu_torch.training.checkpoint import TrainCheckpointer

    downloads, _ = traces
    saved, save = [], TrainCheckpointer.save

    def recorded(self, step, state):
        saved.append((self.directory.name, step))
        return save(self, step, state)

    monkeypatch.setattr(TrainCheckpointer, "save", recorded)
    svc = TrainerService(HostTraceStorage(tmp_path / "trainer"), ModelRegistry(tmp_path / "reg"),
                         _train_config(TrainerConfig, checkpoint_dir=str(tmp_path / "ck")),
                         device="cpu")
    svc.train_mlp_chunk("h1", downloads)
    outcome = svc.train_finish("h1")
    assert outcome.gnn is not None and outcome.gnn_result.steps > 0
    assert saved == [(GNN_MODEL_NAME, 0)]  # one epoch, one checkpoint
    assert not (tmp_path / "ck" / GNN_MODEL_NAME).exists()
    svc.train_mlp_chunk("h1", downloads)
    outcome2 = svc.train_finish("h1")
    assert outcome2.gnn is not None and outcome2.gnn_result.steps == outcome.gnn_result.steps
    assert outcome2.gnn.version == outcome.gnn.version + 1


def test_train_abort_clears_only_its_host(tmp_path, traces):
    downloads, topology = traces
    storage = HostTraceStorage(tmp_path / "trainer")
    svc = TrainerService(storage, ModelRegistry(tmp_path / "reg"), device="cpu")
    for host in ("h1", "h2"):
        svc.train_mlp_chunk(host, downloads)
        svc.train_gnn_chunk(host, topology)
    svc.train_abort("h1")
    names = sorted(p.name for p in (tmp_path / "trainer").iterdir())
    assert names == ["download-h2.csv", "networktopology-h2.csv"]
    assert len(storage.list_downloads()) == 120


def test_trainer_service_takes_cuda_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device trains there")
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainerService(HostTraceStorage(tmp_path / "trainer"), ModelRegistry(tmp_path / "reg"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ab.run_matrix({}, ab.MatrixConfig(evaluators=("ml",)), workdir=str(tmp_path / "ab"))


# --------------------------------------------------------------- announcer


class _Recorder:
    def __init__(self, fail_on=None):
        self.mlp, self.gnn, self.calls, self.fail_on = bytearray(), bytearray(), [], fail_on

    def train_mlp_chunk(self, host_id, data):
        self.calls.append(("mlp", host_id, len(data)))
        if self.fail_on == "mlp":
            raise ConnectionError("stream broke")
        self.mlp += data

    def train_gnn_chunk(self, host_id, data):
        self.calls.append(("gnn", host_id, len(data)))
        self.gnn += data

    def train_finish(self, host_id):
        self.calls.append(("finish", host_id))

    def train_abort(self, host_id):
        self.calls.append(("abort", host_id))


class _Traces:
    def __init__(self, downloads, topology):
        self.downloads, self.topology = downloads, topology

    def open_download(self):
        return self.downloads

    def open_network_topology(self):
        return self.topology


def test_announcer_gates_chunks_and_aborts(traces):
    downloads, topology = traces
    sink = _Recorder()
    ann = Announcer("sched-1", _Traces(downloads, topology), sink, interval_seconds=100,
                    chunk_bytes=1024)
    assert ann.maybe_announce(now=50.0) is False  # inside the first interval
    assert ann.maybe_announce(now=100.0) is True
    assert ann.maybe_announce(now=150.0) is False and ann.uploads == 1
    assert bytes(sink.mlp) == downloads and bytes(sink.gnn) == topology
    sizes = [c[2] for c in sink.calls if c[0] == "mlp"]
    assert sizes == [len(c) for c in _chunks(downloads, 1024)] and max(sizes) == 1024
    assert sink.calls[-1] == ("finish", "sched-1")
    assert ann.maybe_announce(now=200.0) and ann.uploads == 2

    broken = _Recorder(fail_on="mlp")
    ann = Announcer("sched-2", _Traces(downloads, topology), broken, interval_seconds=0)
    with pytest.raises(ConnectionError):
        ann.maybe_announce()
    assert broken.calls[-1] == ("abort", "sched-2") and ann.uploads == 0


# --------------------------------------------------------- decision exporters


@pytest.fixture(scope="module")
def ledger_dump():
    """tests/test_decisions.py:498-514's construction: a small scenario-lab
    replay's ledger dump, written by the reference's service."""
    svc = RefService(metrics_registry=ref_metrics.Registry())
    sim = RefSimulator(svc, num_hosts=48, num_tasks=4, seed=5,
                       scenario=ref_scenarios()["bandwidth_skew"])
    rounds = 0
    while svc.decisions.counters()["joined"] < 8 and rounds < 400:
        sim.run_round(8)
        rounds += 1
    return json.loads(json.dumps(svc.decisions.dump(last_n=256)))


def test_decision_exporters_match_the_reference(ledger_dump):
    doc = {"report": [{"ledger": ledger_dump}], "other": {"rows": [1]}}  # embedded, as a report
    rows = data.decision_rows(doc)
    assert rows == ref_data.decision_rows(doc) == ref_data.decision_rows(ledger_dump)
    arrays = data.decisions_to_rank_arrays(rows)
    want = ref_data.decisions_to_rank_arrays(rows)
    assert arrays["child_idx"].shape[0] > 0
    for key in want:
        assert arrays[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(arrays[key], want[key], err_msg=key)
    got = list(data.decision_rank_batches(rows, 4, np.random.default_rng(0)))
    expected = list(ref_data.decision_rank_batches(rows, 4, np.random.default_rng(0)))
    assert len(got) == len(expected) > 0
    for a, b in zip(got, expected):
        for field in ("child_idx", "parent_idx", "pair_feats", "throughput", "mask"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert list(data.decision_rank_batches([], 4, np.random.default_rng(0))) == []


# --------------------------------------------------------------- the matrix


MATRIX = dict(hosts=48, tasks=6, target_pieces=300, downloads_per_round=8, seeds=(5,),
              probe_every=10)  # tests/test_scenarios.py:286-291


def _matrix_scenarios(fn):
    return {k: v for k, v in fn().items() if k in ("flaky_parent", "churn")}


def test_matrix_rule_arms_match_the_reference():
    """tests/test_scenarios.py:286's config: two port runs give equal
    deterministic views, and the default and random arms' views equal the
    reference's (the random anchor, attached after construction, is read by
    neither package's fused tick: both score it with the rule blend)."""
    cfg = dict(MATRIX, evaluators=("default", "random"))
    got = ab.run_matrix(_matrix_scenarios(builtin_scenarios), ab.MatrixConfig(**cfg),
                        device="cpu")
    again = ab.run_matrix(_matrix_scenarios(builtin_scenarios), ab.MatrixConfig(**cfg),
                          device="cpu")
    want = ref_ab.run_matrix(_matrix_scenarios(ref_scenarios), ref_ab.MatrixConfig(**cfg))
    assert ab.deterministic_view(got) == ab.deterministic_view(again)
    assert ab.deterministic_view(got) == ref_ab.deterministic_view(want)
    flaky = got["scenarios"]["flaky_parent"]["arms"]["default"]["seeds"]["5"]
    assert flaky["injected"]["piece_failures"] > 0 and "timing" in flaky


def test_matrix_ml_arm_is_deterministic(tmp_path):
    """The ml arm trains once through the whole loop (replay -> announcer
    -> TrainerService -> ModelRegistry -> ModelServer) and serves every
    cell; two port runs give equal deterministic views. Its trained weights
    differ from the reference's by bf16 rounding, so its selections are
    compared only within the port."""
    cfg = ab.MatrixConfig(**dict(MATRIX, evaluators=("default", "ml"), train_pieces=600,
                                 trainer_epochs=1, trainer_batch=64, hidden_dim=HIDDEN))
    scen = {k: v for k, v in builtin_scenarios().items() if k == "flaky_parent"}
    runs = [ab.run_matrix(scen, cfg, workdir=str(tmp_path / str(i)), device="cpu")
            for i in range(2)]
    assert ab.deterministic_view(runs[0]) == ab.deterministic_view(runs[1])
    model = runs[0]["model"]
    assert model["train_pieces"] >= 600 and 0.0 <= model["precision"] <= 1.0
    arm = runs[0]["scenarios"]["flaky_parent"]["arms"]["ml"]["seeds"]["5"]
    assert arm["pieces"] >= 300 and arm["decisions"]["shadow_compared"] > 0
    assert "ml_vs_default" in runs[0]["scenarios"]["flaky_parent"]


# ------------------------------------------------------------- the full loop


def test_full_loop(tmp_path):
    """tests/test_e2e_loop.py:24 on the port, at that test's size: a
    simulated cluster writes traces and a topology snapshot, the announcer
    streams them to the trainer, the trainer publishes a GNN version, and
    the scheduler serves it on the ml arm."""
    storage = TraceStorage(tmp_path / "sched-data")
    probes = ProbeStore(max_pairs=4096, max_hosts=128, device="cpu")
    svc = SchedulerService(storage=storage, probes=probes, device="cpu")
    sim = ClusterSimulator(svc, num_hosts=40, num_tasks=8, seed=3)
    for _ in range(12):
        sim.run_round(new_downloads=6)
        sim.run_probe_round(sources=4)
    for _ in range(6):
        for r in svc.tick():
            sim._act(r)
    assert sim.stats.completed > 20, sim.stats
    assert sim.stats.pieces > 100
    downloads = storage.list_downloads()
    assert len(downloads) >= sim.stats.completed - sim.stats.back_to_source - 5
    assert svc.snapshot_topology(now_ns=1) > 0
    storage.flush()
    assert storage.list_network_topologies()

    registry = ModelRegistry(tmp_path / "registry")
    trainer = TrainerService(HostTraceStorage(tmp_path / "trainer-data"), registry,
                             TrainerConfig(epochs=2, batch_size=32, hidden_dim=HIDDEN),
                             device="cpu")
    announcer = Announcer("sched-host-1", storage, trainer, interval_seconds=0)
    assert announcer.maybe_announce()
    trainer.train_finish("sched-host-1")  # a second call with nothing uploaded is a no-op
    assert any(m["type"] == MODEL_TYPE_GNN for m in registry.list_models())
    gnn_id = registry.model_id(GNN_MODEL_NAME, "sched-host-1")
    active = registry.active_version(gnn_id)
    assert active is not None and active.version == 1
    assert active.evaluation.precision >= 0.0
    assert registry.active_version(registry.model_id(MLP_MODEL_NAME, "sched-host-1")) is not None

    server = ModelServer(registry, GNN_MODEL_NAME, "sched-host-1", MODEL_TYPE_GNN,
                         model=GraphSAGERanker(HIDDEN), device="cpu")
    assert server.refresh()
    ml = MLEvaluator(server)
    try:
        garrs = svc.serving_graph_arrays(consume_frontier=False)
        assert (garrs["edge_feats"][:, 1] > 0).any(), "replay produced no serving edges"
        ml.refresh_embeddings(garrs, wait=True)
        ml_cfg = Config()
        ml_cfg.evaluator.algorithm = "ml"
        svc_ml = SchedulerService(config=ml_cfg, ml_evaluator=ml, device="cpu")
        sim2 = ClusterSimulator(svc_ml, num_hosts=20, num_tasks=4, seed=5)
        for _ in range(6):
            sim2.run_round(new_downloads=4)
        for _ in range(4):
            for r in svc_ml.tick():
                sim2._act(r)
        assert sim2.stats.completed > 5, sim2.stats
        assert svc_ml.serving_graph_arrays(consume_frontier=False)["edge_feats"][:, 1].max() > 0
    finally:
        ml.close()
