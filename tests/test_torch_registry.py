"""The port's bucket registry (registry/bucket.py) and flax-layout params
codec (utils/flax_msgpack.py) against the reference BucketModelRegistry on
one shared filesystem bucket: versions published by either package load
in the other, and a tampered blob raises DataLoss."""

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from dragonfly2_tpu.models.attention import AttentionRanker as RefRanker
from dragonfly2_tpu.objectstorage.backends import FilesystemBackend as RefBackend
from dragonfly2_tpu.registry.bucket import BucketModelRegistry as RefBucketRegistry
from dragonfly2_tpu.registry.registry import ModelEvaluation as RefEvaluation
from dragonfly2_tpu_torch.models.attention import AttentionRanker
from dragonfly2_tpu_torch.models.convert import attention_params_to_flax
from dragonfly2_tpu_torch.registry import ModelEvaluation, ModelRegistry, ModelServer, open_registry
from dragonfly2_tpu_torch.registry.registry import MODEL_TYPE_ATTENTION, STATE_ACTIVE, STATE_BAD
from dragonfly2_tpu_torch.utils import dferrors, flax_msgpack

NAME, HOST = "set-ranker", "sched-h"
META = {"hidden_dim": 32, "num_heads": 2, "num_layers": 2}


def _ref_params():
    rng = np.random.default_rng(0)
    n, p, f = 3, 15, 12
    args = (rng.standard_normal((n, f)).astype(np.float32),
            rng.standard_normal((n, p, f)).astype(np.float32),
            rng.standard_normal((n, p, 2)).astype(np.float32),
            np.ones((n, p), bool))
    model = RefRanker(hidden_dim=32, num_heads=2, num_layers=2)
    return jax.device_get(model.init(jax.random.key(0), *args))


def _port_tree():
    model = AttentionRanker(32, 2, 2).reset_parameters(torch.Generator().manual_seed(1))
    return attention_params_to_flax(model)


def _registries(tmp_path):
    ref = RefBucketRegistry(RefBackend(tmp_path), "models", "prefix")
    port = open_registry(f"fs://models/prefix?base_dir={tmp_path}")
    return ref, port


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], dict):
            _assert_trees_equal(a[key], b[key])
        else:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype


def test_reference_publishes_port_reads(tmp_path):
    ref, port = _registries(tmp_path)
    params = _ref_params()
    mv = ref.create_model_version(NAME, "attention", HOST, params, RefEvaluation(f1_score=0.5),
                                  metadata=META)
    ref.activate(mv.model_id, mv.version)
    assert port.model_id(NAME, HOST) == mv.model_id
    active = port.active_version(mv.model_id)
    assert (active.version, active.state, active.metadata) == (1, STATE_ACTIVE, META)
    assert active.evaluation == ModelEvaluation(f1_score=0.5)
    _assert_trees_equal(port.load_params(mv.model_id, 1), params)
    # a template of the same layout is accepted, a different one refused
    port.load_params(mv.model_id, 1, template=params)
    with pytest.raises(ValueError, match="template"):
        port.load_params(mv.model_id, 1, template={"params": {}})


def test_port_publishes_reference_reads(tmp_path):
    ref, port = _registries(tmp_path)
    tree = _port_tree()
    mv = port.create_model_version(NAME, MODEL_TYPE_ATTENTION, HOST, tree, ModelEvaluation(),
                                   metadata=META)
    port.activate(mv.model_id, mv.version)
    assert ref.active_version(mv.model_id).version == 1
    # the reference's template-less restore (flax msgpack_restore)
    _assert_trees_equal(ref.load_params(mv.model_id, 1), tree)
    # byte for byte the blob flax writes for the same tree
    blob = port.backend.get_object("models", f"prefix/{mv.model_id}/1/params.msgpack")
    assert blob == serialization.msgpack_serialize(jax.device_get(tree))


def test_tampered_blob_raises_data_loss(tmp_path):
    _, port = _registries(tmp_path)
    mid = port.model_id(NAME, HOST)
    for _ in range(2):
        mv = port.create_model_version(NAME, MODEL_TYPE_ATTENTION, HOST, _port_tree(),
                                       ModelEvaluation(), metadata=META)
    port.activate(mid, 1)
    server = ModelServer(port, NAME, HOST, MODEL_TYPE_ATTENTION, device="cpu")
    assert server.refresh() and server.version == 1
    port.activate(mid, mv.version)
    key = f"prefix/{mid}/{mv.version}/params.msgpack"
    blob = bytearray(port.backend.get_object("models", key))
    blob[len(blob) // 2] ^= 0xFF
    port.backend.put_object("models", key, bytes(blob))
    with pytest.raises(dferrors.DataLoss, match="sha256"):
        port.load_params(mid, mv.version)
    # serving refuses it, marks it bad, and the pointer falls back to v1
    assert not server.refresh() and server.version == 1
    assert [v.state for v in port.list_versions(mid)] == [STATE_ACTIVE, STATE_BAD]
    assert port.active_version(mid).version == 1
    with pytest.raises(ValueError, match="marked bad"):
        port.activate(mid, mv.version)


def test_codec_matches_flax_on_mixed_leaves():
    tree = {
        "b": {"z": np.arange(6, dtype=np.int32).reshape(2, 3), "a": np.float32(1.5)},
        "a": np.array([True, False]),
        "c": {"k": np.linspace(0, 1, 7, dtype=np.float64), "e": np.zeros((0, 3), np.float32)},
        "d": 3,
        "f": torch.arange(4, dtype=torch.float32),
    }
    blob = flax_msgpack.serialize(tree)
    as_numpy = dict(tree, f=tree["f"].numpy())
    assert blob == serialization.msgpack_serialize(jax.device_get(as_numpy))
    restored = flax_msgpack.restore(blob)
    want = serialization.msgpack_restore(blob)
    assert list(restored) == list(want) == ["a", "b", "c", "d", "f"]
    _assert_trees_equal(restored, want)


def test_unported_registries_raise(tmp_path):
    """A plain path is the filesystem ModelRegistry (params in the bucket
    layout); the s3:// URL, refused before A9 part 3a, opens the bucket
    registry over the signed S3 backend, and the reference's registry on
    the same URL reads what the port published, byte for byte."""
    import urllib.parse

    import chip_smoke
    from dragonfly2_tpu.registry.bucket import open_registry as ref_open_registry
    from dragonfly2_tpu_torch.objectstorage.remote import S3Backend

    assert isinstance(open_registry(str(tmp_path / "registry")), ModelRegistry)
    stub = chip_smoke._S3Stub()
    try:
        url = "s3://models/fleet?" + urllib.parse.urlencode({
            "endpoint": stub.endpoint, "access_key": chip_smoke.OBJ_ACCESS,
            "secret_key": chip_smoke.OBJ_SECRET, "region": chip_smoke.OBJ_REGION})
        port = open_registry(url)
        assert isinstance(port.backend, S3Backend) and port.prefix == "fleet"
        params = {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)}}
        mv = port.create_model_version("ranker", "gnn", "host-1", params, ModelEvaluation())
        port.activate(mv.model_id, mv.version)
        ref = ref_open_registry(url)
        assert ref.active_version(mv.model_id).version == mv.version
        got = ref.load_params(mv.model_id, mv.version)
        np.testing.assert_array_equal(got["params"]["w"], params["params"]["w"])
        assert stub.refused == 0
    finally:
        stub.stop()
