"""Over-the-wire ModelInfer through the port (rpc/inference.py,
registry/serving.py) — the shape of tests/test_inference_rpc.py for the
attention model — plus cross-package runs: the reference client against
the port's server, the port's client against the reference server, and
serving parity with the reference ModelServer on one shared registry."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models.attention import AttentionRanker as RefRanker
from dragonfly2_tpu.objectstorage.backends import FilesystemBackend as RefBackend
from dragonfly2_tpu.registry.bucket import BucketModelRegistry as RefBucketRegistry
from dragonfly2_tpu.registry.registry import ModelEvaluation as RefEvaluation
from dragonfly2_tpu.registry.serving import ModelServer as RefModelServer
from dragonfly2_tpu.rpc import inference as ref_inference
from dragonfly2_tpu.rpc import wire as ref_wire
from dragonfly2_tpu.utils import dferrors as ref_dferrors
from dragonfly2_tpu_torch.device import resolve_device
from dragonfly2_tpu_torch.models.attention import AttentionRanker
from dragonfly2_tpu_torch.models.convert import attention_params_to_flax
from dragonfly2_tpu_torch.registry import MLEvaluator, ModelEvaluation, ModelServer, open_registry
from dragonfly2_tpu_torch.registry.registry import MODEL_TYPE_ATTENTION
from dragonfly2_tpu_torch.rpc import inference, wire
from dragonfly2_tpu_torch.rpc.inference import InferenceClient, InferenceRPCServer
from dragonfly2_tpu_torch.utils import dferrors

NAME, HOST = "set-ranker", "sched-h"
META = {"hidden_dim": 32, "num_heads": 2, "num_layers": 2}
P, F = 15, 12
BF16_TOL = 5e-2  # bf16 ranker, two implementations (tests/test_attention.py:144-147)


def _request(n=5, seed=1):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, P)) < 0.8
    mask[:, 0] = True
    mask[-1] = False
    return {
        "child_feats": rng.standard_normal((n, F)).astype(np.float32),
        "parent_feats": rng.standard_normal((n, P, F)).astype(np.float32),
        "pair_feats": (rng.random((n, P, 2)) < 0.5).astype(np.float32),
        "mask": mask,
    }


@pytest.fixture()
def registries(tmp_path):
    ref = RefBucketRegistry(RefBackend(tmp_path), "models", "r")
    port = open_registry(f"fs://models/r?base_dir={tmp_path}")
    return ref, port


def _port_server(port_registry):
    return ModelServer(port_registry, NAME, HOST, MODEL_TYPE_ATTENTION, device="cpu")


def _publish_reference_params(ref):
    req = _request()
    params = RefRanker(hidden_dim=32, num_heads=2, num_layers=2).init(
        jax.random.key(2), req["child_feats"], req["parent_feats"], req["pair_feats"], req["mask"]
    )
    mv = ref.create_model_version(NAME, "attention", HOST, jax.device_get(params),
                                  RefEvaluation(), metadata=META)
    ref.activate(mv.model_id, mv.version)


def test_infer_rpc_end_to_end(registries):
    _, reg = registries
    servers = {NAME: _port_server(reg)}
    req = _request()

    async def run():
        server = InferenceRPCServer(servers, refresh_ttl_s=0.0)
        host, port = await server.start()
        client = await InferenceClient(host, port).connect()
        try:
            assert await client.server_live()
            assert not await client.model_ready(NAME)
            with pytest.raises(dferrors.Unavailable, match="no active version"):
                await client.model_infer(NAME, req)

            model = AttentionRanker(32, 2, 2).reset_parameters(torch.Generator().manual_seed(0))
            mv = reg.create_model_version(NAME, MODEL_TYPE_ATTENTION, HOST,
                                          attention_params_to_flax(model), ModelEvaluation(),
                                          metadata=META)
            reg.activate(mv.model_id, mv.version)

            assert await client.model_ready(NAME)
            meta = await client.model_metadata(NAME)
            assert meta.platform == "torch-attention" and meta.versions == ["1"]
            assert meta.inputs == ["child_feats", "parent_feats", "pair_feats", "mask"]
            assert meta.outputs == ["scores"]

            out = await client.model_infer(NAME, req)
            direct = servers[NAME].score_set(
                req["child_feats"], req["parent_feats"], req["pair_feats"], req["mask"]
            ).numpy()
            np.testing.assert_array_equal(out["scores"], direct)
            assert out["scores"].shape == (5, P) and out["scores"].dtype == np.float32
            assert (out["scores"][~req["mask"]] == np.float32(-1e30)).all()

            with pytest.raises(dferrors.Unavailable, match="missing"):
                await client.model_infer(NAME, {"child_feats": req["child_feats"]})
            with pytest.raises(dferrors.Unavailable, match="no model"):
                await client.model_infer("nope", req)
            assert await client.server_live()
        finally:
            await client.close()
            await server.stop()

    asyncio.run(run())


def test_reference_client_against_port_server(registries):
    ref, reg = registries
    _publish_reference_params(ref)
    servers = {NAME: _port_server(reg)}
    req = _request(seed=3)

    async def run():
        server = InferenceRPCServer(servers, refresh_ttl_s=0.0)
        host, port = await server.start()
        client = await ref_inference.InferenceClient(host, port).connect()
        try:
            assert await client.server_live()
            assert await client.model_ready(NAME)
            assert (await client.model_metadata(NAME)).platform == "torch-attention"
            out = await client.model_infer(NAME, req)
            with pytest.raises(ref_dferrors.Unavailable, match="missing"):
                await client.model_infer(NAME, {"mask": req["mask"]})
        finally:
            await client.close()
            await server.stop()
        return out

    out = asyncio.run(run())
    direct = servers[NAME].score_set(
        req["child_feats"], req["parent_feats"], req["pair_feats"], req["mask"]
    ).numpy()
    np.testing.assert_array_equal(out["scores"], direct)


def test_port_client_against_reference_server(registries):
    ref, _ = registries
    _publish_reference_params(ref)
    ref_server = RefModelServer(ref, NAME, HOST, "attention", template_params=None)
    req = _request(seed=4)

    async def run():
        server = ref_inference.InferenceRPCServer({NAME: ref_server}, refresh_ttl_s=0.0)
        host, port = await server.start()
        client = await InferenceClient(host, port).connect()
        try:
            assert await client.server_live()
            assert await client.model_ready(NAME)
            assert (await client.model_metadata(NAME)).platform == "jax-attention"
            out = await client.model_infer(NAME, req)
            with pytest.raises(dferrors.Unavailable, match="no model"):
                await client.model_infer("nope", req)
        finally:
            await client.close()
            await server.stop()
        return out

    out = asyncio.run(run())
    direct = np.asarray(ref_server.score_set(
        req["child_feats"], req["parent_feats"], req["pair_feats"], req["mask"]
    ))
    np.testing.assert_array_equal(out["scores"], direct)


def test_port_serving_matches_reference_serving(registries):
    """Slice parity: the same active version, served by both packages."""
    ref, reg = registries
    _publish_reference_params(ref)
    ref_server = RefModelServer(ref, NAME, HOST, "attention", template_params=None)
    port_server = _port_server(reg)
    assert ref_server.refresh() and port_server.refresh()
    assert (port_server.model.hidden_dim, port_server.model.num_heads) == (32, 2)
    for seed, n in ((5, 4), (6, 64)):
        req = _request(n=n, seed=seed)
        args = (req["child_feats"], req["parent_feats"], req["pair_feats"], req["mask"])
        want = np.asarray(ref_server.score_set(*args))
        got = port_server.score_set(*args).numpy()
        mask = req["mask"]
        np.testing.assert_allclose(got[mask], want[mask], atol=BF16_TOL, rtol=BF16_TOL)
        np.testing.assert_array_equal(got[~mask], want[~mask])


def test_frames_interoperate():
    req = _request(n=2)
    port_msg = inference.ModelInferRequest(
        model_name=NAME, id="r1",
        inputs=[inference.InferTensor.from_numpy(k, v) for k, v in req.items()],
    )
    ref_msg = ref_inference.ModelInferRequest(
        model_name=NAME, id="r1",
        inputs=[ref_inference.InferTensor.from_numpy(k, v) for k, v in req.items()],
    )
    frame = wire.encode(port_msg)
    assert frame == ref_wire.encode(ref_msg)
    decoded = ref_wire.decode(frame[4:])
    assert type(decoded) is ref_inference.ModelInferRequest
    for t in decoded.inputs:
        np.testing.assert_array_equal(t.to_numpy(), req[t.name])
    back = wire.decode(ref_wire.encode(ref_inference.ModelReadyResponse(ready=True))[4:])
    assert back == inference.ModelReadyResponse(ready=True)


def test_stop_with_connected_client(registries):
    _, reg = registries
    servers = {NAME: _port_server(reg)}

    async def run():
        server = InferenceRPCServer(servers, refresh_ttl_s=0.0)
        host, port = await server.start()
        client = await InferenceClient(host, port).connect()
        assert await client.server_live()
        await asyncio.wait_for(server.stop(), timeout=5.0)
        await client.close()

    asyncio.new_event_loop().run_until_complete(run())


def test_entry_points_refuse_a_missing_cuda_device(registries):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, reg = registries
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelServer(reg, NAME, HOST, MODEL_TYPE_ATTENTION)
    assert resolve_device("cpu") == torch.device("cpu")
    # the gnn server and the ml evaluator on it refuse it alike
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelServer(reg, NAME, HOST, "gnn")
    with pytest.raises(RuntimeError, match="CUDA"):
        MLEvaluator(ModelServer(reg, NAME, HOST, "gnn"))
    assert MLEvaluator(ModelServer(reg, NAME, HOST, "gnn", device="cpu")).device.type == "cpu"
