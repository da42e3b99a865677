"""The port's tensor, pipeline and expert parallelism against the reference
on the same numpy inputs: parallel/{tensor,pipeline,moe}.py with
gradients, the MoE's capacity drops token for token, the mesh's size,
coordinates and hybrid fold, the multi-process bootstrap's arguments, and
the MoE init's spread against flax's.

The reference runs on tests/conftest.py's 8 virtual CPU devices; the port
runs its meshes in one process over ``devices=["cpu"] * n``
(parallel/mesh.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models.attention import SelfAttentionBlock as RefBlock
from dragonfly2_tpu.parallel import mesh as ref_mesh
from dragonfly2_tpu.parallel import moe as ref_moe
from dragonfly2_tpu.parallel import pipeline as ref_pipeline
from dragonfly2_tpu.parallel import tensor as ref_tensor
from dragonfly2_tpu_torch import parallel
from dragonfly2_tpu_torch.models.attention import AttentionRanker, SelfAttentionBlock
from dragonfly2_tpu_torch.parallel import mesh, moe, pipeline, tensor

# the reference's own tolerances (tests/test_parallel_strategies.py):
# float32 outputs, and gradients through gelu and the summed partials
ATOL = 1e-5
GRAD_ATOL = 1e-4


def _cpu_mesh(n, **axes):
    return mesh.make_mesh(n, devices=["cpu"] * n, **axes)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ----------------------------------------------------------------- tensor


def _ffn_case(t=16, f=12, h=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, f)).astype(np.float32),
            (rng.standard_normal((f, h)) * 0.1).astype(np.float32),
            (rng.standard_normal(h) * 0.1).astype(np.float32),
            (rng.standard_normal((h, f)) * 0.1).astype(np.float32),
            (rng.standard_normal(f) * 0.1).astype(np.float32))


@pytest.mark.parametrize("dp,tp", [(1, 2), (1, 4), (1, 8), (4, 2)])
def test_tp_ffn_matches_reference_with_gradients(dp, tp):
    arrays = _ffn_case(t=8 if dp > 1 else 16)
    ref = ref_mesh.make_mesh(dp * tp, dp=dp, tp=tp)

    def ref_loss(w1):
        x, _, b1, w2, b2 = arrays
        out = ref_tensor.sharded_tp_ffn(ref, x, w1, b1, w2, b2)
        return jnp.sum(out ** 2), out

    (_, want), want_grad = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(arrays[1])
    x, w1, b1, w2, b2 = _t(*arrays)
    w1.requires_grad_(True)
    got = tensor.sharded_tp_ffn(_cpu_mesh(dp * tp, dp=dp, tp=tp), x, w1, b1, w2, b2)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(w1.grad.numpy(), want_grad, atol=GRAD_ATOL)


def test_tp_ffn_keeps_bf16_and_refuses_an_uneven_split():
    x, w1, b1, w2, b2 = _t(*_ffn_case())
    got = tensor.sharded_tp_ffn(_cpu_mesh(2, dp=1, tp=2), x.bfloat16(), w1, b1, w2, b2)
    assert got.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="tp=3"):
        tensor.sharded_tp_ffn(_cpu_mesh(3, dp=1, tp=3), x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="dp=3"):
        tensor.sharded_tp_ffn(_cpu_mesh(3, dp=3), x[:7], w1, b1, w2, b2)


# --------------------------------------------------------------- pipeline


@pytest.mark.parametrize("pp,micro,linear", [(4, 6, False), (8, 1, True)])
def test_pipeline_matches_reference_with_gradients(pp, micro, linear):
    rng = np.random.default_rng(pp)
    f = 8 if pp == 4 else 4
    ws = (rng.standard_normal((pp, f, f)) * 0.3).astype(np.float32)
    bs = (rng.standard_normal((pp, f)) * 0.1).astype(np.float32)
    x = rng.standard_normal((micro, 3, f)).astype(np.float32)

    def ref_stage(params, a):
        y = jnp.dot(a, params[0]) + params[1]
        return y if linear else jnp.tanh(y)

    def stage(params, a):
        y = torch.matmul(a, params[0]) + params[1]
        return y if linear else torch.tanh(y)

    ref = ref_mesh.make_mesh(pp, dp=1, pp=pp)

    def ref_loss(p, a):
        out = ref_pipeline.sharded_pipeline_apply(ref, ref_stage, p, a)
        return jnp.sum(out ** 2), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(ref_loss, argnums=(0, 1), has_aux=True))(
        (ws, bs), x)
    tw, tb, tx = (t.requires_grad_(True) for t in _t(ws, bs, x))
    got = pipeline.sharded_pipeline_apply(_cpu_mesh(pp, dp=1, pp=pp), stage, (tw, tb), tx)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    # the stages applied in sequence
    seq = tx
    for i in range(pp):
        seq = stage((tw[i], tb[i]), seq)
    torch.testing.assert_close(got, seq, atol=ATOL, rtol=0)
    (got ** 2).sum().backward()
    (gw, gb), gx = want_grads
    for port, ref_grad in ((tw, gw), (tb, gb), (tx, gx)):
        np.testing.assert_allclose(port.grad.numpy(), np.asarray(ref_grad), atol=GRAD_ATOL)


def test_pipeline_stage_runs_on_its_device_and_skips_bubbles():
    calls = []

    def stage(params, a):
        calls.append(params.device)
        return a + params

    m = _cpu_mesh(3, dp=1, pp=3)
    out = pipeline.sharded_pipeline_apply(m, stage, torch.arange(3.0)[:, None],
                                          torch.zeros(4, 2))
    assert len(calls) == 3 * 4  # pp x M stage calls, no bubble slot
    torch.testing.assert_close(out, torch.full((4, 2), 3.0))


# -------------------------------------------------------------------- moe


def _moe_case(t=32, f=8, h=16, e=4, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, f)).astype(np.float32),
            rng.standard_normal((f, e)).astype(np.float32),
            (rng.standard_normal((e, f, h)) * 0.2).astype(np.float32),
            (rng.standard_normal((e, h)) * 0.1).astype(np.float32),
            (rng.standard_normal((e, h, f)) * 0.2).astype(np.float32),
            (rng.standard_normal((e, f)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("ep", [2, 4])
def test_moe_matches_reference_with_ample_capacity(ep):
    arrays = _moe_case()
    want = np.asarray(jax.jit(ref_moe.moe_reference)(*arrays))
    ref_m = ref_mesh.make_mesh(ep, dp=1, ep=ep)
    ref_got = np.asarray(jax.jit(
        lambda *a: ref_moe.sharded_moe_ffn(ref_m, *a, capacity=32 // ep))(*arrays))
    tensors = _t(*arrays)
    np.testing.assert_allclose(moe.moe_reference(*tensors).numpy(), want, atol=ATOL)
    got = moe.sharded_moe_ffn(_cpu_mesh(ep, dp=1, ep=ep), *tensors, capacity=32 // ep)
    np.testing.assert_allclose(got.numpy(), ref_got, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_moe_gradients_match_reference():
    arrays = _moe_case(t=16)
    ref = ref_mesh.make_mesh(2, dp=1, ep=2)
    want = jax.jit(jax.grad(
        lambda *a: jnp.sum(ref_moe.sharded_moe_ffn(ref, *a, capacity=8) ** 2),
        argnums=(0, 1, 2, 3, 4, 5)))(*arrays)
    tensors = [t.requires_grad_(True) for t in _t(*arrays)]
    got = moe.sharded_moe_ffn(_cpu_mesh(2, dp=1, ep=2), *tensors, capacity=8)
    (got ** 2).sum().backward()
    for port, ref_grad in zip(tensors, want):
        np.testing.assert_allclose(port.grad.numpy(), np.asarray(ref_grad), atol=GRAD_ATOL)


@pytest.mark.parametrize("capacity", [1, 2])
def test_moe_capacity_drops_the_reference_tokens(capacity):
    """Over-capacity tokens come out as zeros (Switch semantics); which
    tokens overflow is an integer fact of each ep shard's token order, so
    the dropped set equals the reference's exactly, and the kept tokens
    match it."""
    arrays = _moe_case(t=16)
    ep, e = 2, arrays[2].shape[0]
    ref = ref_mesh.make_mesh(ep, dp=1, ep=ep)
    want = np.asarray(jax.jit(
        lambda *a: ref_moe.sharded_moe_ffn(ref, *a, capacity=capacity))(*arrays))

    @jax.jit
    def ref_dispatch(x, gate_w):
        logits = jnp.dot(x, gate_w, preferred_element_type=jnp.float32)
        return ref_moe._top1_dispatch(x, logits, e, capacity)[0]

    ref_kept = np.concatenate([np.asarray(ref_dispatch(x, arrays[1])).sum((1, 2)) > 0
                               for x in np.split(arrays[0], ep)])
    tensors = _t(*arrays)
    got = moe.sharded_moe_ffn(_cpu_mesh(ep, dp=1, ep=ep), *tensors, capacity=capacity).numpy()
    kept = torch.cat([
        moe._top1_dispatch(x, x @ tensors[1], e, capacity)[2]["keep"]
        for x in tensors[0].split(16 // ep)
    ]).numpy()
    np.testing.assert_array_equal(kept, ref_kept)
    assert (~kept).sum() > 0  # the case drops
    np.testing.assert_array_equal(np.abs(got).sum(-1) == 0, ~kept)
    np.testing.assert_allclose(got, want, atol=ATOL)
    oracle = moe.moe_reference(*tensors).numpy()
    np.testing.assert_allclose(got[kept], oracle[kept], atol=ATOL)


def test_moe_refuses_an_uneven_split():
    tensors = _t(*_moe_case(t=15))
    with pytest.raises(ValueError, match="ep=2"):
        moe.sharded_moe_ffn(_cpu_mesh(2, dp=1, ep=2), *tensors, capacity=8)


# ------------------------------------------------------------------- mesh


def test_mesh_size_coordinates_and_slices():
    m = _cpu_mesh(8, dp=2, tp=2, ep=2)
    assert m.size == 8 == ref_mesh.make_mesh(8, dp=2, tp=2, ep=2).size
    m.devices[1, 0, 0, 1, 0, 0] = torch.device("meta")  # a marked place
    assert m.at(dp=1, tp=1) == torch.device("meta")
    sub = m.slice("tp", 1)
    assert sub.shape == {"dp": 2, "graph": 1, "sp": 1, "tp": 1, "pp": 1, "ep": 2}
    assert sub.at(dp=1) == torch.device("meta") and sub.group is None and sub.dcn == 1


def test_hybrid_mesh_folds_dcn_into_dp_in_one_process():
    got = mesh.make_hybrid_mesh(dcn_dp=2, dp=2, tp=2, devices=["cpu"] * 8)
    want = ref_mesh.make_hybrid_mesh(dcn_dp=2, dp=2, tp=2)
    assert got.shape == dict(want.shape) and got.shape["dp"] == 4
    assert got.size == want.size == 8
    assert got.dcn == 1 and got.group is None
    assert parallel.make_hybrid_mesh is mesh.make_hybrid_mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_hybrid_mesh(dcn_dp=2)


def test_initialize_distributed_takes_torchrun_environment(monkeypatch):
    seen = {}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    for key, value in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29555"),
                       ("WORLD_SIZE", "2"), ("RANK", "1")):
        monkeypatch.setenv(key, value)
    mesh.initialize_distributed()
    assert seen == {"backend": "nccl" if torch.cuda.is_available() else "gloo",
                    "init_method": "tcp://localhost:29555", "world_size": 2, "rank": 1}
    mesh.initialize_distributed("localhost:1234", 4, 3, backend="gloo")
    assert seen == {"backend": "gloo", "init_method": "tcp://localhost:1234",
                    "world_size": 4, "rank": 3}
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="process_id"):
        mesh.initialize_distributed()


# ------------------------------------------------------------- MoE block


def test_moe_init_spread_matches_flax():
    """flax's lecun_normal counts the expert dim as receptive field: fan_in
    of moe_w1 [E, F, 4F] is F x E, of moe_w2 [E, 4F, F] 4F x E."""
    hidden, experts = 64, 4
    block = AttentionRanker(hidden, 4, 1, moe_experts=experts, in_features=26).reset_parameters(
        torch.Generator().manual_seed(0)).block_0
    ref = jax.jit(RefBlock(hidden, moe_experts=experts).init)(
        jax.random.key(0), jnp.zeros((2, 5, hidden)), jnp.ones((2, 5), bool))["params"]
    fan_in = {"moe_gate": hidden, "moe_w1": hidden * experts, "moe_w2": 4 * hidden * experts}
    for name, fan in fan_in.items():
        got = getattr(block, name).detach().numpy()
        want = np.asarray(ref[name])
        assert got.shape == want.shape, name
        # both draws' spread is sqrt(1 / fan_in) within 5 standard errors
        # of a sample's std (1 / sqrt(2 n) of it)
        std, tol = (1.0 / fan) ** 0.5, 5 / (2 * got.size) ** 0.5
        for draw in (got, want):
            assert abs(draw.std() / std - 1) < tol, (name, draw.std(), std)
        # truncated at 2 sigma of the untruncated normal
        assert np.abs(got).max() <= 2 * std / 0.87962566 * (1 + 1e-6), name
    for name in ("moe_b1", "moe_b2"):
        assert not getattr(block, name).detach().any()
    assert not hasattr(block, "mlp_up") and set(ref) >= {"moe_gate", "qkv", "proj"}
    assert "mlp_up" not in ref


@pytest.mark.parametrize("ep", [1, 2])
def test_moe_block_matches_reference(ep):
    """One MoE block from the reference's params, on one device (the
    no-drop oracle) and over ep = 2 (capacity from the block's own
    formula), float32."""
    from dragonfly2_tpu_torch.models.convert import params_from_flax

    hidden, experts = 32, 4
    rng = np.random.default_rng(ep)
    x = rng.standard_normal((4, 8, hidden)).astype(np.float32)
    mask = rng.random((4, 8)) < 0.8
    mask[:, 0] = True
    ref_block = RefBlock(hidden, compute_dtype=jnp.float32, moe_experts=experts)
    params = jax.jit(ref_block.init)(jax.random.key(1), x, mask)
    ref_m = ref_mesh.make_mesh(ep, dp=1, ep=ep) if ep > 1 else None
    want = np.asarray(jax.jit(lambda p, a, k: ref_block.apply(p, a, k, mesh=ref_m))(
        params, x, mask))
    block = SelfAttentionBlock(hidden, compute_dtype=torch.float32, moe_experts=experts)
    block.load_state_dict(params_from_flax(jax.device_get(params)))
    m = _cpu_mesh(ep, dp=1, ep=ep) if ep > 1 else None
    got = block(*_t(x, mask), mesh=m)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4)


# ------------------------------------------------- MoE trainings
# (the tp and pp trainings are in tests/test_torch_parallel_training.py:
# the two files' reference runs land on different workers)


@pytest.fixture(scope="module")
def moe_runs():
    """The reference's MoE trainings, each run once: over dp 4 x ep 2 (the
    all_to_alls, capacity from the block's formula) and on one device (the
    no-drop oracle)."""
    from test_torch_parallel_training import PAR_CFG, reference_run, tiny_rank_data

    port_ds, ref_ds = tiny_rank_data()
    cfg = dict(PAR_CFG, attention_moe_experts=4)
    return port_ds, ref_ds, cfg, {
        "dp4xep2": reference_run(ref_ds, cfg, ref_mesh.make_mesh(8, dp=4, ep=2)),
        "one device": reference_run(ref_ds, cfg, None),
    }


@pytest.mark.parametrize("where", ["dp4xep2", "one device"])
def test_moe_training_matches_reference(moe_runs, where):
    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.training import train
    from test_torch_parallel_training import hold_to_reference

    port_ds, ref_ds, cfg, runs = moe_runs
    want, init = runs[where]
    m = _cpu_mesh(8, dp=4, ep=2) if where == "dp4xep2" else None
    got = train.train_attention(port_ds, TrainerConfig(**cfg), mesh=m, device="cpu", params=init)
    assert got.params["params"]["block_0"]["moe_w1"].shape == (4, 32, 128)
    hold_to_reference(got, want, init, cfg, ref_ds)
