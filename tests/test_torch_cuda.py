"""The port's CUDA kernels against their plain versions, on the card.

Imports no jax, so it runs on the GPU machine, which has none:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(--noconftest: tests/conftest.py sets up jax for the reference). Every
test skips, inside the test, where there is no CUDA device."""

import pytest
import torch

from dragonfly2_tpu_torch.ops import flash

pytestmark = pytest.mark.cuda

# bf16 rounding of q, k, v and p before the tensor cores, and of a bf16
# output (chip_smoke.py holds the kernel to the same tolerance)
ATOL, RTOL = 3e-2, 2e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.parametrize(
    "shape,causal,dtype",
    [
        ((8, 4, 15, 32), False, torch.bfloat16),
        ((2, 2, 130, 16), True, torch.bfloat16),
        ((2, 2, 33, 64), False, torch.bfloat16),
        ((2, 2, 200, 128), False, torch.float32),
    ],
)
def test_kernel_matches_plain(shape, causal, dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, l, d = shape
    q, k, v = (torch.randn(b, h, l, d, generator=gen, device="cuda").to(dtype) for _ in range(3))
    mask = torch.rand(b, l, generator=gen, device="cuda") < 0.8
    mask[0] = False
    for kv_mask in (mask, None):
        before = flash.LAUNCHES
        out = flash.flash_attention(q, k, v, kv_mask, causal)
        assert flash.LAUNCHES == before + 1
        assert out.dtype == dtype and out.shape == q.shape and out.is_cuda
        ref = flash.flash_attention_plain(q, k, v, kv_mask, causal)
        torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
    assert (flash.flash_attention(q, k, v, mask, causal)[0] == 0).all()


def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    _need_card()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(flash, "flash_attention_plain", refuse)
    monkeypatch.setattr(flash, "dense_attention", refuse)
    q = torch.randn(2, 2, 15, 32, device="cuda", dtype=torch.bfloat16)
    assert torch.isfinite(flash.flash_attention(q, q, q, None)).all()
    with pytest.raises(ValueError, match="one device"):
        flash.flash_attention(q, q, q, torch.ones(2, 15, dtype=torch.bool))
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q, None)
