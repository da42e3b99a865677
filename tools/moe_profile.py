"""Profile parallel/moe.py's sharded_moe_ffn, forward and backward, on a
CUDA card at the shape of chip_smoke.py phase 20's ep training step: 5,120
bf16 tokens of width 128 over ep 2 (the card repeated), 4 experts of
hidden 512, capacity int(2,560 / 4 * 2.0). Prints torch.profiler's table
of the five profiled calls, by self CUDA time.

    PYTHONPATH=. python3 tools/moe_profile.py
"""

from __future__ import annotations


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dragonfly2_tpu_torch.parallel import moe
    from dragonfly2_tpu_torch.parallel.mesh import make_mesh

    card = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t, f, h, e, ep = 5120, 128, 512, 4, 2
    x = torch.randn(t, f, device=card, generator=gen).bfloat16().requires_grad_(True)
    weights = [torch.randn(*shape, device=card, generator=gen).mul_(0.05).requires_grad_(True)
               for shape in ((f, e), (e, f, h), (e, h), (e, h, f), (e, f))]
    mesh = make_mesh(ep, dp=1, ep=ep, devices=[card] * ep)
    capacity = int(t // ep / e * 2.0)

    def step():
        moe.sharded_moe_ffn(mesh, x, *weights, capacity=capacity).float().sum().backward()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
    print(torch.cuda.get_device_name(0))
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25,
                                    max_name_column_width=90))


if __name__ == "__main__":
    main()
