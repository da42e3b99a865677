#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dragonfly2_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero without a
result line:

1. device: require CUDA; print the card's name and power limit.
2. build: compile every CUDA source of the path (ops/build.py) and print
   the build time and the compiler's register/spill report.
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, at the served shape and at long-context shapes, with the
   kernel's, the plain version's and a PyTorch library call's times
   (CUDA events) beside the bound the card allows.
4. main path: a full-width AttentionRanker (hidden 128, 4 heads, 2 layers)
   from a seeded generator, published to the port's bucket registry under
   a temporary fs:// location and activated, served by InferenceRPCServer
   on 127.0.0.1 with a ModelServer on cuda, and queried with
   InferenceClient (ServerLive, ModelReady, ModelInfer at N = 64, 256 and
   1024 tasks of 15 candidates). Launch counters are zeroed just before and
   read just after; every request must go through the kernel once per
   layer. The answers are checked against the in-process score_set (bit
   for bit) and against the same params on the CPU with the plain version.
5. the kernels JSON line and, last, the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 495e12}  # dense tensor core: bf16, TF32
# kernel vs plain version on the card: both round to bf16 where the kernel
# feeds the tensor cores (q, k, v, p), and the output is bf16 for bf16 inputs
KERNEL_ATOL, KERNEL_RTOL = 3e-2, 2e-2
# full ranker, cuda (kernel, cuBLAS bf16) vs cpu (plain version): bf16
# rounding at every layer, the same family as tests/test_attention.py
MODEL_ATOL, MODEL_RTOL = 5e-2, 5e-2
CANDIDATES = 15  # FILTER_PARENT_LIMIT
TASK_BUCKETS = (64, 256, 1024)  # the scheduler's eval buckets
REQUESTS_PER_BUCKET = 6


def _fail(message: str) -> None:
    print(f"chip_smoke FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    from dragonfly2_tpu_torch.ops import build

    sources = sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
    start = time.perf_counter()
    logs = build.build_all(sources)
    seconds = time.perf_counter() - start
    for name, log in logs.items():
        if not log:
            print(f"build {name}: already built")
            continue
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"build {name}: {len(regs)} kernels, registers max {max(regs, default=0)}, "
              f"spill stores max {max(spills, default=0)} bytes")
    print(f"build: {len(sources)} sources in {seconds:.2f} s")


def _attention_inputs(gen, b, h, l, d, dtype, fully_masked_rows):
    import torch

    q, k, v = (
        torch.randn(b, h, l, d, generator=gen, device="cuda").to(dtype) for _ in range(3)
    )
    mask = torch.rand(b, l, generator=gen, device="cuda") < 0.85
    mask[:, 0] = True
    if fully_masked_rows:
        mask[: max(1, b // 16)] = False
    else:
        mask[-1, l - l // 8:] = False  # a ragged tail
    return q, k, v, mask


def _bound(q, mask, causal):
    """Least time for the function on this card: each input read once and
    the output written once, or the products over the valid (query, key)
    pairs of this run's mask at the dtype's peak — whichever is larger."""
    import torch

    b, h, l, d = q.shape
    nbytes = 4 * q.numel() * q.element_size() + mask.numel()
    m = mask.to(torch.int64)
    if causal:
        pairs = int(torch.cumsum(m, dim=1).sum().item())
    else:
        pairs = int((m.sum(dim=1) * l).sum().item())
    ops = 4 * d * h * pairs
    mem_s = nbytes / PEAK_BYTES_PER_S
    ops_s = ops / PEAK_OPS_PER_S[str(q.dtype).removeprefix("torch.")]
    return max(mem_s, ops_s) * 1e3, ("bytes" if mem_s >= ops_s else "operations")


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from dragonfly2_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = [
        # name, (B, H, L, D), causal, dtype, fully masked rows, timing iters
        ("served", (1024, 4, 15, 32), False, torch.bfloat16, True, 200),
        ("long", (2, 4, 4096, 32), False, torch.bfloat16, False, 20),
        ("long-causal", (2, 4, 4096, 32), True, torch.bfloat16, False, 20),
        ("wide", (4, 8, 2048, 128), False, torch.bfloat16, False, 20),
        ("test-width", (4, 2, 15, 16), False, torch.bfloat16, True, 50),
        ("float32", (3, 2, 130, 64), True, torch.float32, True, 50),
    ]
    results = {}
    for name, (b, h, l, d), causal, dtype, fully, iters in shapes:
        q, k, v, mask = _attention_inputs(gen, b, h, l, d, dtype, fully)
        out = flash.flash_attention(q, k, v, mask, causal)
        torch.cuda.synchronize()
        ref = flash.flash_attention_plain(q, k, v, mask, causal)
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max().item())
        within = bool((diff <= KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()).all().item())
        if not within or not torch.isfinite(out).all():
            _fail(f"kernel {name}: max_abs_err {err} outside atol {KERNEL_ATOL} rtol {KERNEL_RTOL}")
        dead = ~mask.any(dim=1)
        if dead.any() and out[dead].abs().max().item() != 0.0:
            _fail(f"kernel {name}: fully masked rows are not 0")
        no_mask_err = float(
            (flash.flash_attention(q, k, v, None, causal).float()
             - flash.flash_attention_plain(q, k, v, None, causal).float()).abs().max().item()
        )
        if no_mask_err > KERNEL_ATOL + KERNEL_RTOL * float(ref.float().abs().max().item()):
            _fail(f"kernel {name} without a mask: max_abs_err {no_mask_err}")
        ms = _time_ms(lambda: flash.flash_attention(q, k, v, mask, causal), iters)
        plain_ms = _time_ms(lambda: flash.flash_attention_plain(q, k, v, mask, causal),
                            max(3, iters // 4))
        sdpa_mask = mask[:, None, None, :]
        if causal:
            sdpa_mask = sdpa_mask & torch.ones(l, l, dtype=torch.bool, device="cuda").tril()
        library_ms = _time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask), iters
        )
        bound_ms, bound_by = _bound(q, mask, causal)
        results[name] = dict(
            shape=[b, h, l, d], causal=causal, dtype=str(dtype).removeprefix("torch."),
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by,
        )
        print(f"kernel flash_fwd {name} {[b, h, l, d]} causal={causal} "
              f"{results[name]['dtype']}: max_abs_err {err:.3g} (no mask {no_mask_err:.3g}; "
              f"atol {KERNEL_ATOL} rtol {KERNEL_RTOL}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
    return results


def _requests(n: int, rng: np.random.Generator):
    from dragonfly2_tpu_torch.models.attention import NUM_HOST_FEATURES, NUM_PAIR_FEATURES

    child = rng.standard_normal((n, NUM_HOST_FEATURES)).astype(np.float32)
    parents = rng.standard_normal((n, CANDIDATES, NUM_HOST_FEATURES)).astype(np.float32)
    pair = (rng.random((n, CANDIDATES, NUM_PAIR_FEATURES)) < 0.5).astype(np.float32)
    # left-compacted candidate slots, 0..15 valid per task (0 = a task with
    # no eligible parent, whose row the kernel must return as zeros)
    counts = rng.integers(0, CANDIDATES + 1, size=n)
    counts[0] = 0
    mask = np.arange(CANDIDATES)[None, :] < counts[:, None]
    return {"child_feats": child, "parent_feats": parents, "pair_feats": pair, "mask": mask}


async def _serve_and_query(server, name):
    from dragonfly2_tpu_torch.ops import flash
    from dragonfly2_tpu_torch.rpc.inference import InferenceClient, InferenceRPCServer

    rng = np.random.default_rng(SEED)
    batches = {n: _requests(n, rng) for n in TASK_BUCKETS}
    rpc = InferenceRPCServer({name: server}, host="127.0.0.1", port=0)
    host, port = await rpc.start()
    client = await InferenceClient(host, port).connect()
    try:
        if not await client.server_live():
            _fail("ServerLive answered false")
        if not await client.model_ready(name):
            _fail("ModelReady answered false after activation")
        answers, latency_ms = {}, {}
        flash.LAUNCHES = 0
        requests = 0
        for n in TASK_BUCKETS:
            times = []
            for _ in range(REQUESTS_PER_BUCKET):
                start = time.perf_counter()
                out = await client.model_infer(name, batches[n], request_id=f"smoke-{n}")
                times.append((time.perf_counter() - start) * 1e3)
                requests += 1
                if n in answers and not np.array_equal(out["scores"], answers[n]):
                    _fail(f"N={n}: repeated request answered differently")
                answers[n] = out["scores"]
            latency_ms[n] = times
        launches = flash.LAUNCHES
    finally:
        await client.close()
        await rpc.stop()
    return batches, answers, latency_ms, requests, launches


def phase_main_path():
    import torch

    from dragonfly2_tpu_torch.models.attention import AttentionRanker
    from dragonfly2_tpu_torch.models.convert import attention_params_to_flax
    from dragonfly2_tpu_torch.registry import ModelEvaluation, ModelServer, open_registry
    from dragonfly2_tpu_torch.registry.registry import MODEL_TYPE_ATTENTION

    name, host_id = "attention-ranker", "chip-smoke-scheduler"
    model = AttentionRanker().reset_parameters(torch.Generator().manual_seed(SEED))
    with tempfile.TemporaryDirectory(prefix="dfly-smoke-") as tmp:
        registry = open_registry(f"fs://models/smoke?base_dir={tmp}")
        version = registry.create_model_version(
            name, MODEL_TYPE_ATTENTION, host_id, attention_params_to_flax(model),
            ModelEvaluation(),
            metadata={"hidden_dim": model.hidden_dim, "num_heads": model.num_heads,
                      "num_layers": model.num_layers},
        )
        registry.activate(version.model_id, version.version)
        server = ModelServer(registry, name, host_id, MODEL_TYPE_ATTENTION, device="cuda")
        batches, answers, latency_ms, requests, launches = asyncio.run(
            _serve_and_query(server, name)
        )
        expected = requests * model.num_layers
        print(f"main path: {requests} ModelInfer requests, flash_fwd launches {launches} "
              f"(expected {expected} = requests x num_layers)")
        if launches != expected:
            _fail(f"flash_fwd launched {launches} times on the main path, expected {expected}")

        cpu_server = ModelServer(registry, name, host_id, MODEL_TYPE_ATTENTION, device="cpu")
        if not cpu_server.refresh():
            _fail("the CPU ModelServer could not load the active version")
        for n in TASK_BUCKETS:
            batch, wire = batches[n], answers[n]
            mask = batch["mask"]
            if wire.shape != (n, CANDIDATES) or wire.dtype != np.float32:
                _fail(f"N={n}: scores {wire.shape} {wire.dtype}")
            if not np.isfinite(wire[mask]).all():
                _fail(f"N={n}: non-finite score at a valid slot")
            if not (wire[~mask] == np.float32(-1e30)).all():
                _fail(f"N={n}: invalid slots are not -1e30")
            direct = server.score_set(
                batch["child_feats"], batch["parent_feats"], batch["pair_feats"], mask
            ).cpu().numpy()
            if not np.array_equal(wire, direct):
                _fail(f"N={n}: wire scores differ from the in-process score_set")
            cpu = cpu_server.score_set(
                batch["child_feats"], batch["parent_feats"], batch["pair_feats"], mask
            ).numpy()
            err = float(np.abs(wire[mask] - cpu[mask]).max())
            if not np.allclose(wire[mask], cpu[mask], atol=MODEL_ATOL, rtol=MODEL_RTOL):
                _fail(f"N={n}: cuda vs cpu max_abs_err {err}")
            warm = latency_ms[n][1:]
            print(f"ModelInfer N={n} x {CANDIDATES}: p50 {statistics.median(warm):.3f} ms "
                  f"over {len(warm)} warm requests (first {latency_ms[n][0]:.3f} ms); "
                  f"valid slots {int(mask.sum())}; cuda vs cpu max_abs_err {err:.3g} "
                  f"(atol {MODEL_ATOL} rtol {MODEL_RTOL}); wire == score_set bit for bit")
            _breakdown(server, batch, n, statistics.median(warm))
    return launches


def _breakdown(server, batch, n, wire_p50_ms):
    """Where one request's time goes: the in-process score_set (host clock,
    synchronised) against the wire round trip, and the device's kernel time
    per request from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = (batch["child_feats"], batch["parent_feats"], batch["pair_feats"], batch["mask"])
    times = []
    for _ in range(8):
        start = time.perf_counter()
        server.score_set(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    direct_ms = statistics.median(times[2:])
    calls = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            server.score_set(*args)
        torch.cuda.synchronize()
    kernels = sorted(
        ((e.key, e.self_device_time_total / calls / 1e3) for e in prof.key_averages()
         if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda kv: -kv[1],
    )
    device_ms = sum(ms for _, ms in kernels)
    if device_ms == 0:
        print(f"breakdown N={n}: wire p50 {wire_p50_ms:.3f} ms, score_set p50 {direct_ms:.3f} ms; "
              "device time not measured (the profiler saw no device activity)")
        return
    flash_ms = sum(ms for name, ms in kernels if "flash_fwd" in name)
    top = "; ".join(f"{name[:60]} {ms:.4f}" for name, ms in kernels[:4])
    print(f"breakdown N={n}: wire p50 {wire_p50_ms:.3f} ms, score_set p50 {direct_ms:.3f} ms, "
          f"device kernels {device_ms:.4f} ms/request in {len(kernels)} kernels "
          f"(flash_fwd {flash_ms:.4f} ms), device busy {100 * device_ms / direct_ms:.1f}% "
          f"of score_set, {100 * device_ms / wire_p50_ms:.1f}% of the wire request; top: {top}")


def main() -> None:
    try:
        import torch
    except ImportError:
        _fail("torch is not installed")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import dragonfly2_tpu_torch  # noqa: F401
    except ImportError as e:
        _fail(f"the dragonfly2_tpu_torch package is not beside chip_smoke.py ({e})")

    phase_device()
    phase_build()
    kernels = phase_kernels()
    launches = phase_main_path()

    served = kernels["served"]
    line = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "dragonfly2_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "dragonfly2_tpu/ops/flash.py:71",
        "launches": launches,
        "max_abs_err": served["max_abs_err"],
        "ms": served["ms"],
        "plain_ms": served["plain_ms"],
        "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"],
        "library_ms": served["library_ms"],
        "shape": served["shape"],
        "other_shapes": {k: v for k, v in kernels.items() if k != "served"},
    }]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
