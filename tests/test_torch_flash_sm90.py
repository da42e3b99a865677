"""The choice between the flash kernels' instances (ops/flash.py's
``_sm90_path``) and the launches each wrapper makes through the launcher's
one call site, every C entry's declaration in csrc/flash_entries.h
against its definition and the launcher's call of it, and the build: the
launcher's command and the content hashes over the headers a source
includes. Jax-free and CPU-only:
the kernels themselves are held to their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import math
import pathlib
import re
import sysconfig

import pytest
import torch

from dragonfly2_tpu_torch.ops import build, flash

SM90_ENTRIES = {
    "dfly_flash_fwd": "dfly_flash_fwd_sm90",
    "dfly_flash_fwd_lse": "dfly_flash_fwd_lse_sm90",
    "dfly_flash_fwd_partial": "dfly_flash_fwd_partial_sm90",
    "dfly_flash_bwd_dkv": "dfly_flash_bwd_dkv_sm90",
    "dfly_flash_bwd_dq": "dfly_flash_bwd_dq_sm90",
}


@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((1024, 4, 15, 32), torch.bfloat16),  # served
        ((256, 4, 20, 32), torch.bfloat16),  # trained
        ((2000, 4, 10, 32), torch.bfloat16),  # the ring's eval shard at dp = sp = 2
        ((500, 4, 10, 32), torch.bfloat16),
        ((4, 2, 15, 16), torch.bfloat16),
        ((2, 4, 4096, 32), torch.float32),  # TMA does not round float32 to bf16
        ((4, 8, 2048, 128), torch.float32),
        ((3, 2, flash.SM90_MIN_L, 64), torch.bfloat16),
    ],
)
def test_short_sets_and_float32_keep_the_mma_sync_instances(shape, dtype):
    _, _, l, d = shape
    assert not flash._sm90_path(l, d, dtype)


@pytest.mark.parametrize(
    "shape",
    [(2, 4, 4096, 32), (2, 4, 4000, 64), (4, 8, 2048, 128), (2, 1, 16384, 32), (2, 2, 1000, 16),
     (1, 1, flash.SM90_MIN_L + 1, 128)],
)
def test_long_bf16_takes_the_hopper_instances(shape):
    _, _, l, d = shape
    assert flash._sm90_path(l, d, torch.bfloat16)


def test_a_head_dim_no_kernel_takes_is_never_the_hopper_path():
    """Head dims the kernels never see (padded first: 8, 48, 130) and wide
    ones past the wide Hopper instances' 256 (320) take no Hopper instance."""
    assert not any(flash._sm90_path(l, d, torch.bfloat16)
                   for l in (10, 4097) for d in (8, 48, 130, 320))


# ------------------------------------------------- routing, without a card


class _Recorder:
    """Stands in for ``flash._launch``: records (C entry, q, the other
    arguments) and returns outputs of the launcher's shapes on q's device."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, q, *args):
        self.calls.append((name, q, args))
        rows = q[..., 0].float()  # [B, H, L] float32
        return {
            "fwd": lambda: torch.empty_like(q),
            "lse": lambda: (torch.empty_like(q), rows),
            "partial": lambda: (q.float(), rows, rows.clone()),
            "dkv": lambda: (torch.empty_like(q), torch.empty_like(q)),
            "dq": lambda: torch.empty_like(q),
        }[flash.ENTRIES[name][0]]()


@pytest.fixture
def routed(monkeypatch):
    """The wrappers' kernel branch on meta tensors: launches recorded, not
    made, and the device checks that only a card passes switched off."""
    recorder = _Recorder()
    monkeypatch.setattr(flash, "_launch", recorder)
    monkeypatch.setattr(flash, "_check", lambda *a: None)
    monkeypatch.setattr(flash, "_need_cuda", lambda q: None)
    for name in ("LAUNCHES", "LSE_LAUNCHES", "PARTIAL_LAUNCHES", "DKV_LAUNCHES", "DQ_LAUNCHES",
                 "FWD_SM90_LAUNCHES", "LSE_SM90_LAUNCHES", "PARTIAL_SM90_LAUNCHES",
                 "DKV_SM90_LAUNCHES", "DQ_SM90_LAUNCHES"):
        monkeypatch.setattr(flash, name, 0)
    return recorder


def _meta(shape, dtype):
    b, _, l, _ = shape
    q = torch.empty(shape, dtype=dtype, device="meta")
    return q, torch.empty(b, l, dtype=torch.bool, device="meta")


_CALLS = {
    "dfly_flash_fwd": lambda q, m: flash._flash_forward(q, q, q, m, True),
    "dfly_flash_fwd_lse": lambda q, m: flash.flash_attention_lse(q, q, q, m, True),
    "dfly_flash_fwd_partial": lambda q, m: flash.flash_attention_partials(q, q, q, m),
    "dfly_flash_bwd_dkv": lambda q, m: flash.flash_attention_bwd_dkv(
        q, q, q, m, q[..., 0].float(), q[..., 0].float(), q, True),
    "dfly_flash_bwd_dq": lambda q, m: flash.flash_attention_bwd_dq(
        q, q, q, m, q[..., 0].float(), q[..., 0].float(), q, True),
}
_COUNTERS = {
    "dfly_flash_fwd": ("LAUNCHES", "FWD_SM90_LAUNCHES"),
    "dfly_flash_fwd_lse": ("LSE_LAUNCHES", "LSE_SM90_LAUNCHES"),
    "dfly_flash_fwd_partial": ("PARTIAL_LAUNCHES", "PARTIAL_SM90_LAUNCHES"),
    "dfly_flash_bwd_dkv": ("DKV_LAUNCHES", "DKV_SM90_LAUNCHES"),
    "dfly_flash_bwd_dq": ("DQ_LAUNCHES", "DQ_SM90_LAUNCHES"),
}


@pytest.mark.parametrize("entry", sorted(_CALLS))
@pytest.mark.parametrize(
    "shape,dtype,hopper",
    [((256, 4, 20, 32), torch.bfloat16, False), ((2, 4, 4096, 32), torch.bfloat16, True),
     ((2, 4, 4096, 32), torch.float32, False)],
)
def test_each_wrapper_launches_the_instance_its_shape_selects(routed, entry, shape, dtype, hopper):
    q, mask = _meta(shape, dtype)
    _CALLS[entry](q, mask)
    (name, q_seen, args), = routed.calls
    b, h, l, d = shape
    total, sm90 = _COUNTERS[entry]
    assert getattr(flash, total) == 1 and getattr(flash, sm90) == int(hopper)
    assert name == (SM90_ENTRIES[entry] if hopper else entry)
    assert flash.ENTRIES[name] == (_KIND[entry], flash.SM90 if hopper else flash.MMA_SYNC)
    _check_launch_arguments(entry, q_seen, args, shape, (b, h, l, d), dtype, mask)


# the launcher's kind of launch for each wrapper's entry
_KIND = {"dfly_flash_fwd": "fwd", "dfly_flash_fwd_lse": "lse",
         "dfly_flash_fwd_partial": "partial", "dfly_flash_bwd_dkv": "dkv",
         "dfly_flash_bwd_dq": "dq"}


def _check_launch_arguments(entry, q, args, shape, kernel_shape, dtype, mask):
    """The arguments of one launch: q at the kernel's head dim and dtype,
    k, v (and the backward's dO, lse, delta) of q's shape, the key mask,
    causal (True in _CALLS) where the kind has it, the unpadded D's softmax
    scale and warps_for(L), which only the mma.sync instances use."""
    l, d = shape[2], shape[3]
    assert tuple(q.shape) == kernel_shape and q.dtype == dtype
    *operands, scale, warps = args
    assert scale == 1 / math.sqrt(d) and warps == flash.warps_for(l)
    if entry == "dfly_flash_fwd_partial":
        k, v, kv_mask = operands
    elif entry in ("dfly_flash_fwd", "dfly_flash_fwd_lse"):
        k, v, kv_mask, causal = operands
        assert causal is True
    else:
        k, v, do, lse, delta, kv_mask, causal = operands
        assert causal is True and tuple(do.shape) == kernel_shape
        assert tuple(lse.shape) == tuple(delta.shape) == kernel_shape[:3]
    assert tuple(k.shape) == tuple(v.shape) == kernel_shape and kv_mask is mask


WIDE_ENTRIES = {name: f"{name}_wide" for name in _CALLS}
WIDE_COUNTERS = {
    "dfly_flash_fwd": "FWD_WIDE_LAUNCHES",
    "dfly_flash_fwd_lse": "LSE_WIDE_LAUNCHES",
    "dfly_flash_fwd_partial": "PARTIAL_WIDE_LAUNCHES",
    "dfly_flash_bwd_dkv": "DKV_WIDE_LAUNCHES",
    "dfly_flash_bwd_dq": "DQ_WIDE_LAUNCHES",
}


def test_the_wide_thresholds_follow_the_cards_readings():
    """The wide thresholds as the card's readings set them (PERF.md): the
    ranker's sets (L = 20) keep the wide mma.sync forward, dK/dV and dQ; at
    L = 32 all three keep them (the one-pass dK/dV leads the Hopper one
    there at D = 192 and 256); at L = 48, where the Hopper dK/dV starts to
    lead, and from L = 64 all three take their Hopper instances; float32
    and D above 256 never."""
    bf16 = torch.bfloat16
    assert not flash._sm90_path(20, 192, bf16) and not flash._sm90_path(20, 192, bf16, "dkv")
    assert not flash._sm90_path(32, 256, bf16) and not flash._sm90_path(32, 256, bf16, "dkv")
    assert not flash._sm90_path(32, 192, bf16, "dkv")
    assert flash._sm90_path(48, 192, bf16, "dkv") and flash._sm90_path(48, 256, bf16, "dkv")
    assert flash._sm90_path(64, 192, bf16) and flash._sm90_path(1024, 256, bf16, "dkv")
    assert not flash._sm90_path(4096, 192, torch.float32, "dkv")
    assert not flash._sm90_path(4096, 320, bf16) and not flash._sm90_path(4096, 320, bf16, "dkv")
    assert not flash._sm90_path(20, 192, bf16, "dq") and not flash._sm90_path(20, 256, bf16, "dq")
    assert flash._sm90_path(64, 192, bf16, "dq") and flash._sm90_path(4096, 256, bf16, "dq")
    assert not flash._sm90_path(4096, 192, torch.float32, "dq")
    assert not flash._sm90_path(4096, 320, bf16, "dq")
    assert flash.WIDE_DQ_SM90_MIN_L < 4096


def test_the_sets_limit_mirrors_both_sources():
    """ops/flash.py's SETS_MAX_L, which names the packed-sets kernels for
    the profiler, is the limit both C sides route by: the forward's
    (csrc/flash_fwd.cu) and dK/dV's and dQ's (csrc/flash_bwd.cu), read
    from their text: the backward's C side takes its packed-sets branch for
    both kernels, and that branch launches both packed-sets kernels."""
    for source in ("flash_fwd.cu", "flash_bwd.cu"):
        text = (build.CSRC_DIR / source).read_text()
        assert re.findall(r"\bconstexpr int SETS_MAX_L = (\d+);", text) == [
            str(flash.SETS_MAX_L)], source
        assert "L <= SETS_MAX_L" in text, source
    text = (build.CSRC_DIR / "flash_bwd.cu").read_text()
    by_dim = re.search(r"cudaError_t by_dim\(.*?\n\}\n", text, re.S).group(0)
    branch = re.search(r"if \((.*?L <= SETS_MAX_L)\) \{(.*?)\n  \}", by_dim, re.S)
    assert branch.group(1) == "a.L <= SETS_MAX_L"  # dK/dV (DKV) and dQ alike
    for d in flash.HEAD_DIMS:
        assert f"case {d}: return launch_sets<T, {d}, DKV>(a, stream);" in branch.group(2)
    launch = re.search(r"cudaError_t launch_sets\(const Args& a, cudaStream_t stream\) \{.*?\n\}\n",
                       text, re.S).group(0)
    assert re.search(r"if constexpr \(DKV\) \{\s*flash_bwd_dkv_sets_kernel<T, D><<<.*?\} else \{"
                     r"\s*flash_bwd_dq_sets_kernel<T, D><<<", launch, re.S)


WIDE_SM90_COUNTERS = {
    "dfly_flash_fwd": "FWD_WIDE_SM90_LAUNCHES",
    "dfly_flash_fwd_lse": "LSE_WIDE_SM90_LAUNCHES",
    "dfly_flash_fwd_partial": "PARTIAL_WIDE_SM90_LAUNCHES",
    "dfly_flash_bwd_dkv": "DKV_WIDE_SM90_LAUNCHES",
    "dfly_flash_bwd_dq": "DQ_WIDE_SM90_LAUNCHES",
}
_WIDE_MIN_L = {"dfly_flash_bwd_dkv": "WIDE_DKV_SM90_MIN_L", "dfly_flash_bwd_dq": "WIDE_DQ_SM90_MIN_L"}


@pytest.mark.parametrize("entry", sorted(_CALLS))
@pytest.mark.parametrize("shape,dtype", [((2, 4, 40, 256), torch.bfloat16),
                                         ((2, 4, 4096, 256), torch.bfloat16),
                                         ((2, 4, 4096, 192), torch.bfloat16),
                                         ((2, 4, 4096, 192), torch.float32),
                                         ((2, 4, 70, 256), torch.float32),
                                         ((256, 4, 20, 192), torch.bfloat16),
                                         ((2, 4, 1024, 192), torch.bfloat16),
                                         ((2, 4, 4096, 320), torch.bfloat16),
                                         ((2, 4, 40, 512), torch.float32),
                                         ((2, 4, 1000, 130), torch.bfloat16)])
def test_head_dim_256_launches_the_wide_instance_at_every_length(monkeypatch, routed, entry,
                                                                 shape, dtype):
    """A D above 128 (256, and 192, 320, 512 alike) takes a wide instance
    at every L and dtype, unpadded (130 padded to 136 only), and the
    forward one launch above 256 too: the wide
    Hopper one for the forward above WIDE_SM90_MIN_L, for dK/dV above
    WIDE_DKV_SM90_MIN_L and for dQ above WIDE_DQ_SM90_MIN_L, in bf16 at D
    up to 256, else the wide mma.sync
    one, counted in its total and its own part, with the launch's
    arguments at the head dim the kernel takes."""
    for name in (*WIDE_COUNTERS.values(), *WIDE_SM90_COUNTERS.values()):
        monkeypatch.setattr(flash, name, 0)
    q, mask = _meta(shape, dtype)
    _CALLS[entry](q, mask)
    (name, q_seen, args), = routed.calls
    b, h, l, d = shape
    d_kernel = d + (-d) % 8  # D = 130 is zero-padded to 136, the others go as they are
    min_l = getattr(flash, _WIDE_MIN_L.get(entry, "WIDE_SM90_MIN_L"))
    hopper = entry in WIDE_SM90_COUNTERS and dtype == torch.bfloat16 and d <= 256 and l > min_l
    assert name == WIDE_ENTRIES[entry] + ("_sm90" if hopper else "")
    total, sm90 = _COUNTERS[entry]
    assert getattr(flash, total) == 1 and getattr(flash, sm90) == 0
    assert getattr(flash, WIDE_COUNTERS[entry]) == int(not hopper)
    assert getattr(flash, WIDE_SM90_COUNTERS[entry]) == int(hopper)
    assert flash.ENTRIES[name] == (_KIND[entry], flash.WIDE_SM90 if hopper else flash.WIDE)
    _check_launch_arguments(entry, q_seen, args, shape, (b, h, l, d_kernel), dtype, mask)


def test_head_dims_pad_to_the_next_instance_up_to_256():
    """The head dim a kernel takes for each D, from D alone: the instances'
    own, any D above 128 with D % 8 == 0 as it is (192, 320, 512: no pad
    copy), the next instance below 128, and the next multiple of 8 above
    it (130 -> 136). The scale is always the unpadded D's."""
    assert flash.HEAD_DIMS == (16, 32, 64, 128)
    for d in (16, 32, 64, 128, 136, 192, 200, 256, 320, 512):
        assert flash._kernel_dim(d) == d
        assert not flash._padded_route(torch.zeros(1, 1, 4, d, device="meta"))
    for d, d_pad in ((8, 16), (24, 32), (96, 128), (129, 136), (130, 136), (250, 256),
                     (321, 328)):
        assert flash._kernel_dim(d) == d_pad
        assert flash._padded_route(torch.zeros(1, 1, 4, d, device="meta"))
        q = torch.ones(1, 1, 4, d)
        assert not flash._padded_route(q)  # the CPU takes the plain versions at any D
        qp, kp, vp = flash._padded(q, q, q)
        assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == d_pad
        assert torch.equal(qp[..., :d], q) and not qp[..., d:].any()
        assert flash._scale(q) == 1 / math.sqrt(d)  # the kernels score at the unpadded D
    assert flash._is_wide(136) and flash._is_wide(320) and not flash._is_wide(128)


def test_cpu_tensors_take_the_plain_versions_at_long_l(monkeypatch):
    """The Hopper path is a CUDA path: a CPU tensor at a long bf16 shape
    still takes the plain version and launches nothing."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel launch")

    monkeypatch.setattr(flash, "_launch", refuse)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, flash.SM90_MIN_L + 3, 16, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    assert flash._sm90_path(q.shape[2], 16, q.dtype)
    out = flash.flash_attention(q, k, v)
    torch.testing.assert_close(out, flash.flash_attention_plain(q, k, v), rtol=0, atol=0)
    o, lse = flash.flash_attention_lse(q, k, v, None, True)
    assert o.shape == q.shape and torch.isfinite(lse).all()
    acc, row_max, row_sum = flash.flash_attention_partials(q, k, v)
    assert acc.dtype == torch.float32 and (row_sum > 0).all()


# ------------- the C entries: declarations, definitions, the launcher's calls

_DEFINED = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{', re.S)
_DECLARED = re.compile(r'^int\s+(\w+)\s*\(([^)]*)\);', re.S | re.M)
_INSTANCE_ENUM = re.compile(r"enum Instance[^{]*\{([^}]*)\}")


def _kinds(params: str) -> list[str]:
    """'p', 'i' or 'f' for each parameter: pointer, int or float."""
    kinds = []
    for param in params.split(","):
        param = " ".join(param.split())
        assert "*" in param or param.startswith(("int ", "float ")), param
        kinds.append("p" if "*" in param else param[0])
    return kinds


def _c_definitions():
    """{entry: (source stem, kinds)} of every ``extern "C" int`` function
    defined in csrc/*.cu."""
    found = {}
    for path in sorted(build.CSRC_DIR.glob("*.cu")):
        for name, params in _DEFINED.findall(path.read_text()):
            assert name not in found, f"{name} defined twice"
            found[name] = (path.stem, _kinds(params))
    return found


def _c_declarations():
    text = (build.CSRC_DIR / "flash_entries.h").read_text()
    found = {}
    for name, params in _DECLARED.findall(text):
        assert name not in found, f"{name} declared twice"
        found[name] = _kinds(params)
    return found


def _launcher_calls(name: str):
    """(the arguments, the instance case it sits under) of the launcher's
    one call of entry ``name``."""
    text = (build.CSRC_DIR / "flash_launch.cpp").read_text()
    starts = [m.end() for m in re.finditer(rf"\b{name}\(", text)]
    assert len(starts) == 1, f"the launcher calls {name} {len(starts)} times"
    depth, args, current = 1, [], ""
    for char in text[starts[0]:]:
        depth += (char == "(") - (char == ")")
        if depth == 0:
            break
        if char == "," and depth == 1:
            args.append(current)
            current = ""
        else:
            current += char
    args.append(current)
    case = re.findall(r"case (\w+):", text[:starts[0]])[-1]
    return [" ".join(a.split()) for a in args], case


def test_every_c_entry_is_declared_and_launched():
    """Every entry the .cu sources define is declared once in
    flash_entries.h and routed by ops/flash.py, and the launcher numbers
    its instances as ops/flash.py does."""
    assert set(_c_definitions()) == set(_c_declarations()) == set(flash.ENTRIES)
    assert len(flash.ENTRIES) == 20
    enum = _INSTANCE_ENUM.search((build.CSRC_DIR / "flash_launch.cpp").read_text()).group(1)
    numbers = dict(item.replace(" ", "").split("=") for item in enum.split(","))
    assert {name: int(value) for name, value in numbers.items()} == {
        "MMA_SYNC": flash.MMA_SYNC, "WIDE": flash.WIDE, "SM90": flash.SM90,
        "WIDE_SM90": flash.WIDE_SM90}


@pytest.mark.parametrize("name", sorted(flash.ENTRIES))
def test_declaration_matches_the_definition_and_the_launcher_calls_it(name):
    """Count and order of pointer, int and float parameters, declared and
    defined alike, and the launcher's call of the entry under the case of
    the instance ops/flash.py routes to it, with as many arguments as it
    takes and the stream last."""
    stem, kinds = _c_definitions()[name]
    assert _c_declarations()[name] == kinds
    kind, instance = flash.ENTRIES[name]
    forward, hopper = kind in ("fwd", "lse", "partial"), instance in (flash.SM90, flash.WIDE_SM90)
    assert stem == ("flash_fwd" if forward else "flash_bwd") + (
        "" if not hopper else "_sm90" if forward else f"_{kind}_sm90")
    args, case = _launcher_calls(name)
    assert len(args) == len(kinds) and args[-1] == "a.stream"
    assert case == {flash.MMA_SYNC: "MMA_SYNC", flash.WIDE: "WIDE", flash.SM90: "SM90",
                    flash.WIDE_SM90: "WIDE_SM90"}[instance]


# ------------------------------------------------------ the build's hash


def _write(path: pathlib.Path, text: str) -> None:
    path.write_text(text)


def test_library_path_follows_every_included_header(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    _write(tmp_path / "k.cu", '#include <cuda.h>\n#include "a.cuh"\nint k;\n')
    _write(tmp_path / "a.cuh", '#pragma once\n#include "b.cuh"\n')
    _write(tmp_path / "b.cuh", "// b\n")
    _write(tmp_path / "other.cuh", "// not included\n")
    first = build._library_path("k", "/nvcc")
    assert [p.name for p in build._source_files("k")] == ["k.cu", "a.cuh", "b.cuh"]
    assert build._library_path("k", "/nvcc") == first

    _write(tmp_path / "other.cuh", "// edited, still not included\n")
    assert build._library_path("k", "/nvcc") == first
    _write(tmp_path / "b.cuh", "// b, edited\n")  # included through a.cuh
    second = build._library_path("k", "/nvcc")
    assert second != first
    _write(tmp_path / "a.cuh", '#pragma once\n#include "b.cuh"\n// edited\n')
    third = build._library_path("k", "/nvcc")
    assert third not in (first, second)
    assert build._library_path("k", "/other/nvcc") != third


def test_the_hopper_sources_hash_their_shared_header():
    """Each source hashes the entries' header it includes, the Hopper ones
    sm90.cuh too, and the launcher its .cpp and the header."""
    for name in ("flash_fwd_sm90", "flash_bwd_dkv_sm90", "flash_bwd_dq_sm90"):
        assert [p.name for p in build._source_files(name)] == [
            f"{name}.cu", "flash_entries.h", "sm90.cuh"]
    for name in ("flash_fwd", "flash_bwd"):
        assert [p.name for p in build._source_files(name)] == [f"{name}.cu", "flash_entries.h"]
    assert [p.name for p in build._source_files(build.LAUNCHER)] == [
        "flash_launch.cpp", "flash_entries.h"]


# --------------------------------------------------------- the launcher's build


def test_the_launcher_command_has_the_abi_and_torchs_include_and_library_dirs(monkeypatch):
    """The launcher compiles with PyTorch's C++ ABI and include dirs (the
    CUDA runtime's among them) and Python's, links to the kernel libraries
    by name beside it and to PyTorch's library dirs, and includes
    PyTorch's per-operator headers, never torch/extension.h or
    ATen/ATen.h."""
    from torch.utils import cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", "/toolkits/cuda-12")
    libraries = [build.BUILD_DIR / "libflash_fwd-0123456789abcdef.so",
                 build.BUILD_DIR / "libflash_bwd-fedcba9876543210.so"]
    compile_flags, link_flags = build.launcher_flags(libraries)
    assert f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}" in compile_flags
    includes = [*cpp_extension.include_paths(device_type="cuda"), sysconfig.get_paths()["include"]]
    assert "/toolkits/cuda-12/include" in includes
    assert [f for f in compile_flags if f.startswith("-I")] == [f"-I{d}" for d in includes]
    assert {"-l:libflash_fwd-0123456789abcdef.so", "-l:libflash_bwd-fedcba9876543210.so",
            f"-L{build.BUILD_DIR}", "-Wl,-rpath,$ORIGIN", "-shared"} <= set(link_flags)
    library_dirs = [f"-L{d}" for d in cpp_extension.library_paths(device_type="cuda")]
    assert library_dirs and set(library_dirs) <= set(link_flags)
    assert set(build.LAUNCHER_LIBS) <= set(link_flags)
    included = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]',
                          (build.CSRC_DIR / "flash_launch.cpp").read_text(), re.M)
    assert "ATen/ops/empty.h" in included and "flash_entries.h" in included
    assert not {"torch/extension.h", "ATen/ATen.h"} & set(included)


def test_the_launcher_hash_moves_with_its_source_a_header_and_torch(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    _write(tmp_path / "flash_launch.cpp", '#include <Python.h>\n#include "e.h"\n')
    _write(tmp_path / "e.h", "// entries\n")
    flags = (["-O2"], ["-l:libflash_fwd-0.so"])
    first = build._launcher_path("/g++", flags)
    assert first.name.startswith("libflash_launch-") and build._launcher_path("/g++", flags) == first
    _write(tmp_path / "flash_launch.cpp", '#include <Python.h>\n#include "e.h"\n// edited\n')
    second = build._launcher_path("/g++", flags)
    _write(tmp_path / "e.h", "// entries, edited\n")
    third = build._launcher_path("/g++", flags)
    monkeypatch.setattr(torch, "__version__", torch.__version__ + ".other")
    fourth = build._launcher_path("/g++", flags)
    assert len({first, second, third, fourth}) == 4
    # a kernel library's new hash is a new link, and another compiler a new build
    assert build._launcher_path("/g++", (["-O2"], ["-l:libflash_fwd-1.so"])) != fourth
    assert build._launcher_path("/other/g++", flags) != fourth
