"""The kernel build compiles a source of many kernels in parts, all at
once, and links the parts into the source's one library (ops/build.py,
DFLY_IN_PART in csrc/flash_entries.h). Here on the CPU: every entry of
each source lies in exactly one part, and build_all, driven by a stand-in
nvcc that records its commands, compiles each part with its macro, links
every part, keeps no object behind and builds nothing from a failed part."""

import json
import pathlib
import re
import sys

import pytest

from dragonfly2_tpu_torch.ops import build

ENTRY = re.compile(r'^extern "C" (?:int|const char\*) (\w+)\(', re.MULTILINE)
GUARD = re.compile(r"^#if DFLY_IN_PART\((\d+)\)\n" + ENTRY.pattern[1:], re.MULTILINE)


def _declared() -> set[str]:
    header = (build.CSRC_DIR / "flash_entries.h").read_text()
    return set(re.findall(r"^(?:int|const char\*) (dfly_\w+)\(", header, re.MULTILINE))


@pytest.mark.parametrize("name, parts", [("flash_fwd", 6), ("flash_bwd", 4),
                                         ("flash_fwd_sm90", 2), ("flash_bwd_dkv_sm90", 1),
                                         ("flash_bwd_dq_sm90", 1)])
def test_each_entry_lies_in_one_part(name, parts):
    text = (build.CSRC_DIR / f"{name}.cu").read_text()
    assert build.source_parts(name) == parts
    entries = ENTRY.findall(text)
    assert len(entries) == len(set(entries))
    if parts == 1:
        assert "DFLY_IN_PART" not in text
        return
    guarded = {entry: int(part) for part, entry in GUARD.findall(text)}
    assert set(guarded) == set(entries)  # every entry is under its part's guard
    assert set(guarded.values()) == set(range(parts))  # and no part is empty
    assert guarded["dfly_cuda_error_string"] == 0


def test_every_declared_entry_is_built():
    built = [e for name in build.kernel_sources()
             for e in ENTRY.findall((build.CSRC_DIR / f"{name}.cu").read_text())]
    assert set(built) - {"dfly_cuda_error_string"} == _declared() - {"dfly_cuda_error_string"}


def _fake_nvcc(tmp_path: pathlib.Path, fail_part: int | None) -> pathlib.Path:
    script = tmp_path / "nvcc"
    script.write_text(f"""#!{sys.executable}
import json, sys
args = sys.argv[1:]
with open({str(tmp_path / "calls.jsonl")!r}, "a") as log:
    log.write(json.dumps(args) + "\\n")
if "-DDFLY_PART={fail_part}" in args:
    print("error: part {fail_part} refused")
    sys.exit(1)
with open(args[args.index("-o") + 1], "w") as out:
    out.write(" ".join(args))
if args[-1].endswith(".cu"):  # a compile reports its kernels, a link nothing
    print("ptxas info    : Compiling entry function 'k'\\nptxas info    : Used 10 registers")
""")
    script.chmod(0o755)
    return script


def _sandbox(tmp_path, monkeypatch, fail_part=None):
    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    (csrc / "parted.cu").write_text(
        "#if DFLY_IN_PART(0)\nint a;\n#endif\n#if DFLY_IN_PART(1)\nint b;\n#endif\n"
        "#if DFLY_IN_PART(2)\nint c;\n#endif\n")
    (csrc / "whole.cu").write_text("int w;\n")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    nvcc = _fake_nvcc(tmp_path, fail_part)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    return out, nvcc


def _calls(tmp_path) -> list[list[str]]:
    return [json.loads(line) for line in (tmp_path / "calls.jsonl").read_text().splitlines()]


def test_build_all_compiles_the_parts_and_links_them(tmp_path, monkeypatch):
    out, nvcc = _sandbox(tmp_path, monkeypatch)
    reports = build.build_all(["parted", "whole"])
    calls = _calls(tmp_path)
    parts = sorted((c for c in calls if "-c" in c), key=lambda c: c[c.index("-c") - 1])
    assert [c[c.index("-c") - 1] for c in parts] == [f"-DDFLY_PART={i}" for i in range(3)]
    assert all(list(build.NVCC_FLAGS) == c[:len(build.NVCC_FLAGS)] for c in calls)
    (link,) = [c for c in calls if "-shared" in c and c[-1].endswith(".o")]
    assert link[link.index("-o") + 2:] == [c[c.index("-o") + 1] for c in parts]
    (whole,) = [c for c in calls if c[-1].endswith("whole.cu")]
    assert "-shared" in whole and "-c" not in whole
    assert sorted(p.name for p in out.iterdir()) == sorted(
        [build._library_path("parted", str(nvcc)).name, build._library_path("whole", str(nvcc)).name])
    assert set(reports) == {"parted", "whole", *(build.part_name("parted", i) for i in range(3))}
    assert reports["parted"][0].count("Used 10 registers") == 3  # every part's report
    assert reports["parted"][1] >= max(reports[build.part_name("parted", i)][1] for i in range(3))
    # built once: a second call compiles nothing
    assert build.build_all(["parted", "whole"]) == {"parted": ("", 0.0), "whole": ("", 0.0)}
    assert len(_calls(tmp_path)) == len(calls)


def test_a_failed_part_builds_no_library(tmp_path, monkeypatch):
    out, nvcc = _sandbox(tmp_path, monkeypatch, fail_part=1)
    with pytest.raises(RuntimeError, match=r"parted#1: .* exited 1\n.*part 1 refused"):
        build.build_all(["parted", "whole"])
    assert not any("-o" in c and c[-1].endswith(".o") for c in _calls(tmp_path) if "-shared" in c)
    # the whole source still built; nothing of the parted one is left behind
    assert [p.name for p in out.iterdir()] == [build._library_path("whole", str(nvcc)).name]
