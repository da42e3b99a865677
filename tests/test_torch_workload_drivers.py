"""The reference's workload drivers, tools/llm_prefetch.py and tools/stress.py,
against the port's, tools/torch_llm_prefetch.py and tools/torch_stress.py
(--device cpu), on this box at small sizes: the same JSON keys (bar the
port's device), the same offload and exit codes, every shard's sha256 on
every host."""

import asyncio
import hashlib
import json
import pathlib

import pytest

SHARDS, SHARD_BYTES, HOSTS, PIECE = 3, 256 * 1024, 3, 64 * 1024
STRESS_ARGS = ["--connections", "4", "--duration", "2", "--size", str(256 * 1024)]


def _shard_shas() -> set[str]:
    from tools.torch_llm_prefetch import ShardRepo

    repo = ShardRepo(SHARDS, SHARD_BYTES)
    try:
        return {repo.sha(i) for i in range(SHARDS)}
    finally:
        repo.close()


def _host_shas(workdir: pathlib.Path) -> dict[str, set[str]]:
    """Each host's (the seed's and the fleet's) task data files, by sha256."""
    return {host.name: {hashlib.sha256(data.read_bytes()).hexdigest()
                        for data in host.glob("*/data")}
            for host in sorted(workdir.iterdir()) if host.is_dir()}


@pytest.fixture(scope="module")
def prefetch_runs(tmp_path_factory):
    from tools import llm_prefetch, torch_llm_prefetch

    ref_dir, port_dir = tmp_path_factory.mktemp("ref"), tmp_path_factory.mktemp("port")
    ref = asyncio.run(llm_prefetch.run(SHARDS, SHARD_BYTES, HOSTS, PIECE, str(ref_dir)))
    port, clock = asyncio.run(torch_llm_prefetch.run(SHARDS, SHARD_BYTES, HOSTS, PIECE,
                                                     str(port_dir), device="cpu"))
    return {"ref": (ref, ref_dir), "port": (port, port_dir), "clock": clock}


def test_prefetch_keys_and_algorithm_match(prefetch_runs):
    ref, port = prefetch_runs["ref"][0], prefetch_runs["port"][0]
    assert set(port) == set(ref) | {"device"}
    assert port["device"] == "cpu"
    assert port["algorithm"] == ref["algorithm"]
    for key in ("shards", "shard_mib", "hosts", "bytes_total", "metric", "unit"):
        assert port[key] == ref[key], key


@pytest.mark.parametrize("side", ["ref", "port"])
def test_prefetch_fleet_rides_p2p(prefetch_runs, side):
    result, workdir = prefetch_runs[side]
    assert result["fleet_offload_pct"] == 100.0, result
    assert result["origin_bytes"] <= SHARDS * SHARD_BYTES + 4096, result
    assert result["aggregate_mib_s"] > 0
    want = _shard_shas()
    hosts = _host_shas(workdir)
    assert sorted(hosts) == sorted(["seed", *(f"h{n}" for n in range(HOSTS))])
    for host, shas in hosts.items():
        assert shas == want, host


def test_prefetch_scheduler_ticked_on_its_device(prefetch_runs):
    clock = prefetch_runs["clock"]
    assert clock.ms and str(clock.svc.device) == "cpu"
    assert clock.line().startswith(f"scheduler: {len(clock.ms)} ticks on cpu, tick p50 ")


def _stress(main, argv, capsys) -> tuple[int, dict]:
    rc = main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(lines[-1])


def test_stress_matches_the_reference(capsys):
    from tools import stress, torch_stress

    ref_rc, ref = _stress(stress.main, STRESS_ARGS, capsys)
    port_rc = torch_stress.main([*STRESS_ARGS, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    port = json.loads(lines[-1])
    assert set(port) == set(ref) | {"device"}
    assert port["device"] == "cpu"
    for result in (ref, port):
        assert result["errors"] == 0 and result["requests"] > 0, result
        assert result["connections"] == 4 and result["duration_s"] == 2.0
    assert ref_rc == port_rc == 0
    # the scheduler's ticks and p50 on the line before the JSON
    assert lines[-2].startswith("scheduler: ") and " ticks on cpu, tick p50 " in lines[-2]


@pytest.mark.parametrize("module", ["stress", "torch_stress"])
def test_stress_proxy_needs_a_url(module, capsys):
    import importlib

    main = importlib.import_module(f"tools.{module}").main
    with pytest.raises(SystemExit) as exit_:
        main(["--proxy", "127.0.0.1:1"])
    assert exit_.value.code == 2
    assert "--url is required with --proxy" in capsys.readouterr().err


@pytest.mark.parametrize("module", ["stress", "torch_stress"])
def test_stress_counts_errors_against_a_dead_proxy(module, capsys):
    """No proxy listens: every request errors and both exit 1."""
    import importlib
    import socket

    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    main = importlib.import_module(f"tools.{module}").main
    rc, result = _stress(main, ["--proxy", f"127.0.0.1:{port}", "--url", "http://127.0.0.1:1/x",
                                "--connections", "2", "--duration", "0.5"], capsys)
    assert rc == 1 and result["requests"] == 0 and result["errors"] > 0


def test_port_drivers_default_to_the_card():
    """Without CUDA the port's scheduler raises at the drivers' default
    device; nothing falls back to the CPU."""
    import torch

    from tools import torch_llm_prefetch, torch_stress

    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(torch_stress.run_inproc(1, 0.1, 1024))
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(torch_llm_prefetch.run(1, 1024, 1, 1024, "/nonexistent"))
