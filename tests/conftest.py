"""Test harness: force an 8-device virtual CPU mesh before jax loads.

Mirrors the reference's approach of unit-testing "multi-node" logic without
a cluster (SURVEY.md §4): sharding/collective code paths run on
xla_force_host_platform_device_count=8 CPU devices; numeric kernels run on
the CPU backend with fixed seeds. No TPU needed in CI.
"""

import os

# Env vars alone are not enough: in this image jax is pre-imported at
# interpreter startup (a .pth hook) with JAX_PLATFORMS already resolved, so
# the config must be updated through jax.config before first backend use.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

try:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
except RuntimeError:
    # Backend already initialized (a plugin touched jax before conftest) —
    # the env vars above were then read at init and did the same job.
    pass
except AttributeError:
    # Older jax without the jax_num_cpu_devices option: the XLA_FLAGS
    # host-platform device-count flag above is the only mechanism.
    pass

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running end-to-end tests")
    # the packed-transport jits donate their one-shot staging buffer;
    # backends without donation support (CPU CI) warn once per compiled
    # shape — expected no-op, not a finding (ops/evaluator.py)
    config.addinivalue_line(
        "filterwarnings", "ignore:Some donated buffers were not usable"
    )
    # chaos tests are tier-1 on purpose (NOT slow): failure-domain
    # resilience must not rot behind an opt-in marker
    config.addinivalue_line(
        "markers", "chaos: fault-injection resilience tests (tier-1)"
    )
    # like chaos: trust-boundary integrity tests (corrupt parents, digest
    # chains, guarded activation) stay tier-1, never opt-in
    config.addinivalue_line(
        "markers", "corruption: trust-boundary integrity tests (tier-1)"
    )
    # megascale scenario lab: the tier-1 soak smoke (>=50k hosts, a few
    # engine steps, time-budgeted well under the tier-1 wall); the full
    # 24h-trace soak and the >=100k-host runs live behind `slow` and
    # bench_megascale.py --artifact
    config.addinivalue_line(
        "markers", "soak: megascale soak smoke (tier-1, time-budgeted)"
    )
    # real-process planet: the tier-1 procworld smoke (2 schedulers + 3
    # daemons + manager over real sockets, one SIGKILL + one rolling
    # restart, time-budgeted); the full compressed day + divergence
    # report lives in tools/dfproc.py
    config.addinivalue_line(
        "markers", "procworld: real-process planet harness (tier-1, "
        "time-budgeted)"
    )
    # the torch port's hand-written kernels run only on a CUDA device; such
    # tests skip (inside the test) where there is none
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc (the torch port's kernels)"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ----------------------------------------------------- resource leak guard

# Thread names whole subsystems own for the process lifetime: runtime pools
# (jax/XLA, orbax async machinery, grpc pollers, asyncio's default executor)
# plus the few intentionally-immortal daemons in this tree. Anything else
# alive after the last test is a leak the suite must fail on — resilience
# tests juggle servers and sockets, and a silently leaked listener turns
# every later run flaky.
_THREAD_ALLOWLIST_PREFIXES = (
    "MainThread", "pytest", "asyncio_", "ThreadPoolExecutor", "jax_",
    "orbax", "ocdbt", "ts_", "grpc", "eval-warmup", "Dummy",
    "watchdog", "QueueFeederThread",
    # orbax/tensorstore checkpoint pools (0.7.x thread names): process-
    # lifetime runtime pools like the jax_/grpc entries above
    "base_pytree_ch", "metadata_store", "process_metadata_ch",
)


def _listening_socket_inodes() -> set[str]:
    """Inodes of LISTEN-state TCP sockets owned by this process — derived
    from /proc so no extra dependency; empty off-Linux (guard no-ops)."""
    import os
    import re

    listen_inodes = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                for line in f.readlines()[1:]:
                    parts = line.split()
                    if len(parts) > 9 and parts[3] == "0A":  # TCP_LISTEN
                        listen_inodes.add(parts[9])
        except OSError:
            return set()
    owned = set()
    try:
        for fd in os.listdir("/proc/self/fd"):
            try:
                target = os.readlink(f"/proc/self/fd/{fd}")
            except OSError:
                continue
            m = re.match(r"socket:\[(\d+)\]", target)
            if m and m.group(1) in listen_inodes:
                owned.add(m.group(1))
    except OSError:
        return set()
    return owned


@pytest.fixture(scope="session", autouse=True)
def resource_leak_guard():
    """Fail the suite when tests leak non-daemon threads or listening
    sockets past their teardown (CI satellite of the failure-domain PR:
    resilience tests must not regress into resource leaks)."""
    import gc
    import threading
    import time

    baseline_sockets = _listening_socket_inodes()
    yield
    gc.collect()
    # grace for executors/handlers that are mid-teardown at session end
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        leaked_threads = [
            t for t in threading.enumerate()
            if t.is_alive() and not t.daemon
            and not t.name.startswith(_THREAD_ALLOWLIST_PREFIXES)
        ]
        leaked_sockets = _listening_socket_inodes() - baseline_sockets
        if not leaked_threads and not leaked_sockets:
            return
        time.sleep(0.1)
    problems = []
    if leaked_threads:
        problems.append(
            "leaked non-daemon threads: "
            + ", ".join(sorted(t.name for t in leaked_threads))
        )
    if leaked_sockets:
        problems.append(f"leaked listening sockets (inodes): {sorted(leaked_sockets)}")
    pytest.fail("resource leak after test-session teardown: " + "; ".join(problems))


@pytest.fixture(scope="session", autouse=True)
def serving_retrace_tripwire():
    """dfshape's runtime half (tools/dflint/retracer.py): every compile
    signature the serving jits route during the whole session must land
    inside the statically-proven ``_EVAL_BUCKETS`` set — a compile the
    static shape pass did not predict fails the suite. The donation
    guards ride along in mark mode: a donated staging buffer passed
    twice raises UseAfterDonateError at the offending call, and donated
    buffers are frozen so a later write crashes loudly."""
    import pathlib

    from tools.dflint import retracer

    root = pathlib.Path(__file__).resolve().parents[1]
    tripwire = retracer.RetraceTripwire(root=root)
    guards = retracer.install_donation_guards()
    yield
    retracer.uninstall_donation_guards(guards)
    violations = tripwire.violations()
    if violations:
        pytest.fail(
            "retrace tripwire: serving jit compiled outside the "
            "statically-proven signature set:\n" + "\n".join(violations)
        )


@pytest.fixture(scope="session", autouse=True)
def ml_refresh_worker_guard():
    """The background embedding-refresh worker (registry/serving.py
    MLEvaluator) is a daemon thread, so the non-daemon sweep above cannot
    see it — this guard fails the suite if any `ml-embed-refresh` worker
    outlives its evaluator. A collected evaluator's weakref finalizer
    signals its worker to exit, so after a gc pass every worker whose
    owner is gone must drain within the grace window; survivors mean a
    strong reference leaked into the worker (exactly the daemon-thread
    leak this fixture exists to catch)."""
    import gc
    import threading
    import time

    yield
    gc.collect()
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        workers = [
            t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("ml-embed-refresh")
        ]
        if not workers:
            return
        time.sleep(0.1)
    pytest.fail(
        "ml-embed-refresh worker(s) outlived their evaluator: "
        + ", ".join(sorted(t.name for t in workers))
    )
