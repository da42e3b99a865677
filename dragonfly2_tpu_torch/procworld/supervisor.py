"""Port of dragonfly2_tpu/procworld/supervisor.py: the same supervisor
over the port's launchers (``python -m dragonfly2_tpu_torch.cmd``).
Schedulers get ``--device`` from the planet's device (the card unless
the planet is asked for the CPU); the manager and the dfdaemons take no
``--device`` and load no torch of their own.

ProcessPlanet — a supervised real-process service topology.

- :class:`ManagedProc` launches ``python -m dragonfly2_tpu_torch.cmd <role>``
  with stdout/stderr teed to a per-process log file by a reader thread
  (no pipe-buffer deadlock, full log capture), parses the launcher
  READY-line contract (``READY host port [KEY value]...``), and owns the
  bounded SIGTERM -> grace -> SIGKILL escalation ladder plus the
  process-level chaos verbs the simulator cannot express: ``kill()``
  (SIGKILL), ``pause()``/``resume()`` (SIGSTOP/SIGCONT partitions).
- :class:`ProcessPlanet` supervises a named set of ManagedProcs
  (schedulers behind the client hashring, dfdaemons, a manager), with
  TCP liveness probes, role-aware restart (same port, same data dir —
  the rolling-upgrade / crash-recovery shape), and ``dragonfly_proc_*``
  metrics for every supervision event.

Wall clocks are legitimate here — supervising OS processes IS a
wall-clock job. The deterministic replay-facing surface lives in
``procworld/sample.py`` + ``procworld/divergence.py``, which only ever
consume observations this module recorded.
"""

from __future__ import annotations

import os
import pathlib
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time

from dragonfly2_tpu_torch.telemetry import default_registry
from dragonfly2_tpu_torch.telemetry.series import proc_series

REPO = pathlib.Path(__file__).resolve().parents[2]

READY_TIMEOUT_S = 120.0  # a scheduler's first READY waits on a cold torch and CUDA start
STOP_GRACE_S = 10.0


def base_env() -> dict:
    """The launcher environment every spawned service shares: this
    process's, with the repo on PYTHONPATH so ``-m
    dragonfly2_tpu_torch.cmd`` resolves from any cwd. It hides no card:
    a scheduler's device is its ``--device``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


class ManagedProc:
    """One supervised service process with log capture and the
    escalation ladder. Popen surface (``send_signal``/``wait``/``poll``/
    ``kill``/``pid``/``returncode``/``ready_line``) is delegated so call
    sites written against a raw Popen keep working."""

    def __init__(self, args: list[str], popen: subprocess.Popen,
                 log_path: pathlib.Path | None, *, role: str = "",
                 name: str = "", metrics=None):
        self.args = list(args)
        self.popen = popen
        self.log_path = log_path
        self.role = role or (args[0] if args else "")
        self.name = name or self.role
        self.ready_line: str | None = None
        self.host: str | None = None
        self.port: int | None = None
        self.ports: dict[str, int] = {}
        self.escalations = 0
        self._metrics = metrics
        self._lines: list[str] = []
        self._ready = threading.Event()
        self._reader = threading.Thread(target=self._pump, daemon=True)
        self._reader.start()

    # ------------------------------------------------------------ spawn

    @classmethod
    def spawn(cls, args: list[str], cwd, *, log_path=None, env=None,
              name: str = "", metrics=None,
              ready_timeout: float = READY_TIMEOUT_S) -> "ManagedProc":
        popen = subprocess.Popen(
            [sys.executable, "-m", "dragonfly2_tpu_torch.cmd", *args],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=cwd,
            env=env or base_env(),
        )
        proc = cls(args, popen, pathlib.Path(log_path) if log_path else None,
                   name=name, metrics=metrics)
        proc.wait_ready(ready_timeout)
        return proc

    def _pump(self) -> None:
        log = open(self.log_path, "a") if self.log_path else None
        try:
            for line in self.popen.stdout:
                self._lines.append(line.rstrip("\n"))
                if log is not None:
                    log.write(line)
                    log.flush()
                if not self._ready.is_set() and line.startswith("READY "):
                    self._parse_ready(line.strip())
                    self._ready.set()
        finally:
            if log is not None:
                log.close()
            self._ready.set()  # EOF before READY: unblock the waiter

    def _parse_ready(self, line: str) -> None:
        # "READY host port [KEY value]..." — every launcher's contract
        self.ready_line = line
        parts = line.split()
        self.host, self.port = parts[1], int(parts[2])
        rest = parts[3:]
        for key, value in zip(rest[::2], rest[1::2]):
            try:
                self.ports[key] = int(value)
            except ValueError:
                self.ports[key] = value  # INFER carries "host port" pair

    def wait_ready(self, timeout: float = READY_TIMEOUT_S) -> str:
        if not self._ready.wait(timeout) or self.ready_line is None:
            tail = "\n".join(self._lines[-20:])
            self.popen.kill()
            raise RuntimeError(
                f"{self.name or self.args}: no READY line "
                f"(rc={self.popen.poll()}); log tail:\n{tail}"
            )
        return self.ready_line

    # ----------------------------------------------------- supervision

    def alive(self) -> bool:
        return self.popen.poll() is None

    def probe(self, timeout: float = 1.0) -> bool:
        """TCP liveness: can the advertised primary port still accept?"""
        if self.host is None or self.port is None or not self.alive():
            return False
        try:
            with socket.create_connection((self.host, self.port), timeout):
                return True
        except OSError:
            return False

    def stop(self, grace: float = STOP_GRACE_S) -> int:
        """Bounded SIGTERM -> SIGKILL escalation ladder. Returns the exit
        code; an escalation is counted when graceful shutdown blew the
        grace window (the unbounded-wait bug the old ``_stop`` had)."""
        if self.popen.poll() is None:
            self.popen.send_signal(signal.SIGTERM)
            try:
                self.popen.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                self.escalations += 1
                if self._metrics is not None:
                    self._metrics.stop_escalations.labels("SIGKILL").inc()
                self.popen.kill()
                self.popen.wait(timeout=grace)
        self._reader.join(timeout=5.0)
        return self.popen.returncode

    def kill(self) -> None:
        """Process-level chaos: SIGKILL, no grace — the crash the
        simulator models as ``scheduler_crashed``."""
        if self.popen.poll() is None:
            self.popen.send_signal(signal.SIGKILL)
        self.popen.wait(timeout=STOP_GRACE_S)
        self._reader.join(timeout=5.0)

    def pause(self) -> None:
        """SIGSTOP: the silent-partition shape — the process holds its
        sockets but answers nothing (no FIN, requests just hang)."""
        self.popen.send_signal(signal.SIGSTOP)

    def resume(self) -> None:
        self.popen.send_signal(signal.SIGCONT)

    def log_text(self) -> str:
        return "\n".join(self._lines)

    # Popen delegation so migrated tests keep their call shapes
    def send_signal(self, sig):
        self.popen.send_signal(sig)

    def wait(self, timeout=None):
        return self.popen.wait(timeout=timeout)

    def poll(self):
        return self.popen.poll()

    def terminate(self):
        self.popen.terminate()

    @property
    def pid(self):
        return self.popen.pid

    @property
    def returncode(self):
        return self.popen.returncode

    @property
    def stdout(self):
        return self.popen.stdout


# ------------------------------------------------- functional test shims


def spawn_cmd(args: list[str], cwd) -> tuple[ManagedProc, str, int]:
    """Drop-in for the tests' hand-rolled ``_spawn(args, tmp_path)``:
    same (proc, host, port) contract, with log capture and the READY
    parser upgraded to the ManagedProc versions."""
    proc = ManagedProc.spawn(
        args, cwd, log_path=pathlib.Path(cwd) / f"{args[0]}-{os.getpid()}.log"
    )
    return proc, proc.host, proc.port


def stop_proc(proc, grace: float = STOP_GRACE_S) -> None:
    """Drop-in for the tests' ``_stop``: the bounded escalation ladder,
    accepting either a ManagedProc or a raw Popen."""
    if isinstance(proc, ManagedProc):
        proc.stop(grace)
        return
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=grace)


# ------------------------------------------------------------ the planet


class ProcessPlanet:
    """A supervised topology of real service processes: K schedulers
    (the client hashring's node set), M dfdaemons, optionally a manager.
    Knows how to restart any member on its original port/data-dir (the
    crash-recovery and rolling-upgrade shapes) and counts every
    supervision event into the ``dragonfly_proc_*`` families."""

    def __init__(self, workdir, *, registry=None, device=None):
        self.workdir = pathlib.Path(workdir)
        # the schedulers' --device: None is the card (the launcher's own
        # default, which exits where there is none)
        self.device = None if device is None else str(device)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.logdir = self.workdir / "logs"
        self.logdir.mkdir(exist_ok=True)
        self.metrics = proc_series(registry or default_registry())
        self.procs: dict[str, ManagedProc] = {}
        self.restarts: dict[str, int] = {}
        self.chaos_ops: dict[str, int] = {}
        self.liveness_failures = 0

    # ------------------------------------------------------------ spawn

    def _spawn(self, name: str, role: str, args: list[str]) -> ManagedProc:
        proc = ManagedProc.spawn(
            [role, *args], self.workdir,
            log_path=self.logdir / f"{name}.log",
            name=name, metrics=self.metrics,
        )
        proc.role = role
        self.procs[name] = proc
        self.metrics.processes.labels(role).inc()
        return proc

    def spawn_scheduler(self, name: str, *, port: int = 0,
                        manager: str = "", extra: tuple = ()) -> ManagedProc:
        args = [
            "--host", "127.0.0.1", "--port", str(port),
            "--data-dir", str(self.workdir / f"{name}-data"),
            "--metrics-port", "0",
        ]
        if manager:
            args += ["--manager", manager, "--keepalive-interval", "0.5"]
        if self.device is not None:
            args += ["--device", self.device]
        proc = self._spawn(name, "scheduler", [*args, *extra])
        self._pin_port(proc)
        return proc

    def spawn_manager(self, name: str = "manager", *,
                      extra: tuple = ()) -> ManagedProc:
        args = [
            "--host", "127.0.0.1",
            "--db", str(self.workdir / f"{name}.db"),
            "--metrics-port", "0",
        ]
        proc = self._spawn(name, "manager", [*args, *extra])
        self._pin_port(proc)
        return proc

    def spawn_daemon(self, name: str, schedulers: list[str], *,
                     proxy_rules: tuple = (r"127\.0\.0\.1.*\.bin",),
                     idc: str = "", location: str = "",
                     host_type: str = "normal",
                     scenario: str = "", scenario_seed: int = 0,
                     extra: tuple = ()) -> ManagedProc:
        # distinct --hostname per daemon: host-id-v2 keys on (ip,
        # hostname), and every planet member shares 127.0.0.1
        args = ["--data-dir", str(self.workdir / f"{name}-data"),
                "--hostname", name,
                "--host-type", host_type, "--metrics-port", "0", "--proxy"]
        for addr in schedulers:
            args += ["--scheduler", addr]
        for rule in proxy_rules:
            args += ["--proxy-rule", rule]
        if idc:
            args += ["--idc", idc]
        if location:
            args += ["--location", location]
        if scenario:
            args += ["--scenario", scenario,
                     "--scenario-seed", str(scenario_seed)]
        return self._spawn(name, "dfdaemon", [*args, *extra])

    def _pin_port(self, proc: ManagedProc) -> None:
        """Rewrite ``--port 0`` to the bound port in the saved args so a
        restart comes back on the SAME address (clients redial it)."""
        args = proc.args
        for i, a in enumerate(args[:-1]):
            if a == "--port" and args[i + 1] == "0":
                args[i + 1] = str(proc.port)

    # ------------------------------------------------------ supervision

    def scheduler_addresses(self) -> list[str]:
        return [f"{p.host}:{p.port}" for n, p in sorted(self.procs.items())
                if p.role == "scheduler"]

    def daemons(self) -> list[ManagedProc]:
        return [p for _, p in sorted(self.procs.items())
                if p.role == "dfdaemon"]

    def kill(self, name: str) -> None:
        proc = self.procs[name]
        proc.kill()
        self.metrics.processes.labels(proc.role).dec()
        self.chaos_ops["sigkill"] = self.chaos_ops.get("sigkill", 0) + 1
        self.metrics.chaos_ops.labels("sigkill").inc()

    def pause(self, name: str) -> None:
        self.procs[name].pause()
        self.chaos_ops["sigstop"] = self.chaos_ops.get("sigstop", 0) + 1
        self.metrics.chaos_ops.labels("sigstop").inc()

    def resume(self, name: str) -> None:
        self.procs[name].resume()
        self.metrics.chaos_ops.labels("sigcont").inc()

    def restart(self, name: str, *, grace: float = STOP_GRACE_S,
                ready_timeout: float = READY_TIMEOUT_S) -> ManagedProc:
        """Stop (ladder) then respawn with the original args — a
        rolling-upgrade restart. A process that already died (e.g. via
        ``kill``) respawns directly; data dir and pinned port are kept,
        so a restarted scheduler adopts re-announced pieces and a
        restarted daemon reloads its kept pieces from disk."""
        old = self.procs[name]
        if old.alive():
            old.stop(grace)
            self.metrics.processes.labels(old.role).dec()
        proc = ManagedProc.spawn(
            old.args, self.workdir,
            log_path=self.logdir / f"{name}.log",
            name=name, metrics=self.metrics, ready_timeout=ready_timeout,
        )
        proc.role = old.role
        self.procs[name] = proc
        self.restarts[name] = self.restarts.get(name, 0) + 1
        self.metrics.restarts.labels(proc.role).inc()
        self.metrics.processes.labels(proc.role).inc()
        return proc

    def liveness_sweep(self, timeout: float = 1.0) -> dict[str, bool]:
        """Probe every member's advertised port; count failures of
        processes that should be alive."""
        out = {}
        for name, proc in sorted(self.procs.items()):
            ok = proc.probe(timeout)
            out[name] = ok
            if not ok and proc.alive():
                self.liveness_failures += 1
                self.metrics.liveness_failures.labels(proc.role).inc()
        return out

    def stop_all(self, grace: float = STOP_GRACE_S) -> dict[str, int]:
        """Stop daemons, then schedulers, then the manager (reverse
        dependency order); returns exit codes by name."""
        order = {"dfdaemon": 0, "trainer": 1, "scheduler": 2, "manager": 3}
        codes = {}
        for name, proc in sorted(
            self.procs.items(), key=lambda kv: order.get(kv[1].role, 9)
        ):
            was_alive = proc.alive()
            codes[name] = proc.stop(grace)
            if was_alive:
                self.metrics.processes.labels(proc.role).dec()
        return codes

    def escalations_total(self) -> int:
        return sum(p.escalations for p in self.procs.values())

    def describe(self) -> dict:
        """The artifact's topology block — how the planet was wired."""
        return {
            "processes": {
                name: {
                    "role": p.role,
                    "address": f"{p.host}:{p.port}",
                    "ports": dict(p.ports),
                    "cmd": shlex.join(p.args),
                }
                for name, p in sorted(self.procs.items())
            },
            "restarts": dict(sorted(self.restarts.items())),
            "chaos_ops": dict(sorted(self.chaos_ops.items())),
            "stop_escalations": self.escalations_total(),
            "liveness_failures": self.liveness_failures,
        }

    # context manager

    def __enter__(self) -> "ProcessPlanet":
        return self

    def __exit__(self, *exc) -> None:
        self.stop_all()


def wait_for(predicate, timeout: float, interval: float = 0.02,
             what: str = "condition") -> None:
    """Poll until ``predicate()`` is truthy or raise after ``timeout``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval)
    raise TimeoutError(f"timed out after {timeout}s waiting for {what}")
