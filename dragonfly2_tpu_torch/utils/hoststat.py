"""Live host resource stats from /proc — the daemon announce payload.

Port of dragonfly2_tpu/utils/hoststat.py, whole (host code), over the
port's records/schema.py stats.

Capability parity with the reference daemon's gopsutil sampling
(client/daemon/announcer/announcer.go:186-252: cpu.Counts/Percent,
mem.VirtualMemory, disk.Usage, net.Connections): every announce carries
real CPU/memory/disk/network numbers, which become the host feature
columns of the scheduler's training CSV (scheduler/storage/types.go) —
without them the learned rankers train on zero-filled host features.

No psutil dependency: Linux /proc + os.statvfs provide the same
numbers. Non-Linux or unreadable /proc degrades to zeros, never raises.
CPU percent needs two samples; a process-wide `_CPUSampler` keeps the
previous reading so callers just call `collect()`.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

from dragonfly2_tpu_torch.records.schema import CPUStat, DiskStat, MemoryStat


def _read_file(path: str) -> str:
    try:
        with open(path, "r") as f:
            return f.read()
    except OSError:
        return ""


class _CPUSampler:
    """/proc/stat + /proc/self/stat deltas -> system and process CPU%."""

    def __init__(self):
        self._lock = threading.Lock()
        self._prev_total = self._prev_idle = 0
        self._prev_proc = 0.0
        self._prev_t = 0.0

    @staticmethod
    def _totals() -> tuple[int, int]:
        line = _read_file("/proc/stat").split("\n", 1)[0]
        parts = line.split()
        if len(parts) < 5 or parts[0] != "cpu":
            return 0, 0
        nums = [int(x) for x in parts[1:]]
        idle = nums[3] + (nums[4] if len(nums) > 4 else 0)  # idle + iowait
        return sum(nums), idle

    @staticmethod
    def _proc_jiffies() -> float:
        parts = _read_file("/proc/self/stat").rsplit(") ", 1)
        if len(parts) != 2:
            return 0.0
        fields = parts[1].split()
        if len(fields) < 13:
            return 0.0
        return float(int(fields[11]) + int(fields[12]))  # utime + stime

    def sample(self) -> tuple[float, float]:
        """-> (system_percent, process_percent) since the previous call."""
        total, idle = self._totals()
        proc = self._proc_jiffies()
        now = time.monotonic()
        with self._lock:
            dt_total = total - self._prev_total
            dt_idle = idle - self._prev_idle
            dt_proc = proc - self._prev_proc
            first = self._prev_t == 0.0
            self._prev_total, self._prev_idle = total, idle
            self._prev_proc, self._prev_t = proc, now
        if first or dt_total <= 0:
            return 0.0, 0.0
        sys_pct = 100.0 * max(dt_total - dt_idle, 0) / dt_total
        # process jiffies are per-cpu-second; normalize by total jiffies
        # across all cpus scaled to one cpu's span
        ncpu = max(os.cpu_count() or 1, 1)
        proc_pct = 100.0 * ncpu * max(dt_proc, 0.0) / dt_total
        return sys_pct, min(proc_pct, 100.0 * ncpu)


_sampler = _CPUSampler()


def _physical_cores() -> int:
    seen = set()
    phys = core = None
    for line in _read_file("/proc/cpuinfo").split("\n"):
        if line.startswith("physical id"):
            phys = line.split(":")[-1].strip()
        elif line.startswith("core id"):
            core = line.split(":")[-1].strip()
        elif not line.strip():
            if phys is not None and core is not None:
                seen.add((phys, core))
            phys = core = None
    return len(seen) or (os.cpu_count() or 0)


def collect_cpu() -> CPUStat:
    sys_pct, proc_pct = _sampler.sample()
    return CPUStat(
        logical_count=os.cpu_count() or 0,
        physical_count=_physical_cores(),
        percent=round(sys_pct, 2),
        process_percent=round(proc_pct, 2),
    )


def collect_memory() -> MemoryStat:
    info = {}
    for line in _read_file("/proc/meminfo").split("\n"):
        key, _, rest = line.partition(":")
        val = rest.strip().split(" ")[0]
        if val.isdigit():
            info[key] = int(val) * 1024  # kB -> bytes
    total = info.get("MemTotal", 0)
    free = info.get("MemFree", 0)
    available = info.get("MemAvailable", free)
    used = max(total - available, 0)
    process_used = 0
    for line in _read_file("/proc/self/status").split("\n"):
        if line.startswith("VmRSS:"):
            val = line.split()[1]
            if val.isdigit():
                process_used = int(val) * 1024
            break
    return MemoryStat(
        total=total,
        available=available,
        used=used,
        used_percent=round(100.0 * used / total, 2) if total else 0.0,
        process_used=process_used,
        free=free,
    )


def collect_disk(path: str = "/") -> DiskStat:
    try:
        st = os.statvfs(path)
    except OSError:
        return DiskStat()
    total = st.f_blocks * st.f_frsize
    free = st.f_bavail * st.f_frsize
    used = max((st.f_blocks - st.f_bfree) * st.f_frsize, 0)
    used_total = used + free  # gopsutil-style: percent of space a user can address
    inodes_total = st.f_files
    inodes_free = st.f_ffree
    inodes_used = max(inodes_total - inodes_free, 0)
    return DiskStat(
        total=total,
        free=free,
        used=used,
        used_percent=round(100.0 * used / used_total, 2) if used_total else 0.0,
        inodes_total=inodes_total,
        inodes_used=inodes_used,
        inodes_free=inodes_free,
        inodes_used_percent=(
            round(100.0 * inodes_used / inodes_total, 2) if inodes_total else 0.0
        ),
    )


def collect_tcp_counts(upload_port: int | None = None) -> tuple[int, int]:
    """-> (total tcp connections, connections on `upload_port`) from
    /proc/net/tcp{,6} (net.Connections equivalent)."""
    total = uploads = 0
    for path in ("/proc/net/tcp", "/proc/net/tcp6"):
        lines = _read_file(path).split("\n")[1:]
        for line in lines:
            parts = line.split()
            if len(parts) < 4 or ":" not in parts[1]:
                continue
            _, _, port_hex = parts[1].rpartition(":")
            try:
                port = int(port_hex, 16)
            except ValueError:
                continue
            total += 1
            if upload_port is not None and port == upload_port:
                uploads += 1
    return total, uploads


@dataclasses.dataclass
class HostStats:
    cpu: CPUStat
    memory: MemoryStat
    disk: DiskStat
    tcp_connection_count: int
    upload_tcp_connection_count: int


_CACHE_TTL_S = 5.0
_cache_lock = threading.Lock()
_cache: dict[tuple, tuple[float, HostStats]] = {}


def collect(data_dir: str = "/", upload_port: int | None = None) -> HostStats:
    """TTL-cached sample: host_info() runs on the daemon's event loop per
    download, and the /proc/net/tcp scan is exactly as large as the host
    is busy — resource stats drift on seconds, so a 5 s cache bounds the
    per-download cost to a dict lookup."""
    key = (data_dir, upload_port)
    now = time.monotonic()
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None and now - hit[0] < _CACHE_TTL_S:
            return hit[1]
    tcp, up = collect_tcp_counts(upload_port)
    stats = HostStats(
        cpu=collect_cpu(),
        memory=collect_memory(),
        disk=collect_disk(data_dir),
        tcp_connection_count=tcp,
        upload_tcp_connection_count=up,
    )
    with _cache_lock:
        _cache[key] = (now, stats)
        if len(_cache) > 64:
            _cache.pop(min(_cache, key=lambda k: _cache[k][0]))
    return stats
