"""The port's utils/cache.py and utils/dfpath.py against the reference's:
one seeded sequence of cache operations under a pinned clock gives equal
reads, listings, counts and evictions (in the same order) in both
packages; each package loads the other's saved file; the directory
layouts are equal. Every comparison exact."""

from __future__ import annotations

import time

import numpy as np
import pytest

from dragonfly2_tpu.utils import cache as ref_cache
from dragonfly2_tpu.utils import dfpath as ref_dfpath
from dragonfly2_tpu_torch.utils import cache, dfpath


@pytest.fixture()
def clock(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    return now


def _play(mod, clock, seed: int) -> list:
    """A seeded run of every Cache operation; returns what each read saw
    and the evictions in order."""
    rng = np.random.default_rng(seed)
    c = mod.new_cache(default_expiration=5.0)
    evicted = []
    c.on_evicted(lambda k, v: evicted.append((k, v)))
    seen = []
    keys = [f"networktopology:src:{i}" for i in range(6)] + [f"probe:{i}" for i in range(6)]
    for step in range(400):
        op = int(rng.integers(12))
        key = keys[int(rng.integers(len(keys)))]
        ttl = [None, 0.0, 1.5, 7.0][int(rng.integers(4))]
        if op == 0:
            c.set(key, step, ttl)
        elif op == 1:
            try:
                c.add(key, step, ttl)
                seen.append(("add", key, "ok"))
            except mod.CacheKeyExists:
                seen.append(("add", key, "exists"))
        elif op == 2:
            c.delete(key)
        elif op == 3:
            seen.append(("get", key, c.get(key, "missing")))
        elif op == 4:
            seen.append(("exp", key, c.get_with_expiration(key)))
        elif op == 5:
            seen.append(("keys", sorted(c.keys())))
        elif op == 6:
            limit = int(rng.integers(-1, 4))
            seen.append(("scan", limit, c.scan("networktopology:", limit)))
        elif op == 7:
            seen.append(("count", c.item_count()))
        elif op == 8:
            c.delete_expired()
        elif op == 9:
            seen.append(("items", sorted(c.items().items())))
        elif op == 10:
            seen.append(("contains", key, c.contains(key)))
        else:
            c.set_default(key, step)
        clock[0] += float(rng.integers(0, 3)) * 0.5
        if step == 300:
            c.flush()
    return seen, evicted


def test_cache_sequence_equals_the_reference(clock):
    for seed in (0, 1, 2):
        start = clock[0]
        got = _play(cache, clock, seed)
        clock[0] = start
        want = _play(ref_cache, clock, seed)
        assert got == want, seed
        assert got[1], "the sequence evicts"


def test_saved_files_load_across_the_packages(clock, tmp_path):
    for writer, reader in ((cache, ref_cache), (ref_cache, cache)):
        a = writer.Cache(default_expiration=10.0)
        a.set("live", {"x": 1})
        a.set("short", [1, 2], ttl=2.0)
        a.set("forever", "v", ttl=0.0)
        a.set("dead", "gone", ttl=1.0)
        clock[0] += 1.5  # "dead" has expired, "short" has 0.5 s left
        path = tmp_path / f"{writer.__name__.split('.')[0]}.pkl"
        a.save_file(str(path))
        b = reader.Cache()
        b.set("live", "kept")  # load never overwrites a present key
        b.load_file(str(path))
        assert sorted(b.keys()) == ["forever", "live", "short"]
        assert b.get("live") == "kept" and b.get("forever") == "v"
        assert b.get_with_expiration("short") == ([1, 2], clock[0] + 0.5)
        assert b.get_with_expiration("forever") == ("v", None)
        clock[0] += 1.0
        assert sorted(b.keys()) == ["forever", "live"]


def test_janitor_evicts_and_stops():
    evicted = []
    for mod in (cache, ref_cache):
        c = mod.new_cache(default_expiration=0.01, cleanup_interval=0.01)
        c.on_evicted(lambda k, v: evicted.append((mod.__name__, k)))
        c.set("a", 1)
        deadline = time.time() + 5
        while not evicted or evicted[-1][0] != mod.__name__:
            assert time.time() < deadline, "the janitor evicted nothing"
            time.sleep(0.01)
        assert c.item_count() == 0
        c.close()
        c._janitor.join(1)
        assert not c._janitor.is_alive()


def test_paths_equal_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("DRAGONFLY_TPU_HOME", str(tmp_path / "home"))
    for name in ("manager", "scheduler", "trainer", "daemon"):
        got = dfpath.new_paths(name)
        want = ref_dfpath.new_paths(name)
        assert got.__dict__ == want.__dict__ and got.lock_file("x") == want.lock_file("x")
        assert all(p.is_dir() for p in got.__dict__.values())
    got = dfpath.new_paths("daemon", work_home=tmp_path / "w", cache_dir=tmp_path / "c",
                           log_dir=tmp_path / "l", data_dir=tmp_path / "d",
                           plugin_dir=tmp_path / "p")
    want = ref_dfpath.new_paths("daemon", work_home=tmp_path / "w", cache_dir=tmp_path / "c",
                                log_dir=tmp_path / "l", data_dir=tmp_path / "d",
                                plugin_dir=tmp_path / "p")
    assert got.__dict__ == want.__dict__
    assert got.config_dir == tmp_path / "w" / "config"
