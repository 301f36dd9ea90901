"""The port's dsync quorum locks against the JAX package's.

The same scripts of lock, read lock, unlock and refresh, with subsets of
the lock servers down, give the same grant and refuse verdicts on the
JAX DRWMutex and the port's (in-process lockers); then the port's own
counterparts of tests/test_distributed.py's dsync tests and
tests/test_cluster.py's lock-liveness tests.
"""

import importlib
import time

import pytest

from minio_tpu.grid import dsync as ref_dsync
from minio_tpu_torch.grid import dsync
from minio_tpu_torch.grid import GridClient, GridServer
from minio_tpu_torch.object.nslock import LockTimeout


class _Switch:
    """A locker that is unreachable (every call answers None, as a
    RemoteLocker to a dead node does) while `down`."""

    def __init__(self, inner):
        self.inner = inner
        self.down = False

    def _op(self, name, *a):
        return None if self.down else getattr(self.inner, name)(*a)

    def try_lock(self, *a):
        return self._op("try_lock", *a)

    def unlock(self, *a):
        return self._op("unlock", *a)

    def refresh(self, *a):
        return self._op("refresh", *a)


def _run(mod, n: int, script: list) -> list:
    """Play `script` against n lock servers of package `mod`; the
    verdicts in order."""
    lks = [_Switch(mod.LocalLocker(mod.LockServer(ttl=30.0)))
           for _ in range(n)]
    held: dict = {}
    out = []
    for step in script:
        op = step[0]
        if op in ("down", "up"):
            for i in step[1]:
                lks[i].down = op == "down"
            continue
        if op == "lock":
            _, who, write = step
            m = held[who] = mod.DRWMutex(lks, "bkt/obj")
            got = m.lock(write=write, timeout=0.2)
            out.append((op, who, got, m.quorum_unreachable))
            if not got:
                held.pop(who)
        elif op == "unlock":
            held.pop(step[1]).unlock()
        elif op == "refresh":
            m = held[step[1]]
            m._refresh_round()
            out.append((op, step[1], m._held))
            if not m._held:
                held.pop(step[1])
    for m in held.values():
        m.unlock()
    return out


SCRIPTS = {
    "exclusive": [("lock", "a", True), ("lock", "b", True),
                  ("lock", "r", False), ("unlock", "a"),
                  ("lock", "b", True), ("refresh", "b"), ("unlock", "b")],
    "readers_share": [("lock", "r1", False), ("lock", "r2", False),
                      ("lock", "w", True), ("unlock", "r1"),
                      ("lock", "w", True), ("unlock", "r2"),
                      ("lock", "w", True), ("refresh", "w")],
    "one_down": [("down", [0]), ("lock", "a", True), ("lock", "b", True),
                 ("lock", "r", False), ("refresh", "a"), ("unlock", "a"),
                 ("lock", "r", False)],
    "half_down": [("down", [0, 1]), ("lock", "a", True),
                  ("lock", "r", False), ("lock", "r2", False)],
    "majority_down": [("down", [0, 1, 2]), ("lock", "a", True),
                      ("lock", "r", False)],
    "lost_on_refresh": [("lock", "a", True), ("down", [1, 2]),
                        ("refresh", "a"), ("up", [1, 2]),
                        ("lock", "b", True)],
    "reader_survives_one": [("lock", "r", False), ("down", [3]),
                            ("refresh", "r"), ("lock", "w", True),
                            ("unlock", "r"), ("lock", "w", True)],
}


@pytest.mark.parametrize("n", [3, 4, 5])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_verdicts_equal_jax(name, n):
    script = [s for s in SCRIPTS[name]
              if s[0] not in ("down", "up") or max(s[1]) < n]
    ours = _run(dsync, n, script)
    assert ours == _run(ref_dsync, n, script)
    assert ours, "the script decided nothing"


def test_quorums_equal_jax():
    for n in range(1, 10):
        a = dsync.DRWMutex([None] * n, "r")
        b = ref_dsync.DRWMutex([None] * n, "r")
        assert (a._quorum(True), a._quorum(False)) == \
            (b._quorum(True), b._quorum(False)) == (n // 2 + 1, n - n // 2)


# ---------------------------------------------------------------------------
# tests/test_distributed.py's dsync tests
# ---------------------------------------------------------------------------

def _lockers(n=3, remote=False):
    servers = [dsync.LockServer() for _ in range(n)]
    if not remote:
        return servers, [dsync.LocalLocker(s) for s in servers]
    grids, lks = [], []
    for s in servers:
        g = GridServer(0, host="127.0.0.1")
        s.register_into(g)
        g.start()
        grids.append(g)
        lks.append(dsync.RemoteLocker(GridClient("127.0.0.1", g.port)))
    return servers, lks, grids


def test_dsync_mutual_exclusion():
    _, lks = _lockers(3)
    m1 = dsync.DRWMutex(lks, "b/o")
    m2 = dsync.DRWMutex(lks, "b/o")
    assert m1.lock(write=True, timeout=1)
    assert not m2.lock(write=True, timeout=0.3)
    m1.unlock()
    assert m2.lock(write=True, timeout=1)
    m2.unlock()


def test_dsync_readers_share():
    _, lks = _lockers(3)
    r1 = dsync.DRWMutex(lks, "b/o")
    r2 = dsync.DRWMutex(lks, "b/o")
    w = dsync.DRWMutex(lks, "b/o")
    assert r1.lock(write=False, timeout=1)
    assert r2.lock(write=False, timeout=1)
    assert not w.lock(write=True, timeout=0.3)
    r1.unlock()
    r2.unlock()
    assert w.lock(write=True, timeout=1)
    w.unlock()


def test_dsync_quorum_with_one_locker_down():
    servers, lks, grids = _lockers(3, remote=True)
    grids[2].stop()          # one lock server dies
    time.sleep(0.1)
    m = dsync.DRWMutex(lks, "b/o")
    assert m.lock(write=True, timeout=3)   # 2/3 still a quorum
    m2 = dsync.DRWMutex(lks, "b/o")
    assert not m2.lock(write=True, timeout=0.3)
    m.unlock()
    for g in grids[:2]:
        g.stop()


def test_dsync_fails_fast_without_quorum_over_the_grid():
    servers, lks, grids = _lockers(3, remote=True)
    for g in grids[1:]:
        g.stop()
    time.sleep(0.1)
    m = dsync.DRWMutex(lks, "b/o")
    t0 = time.monotonic()
    assert not m.lock(write=True, timeout=30)
    assert m.quorum_unreachable and time.monotonic() - t0 < 15
    grids[0].stop()


def test_dsync_expiry_frees_crashed_holder():
    servers = [dsync.LockServer(ttl=0.2) for _ in range(3)]
    lks = [dsync.LocalLocker(s) for s in servers]
    m1 = dsync.DRWMutex(lks, "b/o")
    assert m1.lock(write=True, timeout=1)
    m1._stop_refresh.set()     # the holder crashed: no unlock, no refresh
    time.sleep(0.35)
    m2 = dsync.DRWMutex(lks, "b/o")
    assert m2.lock(write=True, timeout=1)
    m2.unlock()


def test_dist_nslock_interface():
    _, lks = _lockers(3)
    ns = dsync.DistNSLock(lks)
    with ns.write("b", "o"):
        with pytest.raises(LockTimeout):
            with ns.write("b", "o", timeout=0.3):
                pass
    with ns.read("b", "o"):
        with ns.read("b", "o"):
            pass


# ---------------------------------------------------------------------------
# tests/test_cluster.py's lock liveness
# ---------------------------------------------------------------------------

def test_leaked_write_lock_unblocks_within_ttl():
    servers = [dsync.LockServer(ttl=0.4) for _ in range(3)]
    lks = [dsync.LocalLocker(s) for s in servers]
    holder = dsync.DRWMutex(lks, "bkt/obj")
    assert holder.lock(write=True, timeout=2)
    holder._stop_refresh.set()           # the crash: no refresh, no unlock
    blocked = dsync.DRWMutex(lks, "bkt/obj")
    t0 = time.monotonic()
    assert blocked.lock(write=True, timeout=5)
    waited = time.monotonic() - t0
    blocked.unlock()
    assert waited < 2.0, f"writer waited {waited:.2f}s, TTL is 0.4s"
    assert sum(s.stats()["expired_total"] for s in servers) >= 1


def test_lock_ttl_env_knobs(monkeypatch):
    monkeypatch.setenv("MTPU_GRID_LOCK_TTL", "9.0")
    monkeypatch.setenv("MTPU_GRID_LOCK_REFRESH", "100.0")
    mod = importlib.reload(dsync)
    try:
        assert mod.LOCK_TTL == 9.0
        assert mod.REFRESH_INTERVAL == 3.0     # clamped to TTL/3
        assert mod.LockServer().ttl == 9.0
    finally:
        monkeypatch.delenv("MTPU_GRID_LOCK_TTL")
        monkeypatch.delenv("MTPU_GRID_LOCK_REFRESH")
        importlib.reload(mod)
