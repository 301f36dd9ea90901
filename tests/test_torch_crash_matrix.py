"""The crash-point matrix over both packages' commit paths, on the CPU.

The counterpart of tests/test_crash_matrix.py. For each op (PUT fresh,
overwrite and inline, multipart, DELETE, heal's commit, the group-commit
lanes, a pool migration) `crash_sweep` walks the shared CrashClock over
every durable sub-step the op performs on every drive: the node loses
power at sub-step n, the write in flight is dropped or torn, every later
call fails (storage/crashdisk.CrashDisk, one of each package). The
drives are then remounted and recovered, and the same invariants are
held on both packages (`pkg` "jax" or "port"):

  * an acknowledged write or delete survives (drop and tear modes;
    lose_entry models a filesystem without directory fsync, where the
    guarantee needs MTPU_FS_OSYNC, so it asserts consistency only);
  * every read gives the complete old or the complete new version,
    never torn bytes;
  * after recovery no live group-commit WAL frame is left;
  * after the listed heals the answer has not moved;
  * no tmp/ or staging/ entry is left, and (port) no pooled lease is
    outstanding.

The JAX package remounts with `recovery_sweep` on each drive; the port
with its boot path, `server.recover_drives`, which must take the deep
sweep on every drive (no clean-shutdown stamp may hide a crash). The
port's sets run on the CPU (`device="cpu"`).

Cases the JAX matrix does not reach: a streamed PUT of three 1 MiB
windows and a ragged tail, cut inside the per-drive shard streams; four
concurrent inline PUTs committed as one lane batch a drive, where the
port's lanes must demote no member of a batch the cut met; remounts
across the packages: drives one package cut and recovered are read by
the other, which must give the same answer at every point; and an
overwrite on 12 drives (EC 8+4), where a cut can leave fewer than read
quorum on both sides of the split (port only: the JAX package fails
it). The journal
encodings differ by design (msgpack against JSON; the port carries no
msgpack), so the cross-package cases re-encode each xl.meta field for
field (storage.meta.from_reference_map, and its inverse here); every
other byte on the drives is read as the cutting package left it.

The clock counts a point's sub-steps the same way from run to run: the
checkpoint coordinator is pinned out of the way
(MTPU_GROUP_COMMIT_CKPT_S) and the double owns the WAL's checkpoints.
Every assertion names the point: n, the mode and the clock's fired_op.

Tier 1 runs the smoke subset on both packages; the full sweep is
`slow` (the JAX package's cases of it run in tests/test_crash_matrix.py
too). Tolerance: none; bytes compare exactly.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import threading
import time

import numpy as np
import pytest

import minio_tpu.object.erasure_object as ref_eo
from minio_tpu.object import decom as ref_decom
from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.object.pools import ServerPools as RefPools
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.object.types import GetOptions as RefGetOptions
from minio_tpu.object.types import ObjectNotFound as RefNotFound
from minio_tpu.object.types import PutOptions as RefPutOptions
from minio_tpu.object.types import VersionNotFound as RefVersionNotFound
from minio_tpu.storage import crashdisk as ref_crash
from minio_tpu.storage import group_commit as ref_gc
from minio_tpu.storage import local as ref_local
from minio_tpu.storage import meta as ref_meta

import minio_tpu_torch.object.erasure_object as port_eo
from minio_tpu_torch.io.bufpool import global_pool
from minio_tpu_torch.object import decom as port_decom
from minio_tpu_torch.object.erasure_object import ErasureSet as PortSet
from minio_tpu_torch.object.pools import ServerPools as PortPools
from minio_tpu_torch.object.sets import ErasureSets as PortSets
from minio_tpu_torch.object.types import GetOptions as PortGetOptions
from minio_tpu_torch.object.types import ObjectNotFound as PortNotFound
from minio_tpu_torch.object.types import PutOptions as PortPutOptions
from minio_tpu_torch.object.types import VersionNotFound as PortVersionNotFound
from minio_tpu_torch.server import recover_drives
from minio_tpu_torch.storage import crashdisk as port_crash
from minio_tpu_torch.storage import group_commit as port_gc
from minio_tpu_torch.storage import local as port_local
from minio_tpu_torch.storage import meta as port_meta

PKGS = ("jax", "port")
PKG = {
    "jax": dict(local=ref_local, crash=ref_crash, gc=ref_gc,
                notfound=RefNotFound, vnotfound=RefVersionNotFound,
                put=RefPutOptions, get=RefGetOptions,
                decom=ref_decom, pools=RefPools, sets=RefSets, eo=ref_eo,
                mkset=lambda disks: RefSet(disks)),
    "port": dict(local=port_local, crash=port_crash, gc=port_gc,
                 notfound=PortNotFound, vnotfound=PortVersionNotFound,
                 put=PortPutOptions,
                 get=PortGetOptions, decom=port_decom, pools=PortPools,
                 sets=PortSets, eo=port_eo,
                 mkset=lambda disks: PortSet(disks, device="cpu")),
}
SYS_VOL = port_local.SYS_VOL
assert SYS_VOL == ref_local.SYS_VOL

N = 4                                    # EC 2+2, write quorum 3
BKT = "bkt"
KEY = "obj"
KEY2 = "obj2"

# Both packages' inline threshold is lowered to 2 KiB of shard file in
# this file (`_small_shards`), so that a 6 KiB body takes the shard-file
# paths (staging, data dir, rename_data) that a 300 KiB one takes with
# the default 128 KiB: the port's plain CPU hash, what its sets run here,
# costs about 0.3 ms a 32-byte packet of a stream.
INLINE_LIMIT = 2 << 10
_rng = np.random.default_rng(18)
OLD = _rng.bytes(6 * 1024 + 17)          # single part, not inline
NEW = _rng.bytes(7 * 1024 + 5)
OLD_INLINE = _rng.bytes(1_900)           # inline in xl.meta
NEW_INLINE = _rng.bytes(2_000)
STREAMED = _rng.bytes(3 * (1 << 20) + 777)   # 3 windows + a ragged tail
LANE_OLD = [_rng.bytes(1_000 + i) for i in range(4)]
LANE_NEW = [_rng.bytes(1_100 + i) for i in range(4)]


@pytest.fixture(autouse=True)
def _pinned_checkpoints(monkeypatch):
    # No background checkpoint may run between two sub-steps: the WAL is
    # retired only by the hook-ticked gc_checkpoint of a set's close.
    monkeypatch.setenv("MTPU_GROUP_COMMIT_CKPT_S", "3600")


@pytest.fixture(autouse=True)
def _small_shards(monkeypatch):
    for pkg in PKGS:
        monkeypatch.setattr(PKG[pkg]["eo"], "SMALL_FILE_THRESHOLD",
                            INLINE_LIMIT)


# -- the sweep -----------------------------------------------------------------

def _disks(pkg, root, wrap=None):
    disks = [PKG[pkg]["local"].LocalStorage(str(root / f"d{i}"))
             for i in range(N)]
    return [wrap(d) for d in disks] if wrap is not None else disks


def _mkset(pkg, root, wrap=None):
    return PKG[pkg]["mkset"](_disks(pkg, root, wrap))


def _get(pkg, es, key=KEY):
    try:
        return es.get_object(BKT, key)[1]
    except PKG[pkg]["notfound"]:
        return None


def _remount(pkg, root, where) -> list:
    """The reboot: each package's recovery on fresh drives; returns the
    (bucket, path) list to heal."""
    disks = _disks(pkg, root)
    if pkg == "port":
        rep = recover_drives(disks)
        assert rep["swept"] == N, \
            f"{where}: recovery took the deep sweep on {rep['swept']}/{N}"
        return list(rep["heal"])
    heal = []
    for d in disks:
        heal.extend(ref_local.recovery_sweep(d, min_age=0)["heal"])
    return heal


def _assert_no_live_wal(root, where):
    for i in range(N):
        gdir = root / f"d{i}" / SYS_VOL / "gcommit"
        live = [n for n in (os.listdir(gdir) if gdir.is_dir() else [])
                if os.path.getsize(gdir / n) > 0]
        assert live == [], f"{where}: live WAL frames survived in d{i}"


def _assert_no_garbage(drives, where):
    for d in drives:
        for sub in ("tmp", "staging"):
            p = d / SYS_VOL / sub
            assert not os.path.isdir(p) or os.listdir(p) == [], \
                f"{where}: crash debris survived in {d.name}/{sub}"


def _leases():
    return global_pool("cpu").stats()


def _assert_pool_idle(pkg, where, leaks0):
    if pkg != "port":
        return
    st = _leases()
    assert st["outstanding"] == 0 and st["leaks"] == leaks0, \
        f"{where}: {st['outstanding']} pooled leases outstanding, " \
        f"{st['leaks'] - leaks0} leaked"


def _where(n, mode, clock):
    return f"n={n} mode={mode} fired_op={clock.fired_op or 'none'}"


def _run_cut(pkg, root, mode, n, op, ctx):
    """Run `op` over CrashDisks cut at sub-step n; (completed, error,
    clock)."""
    crash = PKG[pkg]["crash"]
    clock = crash.CrashClock(crash_at=n)
    es = _mkset(pkg, root, wrap=lambda d: crash.CrashDisk(d, clock, mode))
    completed, err = False, None
    try:
        op(es, ctx, clock)
        completed = True
    except Exception as e:  # noqa: BLE001 - PowerCut, quorum faults
        err = e
    es.close()
    _power_off(clock)
    if not clock.fired:
        assert completed, f"{pkg}: op failed without a cut: {err!r}"
    return completed, err, clock


def _power_off(clock) -> None:
    # The port's clock applies the cut's effects once the op's threads
    # have ended; the JAX package's applies them as it fires.
    off = getattr(clock, "power_off", None)
    if off is not None:
        off()


def _checked(check, es, where):
    """check(es, where), which returns what it read; a read that raises
    fails at the point too."""
    try:
        return check(es, where)
    except AssertionError:
        raise
    except Exception as e:  # noqa: BLE001 - a read that cannot answer
        raise AssertionError(f"{where}: the read raised {e!r}") from e


def _settle(pkg, es, heal, key, check, where):
    """check, heal what recovery listed and the key, check again (the
    answer must not have moved), drain the MRF (degraded reads queue
    heals that stage through tmp/)."""
    before = _checked(check, es, where)
    for vol, path in set(heal) | {(BKT, key)}:
        try:
            es.heal_object(vol, path)
        except (PKG[pkg]["notfound"], PKG[pkg]["vnotfound"]):
            pass                # a key the cut left absent: nothing to heal
    after = _checked(check, es, where + " (healed)")
    assert after == before, f"{where}: the heals moved the answer"
    if es._mrf is not None:
        es._mrf.drain(15)
        es._mrf.stop()


def crash_sweep(tmp_path, pkg, mode, setup, op, check, max_points=400,
                stride=1, key=KEY):
    """Walk the cut over sub-steps 1, 1 + stride, ... until `op`
    completes; assert `check(pkg, es, ctx, completed, where)` after each
    cut, before and after the heals. Returns the op's sub-step count
    (the uncut run's)."""
    leaks0 = _leases()["leaks"]
    n = 1
    while n <= max_points:
        root = tmp_path / f"{pkg}-{mode}-{n}"
        es = _mkset(pkg, root)
        es.make_bucket(BKT)
        ctx = setup(pkg, es) or {}
        es.close()
        completed, _, clock = _run_cut(pkg, root, mode, n, op, ctx)
        where = f"{pkg} {_where(n, mode, clock)}"
        heal = _remount(pkg, root, where)
        es3 = _mkset(pkg, root)
        try:
            _assert_no_live_wal(root, where)
            _settle(pkg, es3, heal, key,
                    lambda es, w: check(pkg, es, ctx, completed, w), where)
        finally:
            es3.close()
        _assert_no_garbage([root / f"d{i}" for i in range(N)], where)
        _assert_pool_idle(pkg, where, leaks0)
        shutil.rmtree(root, ignore_errors=True)
        if not clock.fired:
            return clock.count
        n += stride
    raise AssertionError(f"{pkg}: op never completed in {max_points} points")


# -- setups, ops and checks ----------------------------------------------------

def _setup_none(pkg, es):
    return {}


def _setup_put(body):
    def setup(pkg, es):
        es.put_object(BKT, KEY, body)
        return {"old": body}
    return setup


def _setup_heal(pkg, es):
    es.put_object(BKT, KEY, OLD)
    shutil.rmtree(os.path.join(es.disks[1].root, BKT, KEY))
    return {"old": OLD}


def _op_put(new):
    def op(es, ctx, clock):
        es.put_object(BKT, KEY, new)
    return op


def _op_multipart(es, ctx, clock):
    pkg = ctx["pkg"]
    uid = es.new_multipart_upload(BKT, KEY, PKG[pkg]["put"]())
    part = es.put_object_part(BKT, KEY, uid, 1, NEW)
    es.complete_multipart_upload(BKT, KEY, uid, [(1, part.etag)])


def _with_pkg(setup):
    def wrapped(pkg, es):
        ctx = setup(pkg, es) or {}
        ctx["pkg"] = pkg
        return ctx
    return wrapped


def _op_delete(es, ctx, clock):
    es.delete_object(BKT, KEY)


def _op_heal(es, ctx, clock):
    es.heal_object(BKT, KEY)


def _verdict(got, new, ctx, completed, where, durable=True,
             deletable=False):
    old = ctx.get("old")
    if completed and durable and new is not None:
        assert got == new, f"{where}: an acknowledged write was lost"
    elif completed and durable and deletable:
        assert got is None, f"{where}: an acknowledged delete came back"
    else:
        allowed = [x for x in (old, new) if x is not None]
        if old is None or deletable:
            allowed.append(None)
        assert any(got == x for x in allowed), \
            f"{where}: torn read, neither the old nor the new version"


def _check_versions(new, durable=True, deletable=False):
    def check(pkg, es, ctx, completed, where):
        got = _get(pkg, es)
        _verdict(got, new, ctx, completed, where, durable, deletable)
        return got
    return check


def _check_heal(pkg, es, ctx, completed, where):
    # A heal never makes things worse: the old version is the only
    # answer at every cut of the heal's own commit.
    got = _get(pkg, es)
    assert got == ctx["old"], f"{where}: the heal tore the object"
    return got


def _op_group_put(new):
    def op(es, ctx, clock):
        assert es.group_commit is not None, "group lanes not wired"
        es.group_commit.worth_batching = lambda: True
        es.put_object(BKT, KEY, new)
    return op


def _donor_fis(es, key, data):
    """Each drive's FileInfo (its own framed inline shard) for `data`,
    from a real PUT of a donor key: the version maps a batch commits."""
    es.put_object(BKT, key, data)
    return [dataclasses.replace(d.read_version(BKT, key, read_data=True))
            for d in es.disks]


def _setup_group_multi(pkg, es):
    es.put_object(BKT, KEY, OLD_INLINE)
    new_fis = _donor_fis(es, "donor-a", NEW_INLINE)
    k2_fis = _donor_fis(es, "donor-b", NEW_INLINE)
    es.delete_object(BKT, "donor-a")
    es.delete_object(BKT, "donor-b")
    return {"old": OLD_INLINE, "new_fis": new_fis, "k2_fis": k2_fis,
            "pkg": pkg}


def _op_group_multi(es, ctx, clock):
    """One commit_group batch a drive: an overwrite of KEY and a fresh
    KEY2, the batch shape the lanes dispatch."""
    g = PKG[ctx["pkg"]]["gc"]
    for i, d in enumerate(es.disks):
        fi_new = dataclasses.replace(ctx["new_fis"][i])
        fi_new.name = KEY
        fi_k2 = dataclasses.replace(ctx["k2_fis"][i])
        fi_k2.name = KEY2
        res = d.commit_group([g.GroupOp.write_meta(BKT, KEY, fi_new),
                              g.GroupOp.write_meta(BKT, KEY2, fi_k2)])
        for e in res:
            if e is not None:
                raise e


def _check_group_multi(pkg, es, ctx, completed, where):
    got, got2 = _get(pkg, es), _get(pkg, es, KEY2)
    if completed:
        assert got == NEW_INLINE, f"{where}: acked batch overwrite lost"
        assert got2 == NEW_INLINE, f"{where}: acked batch fresh key lost"
    else:
        assert got in (ctx["old"], NEW_INLINE), \
            f"{where}: torn read after a batched commit's cut"
        assert got2 in (None, NEW_INLINE), \
            f"{where}: torn fresh key after a batched commit's cut"
    return got, got2


def _check_group_lose_entry(pkg, es, ctx, completed, where):
    got, got2 = _get(pkg, es), _get(pkg, es, KEY2)
    assert got in (ctx["old"], NEW_INLINE), f"{where}: torn"
    assert got2 in (None, NEW_INLINE), f"{where}: torn key2"
    return got, got2


# -- tier-1 smoke, both packages ---------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_crash_smoke_inline_overwrite(tmp_path, pkg):
    steps = crash_sweep(tmp_path, pkg, "drop", _setup_put(OLD_INLINE),
                        _op_put(NEW_INLINE), _check_versions(NEW_INLINE))
    assert steps >= N    # every drive's journal commit was walked


@pytest.mark.parametrize("pkg", PKGS)
def test_crash_smoke_delete(tmp_path, pkg):
    steps = crash_sweep(tmp_path, pkg, "drop", _setup_put(OLD), _op_delete,
                        _check_versions(None, deletable=True))
    assert steps >= 2 * N    # journal and reclaim on every drive


@pytest.mark.parametrize("pkg", PKGS)
def test_crash_smoke_group_commit(tmp_path, pkg):
    steps = crash_sweep(tmp_path, pkg, "drop", _setup_group_multi,
                        _op_group_multi, _check_group_multi, max_points=200)
    # Each drive's batch: the WAL frame and 2 journal writes.
    assert steps >= 3 * N


# -- the full matrix, both packages (slow) ------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode", ["drop", "tear"])
def test_crash_matrix_put_fresh(tmp_path, pkg, mode):
    crash_sweep(tmp_path, pkg, mode, _setup_none, _op_put(NEW),
                _check_versions(NEW))


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode", ["drop", "tear"])
def test_crash_matrix_put_overwrite(tmp_path, pkg, mode):
    crash_sweep(tmp_path, pkg, mode, _setup_put(OLD), _op_put(NEW),
                _check_versions(NEW))


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode", ["drop", "tear"])
def test_crash_matrix_put_inline(tmp_path, pkg, mode):
    crash_sweep(tmp_path, pkg, mode, _setup_put(OLD_INLINE),
                _op_put(NEW_INLINE), _check_versions(NEW_INLINE))


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode", ["drop", "tear"])
def test_crash_matrix_multipart(tmp_path, pkg, mode):
    crash_sweep(tmp_path, pkg, mode, _with_pkg(_setup_put(OLD)),
                _op_multipart, _check_versions(NEW))


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode", ["drop", "tear"])
def test_crash_matrix_delete(tmp_path, pkg, mode):
    crash_sweep(tmp_path, pkg, mode, _setup_put(OLD), _op_delete,
                _check_versions(None, deletable=True))


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode", ["drop", "tear"])
def test_crash_matrix_heal_commit(tmp_path, pkg, mode):
    crash_sweep(tmp_path, pkg, mode, _setup_heal, _op_heal, _check_heal)


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode", ["drop", "tear"])
def test_crash_matrix_group_put_inline(tmp_path, pkg, mode):
    # A real PUT through the lanes: cuts before, inside and after the WAL
    # frame and the journal writes on every drive.
    crash_sweep(tmp_path, pkg, mode, _setup_put(OLD_INLINE),
                _op_group_put(NEW_INLINE), _check_versions(NEW_INLINE))


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode", ["drop", "tear"])
def test_crash_matrix_group_multi_object(tmp_path, pkg, mode):
    crash_sweep(tmp_path, pkg, mode, _setup_group_multi, _op_group_multi,
                _check_group_multi)


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
def test_crash_matrix_group_lose_entry_partial_batch(tmp_path, pkg):
    # Without directory fsync a partial batch may lose journal renames
    # and the WAL's own entry: old-or-new a key must hold; durability is
    # MTPU_FS_OSYNC's, so it is not asserted.
    crash_sweep(tmp_path, pkg, "lose_entry", _setup_group_multi,
                _op_group_multi, _check_group_lose_entry)


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
def test_crash_matrix_lost_dir_entries(tmp_path, pkg):
    # The last unsynced rename may vanish: old-or-new must hold, an
    # acked write's durability needs MTPU_FS_OSYNC and is not asserted.
    crash_sweep(tmp_path, pkg, "lose_entry", _setup_put(OLD), _op_put(NEW),
                _check_versions(NEW, durable=False))
    crash_sweep(tmp_path, pkg, "lose_entry", _setup_put(OLD_INLINE),
                _op_put(NEW_INLINE), _check_versions(NEW_INLINE,
                                                     durable=False))


# -- (a) a streamed PUT, cut inside its shard streams --------------------------
# 1 MiB windows of 64 erasure blocks of 16 KiB make a 3 MiB + 777 B body
# four windows: the per-drive writers stream them from bounded queues of
# pooled rows, and a cut that fires on one drive stops the others'
# streams between two chunks. (The block is 16 KiB, recorded in each
# version as its block size, so that each block's shard hashes as an
# 8 KiB stream on the port's plain CPU hash; the window is still 1 MiB.)

def _op_streamed(es, ctx, clock):
    es.put_object(BKT, KEY, STREAMED)


STREAM_BLOCK = 16 << 10
STREAM_BLOCKS = 64
STREAM_CHUNKS = 2 * STREAM_BLOCKS * 4    # digest and block, 4 windows


@pytest.fixture
def one_mib_windows(monkeypatch):
    for pkg in PKGS:
        eo = PKG[pkg]["eo"]
        monkeypatch.setattr(eo, "BLOCK_SIZE", STREAM_BLOCK)
        monkeypatch.setattr(eo, "STREAM_WINDOW_BLOCKS", STREAM_BLOCKS)
    monkeypatch.setattr(ref_eo, "STREAM_THRESHOLD",
                        STREAM_BLOCK * STREAM_BLOCKS)


@pytest.mark.parametrize("pkg", PKGS)
def test_crash_smoke_streamed_put(tmp_path, pkg, one_mib_windows):
    steps = crash_sweep(tmp_path, pkg, "drop", _setup_put(OLD),
                        _op_streamed, _check_versions(STREAMED), stride=7)
    assert steps >= 3 * N    # a stream and two rename halves a drive


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode", ["drop", "tear"])
def test_crash_matrix_streamed_put(tmp_path, pkg, mode, one_mib_windows):
    crash_sweep(tmp_path, pkg, mode, _setup_put(OLD), _op_streamed,
                _check_versions(STREAMED))


def test_streamed_cut_leaves_its_stream_mid_chunks(tmp_path,
                                                   one_mib_windows):
    """The cut at the last drive's stream (sub-step N: every stream is
    under way) stops the other drives' streams between two chunks: each
    took at least its first chunk and none took all of them (the bounded
    queue of the stream that fired holds the producer back). Every
    pooled row goes back."""
    root = tmp_path / "s"
    es = _mkset("port", root)
    es.make_bucket(BKT)
    es.close()
    taken = []

    class Counting(port_crash.CrashDisk):
        def create_file(self, volume, path, chunks, append=False,
                        sync=True):
            seen = [0]

            def count():
                for c in chunks:
                    seen[0] += 1
                    yield c
            try:
                return super().create_file(volume, path, count(), append,
                                           sync)
            finally:
                taken.append(seen[0])
    leaks0 = _leases()["leaks"]
    clock = port_crash.CrashClock(crash_at=N)
    es = _mkset("port", root, wrap=lambda d: Counting(d, clock, "tear"))
    with pytest.raises(Exception):
        es.put_object(BKT, KEY, STREAMED)
    es.close()
    clock.power_off()
    where = _where(N, "tear", clock)
    assert clock.fired_op == "create_file", where
    assert len(taken) == N and \
        all(1 <= t < STREAM_CHUNKS for t in taken), \
        (where, taken)
    _assert_pool_idle("port", where, leaks0)


# -- (b) four concurrent inline PUTs, one lane batch a drive -------------------

@pytest.fixture
def one_batch_window(monkeypatch):
    # A window long enough that the four members always meet: the batch
    # closes early when every tracked request has a member pending.
    monkeypatch.setenv("MTPU_GROUP_COMMIT_WAIT_MS", "20000")


def _lane_keys():
    return [f"lane{i}" for i in range(4)]


def _setup_lane(pkg, es):
    for k, body in zip(_lane_keys(), LANE_OLD):
        es.put_object(BKT, k, body)
    return {"pkg": pkg}


def _op_lane(es, ctx, clock):
    """Four inline PUTs at once: one batch a drive (WAL frame and four
    journals), each PUT's outcome and each batch's verdict recorded."""
    gc = es.group_commit
    assert gc is not None, "group lanes not wired"
    gc.worth_batching = lambda: True
    acked = ctx["acked"] = [False] * 4
    batches = ctx["batches"] = []
    gate = threading.Barrier(4)
    if ctx["pkg"] == "port":
        # Each drive's batch, as the lanes ran it: members and verdicts.
        orig = gc._run_batch

        def run_batch(lane, batch):
            orig(lane, batch)
            batches.append((lane.idx, [m.exc for m in batch]))
        gc._run_batch = run_batch

    def put(i):
        gate.wait()
        try:
            es.put_object(BKT, _lane_keys()[i], LANE_NEW[i])
            acked[i] = True
        except Exception:  # noqa: BLE001 - the cut
            pass
    threads = [threading.Thread(target=put, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if ctx["pkg"] == "port":
        st = gc.stats()
        ctx["stats"] = st
    if not all(acked):
        raise RuntimeError("a lane member was not acknowledged")


def _check_lane(pkg, es, ctx, completed, where):
    gots = [_get(pkg, es, k) for k in _lane_keys()]
    for i, (k, got) in enumerate(zip(_lane_keys(), gots)):
        if ctx.get("acked", [False] * 4)[i]:
            assert got == LANE_NEW[i], \
                f"{where}: acknowledged lane member {k} lost"
        else:
            assert got in (LANE_OLD[i], LANE_NEW[i]), \
                f"{where}: torn lane member {k}"
    if pkg != "port" or "stats" not in ctx:
        return gots
    st = ctx["stats"]
    if not completed:
        assert st["solo_demotions"] == 0, \
            f"{where}: {st['solo_demotions']} members demoted after a cut"
    if completed:
        assert st["batches"] == N and st["members"] == 4 * N, \
            f"{where}: lanes ran {st['batches']} batches of " \
            f"{st['members']} members"
    for idx, excs in ctx["batches"]:
        if any(isinstance(e, port_local.PowerFault) for e in excs):
            # The batch the cut met acks none of its members.
            assert all(isinstance(e, port_local.PowerFault)
                       for e in excs), \
                f"{where}: drive {idx}'s cut batch acked a member: {excs}"
    return gots


def _lane_sweep(tmp_path, pkg, mode, stride=1):
    return crash_sweep(tmp_path, pkg, mode, _setup_lane, _op_lane,
                       _check_lane, key=_lane_keys()[0], stride=stride)


@pytest.mark.parametrize("pkg", PKGS)
def test_crash_smoke_lane_batch(tmp_path, pkg, one_batch_window):
    steps = _lane_sweep(tmp_path, pkg, "drop", stride=2)
    # A drive's batch: the WAL frame and four journal writes.
    assert steps >= 5 * N


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode", ["drop", "tear", "lose_entry"])
def test_crash_matrix_lane_batch(tmp_path, pkg, mode, one_batch_window):
    if mode == "lose_entry":
        # Durability without directory fsync is MTPU_FS_OSYNC's: only
        # old-or-new is held.
        def check(pkg, es, ctx, completed, where):
            ctx = dict(ctx, acked=[False] * 4)
            return _check_lane(pkg, es, ctx, completed, where)
        crash_sweep(tmp_path, pkg, mode, _setup_lane, _op_lane, check,
                    key=_lane_keys()[0])
        return
    _lane_sweep(tmp_path, pkg, mode)


def test_port_lane_cut_demotes_no_member(tmp_path, one_batch_window):
    """The first cut of a lane batch (the first journal it keeps, ahead
    of its WAL frame, on one drive): that batch's four members all get
    the fault and none rides the solo path."""
    root = tmp_path / "l"
    es = _mkset("port", root)
    es.make_bucket(BKT)
    ctx = _setup_lane("port", es)
    es.close()
    completed, err, clock = _run_cut("port", root, "drop", 1, _op_lane, ctx)
    where = _where(1, "drop", clock)
    assert not completed and clock.fired_op == "keep_prev.link", where
    cut = [excs for _, excs in ctx["batches"]
           if any(isinstance(e, port_local.PowerFault) for e in excs)]
    assert cut and all(len(excs) == 4 for excs in cut), (where, cut)
    assert ctx["stats"]["solo_demotions"] == 0, where
    assert not any(ctx["acked"]), where


# -- pool migration (object/decom.migrate_key) ---------------------------------
# Snapshot the source stack, restore every version into the destination
# pool, then verify and delete the source copies under the key lock. A cut
# at any durable sub-step must leave the key neither lost nor torn nor
# listed twice, and the re-run migration (the checkpointed resume)
# converges: source empty, destination complete.

MIG_DEP = "00000000-0000-0000-0000-000000000e1a"
MIG_V1 = _rng.bytes(3_000)


def _mk_layer(pkg, root, wrap=None):
    """Two pools (source pool 0, destination pool 1) over one clock; a
    fixed deployment id keeps a key's set across remounts."""
    pools = []
    for p in ("src", "dst"):
        disks = [PKG[pkg]["local"].LocalStorage(str(root / p / f"d{i}"))
                 for i in range(N)]
        if wrap is not None:
            disks = [wrap(d) for d in disks]
        pools.append(PKG[pkg]["sets"]([PKG[pkg]["mkset"](disks)],
                                      deployment_id=MIG_DEP))
    return PKG[pkg]["pools"](pools)


def _drain_layer(lay) -> None:
    for pool in lay.pools:
        for s in pool.sets:
            if s._mrf is not None:
                s._mrf.drain(15)


def migrate_sweep(tmp_path, pkg, mode, versioned=False, max_points=400,
                  stride=1):
    """The crash sweep over migrate_key, on a source pool marked
    draining (reads resolve destination first, and the destination holds
    the whole stack before any source delete runs). lose_entry keeps the
    torn and listed-twice checks but not durability: the destination's
    journal entry may be voided while later source deletes stand."""
    strict = mode != "lose_entry"
    crash = PKG[pkg]["crash"]
    decom = PKG[pkg]["decom"]
    opts = PKG[pkg]["put"]
    leaks0 = _leases()["leaks"]
    n = 1
    while n <= max_points:
        root = tmp_path / f"mig-{pkg}-{mode}-{n}"
        lay = _mk_layer(pkg, root)
        lay.make_bucket(BKT)
        if versioned:
            lay.pools[0].put_object(BKT, KEY, MIG_V1, opts(versioned=True))
            lay.pools[0].put_object(BKT, KEY, OLD, opts(versioned=True))
        else:
            lay.pools[0].put_object(BKT, KEY, OLD)
        lay.close()

        clock = crash.CrashClock(crash_at=n)
        lay2 = _mk_layer(pkg, root,
                         wrap=lambda d: crash.CrashDisk(d, clock, mode))
        lay2.decommissioning.add(0)
        completed, err = False, None
        try:
            decom.migrate_key(lay2, 0, BKT, KEY, lambda: 1)
            completed = True
        except Exception as e:  # noqa: BLE001 - PowerCut, quorum faults
            err = e
        lay2.close()
        _power_off(clock)
        if not clock.fired:
            assert completed, f"{pkg}: migrate failed uncut: {err!r}"
        where = f"{pkg} {_where(n, mode, clock)}"
        for p in ("src", "dst"):
            sub = root / p
            if pkg == "port":
                rep = recover_drives(_disks(pkg, sub))
                assert rep["swept"] == N, f"{where}: shallow recovery"
            else:
                for d in _disks(pkg, sub):
                    ref_local.recovery_sweep(d, min_age=0)
        lay3 = _mk_layer(pkg, root)
        lay3.decommissioning.add(0)
        try:
            nvers = 2 if versioned else 1

            def check(tag):
                w = f"{where} {tag}"
                try:
                    got = lay3.get_object(BKT, KEY)[1]
                except PKG[pkg]["notfound"]:
                    got = None
                if got is not None:
                    assert got == OLD, f"{w}: object torn"
                else:
                    assert not strict, f"{w}: object lost"
                page = lay3.list_objects(BKT, max_keys=10,
                                         include_versions=True)
                vkeys = [(o.name, o.version_id) for o in page.objects]
                assert len(vkeys) == len(set(vkeys)), \
                    f"{w}: listed twice: {vkeys}"
                if strict:
                    assert len(vkeys) == nvers, f"{w}: {vkeys}"
                if versioned and strict:
                    oldest = min(page.objects, key=lambda o: o.mod_time)
                    v1 = lay3.get_object(BKT, KEY, PKG[pkg]["get"](
                        version_id=oldest.version_id))[1]
                    assert v1 == MIG_V1, f"{w}: old version torn"
                return got, sorted(vkeys)

            before = check("remounted")
            for pool in lay3.pools:
                try:
                    pool.heal_object(BKT, KEY)
                except (PKG[pkg]["notfound"], PKG[pkg]["vnotfound"]):
                    pass        # a pool without the key
            assert check("healed") == before, \
                f"{where}: the heals moved the answer"
            decom.migrate_key(lay3, 0, BKT, KEY, lambda: 1)
            check("resumed")
            src = lay3.pools[0].list_objects(BKT, max_keys=10,
                                             include_versions=True)
            assert not src.objects, \
                f"{where}: source copies survived the resumed migration"
            _drain_layer(lay3)
        finally:
            lay3.close()
        _assert_no_garbage([root / p / f"d{i}" for p in ("src", "dst")
                            for i in range(N)], where)
        _assert_pool_idle(pkg, where, leaks0)
        shutil.rmtree(root, ignore_errors=True)
        if not clock.fired:
            return clock.count
        n += stride
    raise AssertionError(f"{pkg}: migrate never completed in {max_points}")


@pytest.mark.parametrize("pkg", PKGS)
def test_crash_smoke_migrate_key(tmp_path, pkg):
    steps = migrate_sweep(tmp_path, pkg, "drop", stride=2)
    # At least the restore commit on each destination drive and the
    # delete on each source drive.
    assert steps >= 2 * N


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode", ["drop", "tear"])
def test_crash_matrix_migrate_key(tmp_path, pkg, mode):
    migrate_sweep(tmp_path, pkg, mode)


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode", ["drop", "tear"])
def test_crash_matrix_migrate_key_versioned(tmp_path, pkg, mode):
    migrate_sweep(tmp_path, pkg, mode, versioned=True)


@pytest.mark.slow
@pytest.mark.parametrize("pkg", PKGS)
def test_crash_matrix_migrate_key_lose_entry(tmp_path, pkg):
    migrate_sweep(tmp_path, pkg, "lose_entry")


# -- (c) remounts across the packages ------------------------------------------

def _journals(root):
    for dirpath, _dirs, files in os.walk(root):
        if "xl.meta" in files and SYS_VOL not in dirpath:
            yield os.path.join(dirpath, "xl.meta")


def _jax_to_port(drives) -> None:
    """Re-encode every JAX journal on the drives as the port's."""
    for d in drives:
        for p in _journals(d):
            with open(p, "rb") as f:
                r = ref_meta.XLMeta.load(f.read())
            x = port_meta.from_reference_map({"versions": r.versions,
                                              "inline": r.inline})
            with open(p, "wb") as f:
                f.write(x.dump())


def _port_to_jax(drives) -> None:
    """Re-encode every port journal on the drives as the JAX package's:
    the same version maps and inline bytes."""
    for d in drives:
        for p in _journals(d):
            with open(p, "rb") as f:
                x = port_meta.XLMeta.load(f.read())
            r = ref_meta.XLMeta()
            r.versions = [dict(v) for v in x.versions]
            r.inline = dict(x.inline)
            with open(p, "wb") as f:
                f.write(r.dump())


def _answer(pkg, root, key=KEY):
    """GET through a fresh set with the MRF closed (a degraded read
    must not change the drives before the other package reads them)."""
    es = _mkset(pkg, root)
    es._mrf_closed = True
    try:
        return _get(pkg, es, key)
    finally:
        es.close()


def cross_sweep(tmp_path, cutter, mode, setup, op, new, stride=1,
                max_points=400):
    """`cutter`'s CrashDisk cuts `op` at each point and `cutter` remounts;
    then the other package remounts the same drives (journals
    re-encoded) and must give the cutter's answer, hold the invariants
    and converge under its own heals."""
    reader = "port" if cutter == "jax" else "jax"
    check = _check_versions(new)
    convert = _jax_to_port if cutter == "jax" else _port_to_jax
    leaks0 = _leases()["leaks"]
    n = 1
    while n <= max_points:
        root = tmp_path / f"x-{cutter}-{mode}-{n}"
        es = _mkset(cutter, root)
        es.make_bucket(BKT)
        ctx = setup(cutter, es) or {}
        es.close()
        completed, _, clock = _run_cut(cutter, root, mode, n, op, ctx)
        where = f"cut by {cutter}, read by {reader}: " \
            f"{_where(n, mode, clock)}"
        _remount(cutter, root, where)
        _assert_no_live_wal(root, where)
        want = _answer(cutter, root)
        _verdict(want, new, ctx, completed, where)
        drives = [root / f"d{i}" for i in range(N)]
        convert(drives)
        heal = _remount(reader, root, where)
        got = _answer(reader, root)
        assert got == want, \
            f"{where}: the {reader} remount answers " \
            f"{None if got is None else len(got)} bytes, the {cutter} " \
            f"remount {None if want is None else len(want)}"
        es3 = _mkset(reader, root)
        try:
            _settle(reader, es3, heal, KEY,
                    lambda es, w: check(reader, es, ctx, completed, w),
                    where)
        finally:
            es3.close()
        _assert_no_garbage(drives, where)
        _assert_pool_idle("port", where, leaks0)
        shutil.rmtree(root, ignore_errors=True)
        if not clock.fired:
            return clock.count
        n += stride
    raise AssertionError(f"op never completed in {max_points} points")


@pytest.mark.parametrize("cutter", ["jax", "port"])
def test_crash_smoke_cross_package_remount(tmp_path, cutter):
    if cutter == "jax":
        steps = cross_sweep(tmp_path, "jax", "drop", _setup_put(OLD),
                            _op_put(NEW), NEW, stride=3)
    else:
        steps = cross_sweep(tmp_path, "port", "drop",
                            _setup_put(OLD_INLINE), _op_put(NEW_INLINE),
                            NEW_INLINE, stride=2)
    assert steps >= N


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["drop", "tear"])
@pytest.mark.parametrize("cutter,old,new", [
    ("jax", OLD, NEW), ("jax", OLD_INLINE, NEW_INLINE),
    ("port", OLD_INLINE, NEW_INLINE), ("port", OLD, NEW)],
    ids=["jax-put", "jax-inline", "port-inline", "port-put"])
def test_crash_matrix_cross_package_remount(tmp_path, cutter, old, new,
                                            mode):
    cross_sweep(tmp_path, cutter, mode, _setup_put(old), _op_put(new), new)


# -- the seam with no hook changes no byte ---------------------------------------

T0 = 1_700_000_000_000_000_000


def _seam_fis(pkg, rng_seed=7):
    meta = ref_meta if pkg == "jax" else port_meta
    rng = np.random.default_rng(rng_seed)
    out = []
    for i, key in enumerate(("k1", "k2", "k1", "k3")):
        body = rng.bytes(int(rng.integers(16, 300)))
        out.append((key, meta.FileInfo(
            volume=BKT, name=key, version_id="", data_dir="",
            mod_time=T0 + i, size=len(body), metadata={"etag": f"e{i}"},
            parts=[meta.ObjectPartInfo(number=1, size=len(body),
                                       actual_size=len(body))],
            erasure=meta.ErasureInfo(data_blocks=2, parity_blocks=1,
                                     block_size=1 << 20, index=1,
                                     distribution=(1, 2, 3)),
            inline_data=body)))
    return out


class _NoCut:
    """A hook that records each seam call and never cuts."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def step(*args, **kwargs):
            self.calls.append(name)
            return None
        return step


def _wal_records(pkg, drive):
    gdir = os.path.join(drive.root, SYS_VOL, "gcommit")
    recs = []
    for name in sorted(os.listdir(gdir)):
        with open(os.path.join(gdir, name), "rb") as f:
            blob = f.read()
        for _t, rs in PKG[pkg]["gc"].iter_frames(blob):
            recs.extend(rs)
    return recs


def _as_port(pkg, blob):
    if pkg == "port":
        x = port_meta.XLMeta.load(blob)
    else:
        r = ref_meta.XLMeta.load(blob)
        x = port_meta.from_reference_map({"versions": r.versions,
                                          "inline": r.inline})
    return x.versions, x.inline


def test_seam_without_hook_writes_the_same_bytes(tmp_path):
    """commit_group, _gc_append_wal and gc_checkpoint with _hook=None
    write what they write with a hook that never cuts, byte for byte;
    the journals and the WAL frame's records decode to what the JAX
    package writes for the same ops; the checkpoint empties every WAL."""
    drives = {}
    for name, hook in (("none", None), ("nocut", _NoCut())):
        d = port_local.LocalStorage(str(tmp_path / f"port-{name}"))
        d._gc_auto = False
        os.makedirs(os.path.join(d.root, BKT))
        res = d.commit_group([port_gc.GroupOp.write_meta(BKT, k, fi)
                              for k, fi in _seam_fis("port")], _hook=hook)
        assert res == [None] * 4
        drives[name] = (d, hook)
    ref = ref_local.LocalStorage(str(tmp_path / "jax"))
    ref._gc_auto = False
    os.makedirs(os.path.join(ref.root, BKT))
    assert ref.commit_group([ref_gc.GroupOp.write_meta(BKT, k, fi)
                             for k, fi in _seam_fis("jax")]) == [None] * 4

    plain, _ = drives["none"]
    hooked, hook = drives["nocut"]
    assert hook.calls == ["step_wal", "note_wal", "step_rename",
                          "meta_prior", "note_rename", "step_rename",
                          "meta_prior", "note_rename", "step_rename",
                          "meta_prior", "note_rename"]
    for key in ("k1", "k2", "k3"):
        a = open(os.path.join(plain.root, BKT, key, "xl.meta"), "rb").read()
        b = open(os.path.join(hooked.root, BKT, key, "xl.meta"),
                 "rb").read()
        r = open(os.path.join(ref.root, BKT, key, "xl.meta"), "rb").read()
        assert a == b, key
        assert _as_port("port", a) == _as_port("jax", r), key
    recs = {name: _wal_records("port", d) for name, (d, _) in drives.items()}
    assert recs["none"] == recs["nocut"]
    ref_recs = _wal_records("jax", ref)
    assert [(v, p) for v, p, _ in recs["none"]] == \
        [(v, p) for v, p, _ in ref_recs] == \
        [(BKT, "k1"), (BKT, "k2"), (BKT, "k3")]
    for (_, _, a), (_, _, r) in zip(recs["none"], ref_recs):
        assert _as_port("port", a) == _as_port("jax", r)
    sizes = {name: os.path.getsize(os.path.join(
        d.root, SYS_VOL, "gcommit", os.listdir(os.path.join(
            d.root, SYS_VOL, "gcommit"))[0])) for name, (d, _) in
        drives.items()}
    assert sizes["none"] == sizes["nocut"] > 0
    sync_hook = _NoCut()
    assert plain.gc_checkpoint() == 1
    assert hooked.gc_checkpoint(_hook=sync_hook) == 1
    assert sync_hook.calls == ["step_sync"]
    assert ref.gc_checkpoint() == 1
    for d in (plain, hooked, ref):
        assert _wal_records("port" if d is not ref else "jax", d) == []
        d.gc_close()


def test_crashdisk_imports_no_reference_package():
    """The port's double stands alone: no jax, no msgpack, nothing of
    minio_tpu."""
    import ast
    src = open(port_crash.__file__).read()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "msgpack", "minio_tpu"}, names


def test_closed_set_mrf_queue_runs_no_heal(tmp_path):
    """A set whose MRF queue is closed before its first use gets a queue
    born stopped: a persisted heal of the key a degraded GET is reading
    stays pending, and the GET does not wait on it. (A queue started and
    then stopped took the entry, its heal waited for the key lock the
    GET held, and the GET's stop() waited out the 60 s lock timeout.)"""
    import json
    from minio_tpu_torch.object.healing import MRF_PATH
    root = tmp_path / "m"
    es = _mkset("port", root)
    es.make_bucket(BKT)
    es.put_object(BKT, KEY, OLD)
    es.close()
    for d in _disks("port", root):
        d.write_all(SYS_VOL, MRF_PATH,
                    json.dumps([{"b": BKT, "o": KEY, "v": ""}]).encode())
    shutil.rmtree(root / "d1" / BKT / KEY)      # the GET is degraded
    es = _mkset("port", root)
    es._mrf_closed = True
    try:
        t0 = time.monotonic()
        assert _get("port", es) == OLD
        assert time.monotonic() - t0 < 10
        q = es._mrf
        assert q is not None and q._worker.ident is None
        assert q.stats()["pending"] == 1 and q.healed == 0
    finally:
        es.close()


# -- an overwrite cut on twelve drives (EC 8+4) ------------------------------
# With 4 drives every split of a cut commit leaves read quorum (2) on one
# side. With 12 a cut after 5 to 7 drives' commits leaves 8 on neither,
# and each drive that committed had dropped the version it replaced: the
# old object was gone and the new one incomplete. The port keeps each
# replaced journal (PREV_FILE) until write quorum is known and settles it
# after; a read that finds no quorum settles what a cut left
# (ErasureSet._settle_prevs). Port only: the JAX package's solo commits
# (minio_tpu/storage/local.py `rename_data`, `write_metadata`) drop the
# replaced version at once, and its reads then fail at these points.

# 8 data shards: a body of 20 KiB makes shard files past the 2 KiB
# inline limit.
OLD12 = _rng.bytes(20 * 1024 + 17)
NEW12 = _rng.bytes(21 * 1024 + 5)
TWELVE = {"put": (OLD12, NEW12, 3 * 12), "inline": (OLD_INLINE, NEW_INLINE,
                                                    2 * 12)}


@pytest.mark.parametrize("body", ["put", "inline"])
def test_crash_smoke_twelve_drive_overwrite(tmp_path, monkeypatch, body):
    monkeypatch.setitem(globals(), "N", 12)
    old, new, least = TWELVE[body]
    # Every fourth point: each side of the split, the points where no
    # side holds 8 among them.
    steps = crash_sweep(tmp_path, "port", "drop", _setup_put(old),
                        _op_put(new), _check_versions(new), stride=4)
    assert steps >= least


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["drop", "tear", "lose_entry"])
@pytest.mark.parametrize("body", ["put", "inline"])
def test_crash_matrix_twelve_drive_overwrite(tmp_path, monkeypatch, mode,
                                             body):
    monkeypatch.setitem(globals(), "N", 12)
    old, new, _ = TWELVE[body]
    crash_sweep(tmp_path, "port", mode, _setup_put(old), _op_put(new),
                _check_versions(new, durable=mode != "lose_entry"))


# -- the other journal-replacing commits on twelve drives --------------------
# The lanes' batches, a multipart completion and restore_version (the
# write of every rebalance and decommission) replace a journal as an
# overwriting PUT does. Each keeps the replaced journal until write
# quorum is known, so the same split is held at every cut. A copy
# commits through put_object, which the overwrite cases above cover.
# Port only, as above: the JAX package fails these points.


@pytest.mark.parametrize("mode", ["drop", "tear"])
def test_crash_smoke_twelve_drive_lane_batch(tmp_path, monkeypatch, mode,
                                             one_batch_window):
    """Four concurrent inline overwrites, one lane batch a drive."""
    monkeypatch.setitem(globals(), "N", 12)
    steps = _lane_sweep(tmp_path, "port", mode, stride=5)
    # A drive's batch: four kept journals, the WAL frame, four journals.
    assert steps >= 9 * 12


def test_crash_smoke_twelve_drive_multipart(tmp_path, monkeypatch):
    """A multipart completion over an existing key."""
    monkeypatch.setitem(globals(), "N", 12)
    steps = crash_sweep(tmp_path, "port", "drop",
                        _with_pkg(_setup_put(OLD12)), _op_multipart,
                        _check_versions(NEW), stride=5)
    assert steps >= 3 * 12


def _op_restore(body):
    """restore_version of a null version over the existing one: a
    version with data (shard files, rename_data), or a null delete
    marker (journal only, write_metadata)."""
    def op(es, ctx, clock):
        meta = port_meta if ctx.get("pkg", "port") == "port" else ref_meta
        fi = meta.FileInfo(volume=BKT, name=KEY, version_id="",
                           mod_time=time.time_ns())
        if body is None:
            fi.deleted = True
        else:
            etag = hashlib.md5(body).hexdigest()
            fi.size, fi.metadata = len(body), {"etag": etag}
            fi.parts = [meta.ObjectPartInfo(
                number=1, size=len(body), actual_size=len(body), etag=etag)]
        es.restore_version(BKT, KEY, fi, body)
    return op


@pytest.mark.parametrize("body", ["data", "marker"])
def test_crash_smoke_twelve_drive_restore_version(tmp_path, monkeypatch,
                                                  body):
    monkeypatch.setitem(globals(), "N", 12)
    new = NEW12 if body == "data" else None
    steps = crash_sweep(tmp_path, "port", "drop",
                        _with_pkg(_setup_put(OLD12)), _op_restore(new),
                        _check_versions(new, deletable=new is None),
                        stride=5)
    assert steps >= 2 * 12


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["drop", "tear"])
@pytest.mark.parametrize("case", ["lane", "multipart", "restore",
                                  "restore_marker"])
def test_crash_matrix_twelve_drive_commit_paths(tmp_path, monkeypatch, mode,
                                                case):
    monkeypatch.setitem(globals(), "N", 12)
    monkeypatch.setenv("MTPU_GROUP_COMMIT_WAIT_MS", "20000")
    if case == "lane":
        _lane_sweep(tmp_path, "port", mode)
    elif case == "multipart":
        crash_sweep(tmp_path, "port", mode, _with_pkg(_setup_put(OLD12)),
                    _op_multipart, _check_versions(NEW))
    else:
        new = NEW12 if case == "restore" else None
        crash_sweep(tmp_path, "port", mode, _with_pkg(_setup_put(OLD12)),
                    _op_restore(new),
                    _check_versions(new, deletable=new is None))


class _HeldCommit:
    """A drive whose solo rename_data waits on `gate` (when `hold`), and
    counts the ones that went through in `done`."""

    def __init__(self, disk, hold: bool, gate, done):
        self._disk, self._hold, self._gate, self._done = \
            disk, hold, gate, done

    def rename_data(self, *args, **kwargs):
        if self._hold:
            assert self._gate.wait(30), "the held commit was never let go"
        out = self._disk.rename_data(*args, **kwargs)
        self._done.release()
        return out

    def __getattr__(self, name):
        return getattr(self._disk, name)


def test_unlocked_reads_during_a_split_commit_change_no_drive(
        tmp_path, monkeypatch):
    """An overwrite on 12 drives (EC 8+4, read quorum 8) is held with 6
    drives committed and 6 not: the drives stand 6 new against 6 old. A
    HEAD and a listing, which take no key lock, read the split then; they
    must not settle it (only the key's write lock may). Once the held
    commits go on, the PUT is acknowledged, and the new object reads
    back, also after a remount."""
    from minio_tpu_torch.object.types import ReadQuorumError
    monkeypatch.setitem(globals(), "N", 12)
    root = tmp_path / "split"
    es = _mkset("port", root)
    es.make_bucket(BKT)
    es.put_object(BKT, KEY, OLD12)
    es.close()
    gate, done = threading.Event(), threading.Semaphore(0)
    held = tuple(os.sep + f"d{i}" for i in range(6))
    es = _mkset("port", root, wrap=lambda d: _HeldCommit(
        d, d.root.endswith(held), gate, done))
    out = {}

    def put():
        try:
            es.put_object(BKT, KEY, NEW12)
            out["acked"] = True
        except Exception as e:  # noqa: BLE001 - reported below
            out["err"] = e

    t = threading.Thread(target=put)
    t.start()
    try:
        for _ in range(6):
            assert done.acquire(timeout=30), "6 drives never committed"
        try:
            es.get_object_info(BKT, KEY)
        except ReadQuorumError:
            pass                # no quorum while the drives stand split
        es.list_objects(BKT)
    finally:
        gate.set()
        t.join(60)
    assert out.get("acked"), f"the PUT failed: {out.get('err')!r}"
    assert _get("port", es) == NEW12, "the acknowledged PUT reads back wrong"
    es.close()
    _remount("port", root, "split")
    es = _mkset("port", root)
    try:
        assert _get("port", es) == NEW12, \
            "the acknowledged PUT was lost after a remount"
    finally:
        es.close()
