"""The port's group-commit write plane against the JAX package's, on the
CPU.

Each case of tests/test_group_commit.py runs on a drive (or set) of
each package with the same operations, FileInfos built from one numpy
seed: the batched commit protocol (`commit_group`: byte identity with
the solo path inside each package, same-object merge order, member
isolation, rename_data members, the no-op short circuit), the WAL
(torn destinations repaired, lost renames installed, newer journals and
deleted objects left alone, torn tails of any length discarded, the
guarded checkpoint truncate, recovery_sweep replaying first), and the
lanes (coalescing of concurrent inline PUTs and delete markers, the
solo bypass, deadline culls, solo demotion, the bump before the ack,
MTPU_GROUP_COMMIT=off, and the port's own rule that a busy lane holds
its next batch, which the JAX package's lanes lack). The journals differ in format (JSON against
msgpack), so outcomes compare as decoded fields: the JAX package's
journal goes through `storage.meta.from_reference_map` and must equal
the port's version maps and inline bytes; replay reports, batch
accounting, listings and GET bytes compare as they are. The JAX case
`test_workers_coalesced_bump_coherence` needs the pre-forked worker
fleet, which the port does not have yet (ROADMAP). Tolerance: none.
"""

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.object.types import DeleteOptions as RefDelete
from minio_tpu.object.types import ObjectNotFound as RefNotFound
from minio_tpu.storage import group_commit as ref_gc
from minio_tpu.storage import local as ref_local
from minio_tpu.storage import meta as ref_meta
from minio_tpu.utils.deadline import DeadlineExceeded as RefDeadline

from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.types import DeleteOptions, ObjectNotFound
from minio_tpu_torch.storage import group_commit as port_gc
from minio_tpu_torch.storage import local as port_local
from minio_tpu_torch.storage import meta as port_meta
from minio_tpu_torch.utils.deadline import DeadlineExceeded

BKT = "b"
PKG = {
    "r": dict(gc=ref_gc, local=ref_local, meta=ref_meta, set=RefSet,
              delete=RefDelete, notfound=RefNotFound, deadline=RefDeadline),
    "p": dict(gc=port_gc, local=port_local, meta=port_meta, set=ErasureSet,
              delete=DeleteOptions, notfound=ObjectNotFound,
              deadline=DeadlineExceeded),
}
SYS_VOL = port_local.SYS_VOL
assert SYS_VOL == ref_local.SYS_VOL


def mkdisk(pkg, tmp_path, name="d0"):
    d = PKG[pkg]["local"].LocalStorage(str(tmp_path / f"{pkg}-{name}"))
    os.makedirs(os.path.join(d.root, BKT), exist_ok=True)
    return d


def mkfi(pkg, key, mod_time, vid="", data=b"x" * 64, deleted=False,
         ddir=""):
    """The same FileInfo in either package."""
    m = PKG[pkg]["meta"]
    return m.FileInfo(
        volume=BKT, name=key, version_id=vid, deleted=deleted,
        data_dir=ddir, mod_time=mod_time, size=len(data),
        metadata={"etag": "e"},
        parts=[m.ObjectPartInfo(number=1, size=len(data),
                                actual_size=len(data))],
        erasure=m.ErasureInfo(data_blocks=2, parity_blocks=1,
                              block_size=1 << 20, index=1,
                              distribution=(1, 2, 3)),
        inline_data=None if deleted else data)


def read_xl(d, key):
    with open(os.path.join(d.root, BKT, key, "xl.meta"), "rb") as f:
        return f.read()


def decoded(pkg, blob):
    """A journal of either package as the port's (version maps, inline
    bytes)."""
    if pkg == "p":
        x = port_meta.XLMeta.load(blob)
    else:
        r = ref_meta.XLMeta.load(blob)
        x = port_meta.from_reference_map({"versions": r.versions,
                                          "inline": r.inline})
    return x.versions, x.inline


def both(fn):
    """fn(pkg) for each package; the two outcomes."""
    return fn("r"), fn("p")


def same_journals(disks, keys):
    for k in keys:
        assert decoded("p", read_xl(disks["p"], k)) == \
            decoded("r", read_xl(disks["r"], k)), k


T0 = 1_700_000_000_000_000_000


# ---------------------------------------------------------------------------
# commit_group protocol
# ---------------------------------------------------------------------------

def test_batched_vs_solo_byte_identity(tmp_path):
    """One batch over fresh keys, overwrites, versions, a delete marker
    and a pre-existing journal gives journals byte-identical to the same
    ops applied solo, in each package; the port's decode equals the JAX
    package's."""
    rng = np.random.default_rng(1)
    bodies = [rng.bytes(int(rng.integers(1, 200))) for _ in range(7)]
    spec = [("k1", 0, "", 0), ("k2", 1, "", 1), ("k1", 2, "", 2),
            ("k3", 3, "11111111-0000-0000-0000-000000000001", 3),
            ("k3", 4, "11111111-0000-0000-0000-000000000002", 4),
            ("k2", 5, "", None), ("k4", 6, "", 5)]
    batched = {}

    def run(pkg):
        da, db = mkdisk(pkg, tmp_path, "da"), mkdisk(pkg, tmp_path, "db")
        for d in (da, db):
            d.write_metadata(BKT, "k4", mkfi(pkg, "k4", T0 - 5,
                                             data=bodies[6]))
        fis = [(k, mkfi(pkg, k, T0 + dt, vid=vid,
                        data=b"" if bi is None else bodies[bi],
                        deleted=bi is None)) for k, dt, vid, bi in spec]
        g = PKG[pkg]["gc"]
        res = da.commit_group([g.GroupOp.write_meta(BKT, k, fi)
                               for k, fi in fis])
        for k, fi in fis:
            db.write_metadata(BKT, k, fi)
        for k in ("k1", "k2", "k3", "k4"):
            assert read_xl(da, k) == read_xl(db, k), (pkg, k)
        batched[pkg] = da
        return res
    assert both(run) == ([None] * 7, [None] * 7)
    same_journals(batched, ("k1", "k2", "k3", "k4"))


def test_same_object_merge_ordering(tmp_path):
    """Same-object members merge in arrival order into ONE journal
    rewrite: the last null-version member wins."""
    disks, infos = {}, {}

    def run(pkg):
        d = disks[pkg] = mkdisk(pkg, tmp_path)
        g = PKG[pkg]["gc"]
        ops = [g.GroupOp.write_meta(BKT, "hot", mkfi(
            pkg, "hot", T0 + i, data=bytes([i]) * 32)) for i in range(5)]
        infos[pkg] = {}
        return d.commit_group(ops, _info=infos[pkg])
    assert both(run) == ([None] * 5, [None] * 5)
    assert infos["p"] == infos["r"]
    assert (infos["p"]["objects"], infos["p"]["merged"]) == (1, 4)
    same_journals(disks, ["hot"])
    versions, inline = decoded("p", read_xl(disks["p"], "hot"))
    assert len(versions) == 1 and inline["null"] == bytes([4]) * 32


def test_member_failure_isolation(tmp_path):
    """A rename_data member whose staging is missing fails alone; its
    batch-mates commit."""
    def run(pkg):
        d = mkdisk(pkg, tmp_path)
        g = PKG[pkg]["gc"]
        res = d.commit_group([
            g.GroupOp.write_meta(BKT, "ok1", mkfi(pkg, "ok1", T0)),
            g.GroupOp.rename("nosuchvol", "missing",
                             mkfi(pkg, "broken", T0, ddir="0" * 8), BKT,
                             "broken"),
            g.GroupOp.write_meta(BKT, "ok2", mkfi(pkg, "ok2", T0))])
        return ([r is None for r in res],
                [os.path.exists(os.path.join(d.root, BKT, k, "xl.meta"))
                 for k in ("ok1", "broken", "ok2")])
    ref, port = both(run)
    assert port == ref == ([True, False, True], [True, False, True])


def test_rename_data_members_batch(tmp_path):
    """rename_data members move their staged data dirs in and the
    journal names them, as solo rename_data does; staging is cleared."""
    disks = {}

    def run(pkg):
        da, db = mkdisk(pkg, tmp_path, "da"), mkdisk(pkg, tmp_path, "db")
        for d in (da, db):
            os.makedirs(os.path.join(d.root, SYS_VOL, "stage", "dd1"))
            with open(os.path.join(d.root, SYS_VOL, "stage", "dd1",
                                   "part.1"), "wb") as f:
                f.write(b"shard")
        fa, fb = (mkfi(pkg, "rk", T0, ddir="dd1", data=b"")
                  for _ in range(2))
        fa.inline_data = fb.inline_data = None
        res = da.commit_group([PKG[pkg]["gc"].GroupOp.rename(
            SYS_VOL, "stage", fa, BKT, "rk")])
        db.rename_data(SYS_VOL, "stage", fb, BKT, "rk")
        assert read_xl(da, "rk") == read_xl(db, "rk")
        disks[pkg] = da
        return (res, os.path.isfile(os.path.join(da.root, BKT, "rk", "dd1",
                                                 "part.1")),
                os.path.exists(os.path.join(da.root, SYS_VOL, "stage")))
    ref, port = both(run)
    assert port == ref == ([None], True, False)
    same_journals(disks, ["rk"])


def test_kept_batch_names_what_its_settle_reclaims(tmp_path):
    """A lane batch that keeps the journal it replaces (keep_prev) names
    the data dirs only that journal holds (`_info["kept"]`), so its
    settle reads no journal; kept or put back, the drive ends as the
    settle that parses both journals leaves it."""
    def stage(d, ddir):
        os.makedirs(os.path.join(d.root, SYS_VOL, "stage", ddir))
        with open(os.path.join(d.root, SYS_VOL, "stage", ddir, "part.1"),
                  "wb") as f:
            f.write(ddir.encode())

    def tree(d):
        top = os.path.join(d.root, BKT)
        return sorted(os.path.relpath(os.path.join(r, f), top)
                      for r, _, fs in os.walk(top) for f in fs)

    for keep in (True, False):
        ends = []
        for hinted in (True, False):
            d = mkdisk("p", tmp_path, f"k{keep}-{hinted}")
            for t, ddir in enumerate(("dd1", "dd2")):
                stage(d, ddir)
                fi = mkfi("p", "rk", T0 + t, ddir=ddir, data=b"")
                fi.inline_data = None
                info = {}
                res = d.commit_group([port_gc.GroupOp.rename(
                    SYS_VOL, "stage", fi, BKT, "rk")], _info=info,
                    keep_prev=True)
                assert res == [None]
            # The second commit replaced the null version held in dd1.
            assert info["kept"] == {(BKT, "rk"): ["dd1"]}
            gone = info["kept"][(BKT, "rk")] if hinted else None
            assert d.settle_prevs([(BKT, "rk", keep, gone)]) == [None]
            ends.append((tree(d), read_xl(d, "rk")))
        assert ends[0] == ends[1]
        assert ends[0][0] == ["rk/dd2/part.1", "rk/xl.meta"] if keep \
            else ["rk/dd1/part.1", "rk/xl.meta"]


def test_noop_short_circuit_solo_and_batched(tmp_path):
    """A byte-identical re-add rewrites no journal, solo or batched."""
    infos = {}

    def run(pkg):
        d = mkdisk(pkg, tmp_path)
        fi = mkfi(pkg, "nk", T0)
        d.write_metadata(BKT, "nk", fi)
        p = os.path.join(d.root, BKT, "nk", "xl.meta")
        st0 = os.stat(p).st_mtime_ns
        d.write_metadata(BKT, "nk", fi)
        solo_same = os.stat(p).st_mtime_ns == st0
        infos[pkg] = {}
        res = d.commit_group([PKG[pkg]["gc"].GroupOp.write_meta(
            BKT, "nk", fi)], _info=infos[pkg])
        return res, solo_same, os.stat(p).st_mtime_ns == st0
    ref, port = both(run)
    assert port == ref == ([None], True, True)
    assert infos["p"] == infos["r"] and infos["p"]["noops"] == 1


# ---------------------------------------------------------------------------
# WAL replay
# ---------------------------------------------------------------------------

def _wal_with(pkg, d, recs, t_ns=None):
    g = PKG[pkg]["gc"]
    path = g.wal_file_path(d.root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "ab") as f:
        f.write(g.encode_frame(recs, t_ns=t_ns))
    return path


def test_replay_repairs_torn_destination(tmp_path):
    disks = {}

    def run(pkg):
        d = disks[pkg] = mkdisk(pkg, tmp_path)
        g = PKG[pkg]["gc"]
        assert d.commit_group([g.GroupOp.write_meta(
            BKT, "rw", mkfi(pkg, "rw", T0))]) == [None]
        blob = read_xl(d, "rw")
        _wal_with(pkg, d, [(BKT, "rw", blob)], t_ns=time.time_ns())
        with open(os.path.join(d.root, BKT, "rw", "xl.meta"), "wb") as f:
            f.write(blob[:len(blob) // 2])
        rep = g.replay_wals(d)
        d.gc_close()
        return (rep, read_xl(d, "rw") == blob,
                os.listdir(os.path.join(d.root, SYS_VOL, g.GC_DIR)))
    ref, port = both(run)
    assert port == ref
    assert port[0]["repaired"] == 1 and port[1] and port[2] == []
    same_journals(disks, ["rw"])


def test_replay_installs_when_rename_lost(tmp_path):
    """A destination older than the frame: the acked journal installs."""
    disks = {}

    def run(pkg):
        d = disks[pkg] = mkdisk(pkg, tmp_path)
        m = PKG[pkg]["meta"]
        d.write_metadata(BKT, "rl", mkfi(pkg, "rl", T0))
        xl = m.XLMeta.load(read_xl(d, "rl"))
        xl.add_version(mkfi(pkg, "rl", T0 + 10, data=b"new" * 8))
        new_blob = xl.dump()
        _wal_with(pkg, d, [(BKT, "rl", new_blob)],
                  t_ns=time.time_ns() + 10_000_000_000)
        return PKG[pkg]["gc"].replay_wals(d), read_xl(d, "rl") == new_blob
    ref, port = both(run)
    assert port == ref and port[0]["repaired"] == 1 and port[1]
    same_journals(disks, ["rl"])


def test_replay_leaves_newer_destination_alone(tmp_path):
    def run(pkg):
        d = mkdisk(pkg, tmp_path)
        stale = PKG[pkg]["meta"].XLMeta()
        stale.add_version(mkfi(pkg, "nw", T0 - 50))
        _wal_with(pkg, d, [(BKT, "nw", stale.dump())],
                  t_ns=time.time_ns() - 10 ** 9)
        d.write_metadata(BKT, "nw", mkfi(pkg, "nw", T0))
        newer = read_xl(d, "nw")
        return PKG[pkg]["gc"].replay_wals(d), read_xl(d, "nw") == newer
    ref, port = both(run)
    assert port == ref and port[0]["repaired"] == 0 and port[1]


def test_replay_never_resurrects_deleted_object(tmp_path):
    def run(pkg):
        d = mkdisk(pkg, tmp_path)
        d.write_metadata(BKT, "dz", mkfi(pkg, "dz", T0))
        _wal_with(pkg, d, [(BKT, "dz", read_xl(d, "dz"))],
                  t_ns=time.time_ns())
        d.delete_version(BKT, "dz", "")
        gone = not os.path.exists(os.path.join(d.root, BKT, "dz"))
        rep = PKG[pkg]["gc"].replay_wals(d)
        return gone, rep, os.path.exists(os.path.join(d.root, BKT, "dz"))
    ref, port = both(run)
    assert port == ref and port[0] and port[1]["repaired"] == 0 \
        and not port[2]


@pytest.mark.parametrize("tail", ["half", 17])
def test_replay_discards_torn_tail_frame(tmp_path, tail):
    """A torn tail frame (half a frame, or 17 bytes: magic, crc and part
    of the body's head) is discarded; the intact frame before it
    replays. The 17-byte case is the JAX package's
    test_replay_survives_16_byte_torn_tail."""
    disks = {}

    def run(pkg):
        d = disks[pkg] = mkdisk(pkg, tmp_path)
        g = PKG[pkg]["gc"]
        good = PKG[pkg]["meta"].XLMeta()
        good.add_version(mkfi(pkg, "tg", T0))
        os.makedirs(os.path.join(d.root, BKT, "tg"))
        path = _wal_with(pkg, d, [(BKT, "tg", good.dump())],
                         t_ns=time.time_ns())
        torn = g.encode_frame([(BKT, "zz", b"garbage")])
        with open(path, "ab") as f:
            f.write(torn[:len(torn) // 2 if tail == "half" else tail])
        rep = g.replay_wals(d)
        return rep, read_xl(d, "tg") == good.dump()
    ref, port = both(run)
    assert port == ref and port[1]
    assert (port[0]["replayed"], port[0]["discarded"]) == (1, 1)
    same_journals(disks, ["tg"])


def test_checkpoint_truncates_wal(tmp_path):
    def run(pkg):
        d = mkdisk(pkg, tmp_path)
        d._gc_auto = False
        g = PKG[pkg]["gc"]
        for i in range(3):
            assert d.commit_group([g.GroupOp.write_meta(
                BKT, f"ck-{i}", mkfi(pkg, f"ck-{i}", T0))]) == [None]
        wal = g.wal_file_path(d.root)
        out = (d.gc_pending(), os.path.getsize(wal) > 0, d.gc_checkpoint(),
               os.path.getsize(wal), d.gc_pending())
        d.gc_close()
        return out
    ref, port = both(run)
    assert port == ref == (3, True, 3, 0, 0)


def test_recovery_sweep_replays_first(tmp_path):
    """recovery_sweep replays WAL frames BEFORE the dangling-data-dir
    scan: a data dir only a WAL-recorded journal names is not reaped."""
    ddir = "11111111-2222-3333-4444-555555555555"

    def run(pkg):
        d = mkdisk(pkg, tmp_path)
        obj = os.path.join(d.root, BKT, "rs")
        os.makedirs(os.path.join(obj, ddir))
        with open(os.path.join(obj, ddir, "part.1"), "wb") as f:
            f.write(b"shard")
        xl = PKG[pkg]["meta"].XLMeta()
        fi = mkfi(pkg, "rs", T0, ddir=ddir, data=b"")
        fi.inline_data = None
        xl.add_version(fi)
        _wal_with(pkg, d, [(BKT, "rs", xl.dump())], t_ns=time.time_ns())
        rep = PKG[pkg]["local"].recovery_sweep(d, min_age=0)
        return (rep["wal_repaired"], rep["dangling"],
                os.path.isfile(os.path.join(obj, ddir, "part.1")))
    ref, port = both(run)
    assert port == ref == (1, 0, True)


def test_truncate_guard_skips_on_concurrent_append(tmp_path):
    """A frame appended between a checkpoint's sync and its truncate was
    not covered by the sync: the guarded truncate skips it."""
    def run(pkg):
        d = mkdisk(pkg, tmp_path)
        d._gc_auto = False
        g = PKG[pkg]["gc"]
        d.commit_group([g.GroupOp.write_meta(BKT, "tr-0",
                                             mkfi(pkg, "tr-0", T0))])
        pre = d.gc_pending()
        d.commit_group([g.GroupOp.write_meta(BKT, "tr-1",
                                             mkfi(pkg, "tr-1", T0))])
        out = (pre, d.gc_truncate_wal(expect=pre), d.gc_pending(),
               d.gc_truncate_wal(expect=2))
        d.gc_close()
        return out
    ref, port = both(run)
    assert port == ref == (1, 0, 2, 2)


def test_checkpoint_between_wal_append_and_journal_writes(tmp_path):
    """A checkpoint that runs after a batch's WAL append and before its
    journals are written retires no frame: its sync could miss those
    writes, and the frame is what makes the acked members durable. The
    port's own rule (the JAX package's guard counts only appends). Once
    the batch's journals are written the next checkpoint retires it."""
    d = mkdisk("p", tmp_path)
    d._gc_auto = False
    wal = port_gc.wal_file_path(d.root)
    mid = []
    append = d._gc_append_wal

    def append_then_checkpoint(recs, *hook):
        append(recs, *hook)
        mid.append((d.gc_pending(), d.gc_checkpoint(), os.path.getsize(wal)))
    d._gc_append_wal = append_then_checkpoint
    ops = [port_gc.GroupOp.write_meta(BKT, k, mkfi("p", k, T0))
           for k in ("mc-0", "mc-1")]
    assert d.commit_group(ops) == [None, None]
    (pending, retired, size), = mid
    assert (pending, retired) == (1, 0) and size > 0
    with open(wal, "rb") as f:
        frames = list(port_gc.iter_frames(f.read()))
    assert [[p for _, p, _ in recs] for _, recs in frames] == \
        [["mc-0", "mc-1"]]
    assert (d.gc_covered(), d.gc_checkpoint(), os.path.getsize(wal)) == \
        (1, 1, 0)
    d.gc_close()


def test_replay_mtime_lie_does_not_roll_back_overwrite(tmp_path):
    """A destination whose mtime reads older than the frame, but whose
    journal supersedes every version of the frame, is not rolled back."""
    def run(pkg):
        d = mkdisk(pkg, tmp_path)
        old = PKG[pkg]["meta"].XLMeta()
        old.add_version(mkfi(pkg, "cl", T0))
        d.write_metadata(BKT, "cl", mkfi(pkg, "cl", T0 + 1000,
                                         data=b"newer" * 8))
        newer = read_xl(d, "cl")
        _wal_with(pkg, d, [(BKT, "cl", old.dump())],
                  t_ns=time.time_ns() + 10 ** 12)
        return PKG[pkg]["gc"].replay_wals(d)["repaired"], \
            read_xl(d, "cl") == newer
    ref, port = both(run)
    assert port == ref == (0, True)


# ---------------------------------------------------------------------------
# the lanes (GroupCommit)
# ---------------------------------------------------------------------------

def _mkset(pkg, tmp_path, n=4):
    kw = {} if pkg == "r" else {"device": "cpu"}
    es = PKG[pkg]["set"]([PKG[pkg]["local"].LocalStorage(
        str(tmp_path / f"{pkg}-es{i}")) for i in range(n)], **kw)
    es._mrf_closed = True
    es.make_bucket(BKT)
    return es


def _wal_sizes(es):
    out = []
    for d in es.disks:
        gdir = os.path.join(d.root, SYS_VOL, "gcommit")
        out += [os.path.getsize(os.path.join(gdir, f))
                for f in (os.listdir(gdir) if os.path.isdir(gdir) else [])]
    return out


def test_concurrent_inline_puts_coalesce_and_roundtrip(tmp_path):
    """12 threads x 8 inline PUTs a package: commits ride the lanes and
    coalesce; every body reads back; the listing shows every key, as the
    JAX package's does; a graceful close leaves no WAL frame. The 12
    writers start each of their 8 rounds together (a barrier), so that
    their commits overlap however loaded the host is."""
    rng = np.random.default_rng(2)
    body = rng.bytes(2048)
    seen = {}

    def run(pkg):
        es = _mkset(pkg, tmp_path)
        rounds = threading.Barrier(12)

        def writer(t):
            for i in range(8):
                rounds.wait(timeout=120)
                es.put_object(BKT, f"k-{t}-{i}", body)
        try:
            assert es.group_commit is not None
            with ThreadPoolExecutor(max_workers=12) as ex:
                list(ex.map(writer, range(12)))
            st = es.group_commit.stats()
            assert st["members"] > 0, "no commit rode the lanes"
            assert st["batches"] < st["members"], "nothing coalesced"
            got = [es.get_object(BKT, f"k-{t}-{i}")[1] == body
                   for t in (0, 5, 11) for i in (0, 7)]
            seen[pkg] = [o.name for o in es.list_objects(BKT, prefix="k-")
                         .objects]
        finally:
            es.close()
        return got, _wal_sizes(es)
    ref, port = both(run)
    assert port[0] == ref[0] == [True] * 6
    assert not any(port[1]) and not any(ref[1])
    assert seen["p"] == seen["r"] and len(seen["p"]) == 96


def test_solo_request_bypasses_lanes(tmp_path):
    def run(pkg):
        es = _mkset(pkg, tmp_path)
        try:
            es.put_object(BKT, "solo", b"x" * 512)
            st = es.group_commit.stats()
            return (st["members"], st["solo_bypass"] >= 1,
                    es.get_object(BKT, "solo")[1])
        finally:
            es.close()
    ref, port = both(run)
    assert port == ref == (0, True, b"x" * 512)


class _FakeEngine:
    def submit_nowait(self, idx, fn):
        fn()


def mkgc(pkg, disks, engine=None):
    """A GroupCommit of either package: the JAX package's runs its
    batches on the drive queues it is given (`engine`, by default each
    batch at once on the submitting thread), the port's on one commit
    thread a lane."""
    if pkg == "p":
        return port_gc.GroupCommit(disks)
    return ref_gc.GroupCommit(disks, engine or _FakeEngine())


def test_deadline_cull_without_poisoning(tmp_path):
    """A member whose budget is spent when its batch runs is culled alone
    with DeadlineExceeded; its batch-mate commits."""
    class _DL:
        expires_at = time.monotonic() - 1.0

    def run(pkg):
        g = PKG[pkg]["gc"]
        d = mkdisk(pkg, tmp_path)
        gc = mkgc(pkg, [d])
        m_ok = g._Member(g.GroupOp.write_meta(BKT, "dc-ok",
                                              mkfi(pkg, "dc-ok", T0)),
                         None, g._Latch(1))
        m_dead = g._Member(g.GroupOp.write_meta(BKT, "dc-no",
                                                mkfi(pkg, "dc-no", T0)),
                           _DL(), g._Latch(1))
        gc._run_batch(gc._lanes[0], [m_ok, m_dead])
        return (m_ok.exc is None,
                isinstance(m_dead.exc, PKG[pkg]["deadline"]),
                os.path.exists(os.path.join(d.root, BKT, "dc-ok")),
                os.path.exists(os.path.join(d.root, BKT, "dc-no")),
                gc.stats()["deadline_culls"])
    ref, port = both(run)
    assert port == ref == (True, True, True, False, 1)


def test_solo_demotion_on_batch_fault(tmp_path):
    """A commit_group that fails whole demotes each member to the solo
    path, counted; the callers see the solo outcome."""
    def run(pkg):
        g = PKG[pkg]["gc"]
        d = mkdisk(pkg, tmp_path)

        class Flaky:
            root = d.root
            endpoint = "flaky"

            def commit_group(self, ops, _info=None, **kw):
                raise OSError("batch machinery failed")

            def write_metadata(self, vol, path, fi, **kw):
                return d.write_metadata(vol, path, fi, **kw)

            def settle_prevs(self, items):
                return d.settle_prevs(items)

        gc = mkgc(pkg, [Flaky()])
        latch = g._Latch(2)
        ms = [g._Member(g.GroupOp.write_meta(BKT, f"sd-{i}",
                                             mkfi(pkg, f"sd-{i}", T0)),
                        None, latch) for i in range(2)]
        gc._run_batch(gc._lanes[0], ms)
        return ([m.exc is None for m in ms], gc.stats()["solo_demotions"],
                [os.path.exists(os.path.join(d.root, BKT, f"sd-{i}"))
                 for i in range(2)])
    ref, port = both(run)
    assert port == ref == ([True, True], 2, [True, True])


def test_coalesced_bump_fires_before_ack(tmp_path):
    def run(pkg):
        g = PKG[pkg]["gc"]
        d = mkdisk(pkg, tmp_path)
        order = []

        class Latch(g._Latch):
            def dec(self):
                order.append("ack")
                super().dec()

        gc = mkgc(pkg, [d])
        gc.bump = lambda bucket: order.append(f"bump:{bucket}")
        m = g._Member(g.GroupOp.write_meta(BKT, "bf", mkfi(pkg, "bf", T0)),
                      None, Latch(1))
        gc._run_batch(gc._lanes[0], [m])
        return order
    ref, port = both(run)
    assert port == ref == [f"bump:{BKT}", "ack"]


def test_delete_marker_storm_coalesces(tmp_path):
    """Versioned delete markers ride the lanes of inline PUTs; the
    deleted keys read as not found and list as markers only."""
    keys = [f"dm-{i:02d}" for i in range(16)]
    listed = {}

    def run(pkg):
        es = _mkset(pkg, tmp_path)
        try:
            for k in keys:
                es.put_object(BKT, k, b"v" * 256)
            before = es.group_commit.stats()["members"]
            with ThreadPoolExecutor(max_workers=8) as ex:
                list(ex.map(lambda k: es.delete_object(
                    BKT, k, PKG[pkg]["delete"](versioned=True)), keys))
            moved = es.group_commit.stats()["members"] > before
            gone = []
            for k in keys[:3]:
                with pytest.raises(PKG[pkg]["notfound"]):
                    es.get_object(BKT, k)
                gone.append(k)
            listed[pkg] = (
                [o.name for o in es.list_objects(BKT).objects],
                [(o.name, o.delete_marker, o.is_latest) for o in
                 es.list_objects(BKT, include_versions=True).objects])
            return moved, gone
        finally:
            es.close()
    ref, port = both(run)
    assert port == ref and port[0]
    assert listed["p"] == listed["r"] and listed["p"][0] == []


def test_group_commit_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_GROUP_COMMIT", "off")

    def run(pkg):
        es = _mkset(pkg, tmp_path)
        try:
            es.put_object(BKT, "off", b"y" * 128)
            return es.group_commit is None, es.get_object(BKT, "off")[1]
        finally:
            es.close()
    ref, port = both(run)
    assert port == ref == (True, b"y" * 128)


def test_commit_fanout_all_none_returns(tmp_path):
    """Every drive slot None returns at once, not parked on a latch."""
    def run(pkg):
        gc = mkgc(pkg, [mkdisk(pkg, tmp_path)])
        t0 = time.monotonic()
        # The port's lanes settle with the set's write quorum.
        errors = gc.commit_fanout([None], *(() if pkg == "r" else (1,)))
        quick = time.monotonic() - t0 < 1.0
        gc.close()
        return errors, quick
    ref, port = both(run)
    assert port == ref == ([None], True)


class _OneWorker:
    """A drive queue with one worker thread, as on a host with fewer
    cores than drives."""

    def __init__(self):
        import queue
        import threading
        self.q = queue.Queue()
        threading.Thread(target=self._work, daemon=True).start()

    def _work(self):
        while True:
            self.q.get()()

    def submit_nowait(self, idx, fn):
        self.q.put(fn)


def test_busy_lane_holds_next_batch(tmp_path):
    """The port's own lane rule: while a lane's batch is queued or runs,
    its new members wait and join the next batch. 16 writers with
    staggered arrivals (seeded) on a drive whose commit takes 50 ms and
    whose queue has one worker: the port commits their 48 members in
    fewer batches than the JAX package's lanes, whose windows shrink to
    batches that queue behind each other; every member commits in
    both."""
    import threading
    rng = np.random.default_rng(10)
    gaps = rng.uniform(0.0, 0.03, size=(16, 3))

    def run(pkg):
        g = PKG[pkg]["gc"]
        d = mkdisk(pkg, tmp_path)

        class Slow:
            root = d.root
            endpoint = "slow"

            def commit_group(self, ops, _info=None, **kw):
                time.sleep(0.05)
                return d.commit_group(ops, _info=_info, **kw)

            def settle_prevs(self, items):
                return d.settle_prevs(items)

        gc = mkgc(pkg, [Slow()], _OneWorker())
        errs = []

        def writer(t):
            with gc.tracking():
                for i in range(3):
                    time.sleep(gaps[t, i])
                    errs.extend(gc.commit_fanout([g.GroupOp.write_meta(
                        BKT, f"w{t}-{i}", mkfi(pkg, f"w{t}-{i}", T0))],
                        *(() if pkg == "r" else (1,))))
        ts = [threading.Thread(target=writer, args=(t,)) for t in range(16)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(60)
        st = gc.stats()
        gc.close()
        committed = sum(os.path.exists(os.path.join(
            d.root, BKT, f"w{t}-{i}", "xl.meta"))
            for t in range(16) for i in range(3))
        return errs, st["members"], st["batches"], committed
    ref, port = both(run)
    assert ref[0] == port[0] == [None] * 48
    assert ref[1] == port[1] == ref[3] == port[3] == 48
    assert port[2] < ref[2], (port[2], ref[2])


@pytest.mark.parametrize("stands", [True, False])
def test_lane_batch_settles_with_one_call_a_drive(tmp_path, monkeypatch,
                                                 stands):
    """Four concurrent inline overwrites ride one lane batch a drive;
    each batch keeps the journals it replaces and settles them with ONE
    settle_prevs call on its drive once write quorum is known: kept when
    the writes stand, put back when they fall short (two drives failing
    their commits). No kept journal is left either
    way, and the answer is the new bodies or the old ones."""
    monkeypatch.setenv("MTPU_GROUP_COMMIT_WAIT_MS", "20000")
    calls = []

    class Counting:
        def __init__(self, d):
            self._d = d
            self.fail = False

        def commit_group(self, ops, **kw):
            if self.fail:
                raise OSError("drive fault")
            return self._d.commit_group(ops, **kw)

        def write_metadata(self, *a, **kw):
            if self.fail:
                raise OSError("drive fault")
            return self._d.write_metadata(*a, **kw)

        def settle_prevs(self, items):
            calls.append((self._d.root, sorted(items)))
            return self._d.settle_prevs(items)

        def settle_prev(self, *a, **kw):
            raise AssertionError("a lane member settled on its own")

        def __getattr__(self, name):
            return getattr(self._d, name)

    disks = [port_local.LocalStorage(str(tmp_path / f"d{i}"))
             for i in range(4)]
    wrapped = [Counting(d) for d in disks]
    es = ErasureSet(wrapped, device="cpu")
    try:
        es.make_bucket(BKT)
        old = [bytes([i]) * 700 for i in range(4)]
        new = [bytes([i + 8]) * 800 for i in range(4)]
        for i in range(4):
            es.put_object(BKT, f"k{i}", old[i])
        gc = es.group_commit
        gc.worth_batching = lambda: True
        if not stands:
            wrapped[0].fail = wrapped[1].fail = True
        gate = threading.Barrier(4)
        errs = [None] * 4

        def put(i):
            gate.wait()
            try:
                es.put_object(BKT, f"k{i}", new[i])
            except Exception as e:  # noqa: BLE001 - checked below
                errs[i] = e
        ts = [threading.Thread(target=put, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        st = gc.stats()
        assert st["batches"] == 4 and st["members"] == 16, st
        assert st["settle_calls"] == 4 and len(calls) == 4, calls
        keys = [(BKT, f"k{i}", stands) for i in range(4)]
        assert all([it[:3] for it in items] == keys
                   for _, items in calls), calls
        assert all((e is None) == stands for e in errs), errs
        want = new if stands else old
        assert [es.get_object(BKT, f"k{i}")[1] for i in range(4)] == want
        for d in disks:
            for i in range(4):
                assert not os.path.exists(os.path.join(
                    d.root, BKT, f"k{i}", port_local.PREV_FILE))
    finally:
        es.close()


def test_member_past_its_deadline_never_settles_after_its_request(
        tmp_path, monkeypatch):
    """Twelve drives, one overwrite A of key k under a short request
    deadline, batched on drives 0-5 with a second request C (key c)
    whose commits there are held; C's batch on drive 5 is held longer.
    A misses write quorum when its deadline passes. A later writer B of
    k starts only once A's commit_fanout returns (as the key's lock
    would let it). A's commits that were still running must not land,
    nor settle, after A returned: every drive ends with B's journal and
    no kept one."""
    from minio_tpu_torch.utils import deadline as deadline_mod
    # Windows close only when both tracked requests have a member
    # pending, or at A's deadline: A and C share each batch on drives
    # 0-5, and A is alone on 6-11.
    monkeypatch.setenv("MTPU_GROUP_COMMIT_WAIT_MS", "20000")
    held = threading.Event()        # drives 0-5: A's and C's batch
    held_c5 = threading.Event()     # drive 5: released last

    class Held:
        def __init__(self, d, idx):
            self._d, self._idx = d, idx

        def commit_group(self, ops, **kw):
            if self._idx < 6 and any(op.path == "c" for op in ops):
                assert held.wait(30)
                if self._idx == 5:
                    assert held_c5.wait(30)
            return self._d.commit_group(ops, **kw)

        def __getattr__(self, name):
            return getattr(self._d, name)

    disks = [mkdisk("p", tmp_path, f"d{i}") for i in range(12)]
    for d in disks:
        d.write_metadata(BKT, "k", mkfi("p", "k", T0, data=b"0" * 64))
    gc = port_gc.GroupCommit([Held(d, i) for i, d in enumerate(disks)])
    op = port_gc.GroupOp.write_meta
    a_fi = mkfi("p", "k", T0 + 1, data=b"A" * 64)
    b_fi = mkfi("p", "k", T0 + 2, data=b"B" * 64)
    c_fi = mkfi("p", "c", T0 + 1, data=b"C" * 64)
    both_in = threading.Barrier(2)
    out = {}

    def req_a():
        with gc.tracking():
            both_in.wait()
            with deadline_mod.bind(deadline_mod.Deadline(0.3)):
                out["a"] = gc.commit_fanout([op(BKT, "k", a_fi)] * 12, 8)
        out["a_at"] = time.monotonic()

    def req_c():
        with gc.tracking():
            both_in.wait()
            out["c"] = gc.commit_fanout(
                [op(BKT, "c", c_fi)] * 6 + [None] * 6, 4)
    ta = threading.Thread(target=req_a)
    tc = threading.Thread(target=req_c)
    t0 = time.monotonic()
    ta.start()
    tc.start()
    # Drives 0-4 let A's and C's batch go after A's deadline; drive 5
    # once a writer B that started when A returned had time to commit.
    threading.Timer(0.8, held.set).start()
    threading.Timer(1.6, held_c5.set).start()
    ta.join(30)
    assert not ta.is_alive()
    # B untracked: its members close their windows at once.
    out["b"] = gc.commit_fanout([op(BKT, "k", b_fi)] * 12, 8)
    tc.join(30)
    gc.close()
    assert out["a_at"] - t0 >= 1.6, "A returned while its commits ran"
    # A's held commits ran, so they count as committed.
    assert out["a"][:6] == [None] * 6, out["a"]
    assert out["b"] == [None] * 12 and out["c"] == [None] * 6 + [None] * 6
    for i, d in enumerate(disks):
        fi = d.read_version(BKT, "k", "")
        assert fi.mod_time == T0 + 2, f"drive {i}: B's journal replaced"
        assert not os.path.exists(os.path.join(
            d.root, BKT, "k", port_local.PREV_FILE)), f"drive {i}"
