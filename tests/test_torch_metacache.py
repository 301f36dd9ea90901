"""The port's shared listing walk streams against the JAX package's, on
the CPU.

Sets of 4 drives of each package take the same operations (bodies from
one numpy seed) and must list the same pages: a repeated listing and a
listing with other page parameters are served from one walk (the hit
counts equal the JAX package's); a mutation of each kind between two
pages (PUT, overwrite, delete, delete marker, multipart complete, a copy
through the GET stream, a heal) is visible on the very next page; a
multi-page listing and six concurrent listings drive one walk of the
drives; pages past the in-memory cap continue through start-floored
walks; a completed walk persists on the first drive, a fresh ErasureSet
on the same drives serves its first page and a deep continuation page
(seeking past whole segments) from the persisted run with no drive walk,
and a truncated run's continuations compact onto it. Beyond the JAX
package's cases: "/" pages equal the JAX package's with empty and nested
prefixes; a concurrent PUT/DELETE storm lists what the JAX package
lists; every mutation path of the port bumps the bucket (each op is
held to its own bump count, so a removed bump fails its op); a bump
removes persisted runs, so a fresh process never loads a run older than
an acknowledged write. The peer bump broadcast (`on_bump`, leading-edge
coalesced with a trailing broadcast owed) reaches another node's walks
as the JAX package's does. The JAX case left out: the 10M-key slow
sweep. Tolerance: none.
"""

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from minio_tpu.object import metacache as ref_mc
from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.object.types import DeleteOptions as RefDelete
from minio_tpu.object.types import PutOptions as RefPut
from minio_tpu.storage.local import LocalStorage as RefDisk

from minio_tpu_torch.object import metacache
from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.types import DeleteOptions, PutOptions
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.storage.meta import FileInfo, now_ns
from minio_tpu_torch.utils.streams import ChunkReader, Payload
from tests.torch_no_caches import no_read_caches  # noqa: F401

N = 4
PKGS = {"r": (RefSet, RefDisk, RefPut, RefDelete, ref_mc),
        "p": (ErasureSet, LocalStorage, PutOptions, DeleteOptions,
              metacache)}


def _mkset(pkg, root, bucket):
    cls, disk = PKGS[pkg][:2]
    es = cls([disk(str(root / f"{pkg}{i}")) for i in range(N)],
             **({} if pkg == "r" else {"device": "cpu"}))
    es._mrf_closed = True
    if bucket:
        es.make_bucket(bucket)
    return es


def _names(info):
    return [o.name for o in info.objects]


def _counting(disks):
    """Wrap drives so that their listing walks are counted."""
    counter = {"walks": 0}

    class W:
        def __init__(self, inner):
            self._inner = inner

        def walk_scan(self, *a, **k):
            counter["walks"] += 1
            return self._inner.walk_scan(*a, **k)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    return [W(d) for d in disks], counter


def _page_all(es, bucket, max_keys, **kw):
    names, marker, pages = [], "", 0
    while True:
        page = es.list_objects(bucket, marker=marker, max_keys=max_keys,
                               **kw)
        names += _names(page)
        pages += 1
        assert pages < 200
        if not page.is_truncated:
            return names, pages
        marker = page.next_marker


def _both(tmp_path, bucket, fn):
    """fn(pkg, es) on a fresh set of each package; (JAX, port)."""
    out = {}
    for pkg in ("r", "p"):
        es = _mkset(pkg, tmp_path, bucket)
        try:
            out[pkg] = fn(pkg, es)
        finally:
            es.close()
    return out["r"], out["p"]


def test_repeat_listing_hits_cache(tmp_path):
    def run(pkg, es):
        for i in range(5):
            es.put_object("mcb", f"k{i}", b"x")
        first = _names(es.list_objects("mcb", prefix="k"))
        hits = [es.metacache.hits]
        again = _names(es.list_objects("mcb", prefix="k"))
        hits.append(es.metacache.hits)
        two = _names(es.list_objects("mcb", prefix="k", max_keys=2))
        hits.append(es.metacache.hits)
        return first, again, two, hits
    ref, port = _both(tmp_path, "mcb", run)
    assert port == ref
    assert port[3] == [0, 1, 2] and port[0] == port[1]


def test_mutations_invalidate_immediately(tmp_path):
    """A mutation of each kind between two pages shows on the very next
    page, with no TTL window, as in the JAX package."""
    rng = np.random.default_rng(3)
    bodies = [rng.bytes(1000) for _ in range(4)]

    def run(pkg, es):
        _, _, put, delete, _ = PKGS[pkg]
        pages = []

        def snap():
            info = es.list_objects("mcb", include_versions=True)
            pages.append([(o.name, o.size, o.delete_marker, o.is_latest)
                          for o in info.objects])
        es.put_object("mcb", "a", bodies[0])
        snap()
        es.put_object("mcb", "b", bodies[1])                  # PUT
        snap()
        es.put_object("mcb", "a", bodies[2][:500])            # overwrite
        snap()
        es.delete_object("mcb", "b", delete())                # delete
        snap()
        es.set_bucket_versioning("mcb", "Enabled")            # versioning
        es.delete_object("mcb", "a", delete(versioned=True))  # marker
        snap()
        uid = es.new_multipart_upload("mcb", "mp")
        etag = es.put_object_part("mcb", "mp", uid, 1, bodies[3]).etag
        es.complete_multipart_upload("mcb", "mp", uid, [(1, etag)])
        snap()
        info, chunks = es.get_object_stream("mcb", "mp")       # copy
        if pkg == "p":
            reader = ChunkReader(chunks)
            try:
                es.put_object("mcb", "cp", Payload(reader, info.size),
                              put(versioned=True))
            finally:
                reader.close()
        else:
            es.put_object("mcb", "cp", b"".join(bytes(c) for c in chunks),
                          put(versioned=True))
        snap()
        return pages
    ref, port = _both(tmp_path, "mcb", run)
    assert port == ref
    assert [len(p) for p in port] == [1, 2, 2, 1, 2, 3, 4]


def test_multipart_and_bucket_delete_invalidate(tmp_path):
    def run(pkg, es):
        _, _, _, delete, _ = PKGS[pkg]
        uid = es.new_multipart_upload("mcb", "mp")
        es.list_objects("mcb")                                 # prime
        e1 = es.put_object_part("mcb", "mp", uid, 1,
                                np.random.default_rng(4).bytes(1000)).etag
        es.complete_multipart_upload("mcb", "mp", uid, [(1, e1)])
        listed = _names(es.list_objects("mcb"))
        es.delete_object("mcb", "mp", delete())
        es.delete_bucket("mcb")
        with pytest.raises(Exception):
            es.list_objects("mcb")
        return listed
    ref, port = _both(tmp_path, "mcb", run)
    assert port == ref == ["mp"]


def test_peer_bump_invalidates_other_nodes_walk(tmp_path):
    """tests/test_metacache.py's case on each package: two "nodes" over
    the same drives; node A's bump rides its on_bump hook to node B, so
    B's next listing shows A's write, and a mutation inside the
    coalescing window reaches B through the trailing broadcast."""
    def run(pkg):
        a = _mkset(pkg, tmp_path / f"peer-{pkg}", "xn")
        b = _mkset(pkg, tmp_path / f"peer-{pkg}", "")
        try:
            dele = PKGS[pkg][3]
            a.put_object("xn", "one", b"1")
            seen = [_names(b.list_objects("xn"))]
            fired = []

            def hook(bucket):
                fired.append(bucket)
                b.metacache.bump(bucket, broadcast=False)
            a.metacache.on_bump = hook
            a.put_object("xn", "two", b"2")
            seen.append(_names(b.list_objects("xn")))
            a.delete_object("xn", "one", dele())
            deadline = time.monotonic() + 2
            while time.monotonic() < deadline and \
                    _names(b.list_objects("xn")) != ["two"]:
                time.sleep(0.02)
            seen.append(_names(b.list_objects("xn")))
            return seen, fired
        finally:
            a.close()
            b.close()
    ref, port = run("r"), run("p")
    assert port[0] == ref[0] == [["one"], ["one", "two"], ["two"]]
    assert set(port[1]) == set(ref[1]) == {"xn"}


def test_bump_coalesces_with_a_trailing_broadcast(tmp_path):
    """Bumps inside the window broadcast once at its leading edge and
    once after it; a bump applied from a peer (broadcast=False) and one
    with bump_coalesce 0 never wait."""
    for pkg in ("r", "p"):
        mc = PKGS[pkg][4].MetaCache()
        fired = []
        mc.on_bump = fired.append
        for _ in range(5):
            mc.bump("b")
        assert fired == ["b"], pkg
        time.sleep(0.3)
        assert fired == ["b", "b"], pkg
        mc.bump("b", broadcast=False)
        mc.bump_coalesce = 0.0
        mc.bump("b")
        mc.bump("b")
        assert fired == ["b"] * 4, pkg


def test_large_bucket_pages_without_rewalking(tmp_path):
    """A 24-page listing drives ONE walk: one walk_scan a walked drive
    (a majority of 4 = 3)."""
    def run(pkg, es):
        for i in range(600):
            es.put_object("big", f"o{i:05d}", b"")
        wrapped, counter = _counting(es.disks)
        es.disks[:] = wrapped
        names, pages = _page_all(es, "big", 25)
        return names, pages, counter["walks"]
    ref, port = _both(tmp_path, "big", run)
    assert port == ref
    assert port[0] == [f"o{i:05d}" for i in range(600)] and port[1] >= 24
    assert port[2] <= 3


def test_concurrent_listings_share_one_walk(tmp_path):
    def run(pkg, es):
        for i in range(300):
            es.put_object("cc", f"k{i:04d}", b"")
        wrapped, counter = _counting(es.disks)
        es.disks[:] = wrapped
        results = [None] * 6

        def worker(i):
            results[i] = _names(es.list_objects("cc", max_keys=1000))
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        return results, counter["walks"]
    ref, port = _both(tmp_path, "cc", run)
    want = [f"k{i:04d}" for i in range(300)]
    assert port[0] == ref[0] == [want] * 6
    assert port[1] <= 3


def test_continuation_past_truncation_cap(tmp_path, monkeypatch):
    """Pages past a stream's in-memory cap ride start-floored walks and
    every key comes once."""
    monkeypatch.setattr(metacache, "_MAX_ENTRIES", 120)
    monkeypatch.setattr(ref_mc, "_MAX_ENTRIES", 120)

    def run(pkg, es):
        for i in range(300):
            es.put_object("cap", f"o{i:05d}", b"")
        return _page_all(es, "cap", 50)
    ref, port = _both(tmp_path, "cap", run)
    assert port == ref
    assert port[0] == [f"o{i:05d}" for i in range(300)]


def _wait_head(disk, bucket, want_count=None, timeout=20.0):
    """The persisted run's head once it is there (and holds want_count
    keys, not truncated, when given)."""
    base = metacache.WalkStream._dir(bucket, "")
    deadline = time.monotonic() + timeout
    head = {}
    while time.monotonic() < deadline:
        try:
            head = json.loads(disk.read_all(".mtpu.sys", f"{base}/head"))
            if want_count is None or (head.get("count") == want_count
                                      and not head.get("truncated")):
                return head
        except Exception:  # noqa: BLE001 - not persisted yet
            pass
        time.sleep(0.05)
    return head


def test_persisted_seek_and_warm_start(tmp_path, monkeypatch):
    """A fresh set's first page, and a deep continuation page, load the
    persisted segments (the deep one seeking past whole segments)
    instead of walking the drives; the pages equal the JAX package's
    from its own persisted run."""
    for mod in (metacache, ref_mc):
        monkeypatch.setattr(mod, "_PERSIST_TTL", 600.0)
        monkeypatch.setattr(mod, "_SEG", 64)
    keys = [f"flat/o{i:08d}" for i in range(700)]
    out = {}
    for pkg in ("r", "p"):
        es = _mkset(pkg, tmp_path, "ns")
        for k in keys:
            es.put_object("ns", k, b"")
        _page_all(es, "ns", 100, prefix="flat/")
        es.close()
        es2 = _mkset(pkg, tmp_path, None)
        wrapped, counter = _counting(es2.disks)
        es2.disks[:] = wrapped
        first = _names(es2.list_objects("ns", prefix="flat/", max_keys=100))
        got = (first, counter["walks"], es2.metacache.persisted_loads)
        es2.close()
        es3 = _mkset(pkg, tmp_path, None)
        wrapped, counter = _counting(es3.disks)
        es3.disks[:] = wrapped
        deep = _names(es3.list_objects("ns", prefix="flat/",
                                       marker=keys[499], max_keys=100))
        w = next(iter(es3.metacache._walks.values()))
        got += (deep, counter["walks"], es3.metacache.persisted_loads,
                w.persisted_from)
        es3.close()
        out[pkg] = got
    assert out["p"] == out["r"]
    first, walks, loads, deep, walks3, loads3, skipped = out["p"]
    assert first == keys[:100] and deep == keys[500:600]
    assert (walks, loads, walks3, loads3) == (0, 1, 0, 1) and skipped > 0


def test_truncated_walk_compacts_in_place(tmp_path, monkeypatch):
    """A truncated persisted run and its continuations compact into ONE
    run; a fresh set serves the whole range from it, past the cap."""
    for mod in (metacache, ref_mc):
        monkeypatch.setattr(mod, "_MAX_ENTRIES", 100)
        monkeypatch.setattr(mod, "_SEG", 40)
        monkeypatch.setattr(mod, "_PERSIST_TTL", 600.0)
    out = {}
    for pkg in ("r", "p"):
        es = _mkset(pkg, tmp_path, "cp")
        try:
            for i in range(250):
                es.put_object("cp", f"o{i:05d}", b"")
            # Generation 0 again, as a quiet bucket in a fresh process.
            es.metacache._gen.clear()
            names, _ = _page_all(es, "cp", 50)
            head = _wait_head(es.disks[0], "cp", 250)
            compactions = es.metacache.compactions
        finally:
            es.close()
        es2 = _mkset(pkg, tmp_path, None)
        try:
            wrapped, counter = _counting(es2.disks)
            es2.disks[:] = wrapped
            again, _ = _page_all(es2, "cp", 50)
            out[pkg] = (names, head.get("count"), head.get("truncated"),
                        compactions >= 1, again, counter["walks"],
                        es2.metacache.persisted_loads >= 1)
        finally:
            es2.close()
    assert out["p"] == out["r"]
    want = [f"o{i:05d}" for i in range(250)]
    assert out["p"] == (want, 250, False, True, want, 0, True)


def test_persisted_walk_warm_starts_fresh_process(tmp_path):
    out = {}
    for pkg in ("r", "p"):
        es = _mkset(pkg, tmp_path, "pp")
        for i in range(50):
            es.put_object("pp", f"k{i:03d}", b"")
        es.list_objects("pp")
        _wait_head(es.disks[0], "pp")
        es.close()
        es2 = _mkset(pkg, tmp_path, None)
        wrapped, counter = _counting(es2.disks)
        es2.disks[:] = wrapped
        out[pkg] = (_names(es2.list_objects("pp", max_keys=1000)),
                    counter["walks"])
        es2.close()
    assert out["p"] == out["r"] == ([f"k{i:03d}" for i in range(50)], 0)


# ---------------------------------------------------------------------------
# beyond the JAX package's cases
# ---------------------------------------------------------------------------

def test_bump_removes_persisted_run(tmp_path, monkeypatch):
    """After a listing persisted its run, an acknowledged PUT removes
    it: a fresh set on the same drives walks and lists the new key."""
    monkeypatch.setattr(metacache, "_PERSIST_TTL", 600.0)
    es = _mkset("p", tmp_path, "rb")
    try:
        for i in range(20):
            es.put_object("rb", f"k{i:02d}", b"")
        es.list_objects("rb")
        assert _wait_head(es.disks[0], "rb").get("count") == 20
        es.put_object("rb", "new", b"1")
        assert not os.path.exists(os.path.join(
            es.disks[0].root, ".mtpu.sys", "listcache",
            metacache._safe("rb")))
    finally:
        es.close()
    es2 = _mkset("p", tmp_path, None)
    try:
        names = _names(es2.list_objects("rb"))
        assert "new" in names and len(names) == 21
        assert es2.metacache.persisted_loads == 0
    finally:
        es2.close()


@pytest.mark.parametrize("prefix", ["", "d1/", "d1/e/", "q/", "d1/e/f/"])
def test_shallow_pages_match_reference(tmp_path, prefix):
    """"/" pages in pages of 2 and of 1000, with empty and nested
    prefixes, equal the JAX package's."""
    keys = ["top", "d1/x", "d1/e/f/g", "d1/e/h", "d1/e/f", "d2/", "d2/y",
            "d3/a/b/c", "e"]

    def run(pkg, es):
        rng = np.random.default_rng(6)
        for k in keys:
            es.put_object("sh", k, rng.bytes(10))
        out = []
        for max_keys in (2, 1000):
            marker = ""
            while True:
                info = es.list_objects("sh", prefix=prefix, delimiter="/",
                                       marker=marker, max_keys=max_keys)
                out.append((_names(info), info.prefixes, info.is_truncated,
                            info.next_marker))
                if not info.is_truncated:
                    break
                marker = info.next_marker
        return out
    ref, port = _both(tmp_path, "sh", run)
    assert port == ref


def test_concurrent_put_delete_storm_lists_like_reference(tmp_path):
    """8 threads PUT 6 keys each into a versioned bucket and delete every
    third after its PUT (a delete marker, or the removal of its version
    by id); listings during the storm come back whole, and the final
    listing and version listing equal the JAX package's."""
    rng = np.random.default_rng(8)
    bodies = [rng.bytes(int(rng.integers(1, 300))) for _ in range(48)]

    def run(pkg, es):
        _, _, put, delete, _ = PKGS[pkg]
        es.set_bucket_versioning("st", "Enabled")
        stop = threading.Event()
        seen = []

        def lister():
            while not stop.wait(0.02):
                seen.append(_names(es.list_objects("st")))

        def worker(t):
            for i in range(6):
                j = 6 * t + i
                vid = es.put_object("st", f"k{j:03d}", bodies[j],
                                    put(versioned=True)).version_id
                if j % 3 == 0:
                    # A marker, or the removal of the version itself.
                    es.delete_object("st", f"k{j:03d}", delete(
                        versioned=True) if j % 2 == 0 else delete(
                            version_id=vid))
        lt = threading.Thread(target=lister)
        lt.start()
        with ThreadPoolExecutor(8) as ex:
            list(ex.map(worker, range(8)))
        stop.set()
        lt.join()
        assert all(s == sorted(s) for s in seen)
        versions = [(o.name, o.delete_marker, o.is_latest, o.size)
                    for o in es.list_objects(
                        "st", include_versions=True).objects]
        return _names(es.list_objects("st")), versions
    ref, port = _both(tmp_path, "st", run)
    assert port == ref
    assert port[0] == [f"k{j:03d}" for j in range(48) if j % 3]


def test_every_mutation_path_bumps(tmp_path):
    """Each mutation path of the port calls the bump funnel, as many
    times as its design says: solo PUTs (inline and staged) once,
    group-committed ones once a drive batch, multipart complete, a
    version delete, solo and group-committed delete markers, a
    versioning change, a heal that rebuilds a drive, the purge of a
    dangling version, and DeleteBucket's drop. The S3 front end's
    DeleteObjects and CopyObject reach these through delete_object and
    put_object."""
    es = _mkset("p", tmp_path, "bb")
    seen = []
    es.metacache.listeners.append(seen.append)
    gc = es.group_commit
    rng = np.random.default_rng(9)

    def count(fn):
        del seen[:]
        fn()
        return len(seen)

    def grouped(fn):
        def go():
            real = gc.worth_batching
            gc.worth_batching = lambda: True
            try:
                fn()
            finally:
                gc.worth_batching = real
        return go
    try:
        big = rng.bytes(300 << 10)      # staged, not inline, at EC 2+2
        ops = {
            "put inline": lambda: es.put_object("bb", "a", b"1"),
            "put staged": lambda: es.put_object("bb", "big", big),
            "group put inline": grouped(
                lambda: es.put_object("bb", "g", b"2")),
            "group put staged": grouped(
                lambda: es.put_object("bb", "gbig", big)),
            "versioning": lambda: es.set_bucket_versioning("bb", "Enabled"),
            "marker": lambda: es.delete_object(
                "bb", "a", DeleteOptions(versioned=True)),
            "group marker": grouped(lambda: es.delete_object(
                "bb", "g", DeleteOptions(versioned=True))),
            "delete version": lambda: es.delete_object(
                "bb", "big", DeleteOptions(version_id="null")),
        }
        for name, fn in ops.items():
            # A group commit bumps once a drive batch, before its acks.
            assert count(fn) == (N if name.startswith("group") else 1), name
        uid = es.new_multipart_upload("bb", "mp")
        etag = es.put_object_part("bb", "mp", uid, 1, rng.bytes(100)).etag
        assert count(lambda: es.complete_multipart_upload(
            "bb", "mp", uid, [(1, etag)])) == 1, "multipart complete"
        # A heal that rewrites a wiped drive's copy.
        shutil.rmtree(os.path.join(es.disks[1].root, "bb", "gbig"))
        assert count(lambda: es.heal_object("bb", "gbig")) == 1, "heal"
        # A dangling version: on one drive only; the heal purges it.
        es.disks[2].write_metadata("bb", "dangle", FileInfo(
            volume="bb", name="dangle", deleted=True, mod_time=now_ns()))
        assert count(lambda: es.heal_object("bb", "dangle")) == 1, "purge"
        for k, v in (("a", ""), ("g", ""), ("gbig", ""), ("mp", "")):
            for o in es.list_versions_all("bb", k):
                es.delete_object("bb", k, DeleteOptions(
                    version_id=o.version_id or "null"))
        assert count(lambda: es.delete_bucket("bb")) == 1, "delete bucket"
    finally:
        es.close()


def test_walk_failure_midway_raises_not_a_short_page(tmp_path):
    """A walk that fails after some keys never serves a short page that
    claims to be complete: a page that fills before the failure point is
    served (truncated), a page that reaches it raises, and the next
    listing walks again and lists every key."""
    es = _mkset("p", tmp_path, "wf")
    try:
        for i in range(12):
            es.put_object("wf", f"k{i:02d}", b"x")
        real = es._resolve_walked
        calls = {"n": 0}

        def failing(*a, **k):
            calls["n"] += 1
            if calls["n"] > 5:
                raise OSError("drive failed mid-walk")
            return real(*a, **k)
        es._resolve_walked = failing
        page = es.list_objects("wf", max_keys=3)
        assert (_names(page), page.is_truncated) == \
            (["k00", "k01", "k02"], True)
        with pytest.raises(OSError):
            es.list_objects("wf", max_keys=1000)
        with pytest.raises(OSError):
            es.list_objects("wf", marker="k02", max_keys=1000)
        es._resolve_walked = real
        assert _names(es.list_objects("wf")) == \
            [f"k{i:02d}" for i in range(12)]
    finally:
        es.close()
