"""The port's journal summaries and shallow walk against the JAX
package's, on the CPU.

The same version stacks, built from one numpy seed, go into a journal of
each package (JSON in the port, msgpack in the JAX package): the port's
`scan_blob` of its journal must equal the JAX package's `summarize_xl`
of its own, flags (delete marker, inline, metadata past the summary)
and the MTPU_META_SCAN_MAXV cut included, over a fixed corpus and a
seeded fuzz; unreadable journals summarize to None in both. The walk's
blob policy (a journal rides along when there is no summary or it does
not suffice) equals the JAX BlobScanner's. Listings through the
summaries equal listings with every journal fully parsed (MAXV 0) and
the JAX package's pages; "/" pages through the shallow walk equal the
deep walk's and the JAX package's; the port's walk_scan visits the keys
the JAX package's walk_dir does. The JAX cases on the fileinfo cache's stat class wait
for the port's fileinfo cache (ROADMAP). Tolerance: none.
"""

import os

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.object.types import DeleteOptions as RefDelete
from minio_tpu.object.types import PutOptions as RefPut
from minio_tpu.storage import meta as ref_meta
from minio_tpu.storage import meta_scan as ref_scan
from minio_tpu.storage.local import LocalStorage as RefDisk

from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.types import DeleteOptions, PutOptions
from minio_tpu_torch.storage import meta as port_meta
from minio_tpu_torch.storage import meta_scan
from minio_tpu_torch.storage.local import LocalStorage

MODS = {"r": ref_meta, "p": port_meta}


def _fi(pkg, rng, name, vid="", deleted=False, meta=None, inline=None,
        ddir="", mt=None):
    m = MODS[pkg]
    size = int(rng.integers(0, 1 << 40))
    fi = m.FileInfo(
        volume="b", name=name, version_id=vid, deleted=deleted,
        data_dir=ddir, mod_time=mt or int(rng.integers(1, 1 << 62)),
        size=size, metadata=meta if meta is not None else
        {"etag": "e" * 32, "content-type": "text/plain"},
        inline_data=inline)
    if not deleted:
        fi.parts = [m.ObjectPartInfo(number=1, size=size, actual_size=size,
                                     etag="p" * 8)]
        fi.erasure = m.ErasureInfo(data_blocks=2, parity_blocks=1,
                                   block_size=1 << 20, index=1,
                                   distribution=(1, 2, 3))
    return fi


def _journal(pkg, versions):
    """One journal of `pkg` holding `versions` [(seed, kwargs)], each
    version's random fields drawn from its own seed."""
    x = MODS[pkg].XLMeta()
    for seed, kw in versions:
        x.add_version(_fi(pkg, np.random.default_rng(seed), "a", **kw))
    return x.dump()


def _corpus():
    """(name, version list) covering every summary decision."""
    u = "{:08d}-0000-4000-8000-{:012d}".format
    return [
        ("single-inline", [(1, dict(inline=b"xyz"))]),
        ("single-ddir", [(2, dict(
            ddir="11111111-1111-4111-8111-111111111111"))]),
        ("delete-marker-latest", [
            (3, dict(vid="22222222-2222-4222-8222-222222222222", mt=5)),
            (4, dict(vid="33333333-3333-4333-8333-333333333333",
                     deleted=True, mt=9, meta={}))]),
        ("user-meta", [(5, dict(meta={"etag": "e", "x-amz-meta-user": "v",
                                      "content-type": "x"}))]),
        ("internal-meta", [(6, dict(meta={"etag": "e",
                                          "x-internal-sse-size": "123"}))]),
        ("unicode", [(7, dict(vid="null", meta={
            "etag": "é" * 40, "x-amz-tagging": "k=v&a=b"}))]),
        ("five-versions", [(10 + v, dict(vid=u(v, 0), mt=100 + v))
                           for v in range(5)]),
        ("over-maxv", [(20 + v, dict(vid=u(v, 1), mt=200 + v))
                       for v in range(meta_scan.MAXV + 1)]),
        ("empty-meta", [(30, dict(meta={}, mt=1))]),
    ]


def _bad_blobs(pkg):
    magic = port_meta.MAGIC if pkg == "p" else ref_meta.MAGIC
    good = MODS[pkg].XLMeta().dump()
    return [b"NOPE" + b"\x00" * 16, good[:-1], magic + b"\x81\xa8versions"]


def test_summaries_match_reference():
    """scan_blob of the port's journal == summarize_xl of the JAX
    package's, for every corpus journal (the JAX package's
    test_native_scan_matches_python_mirror)."""
    assert meta_scan.MAXV == ref_scan.MAXV
    for name, versions in _corpus():
        want = ref_scan.summarize_xl(ref_meta.XLMeta.load(
            _journal("r", versions)))
        got = meta_scan.scan_blob(_journal("p", versions))
        assert got == want, (name, got, want)
        if got is not None:
            assert frozenset(v[4] for v in got if v[4]) == \
                ref_scan.summary_data_dirs(want)
            assert meta_scan.summary_sufficient(got) == \
                ref_scan.summary_sufficient(want)
    assert meta_scan.scan_blob(_journal("p", _corpus()[-2][1])) is None
    for blob in _bad_blobs("p"):
        assert meta_scan.scan_blob(blob) is None, blob
    for blob in _bad_blobs("r"):
        with pytest.raises(Exception):
            ref_scan.summarize_xl(ref_meta.XLMeta.load(blob))


def test_summaries_fuzz_random_journals():
    """60 seeded random version stacks (markers, inline data, data dirs,
    content types, tags, user metadata): equal summaries."""
    rng = np.random.default_rng(99)
    for trial in range(60):
        versions = []
        for v in range(int(rng.integers(1, 7))):
            meta = {"etag": "%032x" % int(rng.integers(0, 1 << 62))}
            if rng.random() < 0.4:
                meta["content-type"] = f"application/x-{trial}"
            if rng.random() < 0.3:
                meta["x-amz-tagging"] = "a=b"
            if rng.random() < 0.25:
                meta["x-amz-meta-k"] = "v" * int(rng.integers(1, 50))
            versions.append((1000 * trial + v, dict(
                deleted=bool(rng.random() < 0.2),
                vid=f"{v:08d}-{trial:04d}-4000-8000-000000000000",
                meta=meta, inline=b"d" if rng.random() < 0.5 else None,
                ddir="" if rng.random() < 0.5 else
                "44444444-4444-4444-8444-444444444444")))
        want = ref_scan.summarize_xl(ref_meta.XLMeta.load(
            _journal("r", versions)))
        assert meta_scan.scan_blob(_journal("p", versions)) == want, trial


def test_scan_counters_move():
    """Sufficient summaries and full-parse fallbacks are counted apart."""
    before = dict(meta_scan.counters)
    meta_scan.scan_blob(_journal("p", _corpus()[0][1]))     # sufficient
    meta_scan.scan_blob(_journal("p", _corpus()[3][1]))     # user meta
    meta_scan.scan_blob(_bad_blobs("p")[2])                 # unreadable
    assert meta_scan.counters["summaries"] - before["summaries"] == 1
    assert meta_scan.counters["fallback"] - before["fallback"] == 2


def test_blob_policy_matches_blob_scanner(tmp_path):
    """For each corpus journal: the port's (summary, blob rides along)
    equals the JAX BlobScanner's, in order."""
    corpus = _corpus()
    ref_out = []
    sc = ref_scan.BlobScanner(max_items=4)
    for i, (name, versions) in enumerate(corpus):
        p = tmp_path / f"r-{i:02d}"
        p.write_bytes(_journal("r", versions))
        if sc.full():
            ref_out.extend(sc.flush())
        fd = os.open(p, os.O_RDONLY)
        try:
            sc.add(name, fd)
        finally:
            os.close(fd)
    ref_out.extend(sc.flush())
    sc.close()
    got = []
    for name, versions in corpus:
        blob = _journal("p", versions)
        vlist, rides = meta_scan.scan_entry(blob)
        assert rides in (None, blob)
        got.append((name, vlist, rides is not None))
    assert got == [(k, v, b is not None) for k, v, b in ref_out]


# ---------------------------------------------------------------------------
# listings through the summaries and the shallow walk
# ---------------------------------------------------------------------------

N = 4
PKGS = {"r": (RefSet, RefDisk, RefPut, RefDelete),
        "p": (ErasureSet, LocalStorage, PutOptions, DeleteOptions)}


@pytest.fixture
def sets(tmp_path):
    out = {}
    for pkg, (cls, disk, put, delete) in PKGS.items():
        es = cls([disk(str(tmp_path / f"{pkg}{i}")) for i in range(N)],
                 **({} if pkg == "r" else {"device": "cpu"}))
        es._mrf_closed = True
        es.make_bucket("b")
        rng = np.random.default_rng(5)
        es.put_object("b", "plain", rng.bytes(100))
        es.put_object("b", "tagged", rng.bytes(100), put(
            user_metadata={"x-amz-tagging": "team=x&env=y"}))
        es.put_object("b", "withmeta", rng.bytes(100),
                      put(user_metadata={"x-amz-meta-k": "v"}))
        es.put_object("b", "typed", rng.bytes(10),
                      put(content_type="text/csv"))
        for k in ("a/nested/one", "a/nested/two", "a/other",
                  "zz/deep/deeper/leaf", "obj", "obj/child", "e/"):
            es.put_object("b", k, rng.bytes(int(rng.integers(1, 50))))
        for body in (rng.bytes(3), rng.bytes(4)):
            es.put_object("b", "ver/k", body, put(versioned=True))
        es.put_object("b", "ver/dead", rng.bytes(5), put(versioned=True))
        es.delete_object("b", "ver/dead", delete(versioned=True))
        out[pkg] = es
    yield out
    for es in out.values():
        es.close()


def _pages(es, **kw):
    """Every page of a listing: (name, is_latest, delete_marker, etag,
    size, content_type) a version, version ids by order of appearance."""
    pages, marker, ids = [], "", {}
    for _ in range(100):
        info = es.list_objects("b", marker=marker, **kw)
        pages.append(([(o.name, o.is_latest, o.delete_marker, o.etag, o.size,
                        o.content_type,
                        ids.setdefault(o.version_id, len(ids))
                        if o.version_id else None)
                       for o in info.objects], list(info.prefixes),
                      info.is_truncated, info.next_marker))
        if not info.is_truncated:
            return pages
        marker = info.next_marker
    raise AssertionError("listing did not end")


SHAPES = [{}, {"prefix": "a/"}, {"prefix": "a/nested/"},
          {"delimiter": "/"}, {"prefix": "a/", "delimiter": "/"},
          {"prefix": "zz/", "delimiter": "/"},
          {"prefix": "obj", "delimiter": "/"},
          {"prefix": "e/", "delimiter": "/"},
          {"prefix": "q/", "delimiter": "/"},
          {"include_versions": True},
          {"prefix": "ver/", "include_versions": True},
          {"delimiter": "/", "max_keys": 2}, {"max_keys": 3}]


@pytest.mark.parametrize("maxv", [8, 0])
def test_listing_identity_summaries_on_off(sets, monkeypatch, maxv):
    """Every listing shape gives the JAX package's pages, with journals
    summarized (MAXV 8) and with every journal fully parsed (MAXV 0,
    the port's counterpart of the JAX package's scanner off)."""
    monkeypatch.setattr(meta_scan, "MAXV", maxv)
    for shape in SHAPES:
        sets["p"].metacache.bump("b")         # a fresh walk every time
        assert _pages(sets["p"], **shape) == _pages(sets["r"], **shape), \
            shape


@pytest.mark.parametrize("mode", ["on", "off"])
def test_listing_identity_shallow_vs_deep(sets, monkeypatch, mode):
    """"/" pages through the shallow one-level walk (on) and through the
    deep walk (off) equal the JAX package's, page by page: nested
    prefixes, an empty prefix, an object that is also a prefix."""
    monkeypatch.setenv("MTPU_LIST_SHALLOW", mode)
    for shape in [s for s in SHAPES if s.get("delimiter")]:
        sets["p"].metacache.bump("b")
        sets["r"].metacache.bump("b")
        assert _pages(sets["p"], **shape) == _pages(sets["r"], **shape), \
            shape


def test_shallow_marker_inside_collapsed_prefix(sets):
    """A marker strictly inside a collapsed prefix brings the prefix
    back on the shallow path."""
    kw = dict(delimiter="/", marker="a/nested/one")
    got, want = (sets[p].list_objects("b", **kw) for p in ("p", "r"))
    assert "a/" in got.prefixes
    assert (got.prefixes, [o.name for o in got.objects]) == \
        (want.prefixes, [o.name for o in want.objects])


def test_walk_scan_matches_walk_dir(sets):
    """The port's walk_scan visits the keys the JAX package's walk_dir
    and walk_scan do, whole and from a midpoint."""
    d, rd = sets["p"].disks[0], sets["r"].disks[0]
    want = [p for p, _ in rd.walk_dir("b")]
    assert [p for p, _, _ in d.walk_scan("b")] == want
    assert [p for p, _, _ in rd.walk_scan("b")] == want
    mid = want[len(want) // 2]
    assert [p for p, _, _ in d.walk_scan("b", forward_from=mid)] == \
        [p for p, _ in rd.walk_dir("b", forward_from=mid)]


def test_shallow_walk_matches_reference(sets):
    """The shallow walk's entries (objects and prefix markers) at the
    root and under a/ equal the JAX package's."""
    for base in ("", "a", "zz/deep"):
        got = [(p, v is meta_scan.PREFIX_MARK)
               for p, v, _ in sets["p"].disks[1].walk_scan(
                   "b", base_dir=base, shallow=True)]
        want = [(p, v is ref_scan.PREFIX_MARK)
                for p, v, _ in sets["r"].disks[1].walk_scan(
                    "b", base_dir=base, shallow=True)]
        assert got == want, base
