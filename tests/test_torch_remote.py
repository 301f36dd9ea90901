"""Remote drives (storage/remote.py) and the sets that use them.

Each drive call gives on a RemoteStorage what it gives on the
LocalStorage behind it, results and exception types alike; an
ErasureSet over remote drives writes the shard files and journals the
JAX package's ErasureSet writes over the JAX package's remote drives for
the same PUTs, reads them back, and reconstructs with a drive server
stopped (the JAX side runs in a subprocess: its grid would start the JAX
package's process-wide poller here); and a set with a remote drive runs
as the JAX package runs one without the cross-node cache protocol:
caches answering misses, no group commit, bucket metadata cached 2 s.
"""

import hashlib
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from minio_tpu.storage.meta import XLMeta as RefMeta
from minio_tpu_torch.grid import GridServer
from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.hotcache import HotObjectCache
from minio_tpu_torch.storage import meta as port_meta
from minio_tpu_torch.storage.health import DiskHealthWrapper
from minio_tpu_torch.storage.local import (FaultyDisk, LocalStorage,
                                           StorageError, VolumeExists,
                                           VolumeNotFound)
from minio_tpu_torch.storage.meta import (ErasureInfo, FileInfo,
                                          FileNotFoundErr, ObjectPartInfo)
from minio_tpu_torch.storage.remote import RemoteStorage, StorageRPCService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = "bkt"


def _serve(roots):
    srv = GridServer(0, host="127.0.0.1")
    StorageRPCService({r: LocalStorage(r) for r in roots}).register_into(srv)
    srv.start()
    return srv


@pytest.fixture
def pair(tmp_path):
    """(local, remote) views of one drive, and a twin drive to compare
    against, filled the same way."""
    root = str(tmp_path / "drv")
    local = LocalStorage(root)
    srv = _serve([root])
    yield local, RemoteStorage("127.0.0.1", srv.port, root), \
        LocalStorage(str(tmp_path / "twin"))
    srv.stop()


def _fi(name, vid="", inline=None, ddir=""):
    return FileInfo(volume=B, name=name, version_id=vid, mod_time=123,
                    size=3, data_dir=ddir,
                    metadata={"etag": "abc", "x-amz-meta-k": "é"},
                    parts=[ObjectPartInfo(number=1, size=3, actual_size=3)],
                    erasure=ErasureInfo(data_blocks=2, parity_blocks=1,
                                        block_size=1 << 20, index=1,
                                        distribution=(1, 2, 3)),
                    inline_data=inline)


def _fill(d):
    """The same drive state through any drive's calls."""
    d.make_vol(B)
    d.make_vol_if_missing(".mtpu.sys")
    d.write_all(B, "cfg/x.json", b"{}")
    d.write_metadata(B, "k", _fi("k", inline=b"xyz"))
    d.write_metadata(B, "k", _fi("k", vid="v2", inline=b"uvw"))
    d.write_metadata(B, "dir/a", _fi("dir/a"))
    d.write_metadata(B, "dir/sub/b", _fi("dir/sub/b"))
    d.create_file(".mtpu.sys", "staging/u1/dd-1/part.1",
                  [b"da", np.frombuffer(b"ta", np.uint8)])
    d.create_file(".mtpu.sys", "staging/u1/dd-1/part.1", [b"++"],
                  append=True)
    d.rename_data(".mtpu.sys", "staging/u1", _fi("obj", ddir="dd-1"),
                  B, "obj")


def _same(fn_local, fn_remote):
    """Both calls return the same value or raise the same type."""
    def outcome(fn):
        try:
            return "ok", fn()
        except Exception as e:  # noqa: BLE001 - compared by type
            return "raised", type(e)
    a, b = outcome(fn_local), outcome(fn_remote)
    assert a == b, (a, b)
    return a


CALLS = {
    "read_all": lambda d: d.read_all(B, "cfg/x.json"),
    "read_all_missing": lambda d: d.read_all(B, "nope"),
    "read_all_dir": lambda d: d.read_all(B, "dir"),
    "read_file": lambda d: d.read_file(B, "obj/dd-1/part.1"),
    "read_file_slice": lambda d: d.read_file(B, "obj/dd-1/part.1", 1, 2),
    "read_file_missing": lambda d: d.read_file(B, "obj/none/part.1"),
    "read_version": lambda d: d.read_version(B, "k", read_data=True),
    "read_version_meta_only": lambda d: d.read_version(B, "k"),
    "read_version_old": lambda d: d.read_version(B, "k", "", True),
    "read_version_named": lambda d: d.read_version(B, "k", "v2", True),
    "read_version_absent": lambda d: d.read_version(B, "k", "v9"),
    "read_version_missing": lambda d: d.read_version(B, "zz"),
    "list_versions": lambda d: d.list_versions(B, "k"),
    "list_dir": lambda d: d.list_dir(B, "dir"),
    "list_dir_root": lambda d: d.list_dir(B, ""),
    "list_dir_missing": lambda d: d.list_dir(B, "nope"),
    "stat_vol": lambda d: d.stat_vol(B).name,
    "stat_vol_missing": lambda d: d.stat_vol("nope"),
    "list_vols": lambda d: [v.name for v in d.list_vols()],
    "make_vol_exists": lambda d: d.make_vol(B),
    "delete_vol_not_empty": lambda d: d.delete_vol(B),
    "delete_vol_missing": lambda d: d.delete_vol("nope"),
    "stat_info_file": lambda d: d.stat_info_file(B,
                                                 "obj/dd-1/part.1").st_size,
    "stat_info_missing": lambda d: d.stat_info_file(B, "x/part.1"),
    "walk_scan": lambda d: list(d.walk_scan(B)),
    "walk_scan_from": lambda d: list(d.walk_scan(B, forward_from="dir/sub")),
    "walk_scan_shallow": lambda d: list(d.walk_scan(B, shallow=True)),
    "walk_scan_base": lambda d: list(d.walk_scan(B, base_dir="dir")),
    "walk_scan_missing": lambda d: list(d.walk_scan("nope")),
    "read_format_fresh": lambda d: d.read_format(),
    "access_denied": lambda d: d.read_all(B, "../../etc/passwd"),
    "delete_missing": lambda d: d.delete(B, "nope"),
    "delete_version_absent": lambda d: d.delete_version(B, "k", "v9"),
    "disk_info_healing": lambda d: d.disk_info().healing,
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_remote_call_equals_local(pair, name):
    local, remote, twin = pair
    _fill(remote)
    _fill(twin)
    verdict = _same(lambda: CALLS[name](twin), lambda: CALLS[name](remote))
    # And the remote drive holds what the twin holds.
    assert _same(lambda: CALLS[name](local), lambda: CALLS[name](twin)) \
        == verdict


def test_mutations_land_as_local(pair):
    local, remote, twin = pair
    _fill(remote)
    _fill(twin)
    for d in (remote, twin):
        d.delete_version(B, "k", "v2")
        d.write_format({"version": "1", "xl": {"this": "u1"}})
        d.rename_file(B, "cfg/x.json", B, "cfg/y.json")
        d.delete(B, "dir/a", recursive=True)
    for name in ("list_versions", "read_format_fresh", "list_dir_root"):
        assert CALLS[name](local) == CALLS[name](twin)
    assert remote.disk_id() == twin.disk_id() == "u1"
    assert local.read_all(B, "cfg/y.json") == b"{}"
    with pytest.raises(FileNotFoundErr):
        remote.read_all(B, "cfg/x.json")
    remote.delete_vol(B, force=True)
    with pytest.raises(VolumeNotFound):
        remote.stat_vol(B)


def test_read_file_into_scatters_like_local(pair):
    local, remote, _ = pair
    local.make_vol(B)
    data = os.urandom(3 * 87382 + 1000)
    local.create_file(B, "o/d/part.1", [data])
    for off, sizes in [(0, [87382, 87382]), (5, [10, 0, 7]),
                       (len(data) - 100, [64, 64]), (0, [len(data) + 9])]:
        a = [bytearray(n) for n in sizes]
        b = [np.zeros(n, np.uint8) for n in sizes]
        assert local.read_file_into(B, "o/d/part.1", off, a) == \
            remote.read_file_into(B, "o/d/part.1", off, b)
        assert [bytes(x) for x in a] == [x.tobytes() for x in b]
    with pytest.raises(FileNotFoundErr):
        remote.read_file_into(B, "o/none/part.1", 0, [bytearray(4)])


def test_health_wrapper_faults_transport_not_answers(tmp_path):
    """A remote handler's domain error leaves the drive online; a dead
    owner is a drive fault that opens the breaker."""
    root = str(tmp_path / "drv")
    srv = _serve([root])
    d = DiskHealthWrapper(RemoteStorage("127.0.0.1", srv.port, root),
                          op_timeout=5.0, trip_after=2, cooldown=60.0)
    d.make_vol(B)
    for _ in range(5):
        with pytest.raises(FileNotFoundErr):
            d.read_all(B, "missing")
    with pytest.raises(VolumeExists):
        d.make_vol(B)
    assert d.is_online()
    srv.stop()
    for _ in range(2):
        with pytest.raises(StorageError):
            d.read_all(B, "missing")
    assert not d.is_online()
    with pytest.raises(FaultyDisk):
        d.read_all(B, "missing")


# ---------------------------------------------------------------------------
# an ErasureSet over remote drives, against the JAX package's
# ---------------------------------------------------------------------------

SIZES = {"inline": 5000, "small": 1, "big": 300_000, "ragged": 393_219}


def _bodies():
    rng = np.random.default_rng(1414)
    return {k: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for k, n in SIZES.items()}


_JAX_SIDE = textwrap.dedent("""
    import hashlib, json, sys
    import numpy as np
    from minio_tpu.grid import GridServer
    from minio_tpu.object.erasure_object import ErasureSet
    from minio_tpu.storage.local import LocalStorage
    from minio_tpu.storage.remote import RemoteStorage, StorageRPCService
    root, sizes = sys.argv[1], json.loads(sys.argv[2])
    rng = np.random.default_rng(1414)
    bodies = {k: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for k, n in sizes.items()}
    roots = [f"{root}/d{i}" for i in range(4)]
    srvs = []
    for half in (roots[:2], roots[2:]):
        s = GridServer(0, host="127.0.0.1")
        StorageRPCService({r: LocalStorage(r) for r in half}).register_into(s)
        s.start()
        srvs.append(s)
    disks = [RemoteStorage("127.0.0.1", srvs[i // 2].port, r)
             for i, r in enumerate(roots)]
    es = ErasureSet(disks)
    es._mrf_closed = True
    es.make_bucket("bkt")
    for k, body in bodies.items():
        es.put_object("bkt", k, body)
    out = {"get": {}, "degraded": {}}
    for k in bodies:
        out["get"][k] = hashlib.sha256(es.get_object("bkt", k)[1]).hexdigest()
    srvs[1].stop()
    for k in bodies:
        try:
            got = es.get_object("bkt", k)[1]
            out["degraded"][k] = hashlib.sha256(got).hexdigest()
        except Exception as e:
            out["degraded"][k] = type(e).__name__
    srvs[0].stop()
    print(json.dumps(out))
""")


def _key_files(drive, key, meta_cls):
    d = os.path.join(drive, B, key)
    xl = meta_cls.load(open(os.path.join(d, "xl.meta"), "rb").read())
    v = xl.versions[0]
    parts = sorted(os.path.join(d, sub, "part.1") for sub in os.listdir(d)
                   if os.path.exists(os.path.join(d, sub, "part.1")))
    return ({**v["ec"], "dist": list(v["ec"]["dist"])}, v["size"],
            list(xl.inline.values()), [open(p, "rb").read() for p in parts])


@pytest.fixture(scope="module")
def two_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("remote_sets")
    r = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(root / "ref"),
                        json.dumps(SIZES)],
                       env=dict(os.environ, PYTHONPATH=REPO,
                                JAX_PLATFORMS="cpu"),
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    roots = [str(root / "port" / f"d{i}") for i in range(4)]
    srvs = [_serve(roots[:2]), _serve(roots[2:])]
    es = ErasureSet([RemoteStorage("127.0.0.1", srvs[i // 2].port, r)
                     for i, r in enumerate(roots)], device="cpu")
    es._mrf_closed = True
    es.make_bucket(B)
    bodies = _bodies()
    for k, body in bodies.items():
        es.put_object(B, k, body)
    port = {"get": {}, "degraded": {}}
    for k in bodies:
        port["get"][k] = hashlib.sha256(es.get_object(B, k)[1]).hexdigest()
    srvs[1].stop()
    for k in bodies:
        try:
            port["degraded"][k] = hashlib.sha256(
                es.get_object(B, k)[1]).hexdigest()
        except Exception as e:  # noqa: BLE001 - compared by name
            port["degraded"][k] = type(e).__name__
    srvs[0].stop()
    es.close()
    yield root, ref, port, bodies


@pytest.mark.parametrize("key", sorted(SIZES))
def test_shard_files_equal_jax(two_sets, key):
    root, _, _, _ = two_sets
    got = [_key_files(str(root / "port" / f"d{i}"), key, port_meta.XLMeta)
           for i in range(4)]
    want = [_key_files(str(root / "ref" / f"d{i}"), key, RefMeta)
            for i in range(4)]
    assert got == want
    inline = key in ("inline", "small")
    assert all(bool(g[2]) == inline and bool(g[3]) != inline for g in got)


@pytest.mark.parametrize("key", sorted(SIZES))
def test_gets_equal_jax_and_reconstruct(two_sets, key):
    _, ref, port, bodies = two_sets
    want = hashlib.sha256(bodies[key]).hexdigest()
    assert port["get"][key] == ref["get"][key] == want
    assert port["degraded"][key] == ref["degraded"][key] == want


# ---------------------------------------------------------------------------
# a set with a remote drive, as the JAX package runs one
# ---------------------------------------------------------------------------

@pytest.fixture
def mixed(tmp_path):
    """One set of 4 drives, 2 of them behind a grid server, seen by two
    ErasureSets: `a` is this node's, `b` stands for another node's."""
    roots = [str(tmp_path / f"d{i}") for i in range(4)]
    srv = _serve(roots[2:])

    def make():
        disks = [LocalStorage(r) for r in roots[:2]] + \
            [RemoteStorage("127.0.0.1", srv.port, r) for r in roots[2:]]
        es = ErasureSet(disks, device="cpu")
        es._mrf_closed = True
        return es
    a, b = make(), make()
    yield a, b, roots
    a.close()
    b.close()
    srv.stop()


def test_remote_set_runs_without_cache_protocol(mixed):
    a, _, roots = mixed
    assert a._remote_set
    assert a.fi_cache.remote_gate() is False
    assert a.metacache.remote_gate() is False
    assert a.group_commit is None
    assert a.metacache.persist_drive is None
    local = ErasureSet([LocalStorage(r + "-l") for r in roots],
                       device="cpu")
    try:
        assert not local._remote_set
        assert local.fi_cache.remote_gate is None
        assert local.metacache.remote_gate is None
        assert local.group_commit is not None
    finally:
        local.close()


def test_remote_set_reads_what_another_node_wrote(mixed):
    """Caches answer misses: an overwrite, a new key and a delete made
    through another node's set show at once in GET, HEAD and listing."""
    a, b, _ = mixed
    a.make_bucket(B)
    a.put_object(B, "k", b"one" * 100)
    for _ in range(2):
        assert a.get_object(B, "k")[1] == b"one" * 100
        assert [o.name for o in a.list_objects(B).objects] == ["k"]
    b.put_object(B, "k", b"two" * 50)
    b.put_object(B, "k2", b"x")
    assert a.get_object(B, "k")[1] == b"two" * 50
    assert a.get_object_info(B, "k").size == 150
    assert [o.name for o in a.list_objects(B).objects] == ["k", "k2"]
    b.delete_object(B, "k2")
    assert [o.name for o in a.list_objects(B).objects] == ["k"]
    assert a.fi_cache.stats()["hits"] == 0
    assert a.fi_cache.stats()["entries"] == 0
    assert a.fi_cache.stats()["stat_entries"] == 0
    hot = HotObjectCache()
    hot.attach_layer(a)
    assert not hot.enabled
    assert not hot.put(B, "k", a.get_object_info(B, "k"), b"two" * 50,
                       None, hot.token(B))
    assert hot.get(B, "k") is None


def test_remote_set_bucket_meta_ttl_is_2s(mixed):
    a, b, _ = mixed
    a.make_bucket(B)
    a.set_bucket_meta(B, {"versioning": True})
    assert a.get_bucket_meta(B) == {"versioning": True}
    b.set_bucket_meta(B, {"versioning-suspended": True})
    assert a.get_bucket_meta(B) == {"versioning": True}    # cached
    time.sleep(a._REMOTE_BUCKET_META_TTL + 0.2)
    assert a.get_bucket_meta(B) == {"versioning-suspended": True}
    assert a._REMOTE_BUCKET_META_TTL == 2.0
    assert a._BUCKET_META_TTL == 60.0
