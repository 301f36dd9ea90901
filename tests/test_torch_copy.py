"""The port's CopyObject and UploadPartCopy against the JAX package's.

Two servers on 12 drives each (EC 8+4), both serving from threads of
this process: the port's, booted through its command line's `boot()`
with `--device cpu`, and the JAX package's S3Server. The same signed
requests (tests/s3client.py) go to both:

  * C5: a copy onto an existing 100-byte object must store the source's
    bytes (the port used to store its empty body); the destination's
    shard files equal the JAX package's, drive by drive;
  * the metadata directive COPY and REPLACE (user metadata, content
    type), a copy of an older version by `?versionId=` into a versioned
    bucket, a copy of a multipart object, UploadPartCopy of ranges (one
    across an erasure block boundary) beside an uploaded part, and the
    refusals (missing source, a malformed source, a range past the end):
    statuses, error codes, ETags and the bytes read back must be equal;
  * a copy onto its own key (REPLACE) and a copy of an older version over
    the latest of its key, each with a body and empty: the source's GET
    read lock is dropped before the destination commits (no reader holds
    the key when its write lock is asked for; a copy that waited on its
    own lock would answer 503 after the 60 s LockTimeout) and each
    answers as the JAX server does.

The port's set has its MRF heal queue closed, as in
tests/test_torch_s3_compat.py.
"""

import re
import threading

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet
from minio_tpu.s3.server import S3Server
from minio_tpu.storage.local import LocalStorage
from minio_tpu_torch import server
from tests.s3client import S3Client

MIB = 1 << 20
BUCKET = "copyb"
VBUCKET = "copyv"
RNG = np.random.default_rng(9)
SRC = RNG.bytes(3 * MIB + 5)
PARTS = [RNG.bytes(5 * MIB), RNG.bytes(5 * MIB), RNG.bytes(MIB + 7)]
# Each package's write-lock requests: [((bucket, key), readers holding
# the key's lock at the request)], filled by _watch_write_locks.
WRITE_LOCKS: dict[str, list] = {"p": [], "r": []}


def _watch_write_locks(pkg: str, es) -> None:
    """Record, for every write lock the set asks for, how many readers
    hold that key's lock at that moment (both packages' NSLockMap keep
    a reader count on each key's lock)."""
    ns = es.ns
    inner = ns.write

    def write(volume, path, *args, **kwargs):
        lk = ns._locks.get((volume, path))
        WRITE_LOCKS[pkg].append(((volume, path),
                                 lk._readers if lk is not None else 0))
        return inner(volume, path, *args, **kwargs)
    ns.write = write


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{"p": port address, "r": reference address}, both with BUCKET
    holding `src`, and the drive roots of each."""
    root = tmp_path_factory.mktemp("s3copy")
    port = server.boot(["--device", "cpu", "--address", "127.0.0.1:0",
                        *[str(root / "p" / f"d{i}") for i in range(12)]])
    port.objects.sets[0]._mrf_closed = True
    _watch_write_locks("p", port.objects.sets[0])
    thread = threading.Thread(target=port.serve_forever, daemon=True)
    thread.start()
    ref_set = ErasureSet([LocalStorage(str(root / "r" / f"d{i}"))
                          for i in range(12)])
    _watch_write_locks("r", ref_set)
    ref = S3Server(ref_set, address="127.0.0.1:0")
    ref.start()
    try:
        addrs = {"p": port.address, "r": ref.address}
        for addr in addrs.values():
            c = S3Client(addr, timeout=300)
            assert c.request("PUT", f"/{BUCKET}")[0] == 200
            assert c.request("PUT", f"/{BUCKET}/src", body=SRC, headers={
                "x-amz-meta-colour": "blue",
                "Content-Type": "text/plain"})[0] == 200
        yield addrs, root
    finally:
        ref.stop()
        port.shutdown()
        thread.join(timeout=30)


def _both(servers, fn):
    addrs, _ = servers
    out = {}
    for p, a in addrs.items():
        c = S3Client(a, timeout=300)
        c.pkg = p
        out[p] = fn(c)
    return out


def _tag(body: bytes, tag: str) -> str:
    m = re.search(rf"<{tag}>([^<]*)</{tag}>".encode(), body)
    return m.group(1).decode() if m else ""


def _copy(c, dst, src, extra=None):
    st, h, body = c.request("PUT", dst, headers={"x-amz-copy-source": src,
                                                 **(extra or {})})
    h = {k.lower(): v for k, v in h.items()}
    return st, _tag(body, "ETag") or _tag(body, "Code"), \
        "x-amz-version-id" in h


def _shard_files(drive) -> list:
    return sorted(f.read_bytes() for f in drive.glob("*/part.1"))


def test_copy_source_is_copied(servers):
    """C5: the destination holds the source's bytes, not the copy
    request's empty body, and its shard files are the JAX package's."""
    def run(c):
        assert c.request("PUT", f"/{BUCKET}/dst", body=b"d" * 100)[0] == 200
        out = _copy(c, f"/{BUCKET}/dst", f"/{BUCKET}/src")
        return out, c.request("GET", f"/{BUCKET}/dst")[2]
    got = _both(servers, run)
    assert got["p"][0] == got["r"][0]
    assert got["p"][0][0] == 200
    assert got["p"][1] == got["r"][1] == SRC
    _, root = servers
    for i in range(12):
        assert _shard_files(root / "p" / f"d{i}" / BUCKET / "dst") == \
            _shard_files(root / "r" / f"d{i}" / BUCKET / "dst")


@pytest.mark.parametrize("directive", ["COPY", "REPLACE"])
def test_copy_metadata_directive(servers, directive):
    key = f"/{BUCKET}/meta-{directive}"

    def run(c):
        out = _copy(c, key, f"/{BUCKET}/src", {
            "x-amz-metadata-directive": directive,
            "x-amz-meta-shape": "round", "Content-Type": "image/png"})
        st, h, _ = c.request("HEAD", key)
        h = {k.lower(): v for k, v in h.items()}
        return out, st, h.get("content-type"), h.get("etag"), sorted(
            (k, v) for k, v in h.items() if k.startswith("x-amz-meta-"))
    got = _both(servers, run)
    assert got["p"] == got["r"]
    want = [("x-amz-meta-shape", "round")] if directive == "REPLACE" \
        else [("x-amz-meta-colour", "blue")]
    assert got["p"][4] == want


def test_copy_by_version_id(servers):
    """An older version, named by ?versionId=, copies into a versioned
    bucket as a new version of the destination."""
    bodies = [RNG.bytes(2 * MIB + 1), RNG.bytes(300)]

    def run(c):
        assert c.request("PUT", f"/{VBUCKET}")[0] == 200
        assert c.request("PUT", f"/{VBUCKET}", query={"versioning": ""},
                         body=b"<VersioningConfiguration><Status>Enabled"
                              b"</Status></VersioningConfiguration>")[0] == 200
        vids = []
        for b in bodies:
            st, h, _ = c.request("PUT", f"/{VBUCKET}/k", body=b)
            vids.append({k.lower(): v for k, v in h.items()}
                        ["x-amz-version-id"])
        out = _copy(c, f"/{VBUCKET}/old", f"/{VBUCKET}/k?versionId={vids[0]}")
        missing = _copy(c, f"/{VBUCKET}/old2",
                        f"/{VBUCKET}/k?versionId=00000000-0000-4000-8000-"
                        "000000000000")
        return out, missing, c.request("GET", f"/{VBUCKET}/old")[2]
    got = _both(servers, run)
    assert got["p"] == got["r"]
    assert got["p"][0][2] and got["p"][1][:2] == (404, "NoSuchVersion")
    assert got["p"][2] == bodies[0]


def _unlocked_copy(c, dst, src, extra=None):
    """The copy's answer, and whether the destination's write lock was
    asked for (at least once) with no reader holding the key: the copy
    had let go of its source's read lock before it committed."""
    seen = WRITE_LOCKS[c.pkg]
    seen.clear()
    out = _copy(c, dst, src, extra)
    bucket, key = dst.lstrip("/").split("/", 1)
    readers = [n for k, n in seen if k == (bucket, key)]
    return out, bool(readers) and not any(readers)


@pytest.mark.parametrize("size", [3 * MIB + 11, 0])
def test_copy_onto_its_own_key(servers, size):
    """A copy onto its own key with REPLACE: the source's read lock is
    dropped before the destination commits, so the copy does not wait
    out its own lock (no reader holds the key when its write lock is
    asked for; the answers of the JAX server); an empty body too (a
    folder marker's metadata update), whose stream delivers no byte at
    all."""
    body = RNG.bytes(size)
    key = f"/{BUCKET}/self{size}"

    def run(c):
        assert c.request("PUT", key, body=body)[0] == 200
        out = _unlocked_copy(c, key, key, {
            "x-amz-metadata-directive": "REPLACE",
            "x-amz-meta-round": "two"})
        st, h, got = c.request("GET", key)
        h = {k.lower(): v for k, v in h.items()}
        return out, st, got, h.get("x-amz-meta-round")
    got = _both(servers, run)
    assert got["p"] == got["r"]
    assert got["p"][0] == ((200, got["p"][0][0][1], False), True)
    assert got["p"][1:] == (200, body, "two")


@pytest.mark.parametrize("size", [2 * MIB + 5, 0])
def test_copy_older_version_over_latest(servers, size):
    """In a versioned bucket, the oldest version copied over the latest
    of its own key becomes a new latest version with its bytes; an empty
    oldest version too."""
    bodies = [RNG.bytes(size), RNG.bytes(700)]
    bucket = f"/copyself{size}"

    def run(c):
        assert c.request("PUT", bucket)[0] == 200
        assert c.request("PUT", bucket, query={"versioning": ""},
                         body=b"<VersioningConfiguration><Status>Enabled"
                              b"</Status></VersioningConfiguration>")[0] == 200
        vids = []
        for b in bodies:
            _, h, _ = c.request("PUT", f"{bucket}/k", body=b)
            vids.append({k.lower(): v for k, v in h.items()}
                        ["x-amz-version-id"])
        out = _unlocked_copy(c, f"{bucket}/k",
                          f"{bucket}/k?versionId={vids[0]}")
        latest = c.request("GET", f"{bucket}/k")[2]
        older = [c.request("GET", f"{bucket}/k",
                           query={"versionId": v})[2] for v in vids]
        return out, latest, older
    got = _both(servers, run)
    assert got["p"] == got["r"]
    assert got["p"][0][1] and got["p"][0][0][0] == 200 and got["p"][0][0][2]
    assert got["p"][1] == bodies[0] and got["p"][2] == bodies


def _upload(c, key, parts):
    """Initiate, then each part: bytes, or (copy source, range or None);
    returns (upload id, [(status, etag)])."""
    _, _, body = c.request("POST", key, query={"uploads": ""})
    uid = _tag(body, "UploadId")
    out = []
    for n, p in enumerate(parts, 1):
        q = {"partNumber": str(n), "uploadId": uid}
        if isinstance(p, bytes):
            st, h, _ = c.request("PUT", key, query=q, body=p)
            out.append((st, {k.lower(): v for k, v in h.items()}.get("etag")))
        else:
            src, rng = p
            st, _, body = c.request(
                "PUT", key, query=q,
                headers={"x-amz-copy-source": src,
                         **({"x-amz-copy-source-range": rng} if rng else {})})
            out.append((st, '"%s"' % _tag(body, "ETag").strip('"')
                        if st == 200 else _tag(body, "Code")))
    return uid, out


def _complete(c, key, uid, etags):
    xml = "<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>"
    st, _, body = c.request("POST", key, query={"uploadId": uid},
                            body=xml.encode())
    return st, _tag(body, "ETag")


@pytest.fixture(scope="module")
def multipart_source(servers):
    """`mp`, a multipart object of PARTS, on both servers."""
    def run(c):
        uid, parts = _upload(c, f"/{BUCKET}/mp", PARTS)
        return _complete(c, f"/{BUCKET}/mp", uid, [e for _, e in parts])
    done = _both(servers, run)
    assert done["p"] == done["r"] and done["p"][0] == 200


def test_copy_of_multipart_source(servers, multipart_source):
    def run(c):
        out = _copy(c, f"/{BUCKET}/mp-copy", f"/{BUCKET}/mp")
        return out, c.request("GET", f"/{BUCKET}/mp-copy")[2]
    got = _both(servers, run)
    assert got["p"] == got["r"]
    assert got["p"][1] == b"".join(PARTS)


def test_upload_part_copy_ranges(servers, multipart_source):
    """Parts: the multipart source's first 5 MiB + 5 B (across its part
    and erasure block boundary), an uploaded 5 MiB part, 5 MiB across
    the same boundary, and `src` whole; then the refusals of a range
    past the end, a missing source and a malformed one."""
    mp_src = b"".join(PARTS)
    lo = 5 * MIB - 100

    def run(c):
        key = f"/{BUCKET}/upc"
        uid, parts = _upload(c, key, [
            (f"/{BUCKET}/mp", f"bytes=0-{5 * MIB + 4}"),
            PARTS[0],
            (f"/{BUCKET}/mp", f"bytes={lo}-{lo + 5 * MIB - 1}"),
            (f"/{BUCKET}/src", None)])
        done = _complete(c, key, uid, [e for _, e in parts])
        _, bad = _upload(c, f"/{BUCKET}/upc2", [
            (f"/{BUCKET}/src", f"bytes={len(SRC)}-{len(SRC) + 9}"),
            (f"/{BUCKET}/nope", None), ("nobucketkey", None)])
        return parts, done, bad, c.request("GET", key)[2]
    got = _both(servers, run)
    assert got["p"] == got["r"]
    parts, done, bad, body = got["p"]
    assert [st for st, _ in parts] == [200] * 4 and done[0] == 200
    assert body == mp_src[:5 * MIB + 5] + PARTS[0] + \
        mp_src[lo:lo + 5 * MIB] + SRC
    assert bad == [(416, "InvalidRange"), (404, "NoSuchKey"),
                   (400, "InvalidArgument")]
