"""Multipart uploads over one erasure set.

The port of minio_tpu/object/multipart.py (reference
cmd/erasure-multipart.go:521 NewMultipartUpload, :570 PutObjectPart,
:1093 CompleteMultipartUpload), with the same records on the drives:

    .mtpu.sys/multipart/<bucket>/<sha256(bucket/object)[:32]>/<upload id>/
        upload.json          the upload's record (EC layout, metadata)
        part.N.<uuid>        one bitrot-framed shard file per attempt
        part.N.meta          the part's record, naming its data file

Each part is an independent erasure encode that streams through the
set's PUT machinery (ErasureSet._stream_framed_writes: a body of one
window through the fan-out pool and the put batcher, so concurrent parts
share device dispatches; a larger one through a writer thread a drive).
Every attempt writes its own data file and the `.meta` replace that
names it is the commit point, so a retried part never pairs a torn data
file with a record that validates. Completion checks the client's part
list against the stored records and moves the part files into one new
data dir under the key's lock through the same staged rename_data commit
a PUT uses. The final ETag is the MD5 of the concatenated part MD5s,
then `-N`.

An upload started in a versioned bucket records `versioned` and its
completion writes a new version id; otherwise it writes the null
version. UploadPartCopy is the S3 front end's: it streams a byte range of
the source object (ErasureSet.get_object_stream) into put_object_part as
a Payload, window by window.

Not ported yet: SSE (a part's `nonce` stays "").
"""

from __future__ import annotations

import hashlib
import json
import os

from minio_tpu_torch.erasure.codec import Erasure
from minio_tpu_torch.object.erasure_object import (BLOCK_SIZE, STAGING_PREFIX,
                                                   _quiet, hash_order)
from minio_tpu_torch.object.types import (EntityTooSmall, InvalidArgument,
                                          InvalidPart, InvalidPartOrder,
                                          ObjectInfo, PutOptions,
                                          UploadNotFound, WriteQuorumError)
from minio_tpu_torch.storage.local import SYS_VOL
from minio_tpu_torch.storage.meta import (ErasureInfo, FileInfo,
                                          ObjectPartInfo, new_uuid, now_ns)
from minio_tpu_torch.utils.streams import Payload

MIN_PART_SIZE = 5 * (1 << 20)   # every part but the last (AWS rule)
MAX_PARTS = 10_000


def _upload_root(bucket: str, object_: str) -> str:
    digest = hashlib.sha256(f"{bucket}/{object_}".encode()).hexdigest()[:32]
    return f"multipart/{bucket}/{digest}"


def _upload_dir(bucket: str, object_: str, upload_id: str) -> str:
    return f"{_upload_root(bucket, object_)}/{upload_id}"


def new_multipart_upload(es, bucket: str, object_: str,
                         opts: PutOptions | None = None) -> str:
    """Record a new upload on a majority of drives; returns its id.
    opts.versioned: the completed object gets a version id of its own."""
    opts = opts or PutOptions()
    es._check_bucket(bucket)
    n = len(es.disks)
    m = es.default_parity
    k = n - m
    upload_id = new_uuid()
    record = {
        "bucket": bucket, "object": object_, "upload_id": upload_id,
        "k": k, "m": m, "distribution": hash_order(f"{bucket}/{object_}", n),
        "user_metadata": {key: v for key, v in opts.user_metadata.items()
                          if not key.startswith("x-internal-")},
        "internal_metadata": {}, "content_type": opts.content_type,
        "versioned": bool(opts.versioned), "initiated": now_ns(),
    }
    blob = json.dumps(record).encode()
    path = f"{_upload_dir(bucket, object_, upload_id)}/upload.json"
    _, errors = es._fanout([lambda d=d: d.write_all(SYS_VOL, path, blob)
                            for d in es.disks])
    if sum(e is None for e in errors) < n // 2 + 1:
        raise WriteQuorumError(bucket, object_)
    return upload_id


def _read_upload(es, bucket: str, object_: str, upload_id: str) -> dict:
    path = f"{_upload_dir(bucket, object_, upload_id)}/upload.json"
    results, _ = es._fanout([lambda d=d: d.read_all(SYS_VOL, path)
                             for d in es.disks])
    for r in results:
        if r is not None:
            try:
                return json.loads(r)
            except ValueError:
                continue
    raise UploadNotFound(bucket, object_, upload_id)


def put_object_part(es, bucket: str, object_: str, upload_id: str,
                    part_number: int, data) -> ObjectPartInfo:
    """Erasure-code one part (bytes or a utils.streams.Payload, read
    window by window) into its own data file on every drive, then commit
    its record where the data landed. The payload's finish hook runs on
    the last byte, before the record is written."""
    if not 1 <= part_number <= MAX_PARTS:
        raise InvalidArgument(bucket, object_, "part number out of range")
    rec = _read_upload(es, bucket, object_, upload_id)
    k, m, dist = rec["k"], rec["m"], rec["distribution"]
    n = k + m
    write_quorum = k + (1 if k == m else 0)
    payload = Payload.wrap(data)
    size = payload.size
    updir = _upload_dir(bucket, object_, upload_id)
    data_file = f"part.{part_number}.{new_uuid()}"
    errors: list = [None] * n

    def cleanup() -> None:
        es._fanout([lambda d=d: _quiet(
            lambda: d.delete(SYS_VOL, f"{updir}/{data_file}"))
            for d in es.disks])

    e = Erasure(k, m, BLOCK_SIZE, backend=es.backend)
    try:
        etag = es._stream_framed_writes(payload, e, dist,
                                        f"{updir}/{data_file}",
                                        write_quorum, errors)
    except BaseException:
        cleanup()
        raise
    meta = {"number": part_number, "size": size, "actual_size": size,
            "etag": etag, "mod_time": now_ns(), "file": data_file,
            "nonce": ""}
    blob = json.dumps(meta).encode()
    _, merrors = es._fanout([
        (lambda i=i: es.disks[i].write_all(
            SYS_VOL, f"{updir}/part.{part_number}.meta", blob))
        if errors[i] is None else None for i in range(n)])
    if sum(errors[i] is None and merrors[i] is None
           for i in range(n)) < write_quorum:
        cleanup()
        raise WriteQuorumError(bucket, object_)
    return ObjectPartInfo(number=part_number, size=size, actual_size=size,
                          etag=etag, mod_time=meta["mod_time"])


def _read_part_meta(es, updir: str, part_number: int):
    """The record most drives hold for a part, or None."""
    path = f"{updir}/part.{part_number}.meta"
    results, _ = es._fanout([lambda d=d: d.read_all(SYS_VOL, path)
                             for d in es.disks])
    votes: dict[bytes, int] = {}
    for r in results:
        if r is not None:
            votes[r] = votes.get(r, 0) + 1
    if not votes:
        return None
    try:
        return json.loads(max(votes, key=lambda b: votes[b]))
    except ValueError:
        return None


def list_parts(es, bucket: str, object_: str, upload_id: str,
               part_marker: int = 0, max_parts: int = 1000) -> list[dict]:
    """The records of the upload's parts above `part_marker`, in part
    order, at most `max_parts`."""
    _read_upload(es, bucket, object_, upload_id)      # the upload exists
    updir = _upload_dir(bucket, object_, upload_id)
    results, _ = es._fanout([lambda d=d: d.list_dir(SYS_VOL, updir)
                             for d in es.disks])
    numbers = set()
    for entries in results:
        for name in entries or ():
            if name.startswith("part.") and name.endswith(".meta"):
                try:
                    numbers.add(int(name[len("part."):-len(".meta")]))
                except ValueError:
                    pass
    found: dict[int, dict] = {}
    for num in sorted(numbers):
        if num <= part_marker:
            continue
        meta = _read_part_meta(es, updir, num)
        if meta:
            found[num] = meta
        if len(found) >= max_parts:
            break
    return [found[num] for num in sorted(found)]


def list_multipart_uploads(es, bucket: str, prefix: str = "") -> list[dict]:
    """The records of the bucket's uploads in progress whose key starts
    with `prefix`, by key and then initiation time."""
    es._check_bucket(bucket)
    out, seen = [], set()
    for d in es.disks[:len(es.disks) // 2 + 1]:
        try:
            hashes = d.list_dir(SYS_VOL, f"multipart/{bucket}")
        except Exception:  # noqa: BLE001 - no uploads on this drive
            continue
        for hdir in hashes:
            hdir = hdir.rstrip("/")
            try:
                uploads = d.list_dir(SYS_VOL, f"multipart/{bucket}/{hdir}")
            except Exception:  # noqa: BLE001 - gone meanwhile
                continue
            for uid in uploads:
                uid = uid.rstrip("/")
                if uid in seen:
                    continue
                try:
                    rec = json.loads(d.read_all(
                        SYS_VOL,
                        f"multipart/{bucket}/{hdir}/{uid}/upload.json"))
                except Exception:  # noqa: BLE001 - torn or gone
                    continue
                if rec.get("object", "").startswith(prefix):
                    seen.add(uid)
                    out.append(rec)
    out.sort(key=lambda r: (r.get("object", ""), r.get("initiated", 0)))
    return out


def abort_multipart_upload(es, bucket: str, object_: str,
                           upload_id: str) -> None:
    _read_upload(es, bucket, object_, upload_id)
    updir = _upload_dir(bucket, object_, upload_id)
    es._fanout([lambda d=d: _quiet(
        lambda: d.delete(SYS_VOL, updir, recursive=True)) for d in es.disks])


def complete_multipart_upload(es, bucket: str, object_: str, upload_id: str,
                              parts: list) -> ObjectInfo:
    """parts: [(part number, etag), ...] in the client's order. Moves the
    named parts' data files into a new data dir on every drive and
    commits the version; a commit on fewer than n drives queues the
    object on the MRF."""
    rec = _read_upload(es, bucket, object_, upload_id)
    k, m, dist = rec["k"], rec["m"], rec["distribution"]
    n = k + m
    updir = _upload_dir(bucket, object_, upload_id)
    if not parts:
        raise InvalidPart(bucket, object_, "empty part list")
    if any(parts[i][0] >= parts[i + 1][0] for i in range(len(parts) - 1)):
        raise InvalidPartOrder(bucket, object_)

    fi_parts: list[ObjectPartInfo] = []
    files: dict[int, str] = {}
    md5_concat = b""
    total = 0
    for idx, (num, etag) in enumerate(parts):
        meta = _read_part_meta(es, updir, num)
        clean = etag.strip('"')
        if meta is None or meta["etag"] != clean:
            raise InvalidPart(bucket, object_, f"part {num}")
        if meta["actual_size"] < MIN_PART_SIZE and idx != len(parts) - 1:
            raise EntityTooSmall(bucket, object_, f"part {num}")
        fi_parts.append(ObjectPartInfo(
            number=num, size=meta["size"], actual_size=meta["actual_size"],
            etag=clean, mod_time=meta["mod_time"],
            nonce=meta.get("nonce", "")))
        files[num] = meta.get("file", f"part.{num}")
        md5_concat += bytes.fromhex(clean)
        total += meta["size"]

    etag = hashlib.md5(md5_concat).hexdigest() + f"-{len(parts)}"
    version_id = new_uuid() if rec.get("versioned") else ""
    mod_time = now_ns()
    data_dir = new_uuid()
    metadata = dict(rec.get("user_metadata") or {})
    metadata.update(rec.get("internal_metadata") or {})
    metadata["etag"] = etag
    if rec.get("content_type"):
        metadata["content-type"] = rec["content_type"]
    staging = f"{STAGING_PREFIX}/p{os.getpid()}-{new_uuid()}"

    def commit_one(i: int) -> None:
        d = es.disks[i]
        for num, _ in parts:
            d.rename_file(SYS_VOL, f"{updir}/{files[num]}",
                          SYS_VOL, f"{staging}/{data_dir}/part.{num}")
        d.rename_data(SYS_VOL, staging, FileInfo(
            volume=bucket, name=object_, version_id=version_id,
            data_dir=data_dir,
            mod_time=mod_time, size=total, metadata=metadata,
            parts=list(fi_parts),
            erasure=ErasureInfo(data_blocks=k, parity_blocks=m,
                                block_size=BLOCK_SIZE,
                                index=dist[i], distribution=tuple(dist))),
            bucket, object_)

    errors: list = [None] * n
    try:
        es._commit(bucket, object_, version_id, errors,
                   k + (1 if k == m else 0), commit_one)
    finally:
        es._fanout([lambda d=d: _quiet(
            lambda: d.delete(SYS_VOL, staging, recursive=True))
            for d in es.disks])
    if any(errors):
        es.mrf.enqueue(bucket, object_, version_id)
    # The part files moved on the drives that committed; stale copies
    # elsewhere go with the upload dir.
    es._fanout([lambda d=d: _quiet(
        lambda: d.delete(SYS_VOL, updir, recursive=True)) for d in es.disks])
    return ObjectInfo(bucket=bucket, name=object_, mod_time=mod_time,
                      size=total, etag=etag, version_id=version_id,
                      content_type=rec.get("content_type", ""),
                      user_metadata=dict(rec.get("user_metadata") or {}),
                      parts=fi_parts)
