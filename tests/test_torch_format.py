"""format.json in the port (topology/format.py, LocalStorage's identity)
against the JAX package's.

  * The two packages write the same format.json bytes for the same
    identity; a layout either package formatted loads in the other, and
    the same drives, shuffled, come back in the same order in both.
  * The JAX package's format cases (tests/test_topology.py) against the
    port: fresh init and reload in shuffled order, a fresh drive adopted
    into its slot with a healing marker, a foreign drive refused and
    left untouched, no quorum refused.
  * The port's server boots on 12 drives the JAX package formatted,
    shuffled on its command line, in their slots; and on 12 drives whose
    slot 0 holds a foreign drive: slot 0 is an OfflineDisk, and PUT, GET, listing (whose walk
    runs persist on the first drive with a root) and small group
    commits work at EC 8+4.

Exact comparisons: bytes, JSON and drive order.
"""

import json
import os
import random
import shutil
import threading

import pytest

from minio_tpu.storage.local import LocalStorage as RefDisk
from minio_tpu.topology import format as ref_fmt

from minio_tpu_torch import server
from minio_tpu_torch.storage.local import (SYS_VOL, LocalStorage,
                                           OfflineDisk, read_healing)
from minio_tpu_torch.topology import format as fmt_mod
from tests.s3client import S3Client


def _mkdisks(tmp_path, n, prefix="d", cls=LocalStorage):
    return [cls(str(tmp_path / f"{prefix}{i}")) for i in range(n)]


def _format_bytes(root) -> bytes:
    return open(os.path.join(root, SYS_VOL, "format.json"), "rb").read()


def test_same_identity_same_bytes(tmp_path):
    info = dict(deployment_id="dep-1", sets=[["u0", "u1", "u2", "u3"]],
                this="u2")
    LocalStorage(str(tmp_path / "p")).write_format(
        fmt_mod.FormatInfo(**info).to_json())
    RefDisk(str(tmp_path / "r")).write_format(
        ref_fmt.FormatInfo(**info).to_json())
    assert _format_bytes(tmp_path / "p") == _format_bytes(tmp_path / "r")


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_layout_loads_across_packages(tmp_path, writer):
    make = RefDisk if writer == "ref" else LocalStorage
    first = ref_fmt.boot if writer == "ref" else fmt_mod.boot
    disks = _mkdisks(tmp_path, 6, cls=make)
    ordered, fmt = first(disks, 6)
    roots = [d.root for d in ordered]
    shuffled = list(range(6))
    random.Random(3).shuffle(shuffled)
    got = {}
    for name, cls, boot in (("ref", RefDisk, ref_fmt.boot),
                            ("port", LocalStorage, fmt_mod.boot)):
        again = [cls(str(tmp_path / f"d{i}")) for i in shuffled]
        o, f = boot(again, 6)
        assert f.deployment_id == fmt.deployment_id and f.sets == fmt.sets
        got[name] = [d.root for d in o]
    assert got["ref"] == got["port"] == roots
    # Nothing was rewritten: every drive keeps the writer's bytes.
    assert all(json.loads(_format_bytes(r))["id"] == fmt.deployment_id
               for r in roots)


def test_format_fresh_init_and_reload(tmp_path):
    disks = _mkdisks(tmp_path, 4)
    ordered, fmt = fmt_mod.boot(disks, 4)
    assert len(fmt.sets) == 1 and len(fmt.sets[0]) == 4
    for d, u in zip(ordered, fmt.sets[0]):
        assert d.read_format()["xl"]["this"] == u
    shuffled = list(disks)
    random.Random(7).shuffle(shuffled)
    ordered2, fmt2 = fmt_mod.boot(shuffled, 4)
    assert fmt2.deployment_id == fmt.deployment_id
    assert [d.root for d in ordered2] == [d.root for d in ordered]


def test_format_fresh_drive_healed_into_position(tmp_path):
    disks = _mkdisks(tmp_path, 4)
    _, fmt = fmt_mod.boot(disks, 4)
    shutil.rmtree(tmp_path / "d2")
    disks2 = _mkdisks(tmp_path, 4)
    ordered, _ = fmt_mod.boot(disks2, 4)
    assert all(d is not None for d in ordered)
    healed = ordered[2]
    assert healed.read_format()["xl"]["this"] == fmt.sets[0][2]
    marker = read_healing(healed)
    assert marker["disk_index"] == 2 and not marker["finished"]
    assert healed.disk_info().healing
    assert [read_healing(d) for i, d in enumerate(ordered) if i != 2] \
        == [None] * 3


def test_format_foreign_drive_refused(tmp_path):
    disks = _mkdisks(tmp_path, 4)
    fmt_mod.boot(disks, 4)
    foreign = _mkdisks(tmp_path, 4, prefix="f")
    fmt_mod.boot(foreign, 4)
    before = _format_bytes(tmp_path / "f0")
    ordered, _ = fmt_mod.boot(disks[:3] + [foreign[0]], 4)
    assert ordered.count(None) == 1
    assert foreign[0] not in ordered
    assert _format_bytes(tmp_path / "f0") == before


def test_format_no_quorum_fails(tmp_path):
    disks = _mkdisks(tmp_path, 4)
    fmt_mod.boot(disks, 4)
    for i in (0, 1, 2):
        os.remove(tmp_path / f"d{i}" / SYS_VOL / "format.json")
    with pytest.raises(fmt_mod.FormatError):
        fmt_mod.boot(_mkdisks(tmp_path, 4), 4)


def test_server_boots_on_reference_formatted_drives(tmp_path):
    """The port's server boots on 12 drives the JAX package formatted,
    given in a shuffled order: it serves them in their format slots and
    rewrites no format.json."""
    drives = [str(tmp_path / f"d{i}") for i in range(12)]
    fmts = ref_fmt.init_formats([RefDisk(d) for d in drives], 12)
    before = [_format_bytes(d) for d in drives]
    shuffled = list(drives)
    random.Random(11).shuffle(shuffled)
    srv = server.boot(["--device", "cpu", "--address", "127.0.0.1:0",
                       "--scanner-interval", "0", *shuffled])
    try:
        assert srv.format.deployment_id == fmts[0].deployment_id
        assert [d.root for d in srv.objects.disks] == \
            [os.path.abspath(d) for d in drives]
        assert not any(d.disk_info().healing for d in srv.objects.disks)
    finally:
        srv.close()
    assert [_format_bytes(d) for d in drives] == before


def test_server_boots_with_slot_zero_refused(tmp_path):
    drives = [str(tmp_path / f"d{i}") for i in range(12)]
    fmt_mod.boot([LocalStorage(d) for d in drives], 12)
    fmt_mod.boot(_mkdisks(tmp_path, 12, prefix="f"), 12)
    shutil.copy(tmp_path / "f0" / SYS_VOL / "format.json",
                tmp_path / "d0" / SYS_VOL / "format.json")
    srv = server.boot(["--device", "cpu", "--address", "127.0.0.1:0",
                       "--scanner-interval", "0", *drives])
    srv.objects._mrf_closed = True
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        es = srv.objects
        assert isinstance(es.disks[0], OfflineDisk)
        assert es.metacache.persist_drive.root == \
            os.path.abspath(drives[1])
        c = S3Client(srv.address)
        assert c.request("PUT", "/bk0")[0] == 200
        bodies = {f"k{i:02d}": os.urandom(1000 + i) for i in range(24)}
        errs = []

        def put(keys):
            for k in keys:
                st, _, _ = c.request("PUT", f"/bk0/{k}", body=bodies[k])
                if st != 200:
                    errs.append((k, st))
        ths = [threading.Thread(target=put, args=(list(bodies)[t::4],))
               for t in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        assert not errs
        big = os.urandom(3 << 20)
        assert c.request("PUT", "/bk0/big", body=big)[0] == 200
        for k, v in {**bodies, "big": big}.items():
            assert c.request("GET", f"/bk0/{k}")[2] == v
        for _ in range(2):
            st, _, body = c.request("GET", "/bk0", {"list-type": "2"})
            assert st == 200
            assert body.count(b"<Key>") == len(bodies) + 1
        st, _, body = c.request("GET", "/minio/health/ready")
        assert st == 200, body
    finally:
        srv.shutdown()
        thread.join(30)
    # The refused drive was never written.
    assert not os.path.isdir(tmp_path / "d0" / "bk0")
