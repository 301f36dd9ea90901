"""Admin profiling on the port (minio_tpu_torch/s3/profiling.py, the
server's `start-profiling` and `download-profiling`, the `peer.profile`
grid verb), held to the JAX package's bundle layout.

On Python 3.12 cProfile is one process-wide sys.monitoring tool: the
JAX `Profiler.request_profile` enables a second profile inside the
running one, which raises. The port runs the one profile between start
and stop, which sees every thread, and takes no per-request captures.
"""

from __future__ import annotations

import base64
import io
import marshal
import os
import sys
import threading
import zipfile

import pytest

from minio_tpu.s3 import profiling as ref_profiling

from minio_tpu_torch import server
from minio_tpu_torch.grid.client import GridClient
from minio_tpu_torch.grid.server import GridServer
from minio_tpu_torch.s3.profiling import (PROFILE_HANDLER, Profiler,
                                          ProfileError, bundle,
                                          make_profile_handler)
from tests.s3client import S3Client


@pytest.mark.skipif(sys.version_info < (3, 12),
                    reason="cProfile is a per-thread hook before 3.12")
def test_jax_request_profile_raises_where_the_port_does_not():
    ref = ref_profiling.Profiler()
    ref.start()
    try:
        with pytest.raises(ValueError, match="profiling tool"):
            with ref.request_profile():
                pass
    finally:
        ref.stop()
    port = Profiler()
    port.start()
    try:
        # The one profile sees another thread's work.
        t = threading.Thread(target=_busy_work)
        t.start()
        t.join()
        # A second profile of the process is refused as an admin error.
        with pytest.raises(ProfileError):
            Profiler().start()
    finally:
        rec = port.stop()
    assert "_busy_work" in rec["text"]
    assert not port.running


def _busy_work() -> int:
    return sum(i * i for i in range(200_000))


def test_profile_start_load_download(tmp_path):
    srv = server.boot(["--device", "cpu", "--address", "127.0.0.1:0",
                       "--scanner-interval", "0",
                       *[str(tmp_path / f"d{i}") for i in range(4)]])
    srv.objects.sets[0]._mrf_closed = True
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        cli = S3Client(srv.address)
        assert cli.request("PUT", "/profbkt")[0] == 200
        st, _, b = cli.request("POST", "/minio/admin/v3/start-profiling")
        assert st == 200, b
        try:
            # A second start is refused.
            assert cli.request(
                "POST", "/minio/admin/v3/start-profiling")[0] == 400
            for i in range(5):
                assert cli.request("PUT", f"/profbkt/o{i}",
                                   body=os.urandom(20_000))[0] == 200
        finally:
            st, h, body = cli.request(
                "GET", "/minio/admin/v3/download-profiling")
        assert st == 200
        assert h.get("Content-Type") == "application/zip"
        z = zipfile.ZipFile(io.BytesIO(body))
        assert z.namelist() == ["local/profile.pstats",
                                "local/profile.txt"]
        # The one profile saw the request threads' PUTs.
        assert "put_object" in z.read("local/profile.txt").decode()
        assert marshal.loads(z.read("local/profile.pstats"))
        # No profile running: a clean 400.
        assert cli.request(
            "GET", "/minio/admin/v3/download-profiling")[0] == 400
    finally:
        if srv.profiler.running:
            srv.profiler.stop()
        srv.shutdown()
        t.join(timeout=30)


def test_peer_profile_handler_roundtrip():
    """The `peer.profile` verb in process and over a real grid pair,
    and the bundle's layout, equal to the JAX package's."""
    p = Profiler()
    h = make_profile_handler(p)
    assert h({"action": "start"})["ok"]
    assert h({"action": "start"})["ok"]     # already running: converged
    sum(i * i for i in range(50_000))
    rec = h({"action": "stop"})
    assert rec["ok"] and rec["text"]
    assert marshal.loads(base64.b64decode(rec["stats_b64"]))
    assert not h({"action": "stop"})["ok"]  # nothing running now
    assert h({"action": "other"}) == {"ok": False}

    srv = GridServer(0, host="127.0.0.1")
    srv.register(PROFILE_HANDLER, make_profile_handler(Profiler()))
    srv.start()
    cli = GridClient("127.0.0.1", srv.port, connect_timeout=2.0)
    try:
        assert cli.call(PROFILE_HANDLER, {"action": "start"},
                        timeout=5) == {"ok": True}
        rec = cli.call(PROFILE_HANDLER, {"action": "stop"}, timeout=10)
        assert rec["ok"] and isinstance(rec["duration_s"], float)
        assert marshal.loads(base64.b64decode(rec["stats_b64"])) \
            is not None
    finally:
        cli.close()
        srv.stop()
    per_node = {"n1": {"stats": b"x", "text": "t"},
                "local": {"stats": b"yz", "text": "u"}}
    blob = bundle(per_node)
    ref_blob = ref_profiling.bundle(per_node)
    got, want = (zipfile.ZipFile(io.BytesIO(b)) for b in (blob, ref_blob))
    assert got.namelist() == want.namelist() == [
        "n1/profile.pstats", "n1/profile.txt", "local/profile.pstats",
        "local/profile.txt"]
    assert all(got.read(n) == want.read(n) for n in got.namelist())
