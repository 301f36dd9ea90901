"""The port stands alone: no JAX, no TPU package, no msgpack, and no
silent CPU fallback when the card it defaults to is missing."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "minio_tpu", "msgpack")


def _port_files():
    return sorted((REPO / "minio_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_package_loads_none_of_them():
    mods = ["minio_tpu_torch.server", "minio_tpu_torch.ops.rs_device",
            "minio_tpu_torch.ops.hh_device", "minio_tpu_torch.storage.bitrot",
            "minio_tpu_torch.ops.batcher", "minio_tpu_torch.io.engine",
            "minio_tpu_torch.io.bufpool", "minio_tpu_torch.utils.deadline",
            "minio_tpu_torch.utils.latency",
            "minio_tpu_torch.experiments.rs_i8_kernel"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_without_cuda_raises(monkeypatch, tmp_path):
    from minio_tpu_torch import device
    from minio_tpu_torch.object.erasure_object import ErasureSet
    from minio_tpu_torch.ops import hh_device, rs_device
    from minio_tpu_torch.storage.local import LocalStorage

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve()
    with pytest.raises(RuntimeError):
        rs_device.GpuBackend()
    with pytest.raises(RuntimeError):
        hh_device.make_deframer(4)
    pm = np.array([[1, 1], [1, 2]], dtype=np.uint8)
    for make in (lambda: hh_device.make_mesh_framer(pm),
                 lambda: hh_device.make_mesh_deframer(2),
                 lambda: rs_device.make_mesh_matrix(pm),
                 lambda: rs_device.mesh_info()):
        with pytest.raises(RuntimeError):
            make()
    with pytest.raises(RuntimeError):
        ErasureSet([LocalStorage(str(tmp_path / f"d{i}")) for i in range(4)])
    assert device.resolve("cpu") == torch.device("cpu")


def test_server_cli_without_cuda_refuses_to_serve(tmp_path):
    code = ("import torch, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "from minio_tpu_torch import server\n"
            f"sys.exit(server.main(['--address', '127.0.0.1:0', "
            f"{str(tmp_path / 'd0')!r}]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       env=dict(os.environ, PYTHONPATH=str(REPO)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is false" in r.stderr
    assert "serving S3" not in r.stdout


def test_fleet_without_cuda_refuses_to_serve(tmp_path):
    """--device cuda with MTPU_HTTP_WORKERS=2 and no card: worker 0's
    boot raises, and the fleet exits non-zero without serving (the
    kernels' build is stubbed: this host has no nvcc either)."""
    code = ("import torch, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "from minio_tpu_torch.ops import _build\n"
            "_build.build = lambda *a, **k: {}\n"
            "from minio_tpu_torch import server\n"
            f"sys.exit(server.main(['--address', '127.0.0.1:0', "
            f"{str(tmp_path / 'd0')!r}]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       env=dict(os.environ, PYTHONPATH=str(REPO),
                                MTPU_HTTP_WORKERS="2"),
                       capture_output=True, text=True, timeout=120,
                       start_new_session=True)
    assert r.returncode != 0
    assert "pre-forked front end: 2 workers" in r.stdout
    assert "worker 0 boot failed" in r.stderr
    assert "torch.cuda.is_available() is false" in r.stderr
    assert "serving S3" not in r.stdout
