"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled on first use by `nvcc` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) under `build/torch_kernels/` at the repository root, and
loaded with ctypes. The library's file name carries a hash of its
source, so an edited kernel is rebuilt and a stale one is never loaded.
A failed build raises; nothing falls back to a plain version.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/<name>.cu

`-Xptxas -v`'s report (registers, shared memory, spills per kernel) is
kept beside each library as `<lib>.ptxas.txt`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("gf_apply", "highwayhash", "rs_i8")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    return BUILD_DIR / f"{name}-{hashlib.sha256(src).hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict[str, Path]:
    """Compile every named kernel whose library is missing, one nvcc
    process per source, all started together. Returns name -> library."""
    out = {n: lib_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".tmp{os.getpid()}")
        procs[n] = (tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{n}.cu (rc {proc.returncode}):\n{text}")
            continue
        Path(str(todo[n]) + ".ptxas.txt").write_text(text)
        os.replace(tmp, todo[n])
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return out


def ptxas_report(name: str) -> str:
    """nvcc -Xptxas -v output of the built library (registers, smem)."""
    p = Path(str(lib_path(name)) + ".ptxas.txt")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build((name,))[name]))
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
