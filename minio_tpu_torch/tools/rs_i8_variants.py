"""Time variants of the rs_i8 kernel's compile-time constants on one card.

    python -m minio_tpu_torch.tools.rs_i8_variants kMinBlocksVec=3 \
        kMinBlocksVec=2,kUnrollVec=1 ...

Each argument is one variant: `constexpr int` names of
`ops/csrc/rs_i8.cu` and their values (no argument: the source as it
is). A variant is a copy of the package under
`build/rs_i8_variants/<variant>/` with those constants replaced, built
there and run in its own process: ptxas' report (registers, spills),
`rs_apply8` against `gf_apply` on ragged, unaligned and widest-matrix
shapes (exact), then `rs_apply8` and `gf_apply` at 32 and 256 EC 8+4
blocks of 128 KiB, CUDA events over 40 launches, inputs rotated over
buffers larger than L2, as launched and queued behind a spin kernel.
Needs a card.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
OUT = PKG.parent / "build" / "rs_i8_variants"


def _child() -> int:
    import numpy as np
    import torch

    from minio_tpu_torch.experiments import rs_i8_kernel as ri
    from minio_tpu_torch.ops import _build, rs_device

    _build.build(("rs_i8",))
    for line in _build.ptxas_report("rs_i8").splitlines():
        if "Used" in line or "spill" in line:
            print("ptxas", line.split(":", 1)[-1].strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(rng.integers(0, 256, size=shape,
                                             dtype=np.uint8)).to(dev)
    for b, k, r, n, off in ((32, 8, 4, 131072, 0), (3, 16, 32, 1543, 0),
                            (2, 15, 1, 777, 3), (2, 16, 32, 131072, 0),
                            (1, 5, 3, 100, 1), (5, 8, 4, 3 * 131072 + 48, 0)):
        mat = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
        data = rand(b * k * n + off)[off:].view(b, k, n)
        if not torch.equal(ri.rs_apply8(mat, data),
                           rs_device.gf_apply(mat, data)):
            print(f"differs from gf_apply at {(b, k, r, n, off)}")
            return 1
    print("matches gf_apply")
    pm = rng.integers(0, 256, size=(4, 8), dtype=np.uint8)

    def timed(fn, queued=False, iters=40):
        for i in range(2):
            fn(i)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(200_000 * iters)
        e0.record()
        for i in range(iters):
            fn(i)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters
    for blocks, nbuf in ((32, 4), (256, 2)):
        bufs = [rand(blocks, 8, 131072) for _ in range(nbuf)]
        for name, fn in (("rs_i8", ri.rs_apply8),
                         ("gf_apply", rs_device.gf_apply)):
            def launch(i, fn=fn):
                return fn(pm, bufs[i % nbuf])
            print(f"{blocks} blocks {name}: {timed(launch):.4f} ms, queued "
                  f"{timed(launch, queued=True):.4f} ms")
        del bufs
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        return _child()
    src = (PKG / "ops" / "csrc" / "rs_i8.cu").read_text()
    rc = 0
    for spec in argv or [""]:
        text, tag = src, spec.replace("=", "_").replace(",", "-") or "source"
        for item in filter(None, spec.split(",")):
            name, value = item.split("=")
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {int(value)};", text)
            if n != 1:
                raise SystemExit(f"rs_i8_variants: no constant {name}")
        root = OUT / tag
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PKG, root / PKG.name,
                        ignore=shutil.ignore_patterns("__pycache__"))
        (root / PKG.name / "ops" / "csrc" / "rs_i8.cu").write_text(text)
        print(f"== variant {spec or '(source)'}", flush=True)
        rc |= subprocess.run([sys.executable, "-m",
                              "minio_tpu_torch.tools.rs_i8_variants",
                              "--child"], cwd=root, timeout=600).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
