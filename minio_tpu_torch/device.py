"""Device selection for the port's entry points.

Every entry point (server, ErasureSet, backends, framers) runs on the
card unless the caller asks for the CPU: `device="cpu"` in the library,
`--device cpu` on the command line. Asking for the card where none is
visible raises; nothing falls back to the CPU behind the caller's back.

`lane_stream(device)` is the CUDA stream that the kernel lane's batched
dispatches (ops/batcher.py through io/engine.kernel_lane) run on, one per
card, apart from the default stream that request threads use for their
ragged tails. `lane_timed(device, fn, ...)` runs one dispatch between a
pair of CUDA events on that stream (the kernel span's `lane_ms`,
ops/batcher.py).
"""

from __future__ import annotations

import contextlib
import threading

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The torch.device for a caller's choice (default: the card)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "minio_tpu_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is false; pass device='cpu' "
            "(--device cpu) to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_streams: dict[torch.device, torch.cuda.Stream] = {}
_streams_mu = threading.Lock()


def _lane_stream_of(dev: torch.device) -> torch.cuda.Stream:
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _streams_mu:
        stream = _streams.get(dev)
        if stream is None:
            stream = _streams[dev] = torch.cuda.Stream(device=dev)
    return stream


def lane_stream(device) -> contextlib.AbstractContextManager:
    """A context that makes the kernel lane's stream on `device` current
    (a no-op for the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(_lane_stream_of(dev))


def lane_timed(device, fn, *args):
    """fn(*args) between a pair of CUDA events on the kernel lane's
    stream of `device`: (fn's result, ms between the events), the ms
    None off the card. A lane dispatch ends with its result's copy back,
    which synchronises that stream, so the end event is reached at once
    and the span is the dispatch's time on the lane: its copies, its
    launches and the host's gaps between them, not the card's busy
    time."""
    dev = None if device is None else torch.device(device)
    if dev is None or dev.type != "cuda":
        return fn(*args), None
    stream = _lane_stream_of(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    out = fn(*args)
    end.record(stream)
    end.synchronize()
    return out, start.elapsed_time(end)
