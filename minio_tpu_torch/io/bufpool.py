"""Tiered pool of leased host staging buffers.

The port of minio_tpu/io/bufpool.py (BufferPool, Lease, global_pool). The
stripe batcher (ops/batcher.py) stages each coalesced window into one
leased buffer; at steady state it allocates no fresh staging memory.

For a set on the card the pool's buffers are PINNED host memory
(`torch.empty(n, dtype=torch.uint8, pin_memory=True)`), shared with numpy
through `.numpy()`: the host-to-device copy of a staged batch is then a
DMA straight from the buffer, and may run asynchronously on the kernel
lane's stream. This is the GPU counterpart of the JAX batcher's donated
pooled staging. For device="cpu" the buffers are plain memory, because
pinning needs a card.

Design:
  * size classes: powers of two from 64 KiB to 512 MiB (the largest
    staged batch, 256 blocks of an EC 8+4 framed window, is ~256 MiB),
    each class a bounded free list; a larger request is served unpooled
    and counted, never refused;
  * idle memory is capped at 2 GiB a pool: a buffer returned past the
    cap is freed instead of kept;
  * leases: a Lease wraps one buffer and is reference-counted:
    retain() before handing the memory to another holder (a framed PUT
    window goes to n drive writer threads), release() once per holder;
    the buffer returns to the pool when the count reaches zero. A buffer
    must go back only after every copy that reads it is done: the
    batcher holds its lease until the dispatch's results are on the
    host;
  * leak accounting: a Lease dropped without release() is returned by
    its finalizer and counted (`leaks`); a release() after the count hit
    zero is counted (`double_releases`) and ignored.

Environment:
  MTPU_BUFPOOL_MAX_PER_CLASS   buffers kept per size class (default 16)
  MTPU_BUFPOOL_OFF             "1"/"on" disables pooling (every lease is
                               a fresh buffer; leases still work)
"""

from __future__ import annotations

import os
import threading
import weakref

import numpy as np
import torch

from minio_tpu_torch.utils.env import env_int

_MIN_CLASS = 16          # 2**16 = 64 KiB
_MAX_CLASS = 29          # 2**29 = 512 MiB
CLASS_SIZES = tuple(1 << p for p in range(_MIN_CLASS, _MAX_CLASS + 1))
_MAX_IDLE_BYTES = 2 << 30  # idle bytes a pool keeps


def _class_for(size: int) -> int:
    """Index of the smallest class holding `size`, or -1 if oversized."""
    for i, c in enumerate(CLASS_SIZES):
        if size <= c:
            return i
    return -1


class _LeaseState:
    """Holder count shared by the Lease and its leak finalizer (finalizers
    run after the lease itself is unreachable)."""

    __slots__ = ("mu", "refs")

    def __init__(self) -> None:
        self.mu = threading.Lock()
        self.refs = 1


class Lease:
    """One leased buffer of at least `size` bytes."""

    __slots__ = ("_pool", "_buf", "_cls", "_state", "size", "__weakref__")

    def __init__(self, pool: "BufferPool", buf: torch.Tensor, cls: int,
                 size: int):
        self._pool = pool
        self._buf = buf
        self._cls = cls
        self._state = _LeaseState()
        self.size = size

    @property
    def tensor(self) -> torch.Tensor:
        """The backing uint8 tensor (capacity >= size; pinned in a pinned
        pool). Only valid while this holder's reference is live."""
        return self._buf

    def ndarray(self, shape, dtype="uint8") -> np.ndarray:
        """A numpy view of the leased bytes shaped `shape` (must fit in
        `size`). Only valid while this holder's reference is live."""
        items = int(np.prod(shape))
        if items * np.dtype(dtype).itemsize > self.size:
            raise ValueError(f"lease of {self.size} cannot shape {shape}")
        return np.frombuffer(self._buf.numpy(), dtype=dtype,
                             count=items).reshape(shape)

    def retain(self) -> "Lease":
        """One more holder; each holder calls release() once."""
        with self._state.mu:
            if self._state.refs <= 0:
                raise ValueError("retain() after the final release")
            self._state.refs += 1
        return self

    def release(self) -> None:
        st = self._state
        with st.mu:
            if st.refs <= 0:
                # Returning the same buffer twice would alias two future
                # leases onto one allocation: count and ignore.
                self._pool._count_double_release()
                return
            st.refs -= 1
            done = st.refs == 0
        if done:
            self._pool._return_buf(self._buf, self._cls)


class LeasedRows(list):
    """A list whose items view pooled memory, holding one reference on
    each lease they view (`leases`); whoever consumes the items releases
    those references."""

    def __init__(self, items=(), leases=()):
        super().__init__(items)
        self.leases = list(leases)


def leases_of(rows) -> list:
    """The leases a result's views hold (none for a plain list)."""
    return list(getattr(rows, "leases", ()))


class BufferPool:
    """Tiered free lists + lease accounting. Thread-safe."""

    def __init__(self, max_per_class: int | None = None,
                 enabled: bool | None = None, pinned: bool = False):
        if max_per_class is None:
            max_per_class = env_int("MTPU_BUFPOOL_MAX_PER_CLASS", 16)
        if enabled is None:
            enabled = os.environ.get("MTPU_BUFPOOL_OFF", "").lower() \
                not in ("1", "on", "true")
        self.max_per_class = max(1, max_per_class)
        self.enabled = enabled
        self.pinned = pinned
        self._mu = threading.Lock()
        self._free: list[list] = [[] for _ in CLASS_SIZES]
        self.hits = 0
        self.misses = 0
        self.oversized = 0
        self.leaks = 0
        self.double_releases = 0
        self.outstanding = 0
        self.idle_bytes = 0

    def _alloc(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pinned)

    def lease(self, size: int) -> Lease:
        """Lease a buffer of at least `size` bytes (pooled when a class
        fits, fresh and unpooled otherwise)."""
        cls = _class_for(size) if self.enabled else -1
        buf = None
        if cls >= 0:
            with self._mu:
                if self._free[cls]:
                    buf = self._free[cls].pop()
                    self.hits += 1
                    self.idle_bytes -= buf.numel()
                else:
                    self.misses += 1
                self.outstanding += 1
            if buf is None:
                try:
                    buf = self._alloc(CLASS_SIZES[cls])
                except BaseException:
                    with self._mu:
                        self.outstanding -= 1
                    raise
        else:
            with self._mu:
                self.oversized += 1
                self.outstanding += 1
            try:
                buf = self._alloc(max(size, 1))
            except BaseException:
                with self._mu:
                    self.outstanding -= 1
                raise
        lease = Lease(self, buf, cls, size)
        # Leak net: the finalizer holds the shared state and the buffer,
        # never the lease itself.
        weakref.finalize(lease, self._finalize_dropped, buf, cls,
                         lease._state)
        return lease

    def _count_double_release(self) -> None:
        with self._mu:
            self.double_releases += 1

    def _return_buf(self, buf: torch.Tensor, cls: int) -> None:
        with self._mu:
            self.outstanding -= 1
            if cls >= 0 and self.enabled \
                    and len(self._free[cls]) < self.max_per_class \
                    and self.idle_bytes + buf.numel() <= _MAX_IDLE_BYTES:
                self._free[cls].append(buf)
                self.idle_bytes += buf.numel()
        # Otherwise the buffer is dropped here and freed with its tensor.

    def _finalize_dropped(self, buf, cls: int, state: _LeaseState) -> None:
        """GC found a dropped lease: if refs were still held (the leak),
        zero them, count it, and return the buffer."""
        with state.mu:
            leaked = state.refs > 0
            state.refs = 0
        if leaked:
            with self._mu:
                self.leaks += 1
            self._return_buf(buf, cls)

    def stats(self) -> dict:
        with self._mu:
            total = self.hits + self.misses
            return {
                "enabled": self.enabled,
                "pinned": self.pinned,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0,
                "oversized": self.oversized,
                "outstanding": self.outstanding,
                "leaks": self.leaks,
                "double_releases": self.double_releases,
                "idle_bytes": self.idle_bytes,
            }


_GLOBAL: dict[bool, BufferPool] = {}
_GLOBAL_MU = threading.Lock()


def global_pool(device="cpu") -> BufferPool:
    """The process-wide pool for staging toward `device`: pinned host
    memory for a CUDA device, plain memory for the CPU."""
    pinned = torch.device(device).type == "cuda"
    pool = _GLOBAL.get(pinned)
    if pool is None:
        with _GLOBAL_MU:
            pool = _GLOBAL.get(pinned)
            if pool is None:
                pool = _GLOBAL[pinned] = BufferPool(pinned=pinned)
    return pool


def pools_stats() -> dict:
    """The process's staging pools (those made so far) summed: the
    metrics and admin-info view, which must not create a pool."""
    with _GLOBAL_MU:
        pools = list(_GLOBAL.values())
    out = {"enabled": False, "pinned": False, "hits": 0, "misses": 0,
           "oversized": 0, "outstanding": 0, "leaks": 0,
           "double_releases": 0, "idle_bytes": 0}
    for pool in pools:
        st = pool.stats()
        for k in out:
            if isinstance(out[k], bool):
                out[k] = out[k] or bool(st.get(k))
            else:
                out[k] += st.get(k, 0)
    total = out["hits"] + out["misses"]
    out["hit_rate"] = (out["hits"] / total) if total else 0.0
    return out
