"""The port's staging pool (minio_tpu_torch/io/bufpool.py) on the CPU.

For device="cpu" the pool holds plain memory; the pinned pool of a set on
the card is tested in tests/test_torch_cuda.py.
"""

import gc

import numpy as np

from minio_tpu_torch.io import bufpool
from minio_tpu_torch.io.bufpool import BufferPool, global_pool


def test_buffers_are_reused_by_size_class():
    pool = BufferPool(pinned=False)
    a = pool.lease(3 << 20)
    ptr = a.tensor.data_ptr()
    assert a.tensor.numel() == 4 << 20 and not a.tensor.is_pinned()
    a.ndarray((3, 1 << 20))[:] = 7
    a.release()
    b = pool.lease(4 << 20)
    assert b.tensor.data_ptr() == ptr
    b.release()
    st = pool.stats()
    assert (st["hits"], st["misses"], st["outstanding"]) == (1, 1, 0)
    assert st["idle_bytes"] == 4 << 20


def test_idle_cap_frees_returns_past_it(monkeypatch):
    monkeypatch.setattr(bufpool, "_MAX_IDLE_BYTES", 1 << 20)
    pool = BufferPool(pinned=False)
    a, b = pool.lease(1 << 20), pool.lease(1 << 20)
    a.release()
    b.release()
    st = pool.stats()
    assert st["idle_bytes"] == 1 << 20 and st["outstanding"] == 0
    c, d = pool.lease(1 << 20), pool.lease(1 << 20)
    assert pool.stats()["hits"] == 1 and pool.stats()["misses"] == 3
    c.release()
    d.release()


def test_oversized_served_unpooled():
    pool = BufferPool(pinned=False)
    big = pool.lease(bufpool.CLASS_SIZES[-1] + 1)
    assert big.tensor.numel() == bufpool.CLASS_SIZES[-1] + 1
    big.release()
    st = pool.stats()
    assert st["oversized"] == 1 and st["idle_bytes"] == 0


def test_leak_and_double_release_counted():
    pool = BufferPool(pinned=False)
    a = pool.lease(1000)
    a.release()
    a.release()
    pool.lease(1000)               # dropped without release()
    gc.collect()
    st = pool.stats()
    assert st["double_releases"] == 1 and st["leaks"] == 1
    assert st["outstanding"] == 0


def test_global_pool_is_plain_memory_for_the_cpu():
    pool = global_pool("cpu")
    assert pool is global_pool("cpu") and not pool.pinned
    lease = pool.lease(100)
    view = lease.ndarray((10, 10))
    assert view.dtype == np.uint8 and view.shape == (10, 10)
    lease.release()
