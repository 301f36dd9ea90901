"""grid: the node-to-node RPC mesh of a distributed deployment.

The port of minio_tpu/grid (reference internal/grid): one TCP
connection a node pair carries length-prefixed control frames (the
MessagePack subset of utils/mpack.py) and raw bulk frames, muxing unary
calls, response streams and client-push sinks, with reconnect and a
per-peer breaker. Remote drives (storage/remote.py) and dsync quorum
locks (grid/dsync.py) ride it.
"""

from minio_tpu_torch.grid.wire import GridError, RemoteCallError  # noqa: F401
from minio_tpu_torch.grid.client import GridClient, client_for  # noqa: F401
from minio_tpu_torch.grid.server import GridServer  # noqa: F401
