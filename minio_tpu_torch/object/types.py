"""Object-layer types and errors (the slice's subset of
minio_tpu/object/types.py; reference cmd/object-api-datatypes.go,
cmd/object-api-errors.go)."""

from __future__ import annotations

import dataclasses


class ObjectError(Exception):
    """Base class; carries bucket/object for S3 error rendering."""

    def __init__(self, bucket: str = "", object_: str = "", msg: str = ""):
        self.bucket = bucket
        self.object = object_
        super().__init__(msg or f"{type(self).__name__}: {bucket}/{object_}")


class BucketNotFound(ObjectError):
    pass


class BucketExists(ObjectError):
    pass


class ObjectNotFound(ObjectError):
    pass


class InvalidRange(ObjectError):
    """The requested byte range does not overlap the object."""


class ReadQuorumError(ObjectError):
    """errErasureReadQuorum: not enough consistent metadata/shards."""


class WriteQuorumError(ObjectError):
    """errErasureWriteQuorum: too few successful writes."""


class InvalidArgument(ObjectError):
    pass


class UploadNotFound(ObjectError):
    """No multipart upload of that id (S3 NoSuchUpload)."""


class InvalidPart(ObjectError):
    """A completed part is absent or its ETag differs."""


class InvalidPartOrder(ObjectError):
    """The completed parts are not in ascending order."""


class EntityTooSmall(ObjectError):
    """A part other than the last is under the minimum part size."""


@dataclasses.dataclass
class ObjectInfo:
    bucket: str = ""
    name: str = ""
    mod_time: int = 0            # ns epoch
    size: int = 0
    etag: str = ""
    content_type: str = ""
    version_id: str = ""
    user_metadata: dict = dataclasses.field(default_factory=dict)
    # x-internal-* entries (stored checksums), as the JAX package keeps
    # them apart from the user's metadata.
    internal_metadata: dict = dataclasses.field(default_factory=dict)
    # storage/meta.ObjectPartInfo of each part (one for a plain PUT).
    parts: list = dataclasses.field(default_factory=list)
