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


class BucketNotEmpty(ObjectError):
    pass


class ObjectNotFound(ObjectError):
    """No such key. `delete_marker` is True when the key's latest
    version is a delete marker (S3 answers x-amz-delete-marker)."""

    def __init__(self, bucket: str = "", object_: str = "", msg: str = "",
                 delete_marker: bool = False, version_id: str = ""):
        super().__init__(bucket, object_, msg)
        self.delete_marker = delete_marker
        self.version_id = version_id


class VersionNotFound(ObjectError):
    pass


class MethodNotAllowed(ObjectError):
    """A read that names a delete marker's version."""

    def __init__(self, bucket: str = "", object_: str = "", msg: str = "",
                 version_id: str = ""):
        super().__init__(bucket, object_, msg)
        self.version_id = version_id


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
class BucketInfo:
    name: str
    created: int = 0             # ns epoch


@dataclasses.dataclass
class PutOptions:
    """version_id: the version to write ("" mints one when `versioned`,
    else the null version). internal_metadata: x-internal-* entries
    stored with the version; read after the payload's finish hook ran,
    so the hook may fill it."""
    version_id: str = ""
    versioned: bool = False
    user_metadata: dict = dataclasses.field(default_factory=dict)
    content_type: str = ""
    internal_metadata: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class GetOptions:
    version_id: str = ""


@dataclasses.dataclass
class DeleteOptions:
    """version_id: remove that version. Without one, `versioned` (bucket
    versioning Enabled) writes a delete marker, `null_marker`
    (Suspended) a null-version marker that replaces the null version,
    and neither removes the null version."""
    version_id: str = ""
    versioned: bool = False
    null_marker: bool = False


@dataclasses.dataclass
class DeletedObject:
    object_name: str = ""
    version_id: str = ""
    delete_marker: bool = False
    delete_marker_version_id: str = ""


@dataclasses.dataclass
class ObjectInfo:
    bucket: str = ""
    name: str = ""
    mod_time: int = 0            # ns epoch
    size: int = 0
    etag: str = ""
    content_type: str = ""
    version_id: str = ""
    is_latest: bool = True
    delete_marker: bool = False
    user_metadata: dict = dataclasses.field(default_factory=dict)
    # x-internal-* entries (stored checksums), as the JAX package keeps
    # them apart from the user's metadata.
    internal_metadata: dict = dataclasses.field(default_factory=dict)
    # storage/meta.ObjectPartInfo of each part (one for a plain PUT).
    parts: list = dataclasses.field(default_factory=list)
    storage_class: str = "STANDARD"


@dataclasses.dataclass
class ListObjectsInfo:
    is_truncated: bool = False
    next_marker: str = ""
    objects: list = dataclasses.field(default_factory=list)
    prefixes: list = dataclasses.field(default_factory=list)
