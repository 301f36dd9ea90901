"""Carry drives between the two packages' journal encodings.

The packages keep the same version maps and byte-identical shard files,
but encode a journal differently: the JAX package as msgpack (XTP1), the
port as JSON (XTJ1; the card's machine has no msgpack). A test that lets
one package serve what the other wrote re-encodes every `xl.meta` of the
drives, field for field; format.json, the bucket records and the pool
documents are JSON in both and stay as they are.
"""

import os
import shutil

from minio_tpu.storage.meta import XLMeta as RefMeta
from minio_tpu_torch.storage import meta as port_meta

SYS_VOL = ".mtpu.sys"


def _journals(root: str):
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root).split(os.sep)[0]
        if "xl.meta" in files and rel != SYS_VOL:
            yield os.path.join(dirpath, "xl.meta")


def copy_to_port(src: str, dst: str) -> None:
    """A copy of a JAX-written drive, its journals carried across."""
    shutil.copytree(src, dst)
    for path in _journals(dst):
        blob = open(path, "rb").read()
        if blob[:4] == port_meta.MAGIC:
            continue
        ref = RefMeta.load(blob)
        open(path, "wb").write(port_meta.from_reference_map(
            {"versions": ref.versions, "inline": ref.inline}).dump())


def to_jax(root: str) -> None:
    """Every port-written journal of a drive, in place, as the JAX
    package's."""
    for path in _journals(root):
        blob = open(path, "rb").read()
        if blob[:4] != port_meta.MAGIC:
            continue
        port = port_meta.XLMeta.load(blob)
        ref = RefMeta()
        ref.versions = [dict(v) for v in port.versions]
        ref.inline = dict(port.inline)
        open(path, "wb").write(ref.dump())

