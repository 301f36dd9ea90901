"""The heal sweep over one erasure set (the part of
minio_tpu/object/scanner.py behind the admin heal; reference
cmd/global-heal.go:49 healErasureSet).

`heal_set` heals every bucket volume, then every object of every bucket
through healing.heal_object, walking the drives' journals in key order
(`_walk_all_drives`). The periodic scanner, usage accounting and the
drive-replacement bulk heal are still to be ported.
"""

from __future__ import annotations

import heapq
from itertools import groupby


def _walk_all_drives(es, bucket: str):
    """Merged sorted walk over all of the set's drives: (object path,
    [drive index, ...]) per key. A drive that cannot be walked
    contributes nothing."""
    def tagged(i, d):
        try:
            for path, _, _ in d.walk_scan(bucket):
                yield path, i
        except Exception:  # noqa: BLE001 - offline drive, missing volume
            return

    merged = heapq.merge(*[tagged(i, d) for i, d in enumerate(es.disks)],
                         key=lambda t: t[0])
    for path, grp in groupby(merged, key=lambda t: t[0]):
        yield path, [i for _, i in grp]


def heal_set(es, deep: bool = False) -> dict:
    """Heal every bucket and every object of one set; counts of buckets,
    objects seen, objects healed and failures."""
    from minio_tpu_torch.object.healing import heal_bucket, heal_object
    stats = {"buckets": 0, "objects": 0, "healed": 0, "failures": 0}
    for b in es.list_buckets():
        try:
            heal_bucket(es, b.name)
            stats["buckets"] += 1
        except Exception:  # noqa: BLE001 - counted
            stats["failures"] += 1
        for path, _ in _walk_all_drives(es, b.name):
            stats["objects"] += 1
            try:
                if heal_object(es, b.name, path, deep=deep).healed:
                    stats["healed"] += 1
            except Exception:  # noqa: BLE001 - counted
                stats["failures"] += 1
    return stats
