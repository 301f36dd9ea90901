"""Environment knobs that take a positive number (a copy of
minio_tpu/utils/env.py): unset, empty, unparsable or <= 0 gives the
default. Knobs where 0 means something parse themselves."""

from __future__ import annotations

import os


def env_num(key: str, default, cast=float):
    try:
        v = cast(os.environ.get(key, "") or default)
        return v if v > 0 else default
    except ValueError:
        return default


def env_float(key: str, default: float) -> float:
    return env_num(key, default, float)


def env_int(key: str, default: int) -> int:
    return env_num(key, default, int)
