"""Validated environment reads (``env_float`` / ``env_int``).

Copied from ``horovod_tpu/common/retry.py``: the spelling every
env-tunable number uses — a garbled value warns and falls back to the
default rather than killing the process.  The JAX package's
``retry_call`` backoff policy guards control-plane connects the serving
slice does not have, so it is not carried over.
"""

from __future__ import annotations

import os

from ..utils.logging import get_logger

__all__ = ["env_float", "env_int"]


def env_float(name: str, default: float) -> float:
    """Validated float read of the environment variable ``name`` with a
    fall-through default."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        get_logger().warning("%s=%r is not a number; using %s",
                             name, raw, default)
        return default


def env_int(name: str, default: int) -> int:
    """Validated integer read of ``name`` (see :func:`env_float`)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        get_logger().warning("%s=%r is not an integer; using %s",
                             name, raw, default)
        return default
