"""Environment-variable configuration.

Copied from ``horovod_tpu/utils/env_parser.py``: the same ``Config``
knobs, names, defaults and validation (reference:
horovod/common/utils/env_parser.cc).  Each ``HVD_TPU_<NAME>`` falls back
to the reference's ``HOROVOD_<NAME>``.  The byte thresholds and the
autotuner's counts are strict: a set but garbled value (``64MB``) or
one below its minimum raises ``ValueError`` naming the variable,
instead of quietly falling through to one bucket per tensor.

``Config`` holds only the knobs the port reads: fusion, overlap,
timeline and the two-level collectives, each with the JAX package's
field name, default and validation.  The JAX ``Config``'s other fields
configure its native controller (cycle time, response cache, stall
inspector, autotune, ``TPU_OPERATIONS``; ROADMAP A13b) or nothing;
``HVD_TPU_ELASTIC`` and ``HVD_TPU_LOG_LEVEL`` are read where they act,
in ``elastic/worker.py`` and ``utils/logging.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _get(name: str, default: Optional[str] = None) -> Optional[str]:
    """Look up ``HVD_TPU_<name>`` falling back to ``HOROVOD_<name>``."""
    v = os.environ.get(f"HVD_TPU_{name}")
    if v is None:
        v = os.environ.get(f"HOROVOD_{name}")
    return v if v is not None else default


def _get_int_validated(name: str, default: int, minimum: int = 0) -> int:
    """Strict integer knob: a set-but-garbage or out-of-range value is a
    configuration ERROR, not a silent default.  Used for the fusion/
    overlap byte thresholds, where a typo'd ``64MB`` or a negative value
    would otherwise silently fall through to the one-bucket-per-tensor
    path and tank collective efficiency without any signal."""
    v = _get(name)
    if v is None:
        return default
    # name the variable the user ACTUALLY set — the error must point at
    # the HOROVOD_* compatibility alias when that is where the value
    # came from, or "unset it" sends them after the wrong knob
    var = (
        f"HVD_TPU_{name}"
        if os.environ.get(f"HVD_TPU_{name}") is not None
        else f"HOROVOD_{name}"
    )
    try:
        value = int(v)
    except ValueError:
        raise ValueError(
            f"{var} must be an integer (bytes/count), got "
            f"{v!r} — unset it or pass a plain integer"
        ) from None
    if value < minimum:
        raise ValueError(
            f"{var} must be >= {minimum}, got {value} "
            f"(0 disables fusion: one bucket per tensor)"
            if minimum == 0 else
            f"{var} must be >= {minimum}, got {value}"
        )
    return value


def _get_bool(name: str, default: bool) -> bool:
    v = _get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Config:
    """Runtime knobs (reference: the HOROVOD_* variables of
    horovod/common/utils/env_parser.cc), the JAX package's fields that
    the port reads."""

    # Tensor fusion (horovod/common/fusion_buffer_manager.cc):
    fusion_threshold_bytes: int = 64 * 1024 * 1024  # HOROVOD_FUSION_THRESHOLD
    # Timeline (horovod/common/timeline.cc):
    timeline_filename: str = ""  # HOROVOD_TIMELINE
    timeline_mark_cycles: bool = False  # HOROVOD_TIMELINE_MARK_CYCLES
    # the hooked DistributedOptimizer's BucketSchedule (0 = one bucket per
    # tensor) and the BucketAutotuner's sweep (ops/overlap.py)
    overlap_bucket_bytes: int = 4 * 1024 * 1024  # HVD_TPU_OVERLAP_BUCKET_BYTES
    overlap_autotune_trials: int = 8  # HVD_TPU_OVERLAP_AUTOTUNE_TRIALS
    overlap_autotune_steps: int = 3  # HVD_TPU_OVERLAP_AUTOTUNE_STEPS
    # Hierarchical allreduce (nccl_operations.cc NCCLHierarchicalAllreduce):
    hierarchical_allreduce: bool = False  # HOROVOD_HIERARCHICAL_ALLREDUCE
    # cross-tier wire format of routed hierarchical allreduces
    # (compression.DcnCompression; "" = full precision):
    dcn_wire_dtype: str = ""  # HVD_TPU_DCN_WIRE_DTYPE

    @staticmethod
    def from_env() -> "Config":
        return Config(
            fusion_threshold_bytes=_get_int_validated(
                "FUSION_THRESHOLD", 64 * 1024 * 1024),
            timeline_filename=_get("TIMELINE", "") or "",
            timeline_mark_cycles=_get_bool("TIMELINE_MARK_CYCLES", False),
            overlap_bucket_bytes=_get_int_validated(
                "OVERLAP_BUCKET_BYTES", 4 * 1024 * 1024),
            overlap_autotune_trials=_get_int_validated(
                "OVERLAP_AUTOTUNE_TRIALS", 8, minimum=1),
            overlap_autotune_steps=_get_int_validated(
                "OVERLAP_AUTOTUNE_STEPS", 3, minimum=1),
            hierarchical_allreduce=_get_bool("HIERARCHICAL_ALLREDUCE", False),
            dcn_wire_dtype=(_get("DCN_WIRE_DTYPE", "") or "").lower(),
        )
