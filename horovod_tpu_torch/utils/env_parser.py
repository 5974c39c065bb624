"""The fusion, overlap, timeline and two-level collective knobs, read
from the environment.

Copied from ``horovod_tpu/utils/env_parser.py`` for the knobs the port
reads: each ``HVD_TPU_<NAME>`` falls back to the reference's
``HOROVOD_<NAME>``.  The byte thresholds and the autotuner's counts are
strict: a set but garbled value (``64MB``) or one below its minimum
raises ``ValueError`` naming the variable, instead of quietly falling
through to one bucket per tensor.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _get(name: str, default: Optional[str] = None) -> Optional[str]:
    """``HVD_TPU_<name>``, else ``HOROVOD_<name>``, else ``default``."""
    v = os.environ.get(f"HVD_TPU_{name}")
    if v is None:
        v = os.environ.get(f"HOROVOD_{name}")
    return v if v is not None else default


def _get_int_validated(name: str, default: int, minimum: int = 0) -> int:
    """A strict integer knob (see the module docstring); the error names
    the variable the user actually set."""
    v = _get(name)
    if v is None:
        return default
    var = (f"HVD_TPU_{name}" if os.environ.get(f"HVD_TPU_{name}") is not None
           else f"HOROVOD_{name}")
    try:
        value = int(v)
    except ValueError:
        raise ValueError(f"{var} must be an integer (bytes/count), got "
                         f"{v!r} — unset it or pass a plain integer"
                         ) from None
    if value < minimum:
        raise ValueError(
            f"{var} must be >= {minimum}, got {value} "
            f"(0 disables fusion: one bucket per tensor)"
            if minimum == 0 else f"{var} must be >= {minimum}, got {value}")
    return value


def _get_bool(name: str, default: bool) -> bool:
    v = _get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Config:
    """The knobs (reference: horovod/common/utils/env_parser.cc)."""

    fusion_threshold_bytes: int = 64 * 1024 * 1024  # HOROVOD_FUSION_THRESHOLD
    # the hooked DistributedOptimizer's BucketSchedule (0 = one bucket per
    # tensor) and the BucketAutotuner's sweep
    overlap_bucket_bytes: int = 4 * 1024 * 1024  # HVD_TPU_OVERLAP_BUCKET_BYTES
    overlap_autotune_trials: int = 8  # HVD_TPU_OVERLAP_AUTOTUNE_TRIALS
    overlap_autotune_steps: int = 3  # HVD_TPU_OVERLAP_AUTOTUNE_STEPS
    # Timeline (horovod/common/timeline.cc):
    timeline_filename: str = ""  # HOROVOD_TIMELINE
    timeline_mark_cycles: bool = False  # HOROVOD_TIMELINE_MARK_CYCLES
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
            overlap_bucket_bytes=_get_int_validated(
                "OVERLAP_BUCKET_BYTES", 4 * 1024 * 1024),
            overlap_autotune_trials=_get_int_validated(
                "OVERLAP_AUTOTUNE_TRIALS", 8, minimum=1),
            overlap_autotune_steps=_get_int_validated(
                "OVERLAP_AUTOTUNE_STEPS", 3, minimum=1),
            timeline_filename=_get("TIMELINE", "") or "",
            timeline_mark_cycles=_get_bool("TIMELINE_MARK_CYCLES", False),
            hierarchical_allreduce=_get_bool("HIERARCHICAL_ALLREDUCE", False),
            dcn_wire_dtype=(_get("DCN_WIRE_DTYPE", "") or "").lower(),
        )
