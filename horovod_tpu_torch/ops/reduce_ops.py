"""Reduction op identifiers (copied from ``horovod_tpu/ops/reduce_ops.py``:
the same stable small ints)."""

from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


# Module-level aliases matching ``hvd.Average`` / ``hvd.Sum`` / ...
Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT
