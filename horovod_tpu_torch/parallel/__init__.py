"""Parallelism beyond data parallel (``horovod_tpu/parallel/``): so far
ring attention, the sequence sharded over the ranks
(:mod:`.ring_attention`)."""

from .ring_attention import (  # noqa: F401
    ring_attention, ring_flash_attention, ring_window_steps,
)
