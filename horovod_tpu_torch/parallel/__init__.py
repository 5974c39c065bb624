"""Parallelism beyond data parallel (``horovod_tpu/parallel/``), over
``torch.distributed`` with one process per GPU: a JAX mesh axis is a
process set here.  Ring attention and Ulysses shard the sequence
(:mod:`.ring_attention`, :mod:`.ulysses`); Megatron layers shard the
weights (:mod:`.tensor_parallel`, and tensor-sharded serving over
:func:`tensor_shard_mesh`'s set); :mod:`.moe` shards experts,
:mod:`.pipeline` stages; :mod:`.sharded` composes dp × sp × tp into one
trainer."""

from .ring_attention import (  # noqa: F401
    ring_attention, ring_flash_attention, ring_window_steps,
)
from .ulysses import heads_to_seq, seq_to_heads, ulysses_attention  # noqa: F401
from .tensor_parallel import (  # noqa: F401
    ColumnParallelDense, RowParallelDense, TensorParallelAttention,
    TensorParallelMlp, transformer_shard_specs,
)
from ._mesh_utils import tensor_shard_mesh  # noqa: F401
from .moe import ExpertParallelMoe  # noqa: F401
