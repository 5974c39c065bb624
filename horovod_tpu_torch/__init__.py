"""horovod_tpu_torch: the PyTorch + CUDA port of ``horovod_tpu``.

A second package beside the JAX one, written in PyTorch for an NVIDIA
H100.  Its module layout mirrors ``horovod_tpu`` so each module's
counterpart is found under the same path; inside, it is PyTorch idiom
(``nn.Module``s, explicit ``device`` and ``torch.Generator``,
``torch.distributed`` for every collective).  Every kernel the JAX
package wrote in Pallas for the TPU becomes a kernel written by hand for
Hopper (``csrc/``), built at first use.

This package imports ``torch`` and numpy only — never ``jax`` and
nothing of ``horovod_tpu``; it keeps its own copies of the jax-free
helpers it needs.

Ported so far: serving (``serving``: paged KV cache, continuous
batching, chunked prefill, prefix cache) and data-parallel training
(``init`` → ``broadcast_parameters`` → ``models.transformer`` with
``attention_impl="flash"`` → the flash backward kernels → gradient
allreduce → optimizer update; ``training``, ``optim``), one process per
GPU as in the original Horovod, and the ResNet workload
(``models.resnet``, every BatchNorm through the fused
BN(+residual)+ReLU kernels of ``ops.fused_norm``; ``SyncBatchNorm``).  Entry points run on the card unless
the caller passes ``device="cpu"``; without a card and without that
explicit choice they raise.
"""

from .common.basics import (
    ccl_built,
    cross_rank,
    cross_size,
    cuda_built,
    ddl_built,
    device,
    gloo_built,
    gloo_enabled,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    native_built,
    nccl_built,
    rank,
    rocm_built,
    shutdown,
    size,
    xla_built,
)
from .common.exceptions import (
    HorovodInternalError,
    HorovodTpuError,
    HostsUpdatedInterrupt,
)
from .functions import (
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from .ops.collective_ops import (
    Handle,
    allgather,
    allreduce,
    allreduce_async,
    barrier,
    broadcast,
    grouped_allreduce,
    poll,
    reducescatter,
    synchronize,
)
from .ops.flash_attention import flash_attention
from .ops.fused_norm import fused_batch_norm_act
from .ops.reduce_ops import Adasum, Average, Max, Min, Product, ReduceOp, Sum
from .optim import (
    DistributedOptimizer,
    allreduce_gradients,
    with_gradient_accumulation,
)
from .sync_batch_norm import SyncBatchNorm
from . import trace

__version__ = "0.2.0"
