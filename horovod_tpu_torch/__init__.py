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
BN(+residual)+ReLU kernels of ``ops.fused_norm``; ``SyncBatchNorm``),
and the rest of Horovod's training API: process sets, every collective
with Adasum, the hook-driven ``DistributedOptimizer`` that reduces each
gradient bucket inside the backward, gradient compression, and ZeRO
stage 1 (``ZeroDistributedOptimizer``, ``training.zero_train_setup``),
and the loop around the step: the input pipeline (``data``), activation
remat (``TransformerConfig.remat_policy``, ``ResNet(remat=True)``),
crash-atomic checkpoints (``checkpoint``), the Keras-style callbacks
(``callbacks``), fault injection (``chaos``) and
``training.fit_epoch``, and fault-tolerant training: the integrity
guard (``guard``), elastic state and the elastic run loop
(``elastic``), and the launcher with its elastic driver
(``python -m horovod_tpu_torch.runner``), and Horovod's observability:
every collective's counters, latency and spans, the Chrome timeline
(``HVD_TPU_TIMELINE``, ``start_timeline``), the ``torch.profiler``
bridge, ``metrics.cluster_snapshot`` and the overlap and serving step
views, with the benchmark entry ``python -m horovod_tpu_torch.bench``,
and the two-level collectives (``HOROVOD_HIERARCHICAL_ALLREDUCE``:
``common.topology``, ``ops.hierarchical``, ``DcnCompression``, the
hierarchical ZeRO exchange and the per-tier byte model).
Entry points run on the card unless
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
    start_timeline,
    stop_timeline,
    xla_built,
)
from .common import basics as _basics
from .common.exceptions import (
    HorovodInternalError,
    HorovodTpuError,
    HostsUpdatedInterrupt,
    ProcessSetError,
)
from .common.process_sets import ProcessSet, global_process_set
from .common.topology import DCN_AXIS, ICI_AXIS, WORLD_AXIS
from .compression import Compression, DcnCompression
from .functions import (
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from .ops.collective_ops import (
    Handle,
    allgather,
    allgather_async,
    allreduce,
    allreduce_async,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_async,
    grouped_allgather,
    grouped_allreduce,
    grouped_allreduce_async,
    grouped_reducescatter,
    grouped_reducescatter_async,
    join,
    poll,
    reducescatter,
    reducescatter_async,
    synchronize,
)
from .ops.flash_attention import flash_attention
from .ops.fused_norm import fused_batch_norm_act
from .ops.reduce_ops import Adasum, Average, Max, Min, Product, ReduceOp, Sum
from .optim import (
    DistributedOptimizer,
    ZeroDistributedOptimizer,
    allreduce_gradients,
    with_gradient_accumulation,
)
from .sync_batch_norm import SyncBatchNorm
from . import callbacks, chaos, checkpoint, data, elastic, guard, trace

__version__ = "0.2.0"


def add_process_set(ranks) -> ProcessSet:
    """Register a process set over ``ranks`` (a list of world ranks or a
    :class:`ProcessSet`; reference: horovod/common/process_sets.py
    add_process_set).  Every process must call it, members or not, with
    the same sets in the same order."""
    st = _basics._require_init()
    ps = ranks if isinstance(ranks, ProcessSet) else ProcessSet(ranks)
    return st.process_set_registry.add(ps)


def remove_process_set(process_set: ProcessSet) -> None:
    """Unregister a process set (reference: remove_process_set); called
    symmetrically, like :func:`add_process_set`."""
    _basics._require_init().process_set_registry.remove(process_set)


def hierarchical_mesh(num_groups=None):
    """The ``(dcn, ici)`` grid of world ranks for two-level reductions
    (reference analog: the local/cross communicators of
    NCCLHierarchicalAllreduce; :func:`.common.topology.hierarchical_mesh`)."""
    from .common import topology

    return topology.hierarchical_mesh(num_groups)


def process_set_ids():
    """The ids of the registered process sets (0 is the world)."""
    return _basics._require_init().process_set_registry.ids()
