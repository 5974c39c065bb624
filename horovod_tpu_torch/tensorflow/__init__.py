"""horovod_tpu_torch.tensorflow: the TensorFlow 2 framework adapter.

Port of ``horovod_tpu/tensorflow`` (reference parity: the
``horovod.tensorflow`` surface — horovod/tensorflow/__init__.py,
mpi_ops.py + the mpi_ops.cc / xla_mpi_ops.cc custom-op bindings,
functions.py, compression.py, elastic.py).  A reference training script
needs only its import changed::

    import horovod_tpu_torch.tensorflow as hvd
    hvd.init()
    tape = hvd.DistributedGradientTape(tape)
    hvd.broadcast_variables(model.variables, root_rank=0)
    hvd.broadcast_variables(opt.variables, root_rank=0)

Design: TF stays the model/autograd frontend; every collective runs
through the package's own (:mod:`..ops.collective_ops`, over
``torch.distributed``): an eager tensor crosses through numpy to a
torch tensor on this rank's device and back, a traced ``tf.function``
graph reaches it through ``tf.py_function``, and a
``jit_compile=True`` function through the XLA custom-call bridge
(:mod:`.xla_ops`, the package's own ``src/xla_bridge.cc``).  Importing
``horovod_tpu_torch`` does not import this adapter: it is imported by
name and needs TensorFlow.
"""

from __future__ import annotations

# lifecycle + topology (shared with the torch API)
from ..common.basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, local_rank, size, local_size,
    cross_rank, cross_size, is_homogeneous, xla_built, nccl_built,
    mpi_enabled, mpi_built, mpi_threads_supported, gloo_built,
    gloo_enabled, ccl_built, cuda_built, rocm_built, ddl_built,
    native_built, start_timeline, stop_timeline,
)
from ..common.exceptions import (  # noqa: F401
    HorovodInternalError, HostsUpdatedInterrupt,
)
from ..common.process_sets import ProcessSet, global_process_set  # noqa: F401
from .. import add_process_set, remove_process_set  # noqa: F401
from ..ops.reduce_ops import (  # noqa: F401
    Adasum, Average, Max, Min, Product, ReduceOp, Sum,
)
from .compression import Compression  # noqa: F401
from .functions import (  # noqa: F401
    allgather_object, broadcast_object, broadcast_object_fn,
    broadcast_model_weights, broadcast_variables,
)
from .mpi_ops import (  # noqa: F401
    allgather, allreduce, alltoall, barrier, broadcast, grouped_allgather,
    grouped_allreduce, grouped_reducescatter, join, reducescatter,
)
from .gradient_aggregation import LocalGradientAggregationHelper  # noqa: F401
from .optimizer import (  # noqa: F401
    DistributedGradientTape, DistributedOptimizer,
)
from .sync_batch_norm import SyncBatchNormalization  # noqa: F401
from . import elastic  # noqa: F401


def broadcast_global_variables(root_rank: int = 0) -> None:
    """Reference: horovod/tensorflow broadcast_global_variables — a TF1
    global-collection API.  TF2 has no global variable collection (the
    reference itself raises in eager mode pointing at
    broadcast_variables); same contract here."""
    raise RuntimeError(
        "hvd.broadcast_global_variables() requires the TF1 global "
        "variable collection, which does not exist under TF2 eager "
        "semantics.  Use hvd.broadcast_variables(model.variables, "
        f"root_rank={root_rank}) or broadcast_model_weights(model) "
        "instead (the reference raises the same way in eager mode)."
    )


def __getattr__(name):
    # lazy: importing horovod_tpu_torch.tensorflow must not pull keras in.
    # importlib directly — `from . import keras` would probe this very
    # __getattr__ before importing (infinite recursion).
    if name == "keras":
        import importlib

        return importlib.import_module(__name__ + ".keras")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )
