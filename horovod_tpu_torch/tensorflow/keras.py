"""Import-path parity for ``horovod.tensorflow.keras``.

Port of ``horovod_tpu/tensorflow/keras.py``.  The reference exposes the
Keras surface both as ``horovod.keras`` and ``horovod.tensorflow.keras``
(the tf.keras flavor).  Keras 3 unified the two, so this module simply
re-exports ``horovod_tpu_torch.keras``::

    import horovod_tpu_torch.tensorflow.keras as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(opt)
"""

from ..keras import *  # noqa: F401,F403
from ..keras import callbacks, elastic  # noqa: F401
from ..keras import (  # noqa: F401
    init, shutdown, is_initialized, rank, local_rank, size, local_size,
    cross_rank, cross_size, allreduce, allgather, broadcast, alltoall,
    grouped_allreduce, reducescatter, barrier, join, broadcast_variables,
    broadcast_object, broadcast_object_fn, allgather_object,
    broadcast_model_weights, DistributedOptimizer, Compression,
    ProcessSet, global_process_set, Adasum, Average, Max, Min, Product,
    ReduceOp, Sum,
)
