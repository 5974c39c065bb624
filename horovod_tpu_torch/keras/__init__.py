"""horovod_tpu_torch.keras: the Keras 3 framework adapter.

Port of ``horovod_tpu/keras`` (reference parity: the ``horovod.keras``
surface — horovod/keras/__init__.py + the horovod/_keras shared impl).
A reference Keras script needs only its import changed::

    import horovod_tpu_torch.keras as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(keras.optimizers.SGD(lr))
    model.compile(optimizer=opt, ...)
    model.fit(..., callbacks=[
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
    ])

Keras 3 is multi-backend.  With the tensorflow backend the collectives
go through the TensorFlow adapter's bridge (numpy, ``tf.py_function``,
or the XLA custom call under ``jit_compile``); with the torch backend
the wrapped optimizer hands its torch gradients to the package's
collectives as they are; a JAX-backend gradient raises ``TypeError``
(this package imports no jax; see
``horovod_tpu_torch.tensorflow.optimizer``).  The adapter needs
TensorFlow installed, as the JAX package's does.
"""

from __future__ import annotations

# lifecycle + topology (shared with the torch API)
from ..common.basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, local_rank, size, local_size,
    cross_rank, cross_size, is_homogeneous, xla_built, nccl_built,
    mpi_enabled, gloo_built, ccl_built, native_built,
    start_timeline, stop_timeline,
)
from ..common.exceptions import (  # noqa: F401
    HorovodInternalError, HostsUpdatedInterrupt,
)
from ..common.process_sets import ProcessSet, global_process_set  # noqa: F401
from ..ops.reduce_ops import (  # noqa: F401
    Adasum, Average, Max, Min, Product, ReduceOp, Sum,
)
from ..tensorflow.compression import Compression  # noqa: F401
from ..tensorflow.functions import (  # noqa: F401
    allgather_object, broadcast_object, broadcast_object_fn,
    broadcast_model_weights, broadcast_variables,
)
from ..tensorflow.mpi_ops import (  # noqa: F401
    allgather, allreduce, alltoall, barrier, broadcast, grouped_allreduce,
    join, reducescatter,
)
from ..tensorflow.optimizer import DistributedOptimizer  # noqa: F401
from . import callbacks  # noqa: F401
from . import elastic  # noqa: F401


def broadcast_global_variables(root_rank: int = 0, models=None) -> None:
    """Reference: horovod/tensorflow/keras broadcast_global_variables.

    Keras 3 has no TF1 global-variables collection, and any implicit
    substitute (scanning the heap for live models) would be
    nondeterministic across ranks — a collective-mismatch hazard.  So
    the models must be passed explicitly; with ``models=None`` this
    raises with the migration options."""
    if models is None:
        raise ValueError(
            "Keras 3 has no global-variables collection to broadcast. "
            "Pass models=[model, ...] here, or use "
            "broadcast_model_weights(model), or add "
            "callbacks.BroadcastGlobalVariablesCallback(0) to fit() — "
            "the drop-in equivalent of the reference pattern."
        )
    if not isinstance(models, (list, tuple)):
        models = [models]
    seen = set()
    variables = []
    for model in models:  # caller-supplied order: identical on all ranks
        for v in model.variables:
            if id(v) not in seen:
                seen.add(id(v))
                variables.append(v)
    if variables:
        broadcast_variables(variables, root_rank=root_rank)


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=None):
    """Reference: horovod/tensorflow/keras load_model — deserialize a
    saved model and wrap its optimizer in DistributedOptimizer so a
    restored training run is distributed again.

    A model saved mid-training carries the DistributedOptimizer's
    dynamic subclass in its config (class_name of the BASE optimizer),
    which keras cannot locate on its own; the built-in keras optimizer
    classes — plus any ``custom_optimizers`` — are injected as
    custom_objects so the base optimizer deserializes, then the wrapper
    is re-applied."""
    import keras

    co = dict(custom_objects or {})
    opt_classes = [
        cls for cls in vars(keras.optimizers).values()
        if isinstance(cls, type)
        and issubclass(cls, keras.optimizers.Optimizer)
    ]
    opt_classes.extend(custom_optimizers or [])
    for cls in opt_classes:
        co.setdefault(cls.__name__, cls)
    model = keras.models.load_model(filepath, custom_objects=co)
    opt = getattr(model, "optimizer", None)
    if opt is not None and not hasattr(opt, "_hvd_passes_per_step"):
        kwargs = {}
        if compression is not None:
            kwargs["compression"] = compression
        model.optimizer = DistributedOptimizer(opt, **kwargs)
    return model
