"""State broadcast helpers for TensorFlow/Keras models.

Port of ``horovod_tpu/tensorflow/functions.py`` (reference parity:
horovod/tensorflow/functions.py — broadcast_variables,
broadcast_object, broadcast_object_fn, allgather_object), used at train
start so every worker leaves rank 0's initialization identically.
"""

from __future__ import annotations

from typing import Any, Iterable

import tensorflow as tf

from .. import functions as _torch_functions
from ..ops import collective_ops as _ops
from . import mpi_ops
from .mpi_ops import _to_numpy, _to_torch


def broadcast_variables(variables: Iterable[tf.Variable],
                        root_rank: int = 0, process_set=None) -> None:
    """Assign every variable rank ``root_rank``'s value (reference:
    horovod/tensorflow/functions.py broadcast_variables).  Works on any
    iterable of ``tf.Variable``/Keras variables."""
    for i, v in enumerate(variables):
        name = getattr(v, "name", None) or f"broadcast_var.{i}"
        value = mpi_ops.broadcast(
            tf.convert_to_tensor(v), root_rank,
            name=f"broadcast.{name}", process_set=process_set,
        )
        v.assign(value)


def broadcast_object(obj: Any, root_rank: int = 0, name: str = None,
                     process_set=None) -> Any:
    """Reference: horovod/tensorflow/functions.py broadcast_object (pickle
    + size/payload broadcast); delegates to the package's own."""
    return _torch_functions.broadcast_object(obj, root_rank=root_rank,
                                             name=name,
                                             process_set=process_set)


def broadcast_object_fn(root_rank: int = 0, name: str = None,
                        process_set=None):
    """Reference: broadcast_object_fn — returns a callable so the object
    need only exist on the root."""
    return lambda obj=None: broadcast_object(
        obj, root_rank=root_rank, name=name, process_set=process_set
    )


def allgather_object(obj: Any, name: str = None, process_set=None) -> list:
    """Gather one picklable object per rank into a list ordered by rank
    (reference: horovod/tensorflow/functions.py allgather_object)."""
    return _torch_functions.allgather_object(obj, name=name,
                                             process_set=process_set)


def broadcast_model_weights(model, root_rank: int = 0,
                            process_set=None) -> None:
    """Broadcast a Keras model's weights (any Keras backend: goes through
    ``get_weights()`` numpy)."""
    synced = [
        _to_numpy(_ops.broadcast(
            _to_torch(w), root_rank, name=f"broadcast_model_weight.{i}",
            process_set=process_set,
        ))
        for i, w in enumerate(model.get_weights())
    ]
    model.set_weights(synced)
