"""Elastic state for TensorFlow / Keras models.

Port of ``horovod_tpu/tensorflow/elastic.py`` (reference parity:
horovod/tensorflow/elastic.py TensorFlowKerasState, TensorFlowState)
over the package's :class:`~horovod_tpu_torch.elastic.ObjectState`:
capture model + optimizer variables at ``commit()``, roll back on peer
failure, rank-0-broadcast on ``sync()``.  Works with any Keras 3 backend
because capture goes through ``get_weights()`` / ``Variable.assign``
numpy values.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np

from ..elastic import ObjectState, run  # noqa: F401 (re-export)
from ..elastic.sampler import ElasticSampler  # noqa: F401 (re-export)


def _is_keras_model(v: Any) -> bool:
    return hasattr(v, "get_weights") and hasattr(v, "set_weights")


def _is_optimizer(v: Any) -> bool:
    return hasattr(v, "variables") and hasattr(v, "apply_gradients")


class TensorFlowKerasState(ObjectState):
    """Elastic state holding a Keras model and/or optimizer (reference:
    TensorFlowKerasState(model=..., optimizer=..., epoch=0, batch=0)).

    The base ObjectState snapshots plain fields; model/optimizer fields
    are recognized structurally and captured as numpy weight lists."""

    def _snapshot(self):
        snap = {}
        for k, v in self._attrs.items():
            if _is_keras_model(v):
                snap[k] = ("__keras_model__",
                           [np.array(w) for w in v.get_weights()])
            elif _is_optimizer(v):
                snap[k] = ("__keras_optimizer__",
                           [np.array(var) for var in v.variables])
            elif hasattr(v, "state_dict") and hasattr(v, "load_state_dict"):
                snap[k] = ("__state_dict__", copy.deepcopy(v.state_dict()))
            else:
                snap[k] = ("__value__", copy.deepcopy(v))
        return snap

    def _apply_snapshot(self, snap) -> None:
        for k, (kind, payload) in snap.items():
            if k not in self._attrs:
                self._attrs[k] = payload if kind == "__value__" else None
                continue
            v = self._attrs[k]
            if kind == "__keras_model__":
                v.set_weights([np.array(w) for w in payload])
            elif kind == "__keras_optimizer__":
                # an unbuilt optimizer has no variables yet; only restore
                # when the shapes line up (same contract as the reference,
                # which pre-builds the optimizer before restoring)
                if len(v.variables) == len(payload):
                    for var, w in zip(v.variables, payload):
                        var.assign(np.array(w))
            elif kind == "__state_dict__":
                v.load_state_dict(copy.deepcopy(payload))
            else:
                self._attrs[k] = copy.deepcopy(payload)


# Alias matching the reference's plain-TF variant: the structural capture
# above covers ``tf.Module``-style objects exposing get_weights or
# variables just the same.
TensorFlowState = TensorFlowKerasState


__all__ = ["TensorFlowKerasState", "TensorFlowState", "ObjectState",
           "ElasticSampler", "run"]
