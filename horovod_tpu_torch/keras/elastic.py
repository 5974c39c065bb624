"""Elastic state + callbacks for Keras training loops.

Port of ``horovod_tpu/keras/elastic.py`` (reference parity:
horovod/keras/elastic.py — KerasState, CommitStateCallback,
UpdateBatchStateCallback, UpdateEpochStateCallback).
"""

from __future__ import annotations

import keras

from ..elastic import run  # noqa: F401 (re-export)
from ..elastic.sampler import ElasticSampler  # noqa: F401 (re-export)
from ..tensorflow.elastic import TensorFlowKerasState


class KerasState(TensorFlowKerasState):
    """Reference: hvd.elastic.KerasState(model, optimizer=None, **kwargs).
    The optimizer defaults to the model's own."""

    def __init__(self, model, optimizer=None, **kwargs):
        if optimizer is None:
            optimizer = getattr(model, "optimizer", None)
        if optimizer is not None:
            super().__init__(model=model, optimizer=optimizer, **kwargs)
        else:
            super().__init__(model=model, **kwargs)


class CommitStateCallback(keras.callbacks.Callback):
    """Commit the elastic state every ``batches_per_commit`` batches
    (reference: hvd.elastic.CommitStateCallback)."""

    def __init__(self, state, batches_per_commit: int = 1):
        super().__init__()
        self.state = state
        self.batches_per_commit = batches_per_commit
        self._counter = 0

    def on_train_batch_end(self, batch, logs=None):
        self._counter = (self._counter + 1) % self.batches_per_commit
        if self._counter == 0:
            self.state.commit()


class UpdateBatchStateCallback(keras.callbacks.Callback):
    """Track the current batch in ``state.batch`` and fast-forward after a
    restore (reference: hvd.elastic.UpdateBatchStateCallback)."""

    def __init__(self, state):
        super().__init__()
        self.state = state

    def on_epoch_begin(self, epoch, logs=None):
        if getattr(self.state, "batch", 0):
            # restored mid-epoch: keras restarts the epoch; steps already
            # done are skipped by the sampler/dataset, and batch resets at
            # the real epoch end
            pass

    def on_train_batch_end(self, batch, logs=None):
        self.state.batch = batch

    def on_epoch_end(self, epoch, logs=None):
        self.state.batch = 0


class UpdateEpochStateCallback(keras.callbacks.Callback):
    """Track the current epoch in ``state.epoch`` (reference:
    hvd.elastic.UpdateEpochStateCallback)."""

    def __init__(self, state):
        super().__init__()
        self.state = state

    def on_epoch_end(self, epoch, logs=None):
        self.state.epoch = epoch + 1


__all__ = ["KerasState", "run", "ElasticSampler",
           "CommitStateCallback", "UpdateBatchStateCallback",
           "UpdateEpochStateCallback"]
