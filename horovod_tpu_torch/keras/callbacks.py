"""Keras callbacks for distributed training.

Port of ``horovod_tpu/keras/callbacks.py`` (reference parity:
horovod/keras/callbacks.py + the shared implementation in
horovod/_keras/callbacks.py) — the callbacks a reference Keras script
uses, re-hosted on Keras 3's multi-backend ``keras.callbacks.Callback``
(they run in eager python between steps, on numpy values, so they work
unchanged for the tensorflow and torch Keras backends).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Union

import numpy as np
import keras

from ..common import basics
from ..metrics import instruments as _metrics
from ..ops import collective_ops as _ops
from ..ops.reduce_ops import Average
from ..tensorflow.mpi_ops import _to_numpy, _to_torch


def _set_lr(optimizer, value: float) -> None:
    optimizer.learning_rate = value


class BroadcastGlobalVariablesCallback(keras.callbacks.Callback):
    """Broadcast model and optimizer variables from ``root_rank`` after
    the FIRST batch, so all workers train identically from then on
    (reference: hvd.callbacks.BroadcastGlobalVariablesCallback, which also
    broadcasts at on_batch_end(0) — the first point where every rank has
    deterministically built both model and optimizer).

    The broadcast point must be the same on every rank: participation in
    the collectives cannot depend on per-rank lazily-built state (e.g.
    "optimizer built?"), or ranks issue different collective sequences
    and the negotiation deadlocks."""

    def __init__(self, root_rank: int = 0):
        super().__init__()
        self.root_rank = root_rank
        self._done = False

    def on_train_batch_end(self, batch, logs=None):
        if self._done:
            return
        self._done = True
        from ..tensorflow.functions import broadcast_model_weights

        broadcast_model_weights(self.model, root_rank=self.root_rank)
        opt = getattr(self.model, "optimizer", None)
        if opt is not None:
            synced = [
                _to_numpy(_ops.broadcast(
                    _to_torch(np.array(v)), self.root_rank,
                    name=f"broadcast_opt_var.{i}",
                ))
                for i, v in enumerate(opt.variables)
            ]
            for var, w in zip(opt.variables, synced):
                var.assign(w)


class MetricAverageCallback(keras.callbacks.Callback):
    """Average epoch-end metrics over all workers (reference:
    hvd.callbacks.MetricAverageCallback), so rank 0's logs/checkpoint
    decisions see global rather than local values."""

    def on_epoch_end(self, epoch, logs=None):
        if not logs:
            return
        if basics.is_initialized() and basics.size() > 1:
            for key in sorted(logs):
                value = logs[key]
                if isinstance(value, (int, float, np.floating, np.integer)):
                    logs[key] = float(_ops.allreduce(
                        _to_torch(np.asarray(value, np.float64)),
                        op=Average, name=f"metric_avg.{key}",
                    ))


class TelemetryCallback(keras.callbacks.Callback):
    """Feed the metrics subsystem from the Keras fit loop: per-batch step
    time into ``hvd_tpu_step_duration_seconds{adapter="keras"}`` and
    per-epoch logged metrics as gauges (so a /metrics scrape shows live
    loss/accuracy next to the collective-latency histograms).

    Purely local — registers no collectives, so it is safe on any subset
    of ranks (unlike MetricAverageCallback, which is rank-symmetric)."""

    def __init__(self, log_metrics: bool = True):
        super().__init__()
        self.log_metrics = log_metrics
        self._step_time = _metrics.STEP_DURATION.labels("keras")
        self._t0: Optional[float] = None

    def on_train_batch_begin(self, batch, logs=None):
        self._t0 = time.perf_counter()

    def on_train_batch_end(self, batch, logs=None):
        if self._t0 is not None:
            self._step_time.observe(time.perf_counter() - self._t0)
            self._t0 = None

    def on_epoch_end(self, epoch, logs=None):
        if not self.log_metrics or not logs:
            return
        g = _metrics.KERAS_EPOCH_METRIC
        for key, value in logs.items():
            if isinstance(value, (int, float, np.floating, np.integer)):
                g.labels(str(key)).set(float(value))


class LearningRateWarmupCallback(keras.callbacks.Callback):
    """Linear LR warmup from ``target_lr / cross_size()`` (the number of
    gradient-averaging processes) to ``target_lr`` over the first epochs
    (reference: hvd.callbacks.LearningRateWarmupCallback, after Goyal et
    al.)."""

    def __init__(self, target_lr: float, warmup_epochs: float = 5,
                 steps_per_epoch: Optional[int] = None,
                 initial_lr: Optional[float] = None, verbose: bool = False):
        super().__init__()
        self.target_lr = target_lr
        self.warmup_epochs = warmup_epochs
        self.steps_per_epoch = steps_per_epoch
        self.initial_lr = initial_lr
        self.verbose = verbose
        self._current_epoch = 0

    def _initial(self) -> float:
        if self.initial_lr is not None:
            return self.initial_lr
        # cross_size, the JAX package's process count (there a process
        # may drive several chips): the scaling recipe's target_lr is
        # scaled by the number of gradient-averaging processes, so warmup
        # starts from target/processes (pass initial_lr to override)
        size = basics.cross_size() if basics.is_initialized() else 1
        return self.target_lr / size

    def on_epoch_begin(self, epoch, logs=None):
        self._current_epoch = epoch

    def on_train_batch_begin(self, batch, logs=None):
        if self._current_epoch >= self.warmup_epochs:
            return
        if self.steps_per_epoch:
            progress = (self._current_epoch +
                        batch / self.steps_per_epoch) / self.warmup_epochs
        else:
            progress = self._current_epoch / self.warmup_epochs
        progress = min(max(progress, 0.0), 1.0)
        init = self._initial()
        _set_lr(self.model.optimizer,
                init + (self.target_lr - init) * progress)

    def on_epoch_end(self, epoch, logs=None):
        if epoch < self.warmup_epochs <= epoch + 1:
            _set_lr(self.model.optimizer, self.target_lr)
            if self.verbose:
                print(f"Epoch {epoch + 1}: finished gradual learning rate "
                      f"warmup to {self.target_lr}.")


class LearningRateScheduleCallback(keras.callbacks.Callback):
    """Piecewise LR schedule (reference:
    hvd.callbacks.LearningRateScheduleCallback): within
    [start_epoch, end_epoch) the LR is ``initial_lr * multiplier(epoch)``
    (or a constant multiplier)."""

    def __init__(self, initial_lr: float,
                 multiplier: Union[float, Callable[[int], float]],
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 staircase: bool = True,
                 steps_per_epoch: Optional[int] = None):
        super().__init__()
        self.initial_lr = initial_lr
        self.multiplier = multiplier
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        self._current_epoch = 0

    def _mult(self, epoch: float) -> float:
        return self.multiplier(epoch) if callable(self.multiplier) \
            else self.multiplier

    def _in_range(self, epoch: float) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def on_epoch_begin(self, epoch, logs=None):
        self._current_epoch = epoch
        if (self.staircase or not self.steps_per_epoch) and \
                self._in_range(epoch):
            _set_lr(self.model.optimizer, self.initial_lr * self._mult(epoch))

    def on_train_batch_begin(self, batch, logs=None):
        if self.staircase or not self.steps_per_epoch:
            return
        epoch = self._current_epoch + batch / self.steps_per_epoch
        if self._in_range(epoch):
            _set_lr(self.model.optimizer, self.initial_lr * self._mult(epoch))
