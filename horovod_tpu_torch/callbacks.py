"""Training-loop callbacks.

Port of ``horovod_tpu/callbacks.py`` (reference parity:
horovod/keras/callbacks.py + horovod/_keras/callbacks.py):
BroadcastGlobalVariablesCallback, MetricAverageCallback,
LearningRateWarmupCallback, LearningRateScheduleCallback around a
:class:`TrainLoop` that holds a :class:`~.training.TrainState`.

The learning rate lives in the torch optimizer's ``param_groups`` (where
the JAX package injects it into the optax state with
``inject_hyperparams``): :func:`get_lr` reads the first group's, and
:func:`set_lr` writes every group's, in place::

    optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    loop = hvd.callbacks.TrainLoop(state, callbacks=[
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.LearningRateWarmupCallback(target_lr=0.1 * hvd.size(),
                                                 warmup_epochs=5,
                                                 steps_per_epoch=100),
        hvd.callbacks.MetricAverageCallback(),
    ])
    for epoch in range(epochs):
        loop.on_epoch_begin(epoch)
        for batch, (x, y) in enumerate(loader):
            loop.on_batch_begin(batch)
            loop.state, loss = step(loop.state, x, y)
            loop.on_batch_end(batch, {"loss": float(loss)})
        logs = loop.on_epoch_end(epoch, {"loss": epoch_loss})

:func:`warmup_schedule` is the static form: a function ``step -> lr``
with optax's ``linear_schedule`` values (in fp32, as optax computes
them), for a ``LambdaLR`` or a loop that sets the rate itself.
"""

from __future__ import annotations

import time as _time
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from .common import basics
from .metrics import instruments as _metrics
from .ops import collective_ops
from .ops.reduce_ops import Average

_STEP_TIME = _metrics.STEP_DURATION.labels("torch")


# -- LR plumbing -------------------------------------------------------------


def _groups(optimizer):
    groups = getattr(optimizer, "param_groups", None)
    if not groups or any("lr" not in g for g in groups):
        raise ValueError(
            "no learning rate found: the optimizer needs torch "
            "param_groups carrying 'lr' (see horovod_tpu_torch.callbacks)")
    return groups


def get_lr(optimizer) -> float:
    """The optimizer's learning rate (its first param group's)."""
    return float(_groups(optimizer)[0]["lr"])


def set_lr(optimizer, lr: float):
    """Set every param group's learning rate, in place; returns the
    optimizer."""
    for g in _groups(optimizer):
        g["lr"] = float(lr)
    return optimizer


# -- loop + callback protocol ------------------------------------------------


class Callback:
    loop: "TrainLoop"

    def set_loop(self, loop: "TrainLoop") -> None:
        self.loop = loop

    def on_train_begin(self) -> None: ...

    def on_epoch_begin(self, epoch: int) -> None: ...

    def on_batch_begin(self, batch: int) -> None: ...

    def on_batch_end(self, batch: int, logs: Optional[dict] = None) -> None:
        ...

    def on_epoch_end(self, epoch: int,
                     logs: Optional[dict] = None) -> Optional[dict]: ...


class TrainLoop:
    """Thin callback host around a TrainState (stands in for the Keras
    ``model`` object the reference callbacks mutate)."""

    def __init__(self, state, callbacks: List[Callback]):
        self.state = state
        self.callbacks = callbacks
        self.epoch = 0
        self.batch = 0
        for cb in callbacks:
            cb.set_loop(self)
        self._began = False

    # lr accessors proxy into the live optimizer
    @property
    def lr(self) -> float:
        return get_lr(self.state.optimizer)

    @lr.setter
    def lr(self, value: float) -> None:
        set_lr(self.state.optimizer, value)

    def on_epoch_begin(self, epoch: int) -> None:
        if not self._began:
            self._began = True
            for cb in self.callbacks:
                cb.on_train_begin()
        self.epoch = epoch
        for cb in self.callbacks:
            cb.on_epoch_begin(epoch)

    def on_batch_begin(self, batch: int) -> None:
        self.batch = batch
        self._batch_t0 = _time.perf_counter()
        for cb in self.callbacks:
            cb.on_batch_begin(batch)

    def on_batch_end(self, batch: int, logs: Optional[dict] = None) -> None:
        t0 = getattr(self, "_batch_t0", None)
        if t0 is not None:
            _STEP_TIME.observe(_time.perf_counter() - t0)
            self._batch_t0 = None
        for cb in self.callbacks:
            cb.on_batch_end(batch, logs)

    def on_epoch_end(self, epoch: int,
                     logs: Optional[dict] = None) -> Optional[dict]:
        for cb in self.callbacks:
            out = cb.on_epoch_end(epoch, logs)
            if out is not None:
                logs = out
        return logs


# -- the reference callbacks -------------------------------------------------


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast the initial state from root so all workers start
    identical (reference: keras/callbacks.py
    BroadcastGlobalVariablesCallback): parameters and buffers (BatchNorm
    running statistics), then the optimizer state, in place."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self) -> None:
        from . import functions

        st = self.loop.state
        functions.broadcast_parameters(st.model, root_rank=self.root_rank)
        functions.broadcast_optimizer_state(st.optimizer,
                                            root_rank=self.root_rank)


class MetricAverageCallback(Callback):
    """Average epoch metrics over workers before reporting (reference:
    keras/callbacks.py MetricAverageCallback)."""

    def on_epoch_end(self, epoch: int,
                     logs: Optional[dict] = None) -> Optional[dict]:
        if not logs:
            return logs
        out = dict(logs)
        for k, v in logs.items():
            if isinstance(v, (int, float, np.floating, np.integer)) or (
                hasattr(v, "shape") and tuple(getattr(v, "shape", ())) == ()
            ):
                reduced = collective_ops.allreduce(
                    torch.tensor(float(v), device=basics.device()),
                    op=Average, name=f"metric.{k}")
                out[k] = float(reduced)
        return out


class LearningRateWarmupCallback(Callback):
    """Linear LR warmup over the first epochs (reference:
    keras/callbacks.py LearningRateWarmupCallback, after Goyal et al. —
    ramp from ``target_lr / size`` to ``target_lr``, adjusted every batch
    at epoch + batch/steps_per_epoch granularity)."""

    def __init__(self, target_lr: float, warmup_epochs: float = 5,
                 steps_per_epoch: Optional[int] = None,
                 initial_lr: Optional[float] = None, verbose: bool = False):
        self.target_lr = target_lr
        self.warmup_epochs = warmup_epochs
        self.steps_per_epoch = steps_per_epoch
        self.initial_lr = initial_lr
        self.verbose = verbose
        self._current_epoch = 0

    def _initial(self) -> float:
        if self.initial_lr is not None:
            return self.initial_lr
        size = basics.size() if basics.is_initialized() else 1
        return self.target_lr / size

    def on_epoch_begin(self, epoch: int) -> None:
        self._current_epoch = epoch

    def on_batch_begin(self, batch: int) -> None:
        if self._current_epoch >= self.warmup_epochs:
            return
        if self.steps_per_epoch:
            progress = (self._current_epoch +
                        batch / self.steps_per_epoch) / self.warmup_epochs
        else:
            progress = self._current_epoch / self.warmup_epochs
        progress = min(max(progress, 0.0), 1.0)
        init = self._initial()
        self.loop.lr = init + (self.target_lr - init) * progress

    def on_epoch_end(self, epoch: int,
                     logs: Optional[dict] = None) -> Optional[dict]:
        # fires exactly on the epoch that crosses warmup_epochs — also for
        # fractional warmup_epochs (e.g. 2.5 pins the target at epoch 2)
        if epoch < self.warmup_epochs <= epoch + 1:
            self.loop.lr = self.target_lr
            if self.verbose:
                print(f"Epoch {epoch + 1}: finished gradual learning rate "
                      f"warmup to {self.target_lr}.")
        return logs


class LearningRateScheduleCallback(Callback):
    """Piecewise LR schedule (reference: keras/callbacks.py
    LearningRateScheduleCallback): within [start_epoch, end_epoch) the LR
    is ``initial_lr * multiplier(epoch)`` (or a constant multiplier)."""

    def __init__(self, initial_lr: float,
                 multiplier: Union[float, Callable[[int], float]],
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 staircase: bool = True,
                 steps_per_epoch: Optional[int] = None):
        self.initial_lr = initial_lr
        self.multiplier = multiplier
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        self._current_epoch = 0

    def _mult(self, epoch: float) -> float:
        if callable(self.multiplier):
            return self.multiplier(epoch)
        return self.multiplier

    def _in_range(self, epoch: float) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def on_epoch_begin(self, epoch: int) -> None:
        self._current_epoch = epoch
        # staircase, or smooth mode without per-batch granularity
        # available: adjust at epoch boundaries (reference behavior —
        # never silently skip the schedule)
        if (self.staircase or not self.steps_per_epoch) and \
                self._in_range(epoch):
            self.loop.lr = self.initial_lr * self._mult(epoch)

    def on_batch_begin(self, batch: int) -> None:
        if self.staircase or not self.steps_per_epoch:
            return
        epoch = self._current_epoch + batch / self.steps_per_epoch
        if self._in_range(epoch):
            self.loop.lr = self.initial_lr * self._mult(epoch)


# -- static schedules ---------------------------------------------------------


def warmup_schedule(target_lr: float, warmup_steps: int,
                    initial_lr: Optional[float] = None
                    ) -> Callable[[int], float]:
    """The static form of LearningRateWarmupCallback: ``step -> lr``,
    the values of ``optax.linear_schedule(initial_lr, target_lr,
    warmup_steps)`` (computed in fp32 as optax does; constant
    ``initial_lr`` when ``warmup_steps <= 0``).  ``initial_lr`` defaults
    to ``target_lr / size``.  Use it to set the rate per step, or as a
    ``LambdaLR`` factor over a base rate of 1."""
    if initial_lr is None:
        initial_lr = target_lr / (
            basics.size() if basics.is_initialized() else 1
        )
    steps = int(warmup_steps)
    # optax: (init - end) in Python floats, then weak-typed fp32 math
    span, end = np.float32(initial_lr - target_lr), np.float32(target_lr)

    def schedule(step: int) -> float:
        if steps <= 0:
            return float(initial_lr)
        count = np.float32(min(max(int(step), 0), steps))
        frac = np.float32(1) - count / np.float32(steps)
        return float(span * frac + end)

    return schedule
