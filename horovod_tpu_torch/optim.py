"""Distributed optimizers: gradient reduction around a torch optimizer.

Port of ``horovod_tpu/optim.py`` (``allreduce_gradients``,
``DistributedOptimizer``, ``with_gradient_accumulation``) with the
contract of the reference's PyTorch ``DistributedOptimizer``
(``horovod_tpu/torch/optimizer.py``): the user runs ``backward_passes_
per_step`` backward passes, then ``step()`` reduces the accumulated
gradients across ranks and steps the wrapped optimizer.  The reduction
runs after the backward, through fused buckets (:mod:`.ops.fusion`);
launching it from gradient hooks inside the backward, so that it
overlaps, is the overlap slice's work.

The wrappers update the model's parameters in place, as torch
optimizers do (the JAX package returns new pytrees).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, List, Sequence

import torch

from .ops import collective_ops
from .ops.reduce_ops import Average, ReduceOp


def allreduce_gradients(grads: Any, op: ReduceOp = Average,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0) -> Any:
    """Reduce a tensor / list / dict of gradients across ranks through
    per-dtype fused buckets; returns the reduced tree (Average = SUM,
    then a division by ``size()`` in the gradients' dtype)."""
    return collective_ops.allreduce(grads, op=op,
                                    prescale_factor=prescale_factor,
                                    postscale_factor=postscale_factor)


def _params_with_grad(param_groups) -> List[torch.nn.Parameter]:
    return [p for g in param_groups for p in g["params"]
            if p.grad is not None]


def reduce_param_grads(params: Sequence[torch.nn.Parameter],
                       op: ReduceOp = Average, prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0,
                       divide_by: int = 1) -> None:
    """Replace each parameter's ``.grad`` by its reduction across ranks
    (after a local division by ``divide_by``, the count of accumulated
    backward passes)."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    if divide_by > 1:
        grads = [g / divide_by for g in grads]
    reduced = allreduce_gradients(grads, op, prescale_factor,
                                  postscale_factor)
    for p, g in zip(params, reduced):
        p.grad = g


class _Wrapper:
    """Delegates everything it does not define to the wrapped optimizer
    (``param_groups``, ``state``, ``state_dict``, ...)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer

    def __getattr__(self, name):
        return getattr(self.__dict__["optimizer"], name)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)


class DistributedOptimizer(_Wrapper):
    """Wrap a ``torch.optim.Optimizer`` so that ``step()`` sees gradients
    reduced across ranks (reference: horovod/torch/optimizer.py).

    ``op`` (Average, Sum, Min, Max, Product), ``prescale_factor`` and
    ``postscale_factor`` go to the allreduce; with
    ``backward_passes_per_step=k`` the caller runs k backward passes
    (their gradients add up in ``.grad``) before each ``step()``, which
    reduces their mean.  ``synchronize()`` reduces without stepping
    (for clipping), and ``skip_synchronize()`` makes the next ``step()``
    use the gradients as they stand."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 op: ReduceOp = Average, prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 backward_passes_per_step: int = 1):
        super().__init__(optimizer)
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.op = op
        self.prescale_factor = prescale_factor
        self.postscale_factor = postscale_factor
        self.backward_passes_per_step = backward_passes_per_step
        self._synchronized = False
        self._should_synchronize = True

    def synchronize(self) -> None:
        """Reduce every parameter's gradient across ranks, in place."""
        reduce_param_grads(_params_with_grad(self.optimizer.param_groups),
                           self.op, self.prescale_factor,
                           self.postscale_factor,
                           divide_by=self.backward_passes_per_step)
        self._synchronized = True

    @contextlib.contextmanager
    def skip_synchronize(self):
        """Step without reducing again (after a manual synchronize())."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.step() called after optimizer.synchronize(); "
                    "use optimizer.skip_synchronize() to avoid reducing "
                    "gradients twice")
            self.synchronize()
        self._synchronized = False
        return self.optimizer.step(closure)


class _GradientAccumulation(_Wrapper):
    """``optax.MultiSteps`` over a torch optimizer: each ``step()`` folds
    the current gradients into a running mean, and every ``every_k``-th
    steps the wrapped optimizer on that mean (the parameters stay put in
    between)."""

    def __init__(self, optimizer, every_k: int):
        super().__init__(optimizer)
        if every_k < 1:
            raise ValueError("every_k must be >= 1")
        self.every_k = every_k
        self.mini_step = 0
        self._acc = {}

    def step(self, closure=None):
        n = self.mini_step
        with torch.no_grad():
            for p in _params_with_grad(self.optimizer.param_groups):
                acc = self._acc.get(p)
                if acc is None:
                    acc = torch.zeros_like(p.grad)
                # optax's Welford mean: acc + (g - acc) / (n + 1)
                self._acc[p] = acc + (p.grad - acc) / (n + 1)
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step:
            return None
        for p, acc in self._acc.items():
            p.grad = acc
        self._acc = {}
        return self.optimizer.step(closure)


def with_gradient_accumulation(optimizer, every_k: int):
    """Accumulate ``every_k`` microbatches' gradients (their mean) and
    step once, as ``optax.MultiSteps`` does; wrap the *inner* optimizer
    that ``training.data_parallel_train_step`` drives (its gradients
    are then reduced every microbatch, as in the JAX package)."""
    return _GradientAccumulation(optimizer, every_k)
