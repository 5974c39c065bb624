"""Data-parallel training loop building blocks.

Port of ``horovod_tpu/training.py``: a :class:`TrainState`, the loss,
and the data-parallel step — forward, backward, fused gradient allreduce,
optimizer update.  Where the JAX package compiles the step into one SPMD
program over a mesh, each rank here is its own process running the same
eager step on its own shard of the batch, and the gradients cross ranks
through ``torch.distributed`` (one process per GPU, see
:mod:`.common.basics`).  The model and optimizer are updated in place;
the state carries them and the step count.

Not ported yet (queued in ROADMAP): ZeRO (``zero_train_setup``), the
overlapped backward (``overlap=``), the integrity guard (``guard=``)
and ``fit_epoch``'s checkpoint arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from . import trace
from .functions import broadcast_optimizer_state, broadcast_parameters
from .models.resnet import running_stats
from .ops import collective_ops
from .ops.reduce_ops import Average, ReduceOp
from .optim import reduce_param_grads


@dataclasses.dataclass
class TrainState:
    """The step count and what it trains: ``model`` (an ``nn.Module``)
    and ``optimizer`` (a torch optimizer over its parameters, or a
    wrapper of one such as ``with_gradient_accumulation``'s)."""

    step: int
    model: torch.nn.Module
    optimizer: Any


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels, op for op as
    ``optax.softmax_cross_entropy_with_integer_labels`` (log-sum-exp with
    the row max subtracted, minus the label's logit), in the logits'
    own dtype — it does not upcast as ``F.cross_entropy`` does."""
    amax = logits.detach().amax(dim=-1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    sumexp = torch.exp(logits - amax).sum(dim=-1)
    log_norm = torch.log(sumexp) + amax[..., 0]
    label = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (log_norm - label).mean()


def create_train_state(model: torch.nn.Module, optimizer) -> TrainState:
    """A state at step 0 over ``model`` and ``optimizer`` (built by the
    caller over ``model.parameters()``: a torch optimizer is constructed
    from its parameters, where an optax one is initialised from them)."""
    return TrainState(step=0, model=model, optimizer=optimizer)


def data_parallel_train_step(model: torch.nn.Module, optimizer,
                             loss_fn: Callable = softmax_cross_entropy,
                             op: ReduceOp = Average) -> Callable:
    """The data-parallel train step:
    ``step(state, inputs, labels) -> (state, loss)``.

    Each rank feeds its own shard; the gradients are reduced with ``op``
    across ranks before ``optimizer`` steps, so pass the *inner*
    optimizer (wrapping it in ``DistributedOptimizer`` as well would
    reduce twice).  ``loss`` is the rank-averaged loss, a 0-d tensor on
    the device (no host sync).  ``state`` must carry this ``model`` and
    ``optimizer`` (:func:`create_train_state`).  A model with BatchNorm
    running statistics has them averaged across ranks after the update
    (replicas see different batches), in one grouped allreduce, as the
    JAX step averages its ``batch_stats``."""
    stats = running_stats(model)

    def step(state: TrainState, inputs, labels
             ) -> Tuple[TrainState, torch.Tensor]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("state does not carry this step's model and "
                             "optimizer")
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(inputs), labels)
        loss.backward()
        reduce_param_grads(list(model.parameters()), op)
        optimizer.step()
        if stats:
            with torch.no_grad():
                for t, avg in zip(stats, collective_ops.grouped_allreduce(
                        stats, op=Average)):
                    t.copy_(avg)
        loss = collective_ops.allreduce(loss.detach(), op=Average)
        return dataclasses.replace(state, step=state.step + 1), loss

    return step


def fit_epoch(step: Callable, state: TrainState, loader,
              epoch: Optional[int] = None):
    """Drive one epoch of ``step`` over ``loader`` (any iterable of
    ``(inputs, labels)`` batches), each step under a ``train.step`` span
    numbered by the global step and tagged with ``epoch``.  Returns
    ``(state, last_loss)`` with the loss fetched to the host (``None``
    for an empty loader)."""
    loss = None
    for inputs, labels in loader:
        with trace.span("train.step", step=state.step + 1,
                        epoch=-1 if epoch is None else epoch):
            state, loss = step(state, inputs, labels)
    return state, (None if loss is None else float(loss))


def replicate_state(state: TrainState, root_rank: int = 0) -> TrainState:
    """Give every rank ``root_rank``'s weights and optimizer state, in
    place (the reference's broadcast_parameters at train start)."""
    broadcast_parameters(state.model, root_rank)
    broadcast_optimizer_state(state.optimizer, root_rank)
    return state
