"""Data-parallel training loop building blocks.

Port of ``horovod_tpu/training.py``: a :class:`TrainState`, the loss,
and the data-parallel step — forward, backward, fused gradient allreduce,
optimizer update.  Where the JAX package compiles the step into one SPMD
program over a mesh, each rank here is its own process running the same
eager step on its own shard of the batch, and the gradients cross ranks
through ``torch.distributed`` (one process per GPU, see
:mod:`.common.basics`).  The model and optimizer are updated in place;
the state carries them and the step count.

``overlap=True`` launches each gradient bucket's allreduce from the
backward's hooks (``optim.DistributedOptimizer``'s machinery), and
:func:`zero_train_setup` builds the ZeRO stage-1 trainer.  ``guard=True``
makes either step also return the integrity guard's on-device
diagnostics (:mod:`.guard`).  :func:`fit_epoch` drives an epoch from a
loader (``data.DataLoader``) with periodic crash-atomic checkpoints
(:mod:`.checkpoint`) and feeds an armed guard.  Under
``HOROVOD_HIERARCHICAL_ALLREDUCE`` both steps reduce through the
two-level collectives where the world spans slices (the reducer routes
its buckets), and :func:`zero_train_setup` takes ``hierarchical=`` and
``dcn_compression=`` for the two-level ZeRO exchange.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from . import chaos as _chaos
from . import checkpoint as _checkpoint
from . import trace
from .common.retry import env_int
from .functions import broadcast_optimizer_state, broadcast_parameters
from .guard import grad_diag
from .models.resnet import running_stats
from .ops import collective_ops
from .ops.reduce_ops import Average, ReduceOp
from .optim import ZeroDistributedOptimizer, _BucketReducer
from .utils.logging import set_log_context


def _resolve_guard(guard: Optional[bool]) -> bool:
    """``guard=None`` defers to ``HVD_TPU_GUARD`` (the JAX package's
    spelling)."""
    if guard is None:
        return bool(env_int("HVD_TPU_GUARD", 0))
    return bool(guard)


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


def _check_overlap(op: ReduceOp, stats, model) -> None:
    """The reference's refusals for the overlapped step (the ring impls'
    is ``overlap_segments``')."""
    if ReduceOp(op) not in (ReduceOp.AVERAGE, ReduceOp.SUM):
        raise ValueError(f"overlap supports Sum/Average gradient reduction, "
                         f"got {op!r}")
    if stats:
        raise ValueError("overlap=True does not support models with running "
                         "statistics (batch_stats)")
    impl = getattr(getattr(model, "cfg", None), "attention_impl", None)
    if impl in ("ring", "ring_flash"):
        raise ValueError(
            f"overlap=True does not support the sequence-sharded ring "
            f"impls (attention_impl={impl!r}); use the plain step, "
            f"data_parallel_train_step(overlap=False)")


def _average_stats(stats) -> None:
    """Average BatchNorm running statistics across ranks, in place."""
    if stats:
        with torch.no_grad():
            for t, avg in zip(stats, collective_ops.grouped_allreduce(
                    stats, op=Average)):
                t.copy_(avg)


def data_parallel_train_step(model: torch.nn.Module, optimizer,
                             loss_fn: Callable = softmax_cross_entropy,
                             op: ReduceOp = Average, overlap: bool = False,
                             bucket_bytes: Optional[int] = None,
                             guard: Optional[bool] = None) -> Callable:
    """The data-parallel train step:
    ``step(state, inputs, labels) -> (state, loss)``.

    Each rank feeds its own shard; the gradients are reduced with ``op``
    across ranks before ``optimizer`` steps, so pass the *inner*
    optimizer (wrapping it in ``DistributedOptimizer`` as well would
    reduce twice).  ``loss`` is the rank-averaged loss, a 0-d tensor on
    the device (no host sync).  ``state`` must carry this ``model`` and
    ``optimizer`` (:func:`create_train_state`).  Over a ring-attention
    transformer (``attention_impl="ring"|"ring_flash"``) a rank's shard
    is its slice of the sequence: the average of the shards' mean losses
    is the global mean, and the averaged gradients are its gradients.

    The gradients reduce in the buckets of a
    :class:`~.ops.fusion.BucketSchedule` over the model's parameters.
    With ``overlap=True`` each bucket's allreduce launches from the hook
    that completes it, inside the backward (``bucket_bytes``, default
    ``HVD_TPU_OVERLAP_BUCKET_BYTES``); without, the buckets reduce after
    the backward (default: the fusion threshold).  A floating sum adds
    the ranks in one order whatever the buckets, so the two give
    bit-equal gradients.  ``overlap=True`` takes Sum and Average
    only, no model with running statistics, and no ring-attention
    transformer (whose sequence is sharded over the ranks).  Without overlap, a
    model with BatchNorm running statistics has them averaged across
    ranks after the update (replicas see different batches), in one
    grouped allreduce, as the JAX step averages its ``batch_stats``.
    The step's reducer is ``step.reducer`` (its ``schedule`` and its
    ``last_launches``).

    ``guard=True`` (``None`` = the ``HVD_TPU_GUARD`` flag) makes the step
    also return the silent-corruption diagnostics,
    ``step(state, x, y) -> (state, loss, diag)``:
    :func:`~.guard.step_diag`'s ``finite`` over the loss and the
    POST-reduction gradients and ``digest`` over those gradients, both
    tensors on the device (no host sync).  They only read the
    gradients: state and loss stay bit-identical to the unguarded step,
    and no collective is added."""
    guard = _resolve_guard(guard)
    stats = running_stats(model)
    if overlap:
        _check_overlap(op, stats, model)
    reducer = _BucketReducer(model.parameters(), op=op,
                             bucket_bytes=bucket_bytes, overlap=overlap,
                             always_armed=False)

    def step(state: TrainState, inputs, labels
             ) -> Tuple[TrainState, torch.Tensor]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("state does not carry this step's model and "
                             "optimizer")
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(inputs), labels)
        reducer.backward(loss)
        reducer.synchronize()
        if guard:
            digest, finite = grad_diag([p.grad for p in reducer.params])
        optimizer.step()
        _average_stats(stats)
        loss = collective_ops.allreduce(loss.detach(), op=Average)
        new_state = dataclasses.replace(state, step=state.step + 1)
        if guard:
            return new_state, loss, {
                "finite": finite & torch.isfinite(loss), "digest": digest}
        return new_state, loss

    step.reducer = reducer
    return step


def zero_train_setup(model: torch.nn.Module, inner_optimizer,
                     loss_fn: Callable = softmax_cross_entropy,
                     op: ReduceOp = Average, hierarchical: bool = False,
                     dcn_compression=None, overlap: bool = False,
                     bucket_bytes: Optional[int] = None,
                     guard: Optional[bool] = None):
    """Build a ZeRO stage-1 data-parallel trainer: ``(state, step)``.

    The sharded sibling of :func:`create_train_state` +
    :func:`data_parallel_train_step`: ``inner_optimizer`` (a fresh torch
    optimizer over ``model``'s parameters) is wrapped in
    :class:`~.optim.ZeroDistributedOptimizer`, so each rank keeps about
    1/world of its state, and ``step(state, inputs, labels) -> (state,
    loss)`` matches the data-parallel step's contract.  ``op``: Average
    or Sum.

    ``overlap=True`` allreduces the gradients in the buckets of a
    :class:`~.ops.fusion.BucketSchedule` from the backward's hooks, as
    the data-parallel step does, and the step takes this rank's shard of
    them locally (the JAX package's ``pre_reduced`` path): the same bits
    as the reduce-scatter, since a floating sum adds the ranks in one
    order however its buffer is cut.  It takes no model with running
    statistics.  The parameters start from rank 0's.

    ``hierarchical=True`` selects the two-level exchange where the world
    spans slices: the state shards over a slice's ranks
    (:class:`~.optim.ZeroDistributedOptimizer`), and ``dcn_compression``
    casts only the cross hop's shard.  With
    ``overlap=True`` the buckets take the two-level sum instead, their
    cross hop in the compression's wire dtype; error-feedback
    compression rides the reduce-scatter's residual, which the
    overlapped exchange does not have, so that pair raises.  The JAX
    version also returns the optimizer state's sharding specs; the port
    has none to return.

    ``guard=True`` (``None`` = ``HVD_TPU_GUARD``) adds the diagnostics
    as a third step output, from REPLICATED values only, as the JAX
    step's: the digest and the finite sentinel over the POST-allgather
    update deltas (new minus old parameters, identical on every rank
    after the allgather — the cross-rank agreement object) and the mean
    loss.  Per-rank intermediates (local gradients, reduce-scattered
    shards) differ across ranks by design; a non-finite shard still
    reaches the deltas through the inner update the same step.  State
    and loss stay bit-identical to the unguarded step; no collective is
    added."""
    guard = _resolve_guard(guard)
    if overlap and getattr(dcn_compression, "error_feedback", False):
        raise ValueError(
            "overlap=True folds the gradient reduce-scatter into the bucket "
            "collectives: error_feedback compression (which rides that "
            "hop's residual) does not compose; use a stateless "
            "DcnCompression or overlap=False")
    broadcast_parameters(model, 0)  # the JAX version's state starts equal
    zopt = ZeroDistributedOptimizer(inner_optimizer, op=op,
                                    hierarchical=hierarchical,
                                    dcn_compression=dcn_compression)
    stats = running_stats(model)
    reducer = None
    if overlap:
        _check_overlap(op, stats, model)
        reducer = _BucketReducer(model.parameters(), op=op,
                                 bucket_bytes=bucket_bytes,
                                 always_armed=False,
                                 hierarchical=zopt.tiers is not None,
                                 dcn_compression=dcn_compression)

    def step(state: TrainState, inputs, labels
             ) -> Tuple[TrainState, torch.Tensor]:
        if state.model is not model or state.optimizer is not zopt:
            raise ValueError("state does not carry this step's model and "
                             "optimizer")
        zopt.zero_grad(set_to_none=True)
        loss = loss_fn(model(inputs), labels)
        updates = [] if guard else None
        if reducer is None:
            loss.backward()
            zopt._step(reduce=True, updates=updates)
        else:
            reducer.backward(loss)
            reducer.synchronize()
            zopt._step(reduce=False, updates=updates)
        _average_stats(stats)
        loss = collective_ops.allreduce(loss.detach(), op=Average)
        new_state = dataclasses.replace(state, step=state.step + 1)
        if guard:
            digest, finite = grad_diag(updates)
            return new_state, loss, {
                "finite": finite & torch.isfinite(loss), "digest": digest}
        return new_state, loss

    step.reducer = reducer
    return TrainState(step=0, model=model, optimizer=zopt), step


def fit_epoch(step: Callable, state: TrainState, loader,
              epoch: Optional[int] = None, *,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0,
              checkpoint_keep: Optional[int] = None,
              guard=None):
    """Drive one epoch of ``step`` over ``loader`` (a
    :class:`~.data.DataLoader`, or any iterable of ``(inputs, labels)``
    batches); ``loader.set_epoch(epoch)`` is called first where the
    loader has it.  The loader stages batch N+1 on the card while the
    step computes batch N, so this loop adds no synchronisation.

    Each step passes the ``training.step`` chaos point first; while the
    trace recorder is on it runs under a ``train.step`` span numbered by
    the global step (``state.step + 1``) and tagged with ``epoch``, and
    the structured log's ``step`` field carries the same number.

    With ``checkpoint_dir`` and ``checkpoint_every`` set, rank 0 writes
    a crash-atomic checkpoint every ``checkpoint_every`` batches
    (:func:`~.checkpoint.save_checkpoint` keyed by ``state.step``),
    keeping the newest ``checkpoint_keep``; pair it with
    :func:`~.checkpoint.restore_checkpoint` before training so a
    restarted job resumes.

    ``guard`` takes an armed :class:`~.guard.IntegrityGuard` when
    ``step`` was built with ``guard=True``: each step's on-device
    diagnostics feed the guard without a host sync, numbered by the
    global step (``state.step``, the checkpoints' key), and on cadence
    steps the guard performs its ONE bounded sync (window + loss +
    param fingerprint of ``state.model``), the cross-rank agreement
    check and the response — :class:`~.guard.IntegrityError` on
    detected corruption in non-elastic runs (reload a verified
    checkpoint), the quarantine/rollback restart path under the elastic
    driver.  ``checkpoint_keep`` defaults to 3, and to
    ``max(3, 2·guard.cadence)`` with a guard armed: rollback discards
    every checkpoint newer than the last verified step, so a ring
    shallower than the cadence could be emptied.

    Returns ``(state, last_loss)`` with the loss fetched to the host
    (the end-of-epoch sync point; ``None`` for an empty loader)."""
    if epoch is not None and hasattr(loader, "set_epoch"):
        loader.set_epoch(epoch)
    if checkpoint_keep is None:
        checkpoint_keep = (max(3, 2 * guard.cadence)
                           if guard is not None
                           and getattr(guard, "enabled", False) else 3)
    loss = None
    batches = 0
    guard_base = None
    tracing = trace.enabled()
    for inputs, labels in loader:
        if _chaos.active:
            _chaos.raise_point("training.step")
        if tracing:
            step_no = state.step + 1
            set_log_context(step=step_no)
            with trace.span("train.step", step=step_no,
                            epoch=-1 if epoch is None else epoch):
                out = step(state, inputs, labels)
        else:
            out = step(state, inputs, labels)
        if len(out) == 3:
            state, loss, diag = out
            if guard is not None:
                if guard_base is None:
                    # the guard numbers steps GLOBALLY (state.step):
                    # checkpoints are keyed by it, so rollback's
                    # discard_newer_than and the exchange keys share the
                    # numbering across epochs and resumes
                    guard_base = state.step - batches - 1
                guard.on_train_step(guard_base + batches + 1, loss, diag,
                                    params=state.model)
        else:
            state, loss = out
        batches += 1
        if (checkpoint_dir and checkpoint_every
                and batches % checkpoint_every == 0):
            _checkpoint.save_checkpoint(checkpoint_dir, state, state.step,
                                        keep=checkpoint_keep)
    return state, (None if loss is None else float(loss))


def replicate_state(state: TrainState, root_rank: int = 0) -> TrainState:
    """Give every rank ``root_rank``'s weights and optimizer state, in
    place (the reference's broadcast_parameters at train start)."""
    broadcast_parameters(state.model, root_rank)
    broadcast_optimizer_state(state.optimizer, root_rank)
    return state
