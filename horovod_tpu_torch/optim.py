"""Distributed optimizers: gradient reduction around a torch optimizer.

Port of ``horovod_tpu/optim.py`` (``allreduce_gradients``,
``DistributedOptimizer``, ``with_gradient_accumulation``, ZeRO stage 1:
``ZeroPlan``, ``state_bytes``, ``ZeroDistributedOptimizer``) with the
contract of the reference's PyTorch ``DistributedOptimizer``
(``horovod_tpu/torch/optimizer.py``).

``DistributedOptimizer`` is driven by hooks, Horovod's own hot path: a
post-accumulate-grad hook on every parameter counts the backward passes,
and when a parameter's last pass lands it is ready; when the last
parameter of a :class:`~.ops.fusion.BucketSchedule` bucket is ready, the
hook fuses the bucket and launches its allreduce (``async_op=True``)
there, inside the backward, while autograd goes on with the earlier
layers.  Buckets launch strictly in the schedule's order, so every rank
issues the same collectives in the same order whatever order its own
hooks fire in.  ``synchronize()`` waits for them and writes the reduced
gradients into ``.grad``.  The reference's submission thread is not
needed: NCCL and gloo works are already asynchronous, and launching
from the hook on the autograd thread is what PyTorch's own DDP does.
The hooks run on the stream that produced the gradients, and an NCCL
collective orders itself after that stream, so a bucket is fused and
reduced only once its gradients exist.

The wrappers update the model's parameters in place, as torch
optimizers do (the JAX package returns new pytrees).
"""

from __future__ import annotations

import contextlib
import inspect
import warnings
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from . import trace as _trace
from .common import basics
from .common.retry import env_int
from .compression import Compression
from .metrics import instruments as _metrics
from .ops import collective_ops, hierarchical
from .ops.comm_model import modeled_collective_bytes
from .ops.fusion import BucketSchedule, dtype_name, fusion_threshold
from .ops.reduce_ops import Average, ReduceOp
from .utils.env_parser import Config


def _stateless(dcn_compression, where: str) -> None:
    if dcn_compression is not None and dcn_compression.error_feedback:
        raise ValueError(
            f"{where} is stateless: use ops.hierarchical."
            f"hierarchical_allreduce(residual=...) or "
            f"ZeroDistributedOptimizer to carry the error-feedback residual")


def allreduce_gradients(grads: Any, op: ReduceOp = Average,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        process_set=None,
                        hierarchical: Optional[bool] = None,
                        dcn_compression=None) -> Any:
    """Reduce a tensor / list / dict of gradients across ranks through
    per-dtype fused buckets; returns the reduced tree (Average = SUM,
    then a division by the set's size in the gradients' dtype).  A
    floating sum adds the ranks in rank order, as the optimizers'
    buckets do, so the bits do not depend on the buckets.

    ``hierarchical`` (default: the ``HOROVOD_HIERARCHICAL_ALLREDUCE``
    flag) takes the two-level path (:mod:`.ops.hierarchical`) for a Sum
    or Average over the world when it spans more than one slice; the
    sum is then (each slice's sum) added across slices in slice order.
    ``dcn_compression`` (default: ``HVD_TPU_DCN_WIRE_DTYPE``'s) casts
    only the cross-tier shard; it must be stateless here (error feedback
    raises)."""
    _stateless(dcn_compression, "allreduce_gradients")
    return collective_ops._submit(
        None, "allreduce", grads, lambda: collective_ops._allreduce_async(
            grads, ReduceOp(op), prescale_factor, postscale_factor,
            process_set, ordered=True, hierarchical=hierarchical,
            dcn_compression=dcn_compression)).wait()


def _unique(params: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    seen, out = set(), []
    for p in params:
        if p.requires_grad and id(p) not in seen:
            seen.add(id(p))
            out.append(p)
    return out


class _BucketReducer:
    """Bucketed gradient reduction of a parameter list (in registration
    order) with ``op`` over ``process_set``, launched from
    post-accumulate-grad hooks (``overlap=True``) or after the backward
    (``overlap=False``: :meth:`synchronize` issues every bucket).

    The :class:`~.ops.fusion.BucketSchedule` owns the layout: each
    bucket is fused once into a flat buffer (zero-padded to a multiple
    of the set's size), reduced as one buffer, and its slices become the
    reduced ``.grad`` views.  ``bucket_bytes`` defaults to
    ``HVD_TPU_OVERLAP_BUCKET_BYTES`` with overlap and to the fusion
    threshold without.  ``always_armed=False`` makes the hooks act only
    inside :meth:`backward`, so a training step's hooks never fire for
    another loop's backward over the same model.  ``hierarchical``
    (default: the ``HOROVOD_HIERARCHICAL_ALLREDUCE`` flag) routes every
    bucket through the two-level sum where
    ``collective_ops._route`` allows it, overlapped or not, its cross hop
    in ``dcn_compression``'s wire dtype (default:
    ``HVD_TPU_DCN_WIRE_DTYPE``'s; stateless).  Its sum does not depend
    on the buckets either, so overlapped and plain steps stay
    bit-identical under it."""

    def __init__(self, params: Iterable[torch.Tensor], *,
                 op: ReduceOp = Average, process_set=None,
                 bucket_bytes: Optional[int] = None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 gradient_predivide_factor: float = 1.0,
                 overlap: bool = True, always_armed: bool = True,
                 hierarchical: Optional[bool] = None,
                 dcn_compression=None):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        _stateless(dcn_compression, "the gradient reducer")
        if bucket_bytes is None:
            bucket_bytes = (Config.from_env().overlap_bucket_bytes if overlap
                            else fusion_threshold())
        self.params = _unique(params)
        self.schedule = BucketSchedule(self.params, bucket_bytes)
        self._op = ReduceOp(op)
        self._process_set = process_set
        self._group, self._n, self._me = collective_ops._scope(process_set)
        self._tiers = (collective_ops._route(self._op, process_set,
                                             hierarchical)
                       if self._n > 1 else None)
        self._wire = (collective_ops._dcn_compression(dcn_compression)
                      if self._tiers is not None else None)
        self._compression = compression
        self._passes_per_step = backward_passes_per_step
        self._predivide = gradient_predivide_factor
        self._index = {id(p): i for i, p in enumerate(self.params)}
        self._bucket_of = [0] * len(self.params)
        for b, (_, idxs) in enumerate(self.schedule.buckets):
            for i in idxs:
                self._bucket_of[i] = b
        self._armed = always_armed
        #: per bucket of the last step: (bucket, parameters ready when it
        #: launched, launched from a hook)
        self.last_launches: List[Tuple[int, int, bool]] = []
        #: the last step's launch record, in launch order, for
        #: ``ops.comm_model.overlap_inventory``
        self.last_record: Dict[str, Any] = {}
        self._reset()
        self._hook_handles = []
        if overlap:
            self._hook_handles = [p.register_post_accumulate_grad_hook(
                self._hook) for p in self.params]

    def _reset(self) -> None:
        nb = self.schedule.num_buckets
        self._passes = [0] * len(self.params)
        self._remaining = [len(idxs) for _, idxs in self.schedule.buckets]
        self._handles: List[Optional[tuple]] = [None] * nb
        self._next = 0
        self._ready = 0
        self._launches: List[Tuple[int, int, bool]] = []
        self._record: List[Dict[str, Any]] = []

    @property
    def pending(self) -> bool:
        """A gradient was marked ready or a bucket launched since the
        last :meth:`synchronize`."""
        return self._ready > 0 or self._next > 0

    def _hook(self, p: torch.Tensor) -> None:
        if not self._armed:
            return
        i = self._index[id(p)]
        self._passes[i] += 1
        if self._passes[i] < self._passes_per_step:
            return
        if self._passes[i] > self._passes_per_step:
            raise RuntimeError(
                "gradients were computed more than backward_passes_per_step "
                "times before the optimizer stepped or synchronized")
        self._ready += 1
        b = self._bucket_of[i]
        self._remaining[b] -= 1
        while (self._next < self.schedule.num_buckets
               and self._remaining[self._next] == 0):
            self._launch(self._next, from_hook=True)

    def _launch(self, b: int, from_hook: bool) -> None:
        idxs = self.schedule.buckets[b][1]
        grads = [self.params[i].grad for i in idxs]
        parts = [(torch.zeros_like(self.params[i]) if g is None else g
                  ).reshape(-1) for i, g in zip(idxs, grads)]
        pad = (-sum(x.numel() for x in parts)) % self._n
        if pad:
            parts.append(parts[0].new_zeros(pad))
        flat = torch.cat(parts)
        if self._passes_per_step > 1:
            flat /= self._passes_per_step
        if self._predivide != 1.0:
            flat /= self._predivide
        flat, ctx = self._compression.compress(flat)
        with _trace.span("overlap.bucket", bucket=b, params=len(idxs)):
            handle = collective_ops._submit(
                f"bucket.{b}", "allreduce", flat,
                lambda: collective_ops.Handle(
                    *collective_ops._allreduce_flat_async(
                        flat, self._op, self._group, self._n, self._me,
                        self._process_set, ordered=True, tiers=self._tiers,
                        wire=self._wire)))
        # launch lead: parameters still awaiting gradients at this launch
        # (none once the backward is over)
        pending = len(self.params) - self._ready if from_hook else 0
        _metrics.OVERLAP_LAUNCH_LEAD.observe(pending)
        self._handles[b] = (handle, ctx, [g is not None for g in grads])
        self._launches.append((b, self._ready, from_hook))
        self._record.append({"bucket": b, "payload_bytes": flat.numel()
                             * flat.element_size(), "pending": pending})
        self._next = b + 1

    def backward(self, loss: torch.Tensor) -> None:
        """``loss.backward()`` with the hooks armed."""
        self._armed = True
        try:
            loss.backward()
        finally:
            self._armed = False

    def synchronize(self) -> None:
        """Launch the buckets no hook launched (all of them without
        overlap; those holding a parameter that got no gradient), wait
        for every bucket and write the reduced gradients into
        ``.grad`` (a parameter without one keeps ``None``)."""
        for b in range(self._next, self.schedule.num_buckets):
            self._launch(b, from_hook=False)
        for (handle, ctx, had_grad), (_, idxs) in zip(
                self._handles, self.schedule.buckets):
            flat = self._compression.decompress(handle.wait(), ctx)
            if self._predivide != 1.0:
                flat = flat * self._predivide
            off = 0
            for i, had in zip(idxs, had_grad):
                p = self.params[i]
                g = flat[off:off + p.numel()].view(p.shape)
                off += p.numel()
                if had:
                    p.grad = g if g.dtype == p.dtype else g.to(p.dtype)
        self.last_launches = self._launches
        self.last_record = {"world": self._n, "buckets": self._record}
        tl = basics._state.timeline
        if tl is not None and basics._state.mark_cycles:
            tl.instant("CYCLE")  # one gradient flush
        self._reset()

    def close(self) -> None:
        """Remove the hooks."""
        for h in self._hook_handles:
            h.remove()
        self._hook_handles = []


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
    reduced across ranks, each bucket launched from the backward's hooks
    (reference: horovod/torch/optimizer.py DistributedOptimizer).

    ``op``: Average, Sum or Adasum (Min / Max / Product reduce too).
    ``named_parameters`` names the parameters (accepted for the
    reference's signature: buckets depend only on the parameters' specs
    and order).  ``compression`` casts each gradient to a 16-bit wire
    type around the reduction.  ``gradient_predivide_factor`` f divides
    the gradients by f before the reduction and multiplies them by f
    after it.  ``process_set`` scopes the reduction.  With
    ``backward_passes_per_step=k`` the caller runs k backward passes
    (their gradients add up in ``.grad``), and the k-th launches the
    buckets, which reduce the mean.  ``synchronize()`` waits for the
    reduction without stepping (for clipping), and
    ``skip_synchronize()`` makes the next ``step()`` use the gradients
    as they stand.  The bucket size is ``HVD_TPU_OVERLAP_BUCKET_BYTES``
    (4 MiB); ``close()`` removes the hooks.  ``hierarchical`` (default:
    the ``HOROVOD_HIERARCHICAL_ALLREDUCE`` flag) selects the two-level
    reduction for a world that spans slices, and ``dcn_compression``
    then casts only its cross-tier shard (where ``compression`` casts
    the whole gradient around the whole reduction)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[
                     Iterable[Tuple[str, torch.nn.Parameter]]] = None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op: ReduceOp = Average,
                 gradient_predivide_factor: float = 1.0,
                 process_set=None,
                 hierarchical: Optional[bool] = None,
                 dcn_compression=None):
        super().__init__(optimizer)
        if named_parameters is not None:
            named = list(named_parameters)
            if any(not isinstance(n, str) for n, _ in named):
                raise ValueError("named_parameters must be (name, "
                                 "parameter) pairs")
        params = [p for g in optimizer.param_groups for p in g["params"]]
        self.backward_passes_per_step = backward_passes_per_step
        self._reducer = _BucketReducer(
            params, op=op, process_set=process_set, compression=compression,
            backward_passes_per_step=backward_passes_per_step,
            gradient_predivide_factor=gradient_predivide_factor,
            hierarchical=hierarchical, dcn_compression=dcn_compression)
        self._synchronized = False
        self._should_synchronize = True

    def synchronize(self) -> None:
        """Wait for every bucket's reduction and install the reduced
        gradients (reference: _DistributedOptimizer.synchronize)."""
        self._reducer.synchronize()
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

    def zero_grad(self, set_to_none: bool = True) -> None:
        if self._reducer.pending:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize()")
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def close(self) -> None:
        """Remove the gradient hooks; the wrapped optimizer goes on as a
        plain local one."""
        self._reducer.close()


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
            for g in self.optimizer.param_groups:
                for p in g["params"]:
                    if p.grad is None:
                        continue
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


# -- ZeRO stage 1 -------------------------------------------------------------
#
# The partition is flat: the parameters are raveled into one 1-D buffer
# per dtype (a ZeroPlan, a pure function of the parameters' specs, so
# every rank partitions identically), zero-padded so each buffer divides
# by the world size.  The wrapped optimizer steps 1-D slices, which is
# exact for every elementwise optimizer (SGD, momentum, Adam(W), RMSprop):
# per element the arithmetic is the replicated form's, so sharded and
# replicated updates are bit-equal given bit-equal reduced gradients.
# Optimizers that couple elements across tensors (global-norm clipping,
# factored second moments) would compute per-shard statistics; apply
# those before the wrapper.


class ZeroPlan:
    """Deterministic flat partition of a list of tensors for ZeRO
    sharding (port of ``horovod_tpu/optim.py::ZeroPlan``): the leaves
    group into one 1-D buffer per dtype, sorted by dtype name, each
    zero-padded to a multiple of ``world`` so every rank's shard has the
    same size."""

    def __init__(self, leaves: Sequence[Any], world: int):
        self.world = int(world)
        self.specs = [(tuple(x.shape), x.dtype) for x in leaves]
        self.sizes = [int(torch.Size(s).numel()) for s, _ in self.specs]
        by_dtype: Dict[str, List[int]] = {}
        for i, (_, dt) in enumerate(self.specs):
            by_dtype.setdefault(dtype_name(dt), []).append(i)
        #: [(dtype name, leaf indices)] in sorted dtype-name order
        self.buckets: List[Tuple[str, List[int]]] = sorted(by_dtype.items())
        self.bucket_sizes = [sum(self.sizes[i] for i in idxs)
                             for _, idxs in self.buckets]
        self.shard_sizes = [-(-n // self.world) if n else 0
                            for n in self.bucket_sizes]
        self.padded_sizes = [s * self.world for s in self.shard_sizes]

    def _itemsize(self, b: int) -> int:
        return getattr(torch, self.buckets[b][0]).itemsize

    @property
    def total_bytes(self) -> int:
        return sum(n * self._itemsize(b)
                   for b, n in enumerate(self.bucket_sizes))

    @property
    def padded_bytes(self) -> int:
        return sum(n * self._itemsize(b)
                   for b, n in enumerate(self.padded_sizes))

    @property
    def shard_bytes(self) -> int:
        return sum(n * self._itemsize(b)
                   for b, n in enumerate(self.shard_sizes))

    def flatten(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Ravel + concatenate + zero-pad each dtype bucket."""
        out = []
        for (_, idxs), padded in zip(self.buckets, self.padded_sizes):
            parts = [leaves[i].reshape(-1) for i in idxs]
            pad = padded - sum(p.numel() for p in parts)
            if pad:
                parts.append(parts[0].new_zeros(pad))
            out.append(torch.cat(parts))
        return out

    def unflatten(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Inverse of :meth:`flatten` (padding dropped): views of the
        buffers in the leaves' shapes."""
        leaves: List[Any] = [None] * len(self.specs)
        for (_, idxs), buf in zip(self.buckets, bufs):
            off = 0
            for i in idxs:
                leaves[i] = buf[off:off + self.sizes[i]].view(
                    self.specs[i][0])
                off += self.sizes[i]
        return leaves

    def shards(self, leaves: Sequence[Optional[torch.Tensor]], me: int,
               out: Optional[Sequence[torch.Tensor]] = None
               ) -> List[torch.Tensor]:
        """Rank ``me``'s slice of each flattened bucket, copied from the
        leaves that overlap it (a ``None`` leaf and the padding read as
        zeros) into ``out`` (new buffers when not given)."""
        res = []
        for b, ((_, idxs), s) in enumerate(zip(self.buckets,
                                               self.shard_sizes)):
            lo, hi = me * s, (me + 1) * s
            if out is None:
                dev = next(x.device for x in leaves if x is not None)
                dst = torch.zeros(s, dtype=getattr(torch, self.buckets[b][0]),
                                  device=dev)
            else:
                dst = out[b]
            off = 0
            for i in idxs:
                a, z = max(lo, off), min(hi, off + self.sizes[i])
                if a < z:
                    src = leaves[i]
                    if src is None:
                        dst[a - lo:z - lo].zero_()
                    else:
                        dst[a - lo:z - lo].copy_(
                            src.reshape(-1)[a - off:z - off])
                off += self.sizes[i]
            if off < hi:  # the padding
                dst[max(off, lo) - lo:].zero_()
            res.append(dst)
        return res


def state_bytes(tree: Any) -> int:
    """Total tensor bytes of a tensor / list / tuple / dict tree (an
    optimizer's ``state``, parameters, ...): the per-rank accounting of
    the ZeRO partition."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(state_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(state_bytes(v) for v in tree)
    return 0


def _zero_min_bytes(explicit: Optional[int]) -> int:
    """Sharding threshold: below this many total parameter bytes the
    wrapper keeps replicated state and one allreduce
    (``HVD_TPU_ZERO_MIN_BYTES``, default 0)."""
    if explicit is not None:
        return int(explicit)
    return env_int("HVD_TPU_ZERO_MIN_BYTES", 0)


class ZeroDistributedOptimizer(_Wrapper):
    """ZeRO stage 1: each rank keeps the optimizer state of its 1/world
    shard of the parameters (port of ``horovod_tpu/optim.py::
    ZeroDistributedOptimizer``).

    ``optimizer`` is a fresh torch optimizer over the model's
    parameters; the wrapper rebuilds it, with each param group's
    settings, over this rank's flat shards (one 1-D tensor per param
    group and dtype, :class:`ZeroPlan`).  ``step()`` reduce-scatters the
    flattened gradients (``zero.grads``), steps the shard optimizer, and
    all-gathers the updated shards back into the parameters
    (``zero.updates``); the parameters stay replicated.  Each collective
    goes through the instrumented submission, under the reference's
    name: its counter, bytes, ``COMM`` span and timeline event.

    ``op``: Average or Sum.  ``backward_passes_per_step=k``: the caller
    runs k backward passes before each ``step()``, which reduces their
    mean.  ``min_total_bytes`` (default ``HVD_TPU_ZERO_MIN_BYTES``, 0):
    below this many parameter bytes in all, the state stays replicated
    and the padded gradient buffers take one allreduce (``zero.grads``;
    none at world 1).  Unlike the JAX package's, the
    flat path runs at world 1 as well (its state is then the whole
    model's), so one card drives it.

    ``hierarchical`` (default: the ``HOROVOD_HIERARCHICAL_ALLREDUCE``
    flag) selects the two-level exchange when the world process set
    spans more than one slice of more than one rank
    (:mod:`.common.topology`): the plan shards over the ``n_local``
    ranks of a slice, this rank's shard is its position in the slice;
    the gradients reduce-scatter over the local group
    (``zero.grads.local``), only the 1/n_local shard crosses to the
    other slices (``zero.grads.cross``: a sum over the cross group),
    and the updated shards all-gather back over the local group
    (``zero.updates.local``); each hop books its share of the modeled
    bytes (:meth:`_tier_bytes`) into
    ``hvd_tpu_collective_{ici,dcn}_bytes_total``.  The optimizer state is then sharded
    1/n_local within a slice and replicated across slices (the ZeRO++
    secondary partition).  ``dcn_compression`` casts the cross hop's
    shard to its wire dtype: every rank gathers the slices' wire shards
    and sums them in the gradients' dtype, slices in order (the JAX
    package's eager exchange all-reduces in the wire dtype; its SPMD
    one, and this one, accumulate at full precision).  With
    ``error_feedback`` the quantization residual of each shard lives in
    the optimizer's state (``state[shard]["dcn_residual"]``), so
    ``state_dict()`` / ``load_state_dict()``, checkpoints and
    ``elastic.TpuState`` carry it.  ``tiers`` is the layout in use
    (None: the flat exchange)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 op: ReduceOp = Average, process_set=None,
                 backward_passes_per_step: int = 1,
                 min_total_bytes: Optional[int] = None,
                 hierarchical: Optional[bool] = None,
                 dcn_compression=None):
        op = ReduceOp(op)
        if op not in (ReduceOp.AVERAGE, ReduceOp.SUM):
            raise ValueError(f"ZeroDistributedOptimizer supports Sum/Average,"
                             f" got {op!r}")
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        super().__init__(optimizer)
        self.op = op
        self.process_set = process_set
        self.backward_passes_per_step = backward_passes_per_step
        _, self._world, self._me = collective_ops._scope(process_set)
        tiers = (collective_ops._route(op, process_set, hierarchical)
                 if self._world > 1 else None)
        self.tiers = tiers if tiers is not None and tiers.n_ici > 1 else None
        self.dcn_compression = dcn_compression
        self._hierarchical = hierarchical
        n_plan, self._shard_index = ((self.tiers.n_ici, self.tiers.position)
                                     if self.tiers else
                                     (self._world, self._me))
        self._groups = [_unique(g["params"]) for g in optimizer.param_groups]
        self.plans = [ZeroPlan(ps, n_plan) for ps in self._groups]
        self.sharded = sum(p.total_bytes for p in self.plans) >= \
            _zero_min_bytes(min_total_bytes)
        self._flat_params = [p for ps in self._groups for p in ps]
        if not self.sharded:
            return
        self._shards = [
            [torch.nn.Parameter(s) for s in plan.shards(ps,
                                                        self._shard_index)]
            for plan, ps in zip(self.plans, self._groups)]
        groups = []
        for g, shards in zip(optimizer.param_groups, self._shards):
            opts = {k: v for k, v in g.items() if k != "params"}
            groups.append(dict(opts, params=shards))
        # every group carries all its settings; the constructor takes
        # the ones it names (AdamW's defaults hold one it does not)
        cls = type(optimizer)
        named = inspect.signature(cls.__init__).parameters
        self.optimizer = cls(groups, **{k: v for k, v in
                                        optimizer.defaults.items()
                                        if k in named})

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self._flat_params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.detach_().zero_()

    def _grads(self, ps: List[torch.Tensor]) -> List[torch.Tensor]:
        k = self.backward_passes_per_step
        return [torch.zeros_like(p) if p.grad is None else
                (p.grad / k if k > 1 else p.grad) for p in ps]

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._step(reduce=True)
        return loss

    def _two_level_grads(self, plan: ZeroPlan, ps: List[torch.Tensor],
                         shards: List[torch.nn.Parameter]
                         ) -> Tuple[List[torch.Tensor], List[Any]]:
        """The hierarchical exchange's first two collectives: this rank's
        gradient shards, reduced over the world, and their new
        error-feedback residuals (None without feedback)."""
        t, comp = self.tiers, self.dcn_compression
        bufs = plan.flatten(self._grads(ps))
        tier_bytes = [self._tier_bytes(buf) for buf in bufs]

        def local():
            works, results = [], []
            for buf, (ici, _) in zip(bufs, tier_bytes):
                collective_ops._account_tier_bytes(ici // 2, 0)
                w, res = collective_ops._reduce_scatter_start(
                    buf, t.local_group, t.n_ici, t.position)
                works += w
                results.append(res)
            return collective_ops.Handle(
                works, lambda: [res() for res in results])

        pieces = collective_ops._submit("zero.grads.local", "reducescatter",
                                        bufs, local).wait()
        residuals = [self.optimizer.state.get(sh, {}).get("dcn_residual")
                     for sh in shards]
        crossed = [None] * len(pieces)

        def cross():
            for k, (piece, res) in enumerate(zip(pieces, residuals)):
                collective_ops._account_tier_bytes(0, tier_bytes[k][1])
                crossed[k] = hierarchical._cross_sum(piece, t, comp, res)
            return collective_ops._ready([g for g, _ in crossed])

        sums = collective_ops._submit("zero.grads.cross", "allreduce",
                                      pieces, cross).wait()
        g_shards = [collective_ops._divide(g, self._world)
                    if self.op == ReduceOp.AVERAGE else g for g in sums]
        feedback = comp is not None and comp.error_feedback
        return g_shards, [r if feedback else None for _, r in crossed]

    def _tier_bytes(self, buf: torch.Tensor) -> Tuple[int, int]:
        """The modeled (local, cross) bytes of the two-level exchange of
        one padded bucket: those of a two-level allreduce of it
        (``comm_model.modeled_collective_bytes``), half the local ones
        in the reduce-scatter and half in the all-gather."""
        comp = self.dcn_compression
        m = modeled_collective_bytes(
            (buf.numel(),), self.tiers.size, self.tiers.n_ici,
            wire_dtype=None if comp is None else comp.wire_dtype,
            dtype=buf.dtype)
        return m["ici_bytes"], m["dcn_bytes"]

    def _allreduce(self, bufs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The unsharded exchange: the padded gradient buffers reduced
        with ``op`` (``zero.grads``, the replicated fallback's one
        allreduce)."""
        comp = self.dcn_compression
        if comp is not None and comp.error_feedback:
            comp = None  # the residual lives in the sharded state only
        return collective_ops._submit(
            "zero.grads", "allreduce", bufs,
            lambda: collective_ops._allreduce_async(
                bufs, self.op, 1.0, 1.0, self.process_set, ordered=True,
                hierarchical=self._hierarchical,
                dcn_compression=comp)).wait()

    def _gather(self, shards: List[torch.nn.Parameter]) -> List[torch.Tensor]:
        """The updated shards, all-gathered into full flat buffers
        (``zero.updates``; over the local group on the two-level
        exchange, ``zero.updates.local``)."""
        if self.tiers is None:
            group, n, _ = collective_ops._scope(self.process_set)
        else:
            group, n = self.tiers.local_group, self.tiers.n_ici
        full = [s.new_empty(s.numel() * n) for s in shards]

        def gather():
            for buf, s in zip(full, shards):
                if self.tiers is not None:
                    collective_ops._account_tier_bytes(
                        self._tier_bytes(buf)[0] // 2, 0)
                else:
                    collective_ops._account_flat(
                        buf.numel() * buf.element_size(), n, 1.0)
                collective_ops._all_gather_flat(buf, s.detach(), group=group)
            return collective_ops._ready(full)

        name = "zero.updates" if self.tiers is None else "zero.updates.local"
        return collective_ops._submit(name, "allgather",
                                      [s.detach() for s in shards],
                                      gather).wait()

    def _step(self, reduce: bool, updates: Optional[list] = None) -> None:
        """Reduce (or, with ``reduce=False``, take the already reduced
        ``.grad``), step the shards, gather them into the parameters.
        A list ``updates`` receives each parameter's update (new minus
        old value, after the allgather) in parameter order: the
        integrity guard's agreement object."""
        if not self.sharded:
            if reduce:
                for plan, ps in zip(self.plans, self._groups):
                    grads = self._grads(ps)
                    if self._world > 1:  # at world 1 the mean is the value
                        grads = plan.unflatten(
                            self._allreduce(plan.flatten(grads)))
                    for p, g in zip(ps, grads):
                        p.grad = g
            old = (None if updates is None else
                   [p.detach().clone() for p in self._flat_params])
            self.optimizer.step()
            if updates is not None:
                updates.extend(p.detach() - o
                               for p, o in zip(self._flat_params, old))
            return
        me = self._shard_index
        residuals = {}
        for plan, ps, shards in zip(self.plans, self._groups, self._shards):
            if reduce:
                _metrics.OPTIM_RS_BYTES.inc(plan.padded_bytes)
                if self.tiers is not None:
                    g_shards, res = self._two_level_grads(plan, ps, shards)
                    residuals.update((sh, r) for sh, r in zip(shards, res)
                                     if r is not None)
                else:
                    g_shards = collective_ops.grouped_reducescatter(
                        plan.flatten(self._grads(ps)), op=self.op,
                        name="zero.grads", process_set=self.process_set)
            else:
                g_shards = plan.shards([p.grad for p in ps], me)
            with torch.no_grad():
                # the parameters may have been set since the last step
                plan.shards([p.detach() for p in ps], me,
                            out=[s.data for s in shards])
            for s, g in zip(shards, g_shards):
                s.grad = g
        self.optimizer.step()
        for sh, r in residuals.items():  # after the inner step's own init
            self.optimizer.state[sh]["dcn_residual"] = r
        with torch.no_grad():
            for plan, ps, shards in zip(self.plans, self._groups,
                                        self._shards):
                _metrics.OPTIM_AG_BYTES.inc(plan.shard_bytes)
                full = self._gather(shards)
                for s in shards:
                    s.grad = None
                for p, v in zip(ps, plan.unflatten(full)):
                    if updates is not None:
                        updates.append(v - p)
                    p.copy_(v)
        _metrics.OPTIM_STATE_SHARD_BYTES.set(state_bytes(
            [{k: v for k, v in st.items() if k != "dcn_residual"}
             for st in self.optimizer.state.values()]))
