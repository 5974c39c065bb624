"""DistributedGradientTape / DistributedOptimizer for TensorFlow + Keras 3.

Port of ``horovod_tpu/tensorflow/optimizer.py`` (reference parity:
horovod/tensorflow/__init__.py DistributedGradientTape,
_make_allreduce_grads_fn, and horovod/_keras/__init__.py
create_distributed_optimizer).  The TF2 training idioms both reference
paths serve:

  tape = hvd.DistributedGradientTape(tape)          # custom loops
  opt  = hvd.DistributedOptimizer(keras_optimizer)  # model.fit / Keras 3

Keras 3 funnels every backend's update through ``Optimizer.apply``, so
the dynamic subclass here overrides that single point — the same
subclass-the-instance trick the reference uses (upstream
create_distributed_optimizer builds ``cls = type(opt.__class__.__name__,
(opt.__class__,), ...)``).  Gradients reach the package's collectives by
backend: TF tensors through :mod:`.mpi_ops` (eager, tf.function, or the
XLA bridge under jit_compile), torch tensors (KERAS_BACKEND=torch)
straight, anything numpy-convertible as numpy.  The JAX backend's update
runs under ``jax.jit``, which the JAX package reaches through
``jax.pure_callback``; this package imports no jax, so a JAX-backend
gradient raises ``TypeError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..common import basics
from ..common.process_sets import ProcessSet
from ..ops import collective_ops as _ops
from ..ops.reduce_ops import Average, ReduceOp, Sum
from .compression import Compression
from .mpi_ops import _to_numpy, _to_torch

_NO_JAX = ("a JAX-backend gradient: the JAX package reaches its "
           "collectives from inside jax.jit through jax.pure_callback; "
           "horovod_tpu_torch imports no jax — use the tensorflow or "
           "torch Keras backend")


def _scale_factors(op: Optional[ReduceOp], gradient_predivide_factor: float,
                   process_set: Optional[ProcessSet]):
    """Map (op, predivide) onto (op, prescale, postscale) the way the
    reference's _make_allreduce_grads_fn does: dividing by the factor
    before the sum and by size/factor after is numerically safer than one
    post-division for fp16 gradients.  The size is the set's (one
    contribution a process: one process a GPU)."""
    if gradient_predivide_factor == 1.0:
        return op or Average, 1.0, 1.0
    n = basics._require_init().process_set_registry.resolve(
        process_set).size()
    return Sum, 1.0 / gradient_predivide_factor, \
        gradient_predivide_factor / n


def _allreduce_torch_grads(grads, compression, op, prescale, postscale,
                           process_set, name_prefix):
    """Allreduce torch gradients (None entries pass through), each on
    this rank's device and back on its own; fp16 compression casts on
    the wire."""
    outs = []
    dev = basics.device()
    for i, g in enumerate(grads):
        if g is None:
            outs.append(None)
            continue
        t = g.detach().to(dev)
        ctx = None
        if compression is Compression.fp16 and t.dtype in (torch.float32,
                                                            torch.float64):
            ctx, t = t.dtype, t.to(torch.float16)
        out = _ops.allreduce(t, op=op, prescale_factor=prescale,
                             postscale_factor=postscale,
                             process_set=process_set,
                             name=f"{name_prefix}.{i}")
        outs.append((out if ctx is None else out.to(ctx)).to(g.device))
    return outs


def _allreduce_np_grads(grads, compression, op, prescale, postscale,
                        process_set, name_prefix):
    """Allreduce numpy gradients (None entries pass through)."""
    torch_grads = [None if g is None else _to_torch(np.asarray(g))
                   for g in grads]
    return [None if t is None else _to_numpy(t) for t in
            _allreduce_torch_grads(torch_grads, compression, op, prescale,
                                   postscale, process_set, name_prefix)]


class _DistributedGradientTape:
    """Wraps tf.GradientTape; ``gradient()`` returns allreduced grads
    (reference: horovod/tensorflow/__init__.py _DistributedGradientTape)."""

    def __init__(self, tape, compression, op, gradient_predivide_factor,
                 process_set, num_groups):
        self._tape = tape
        self._compression = compression
        self._op = op
        self._predivide = gradient_predivide_factor
        self._process_set = process_set
        self._num_groups = num_groups

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def __getattr__(self, name):
        return getattr(self._tape, name)

    def gradient(self, target, sources, output_gradients=None):
        from . import mpi_ops

        grads = self._tape.gradient(target, sources, output_gradients)
        op, prescale, postscale = _scale_factors(
            self._op, self._predivide, self._process_set
        )
        flat = list(grads) if isinstance(grads, (list, tuple)) else [grads]
        live = [(i, g) for i, g in enumerate(flat) if g is not None]
        if self._num_groups > 0 and len(live) > 1:
            # split into num_groups chunks, each one grouped op
            # (reference: num_groups arg of DistributedGradientTape)
            n = min(self._num_groups, len(live))
            out_live = []
            for c in range(n):
                chunk = live[c::n]
                tensors = [self._compression.compress(g) for _, g in chunk]
                reduced = mpi_ops.grouped_allreduce(
                    [t for t, _ in tensors], op=op, prescale_factor=prescale,
                    postscale_factor=postscale, process_set=self._process_set,
                    name=f"DistributedGradientTape.group{c}",
                )
                out_live.extend(
                    (i, self._compression.decompress(r, ctx))
                    for (i, _), r, (_, ctx) in zip(chunk, reduced, tensors)
                )
            for i, g in out_live:
                flat[i] = g
        else:
            for i, g in live:
                t, ctx = self._compression.compress(g)
                t = mpi_ops.allreduce(
                    t, op=op, prescale_factor=prescale,
                    postscale_factor=postscale, process_set=self._process_set,
                    name=f"DistributedGradientTape.{i}",
                )
                flat[i] = self._compression.decompress(t, ctx)
        if isinstance(grads, (list, tuple)):
            return type(grads)(flat)
        return flat[0]


def DistributedGradientTape(gradtape, device_dense: str = "",
                            device_sparse: str = "",
                            compression=Compression.none,
                            op: Optional[ReduceOp] = None,
                            gradient_predivide_factor: float = 1.0,
                            num_groups: int = 0,
                            process_set: Optional[ProcessSet] = None):
    """Reference: hvd.DistributedGradientTape.  ``device_dense``/
    ``device_sparse`` are accepted for signature parity; the collectives
    run on this rank's device.  Sparse gradients (tf.IndexedSlices, e.g.
    from embedding lookups) densify on the wire — the reference's
    ``sparse_as_dense=True`` behavior."""
    return _DistributedGradientTape(
        gradtape, compression, op, gradient_predivide_factor, process_set,
        num_groups,
    )


def DistributedOptimizer(optimizer, name: Optional[str] = None,
                         device_dense: str = "", device_sparse: str = "",
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: Optional[ReduceOp] = None,
                         gradient_predivide_factor: float = 1.0,
                         average_aggregated_gradients: bool = True,
                         process_set: Optional[ProcessSet] = None):
    """Wrap a Keras 3 optimizer so ``apply`` allreduces gradients first
    (reference: horovod/_keras/__init__.py create_distributed_optimizer).

    TF tensors bridge through ``tensorflow.mpi_ops`` (eager or
    tf.function); torch tensors go to the collectives as they are;
    anything numpy-convertible takes the numpy path; JAX-backend
    gradients raise ``TypeError``.  ``backward_passes_per_step > 1``
    aggregates locally for N applies and allreduces once (eager-mode
    python state; the reference's LocalGradientAggregationHelper
    semantics)."""
    # wrapping twice would make ``super(self.__class__, self)`` resolve
    # to the same frame in both dynamic subclasses — infinite recursion
    # instead of a clear error; the reference raises ValueError too
    if optimizer.__class__.__dict__.get("apply") is _distributed_apply:
        raise ValueError(
            "optimizer is already a horovod_tpu_torch DistributedOptimizer; "
            "wrapping it twice is not supported"
        )
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,), {
        "apply": _distributed_apply,
    })
    optimizer.__class__ = cls
    optimizer._hvd_compression = compression
    optimizer._hvd_op = op
    optimizer._hvd_predivide = gradient_predivide_factor
    optimizer._hvd_process_set = process_set
    optimizer._hvd_passes_per_step = int(backward_passes_per_step)
    optimizer._hvd_average_aggregated = average_aggregated_gradients
    optimizer._hvd_agg = None
    optimizer._hvd_agg_count = 0
    return optimizer


def _grad_kind(g):
    """``"tf"``, ``"torch"``, ``"jax"`` (jax and jaxlib arrays and
    tracers, told apart by module without importing jax) or ``"np"``."""
    mod = type(g).__module__
    if mod.startswith("tensorflow"):
        return "tf"
    if mod.startswith("torch"):
        return "torch"
    if mod.split(".")[0] in ("jax", "jaxlib"):
        return "jax"
    return "np"


def _distributed_apply(self, grads, trainable_variables=None):
    op, prescale, postscale = _scale_factors(
        self._hvd_op, self._hvd_predivide, self._hvd_process_set
    )
    # classify on the INCOMING grads: local aggregation converts TF
    # gradients to numpy below, and the TF bridge must not engage on the
    # flush pass
    kinds = {_grad_kind(g) for g in grads if g is not None}
    if "jax" in kinds:
        raise TypeError(f"DistributedOptimizer got {_NO_JAX}")
    n = self._hvd_passes_per_step
    if n > 1:
        if any(g is not None and _grad_kind(g) == "tf"
               and not hasattr(g, "numpy") for g in grads):
            raise RuntimeError(
                "backward_passes_per_step > 1 aggregates in eager python "
                "state; compile-free execution is required (e.g. "
                "model.compile(..., run_eagerly=True))"
            )
        if kinds == {"torch"}:
            # Keras torch backend: sum on each gradient's own device
            grads = [None if g is None else g.detach() for g in grads]
        else:
            grads = [
                None if g is None
                else (g.detach().cpu().numpy()
                      if _grad_kind(g) == "torch" else np.asarray(g))
                for g in grads
            ]
        if self._hvd_agg is None:
            self._hvd_agg = [None if g is None
                             else g.clone() if torch.is_tensor(g)
                             else g.copy() for g in grads]
        else:
            for a, g in zip(self._hvd_agg, grads):
                if a is not None and g is not None:
                    a += g
        self._hvd_agg_count += 1
        if self._hvd_agg_count < n:
            return  # aggregate only; no variable update this pass
        grads = self._hvd_agg
        if self._hvd_average_aggregated:
            grads = [None if g is None else g / n for g in grads]
        self._hvd_agg = None
        self._hvd_agg_count = 0
        if kinds == {"tf"}:
            # eager-only path (guard above); the aggregated numpy arrays
            # take the numpy path and return fine to TF
            kinds = {"np"}

    if kinds == {"tf"}:
        from . import mpi_ops

        reduced = []
        for i, g in enumerate(grads):
            if g is None:
                reduced.append(None)
                continue
            t, ctx = self._hvd_compression.compress(g)
            t = mpi_ops.allreduce(
                t, op=op, prescale_factor=prescale,
                postscale_factor=postscale,
                process_set=self._hvd_process_set,
                name=f"DistributedOptimizer.{i}",
            )
            reduced.append(self._hvd_compression.decompress(t, ctx))
    elif kinds == {"torch"}:
        # Keras torch backend: the gradients go to the collectives as
        # torch tensors (no numpy hop) and come back on their devices
        reduced = _allreduce_torch_grads(
            grads, self._hvd_compression, op, prescale, postscale,
            self._hvd_process_set, "DistributedOptimizer",
        )
    else:
        reduced = _allreduce_np_grads(
            grads, self._hvd_compression, op, prescale, postscale,
            self._hvd_process_set, "DistributedOptimizer",
        )
    return super(self.__class__, self).apply(reduced, trainable_variables)
