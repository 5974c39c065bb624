"""Activation remat for the port's models: ``torch.utils.checkpoint`` per
block, under the JAX package's named policies.

The JAX package wraps a block in ``nn.remat(policy=...)``; here the
block's call goes through ``checkpoint(use_reentrant=False)``:

* ``full`` — plain checkpointing: the block keeps its inputs and
  recomputes everything in the backward (``jax.checkpoint``'s default,
  save nothing);
* ``dots`` / ``dots_no_batch`` — selective checkpointing
  (``create_selective_checkpoint_contexts``) that classifies products
  the way JAX's ``checkpoint_dots`` / ``checkpoint_dots_with_no_batch_dims``
  do, by their batch dimensions and not by their names: a product with
  no batch dimension (``aten.mm``, ``aten.addmm``; a ``bmm`` over a
  batch of one, as einsum lowers a plain contraction) is saved under
  both; a batched one (``bmm`` / ``baddbmm`` over more than one matrix:
  the dense attention's two einsums) only under ``dots``; every other
  op is recomputed.

A hand-written kernel launched inside an ``autograd.Function`` (the
flash forward) is neither kind of product, as a ``pallas_call`` is
neither in JAX: it runs again in the recompute, through the same
wrapper and variant rule, and the tensors its ``ctx.save_for_backward``
keeps are the checkpoint's (unpacked from the recompute), not held
across the forward.

``recompute_only`` gives ``checkpoint`` a second context that is
entered only while the backward recomputes: the ResNet uses it to stop
a recomputed BatchNorm from moving its running statistics again.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

_aten = torch.ops.aten
# (op, index of the first operand): the products a policy may save
_PRODUCTS = {
    _aten.mm.default: None,
    _aten.addmm.default: None,
    _aten.bmm.default: 0,
    _aten.baddbmm.default: 1,
}


def _product_batch(op, args) -> Optional[int]:
    """The batch size of a product op (1 for an unbatched one), or None
    when ``op`` is not a product."""
    if op not in _PRODUCTS:
        return None
    i = _PRODUCTS[op]
    return 1 if i is None else int(args[i].shape[0])


def _save_products(save_batched: bool, ctx, op, *args, **kwargs):
    batch = _product_batch(op, args)
    if batch is not None and (batch == 1 or save_batched):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


#: the selective policy of each named policy that saves products
_SELECTIVE = {
    "dots": functools.partial(_save_products, True),
    "dots_no_batch": functools.partial(_save_products, False),
}


def remat_call(fn: Callable, policy: str, *args,
               context_fn: Optional[Callable] = None):
    """``fn(*args)`` under the named remat policy (``"none"`` calls it
    plainly).  ``context_fn`` (full policy only) is ``checkpoint``'s
    ``(forward context, recompute context)`` factory.  No RNG state is
    stashed: the blocks draw no random numbers."""
    if policy == "none":
        return fn(*args)
    if policy in _SELECTIVE:
        if context_fn is not None:
            raise ValueError("a selective policy brings its own context_fn")
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _SELECTIVE[policy])
    elif policy != "full":
        raise ValueError(f"unknown remat policy {policy!r}")
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def recompute_only(enter: Callable[[], contextlib.AbstractContextManager]):
    """A ``context_fn`` whose recompute context is ``enter()`` and whose
    forward context does nothing."""
    return lambda: (contextlib.nullcontext(), enter())
