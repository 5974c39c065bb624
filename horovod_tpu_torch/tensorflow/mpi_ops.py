"""TensorFlow tensor collectives over the port's collectives.

Port of ``horovod_tpu/tensorflow/mpi_ops.py`` (reference parity:
horovod/tensorflow/mpi_ops.py + the C++ custom ops it fronts,
tensorflow/mpi_ops.cc).  A ``tf.Tensor`` becomes a numpy array, then a
torch tensor on this rank's device (``basics.device()``), goes through
the port's collective (:mod:`..ops.collective_ops`, over
``torch.distributed``), and comes back through numpy as a ``tf.Tensor``
of the input's dtype.  bfloat16 crosses as its 16 bits.

Graph mode (``tf.function``): the collective runs inside
``tf.py_function``, so traced programs (e.g. Keras ``model.fit``'s
compiled ``train_step``) execute it at run time.  Output shapes are
re-asserted where statically known (allreduce and broadcast preserve
the shape).

``tf.function(jit_compile=True)``: py_function has no XLA lowering, so
shape-preserving collectives switch to the XLA custom-call bridge
(:mod:`.xla_ops`; reference: tensorflow/xla_mpi_ops.cc) when tracing
for a must-compile function (auto-detected; HOROVOD_ENABLE_XLA_OPS=1
forces it for all graph mode, =0 disables).  A bridge that cannot be
built or loaded raises there, with the build's error.  Shape-dynamic
collectives (allgather, alltoall, reducescatter) cannot be
XLA-compiled — the reference's XLA op set is allreduce-only — and
raise with a hint.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import tensorflow as tf
import torch

from ..common import basics
from ..common.process_sets import ProcessSet
from ..ops import collective_ops as _ops
from ..ops.reduce_ops import ReduceOp, Sum

#: numpy's bfloat16 (ml_dtypes), as TensorFlow hands it out
_BF16 = np.dtype(tf.bfloat16.as_numpy_dtype)


def _to_torch(a) -> torch.Tensor:
    """A numpy array (or anything numpy takes) as a torch tensor of its
    own on this rank's device."""
    a = np.asarray(a)
    if a.dtype == _BF16:
        t = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(basics.device())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A torch tensor's values as a host numpy array."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16)
    return t.numpy()


def _on_arrays(fn):
    """``fn`` over torch tensors, called on numpy arrays: each array
    crosses to the device and each result back (a list for a list)."""
    def call(a):
        if isinstance(a, (list, tuple)):
            return [_to_numpy(o) for o in fn([_to_torch(x) for x in a])]
        return _to_numpy(fn(_to_torch(a)))
    return call


def _is_symbolic(t) -> bool:
    return isinstance(t, tf.Tensor) and not hasattr(t, "numpy")


def _xla_path() -> bool:
    """True when collectives should lower through the XLA custom-call
    bridge: tracing for jit_compile=True (or forced via env).  Then the
    bridge must load: one that cannot be built raises here, with its
    build error, rather than a py_function that XLA would refuse later.
    Trace-time only — never on the eager fast path."""
    if os.environ.get("HOROVOD_ENABLE_XLA_OPS", "").lower() in ("0", "false"):
        return False
    from . import xla_ops

    if not xla_ops.in_jit_trace():
        return False
    xla_ops.require()
    return True


def _reject_in_jit(op_name: str) -> None:
    from . import xla_ops

    # consider_env=False: the HOROVOD_ENABLE_XLA_OPS force flag must not
    # reject shape-dynamic ops in PLAIN graphs, where py_function works
    if xla_ops.in_jit_trace(consider_env=False):
        raise NotImplementedError(
            f"hvd.{op_name} has a data-dependent output shape and cannot "
            "run inside tf.function(jit_compile=True) (XLA needs static "
            "shapes; the reference's XLA op set is likewise "
            "allreduce-only).  Call it outside the jit-compiled function, "
            "or use the torch API (horovod_tpu_torch), whose collectives "
            "take uneven shapes."
        )


def _check_xla_error() -> None:
    """Surface a collective's error captured inside a compiled program
    (the XLA bridge cannot raise through XLA) from the next eager/graph
    entry.  sys.modules guard: never pays the bridge import on sessions
    that never used jit_compile."""
    m = sys.modules.get(__package__ + ".xla_ops")
    if m is not None:
        m.maybe_reraise()


def _run(engine_fn, tensor, out_dtype=None, preserve_shape=True):
    """Execute ``engine_fn(torch tensor) -> torch tensor`` on a TF
    tensor, in eager or graph mode."""
    _check_xla_error()
    tensor = tf.convert_to_tensor(tensor)
    out_dtype = out_dtype or tensor.dtype
    call = _on_arrays(engine_fn)
    if not _is_symbolic(tensor):
        return tf.convert_to_tensor(call(tensor.numpy()), dtype=out_dtype)
    out = tf.py_function(lambda a: call(a.numpy()), [tensor], Tout=out_dtype)
    if preserve_shape:
        out.set_shape(tensor.shape)
    else:
        out.set_shape([None] + list(tensor.shape)[1:])
    return out


# -- allreduce ---------------------------------------------------------------


def allreduce(tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None):
    """Reference: horovod/tensorflow/mpi_ops.py allreduce (op defaults to
    Average, as upstream's ``hvd.allreduce``)."""
    tensor = tf.convert_to_tensor(tensor)  # once; _run's convert is a no-op
    if _is_symbolic(tensor) and _xla_path():
        from . import xla_ops

        return xla_ops.xla_allreduce(
            tensor, average=average, name=name, op=op,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, process_set=process_set)
    return _run(
        lambda t: _ops.allreduce(
            t, average=average, name=name, op=op,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, process_set=process_set,
        ),
        tensor,
    )


def grouped_allreduce(tensors, average: Optional[bool] = None,
                      name: Optional[str] = None,
                      op: Optional[ReduceOp] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set: Optional[ProcessSet] = None):
    """Reference: horovod/tensorflow/mpi_ops.py grouped_allreduce — the
    group reduces as one fused submission."""
    _check_xla_error()
    tensors = [tf.convert_to_tensor(t) for t in tensors]
    call = _on_arrays(lambda ts: _ops.grouped_allreduce(
        ts, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set))
    if not any(_is_symbolic(t) for t in tensors):
        outs = call([t.numpy() for t in tensors])
        return [tf.convert_to_tensor(o, dtype=t.dtype)
                for o, t in zip(outs, tensors)]
    if _xla_path():
        from . import xla_ops

        return xla_ops.xla_grouped_allreduce(
            tensors, average=average, name=name, op=op,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, process_set=process_set)
    outs = tf.py_function(lambda *arrays: call([a.numpy() for a in arrays]),
                          tensors, Tout=[t.dtype for t in tensors])
    for o, t in zip(outs, tensors):
        o.set_shape(t.shape)
    return list(outs)


def _run_grouped(engine_fn, tensors, op_name: str):
    """Shared scaffold for grouped shape-dynamic collectives: eager →
    the collective directly; plain graph → py_function; jit_compile →
    clean rejection (dim0 may differ per rank, so output dim0 is
    unknown)."""
    _check_xla_error()
    tensors = [tf.convert_to_tensor(t) for t in tensors]
    call = _on_arrays(engine_fn)
    if any(_is_symbolic(t) for t in tensors):
        _reject_in_jit(op_name)
        outs = tf.py_function(
            lambda *arrays: call([a.numpy() for a in arrays]), tensors,
            Tout=[t.dtype for t in tensors])
        for o, t in zip(outs, tensors):
            if t.shape.rank is not None:  # unknown rank stays unknown
                o.set_shape([None] + list(t.shape)[1:])
        return list(outs)
    outs = call([t.numpy() for t in tensors])
    return [tf.convert_to_tensor(o, dtype=t.dtype)
            for o, t in zip(outs, tensors)]


def grouped_allgather(tensors, name: Optional[str] = None,
                      process_set: Optional[ProcessSet] = None):
    """Reference: tf grouped_allgather — one dim0 exchange and one
    gather per dtype (``collective_ops.grouped_allgather``)."""
    return _run_grouped(
        lambda ts: _ops.grouped_allgather(ts, name=name,
                                          process_set=process_set),
        tensors, "grouped_allgather",
    )


def grouped_reducescatter(tensors, op: Optional[ReduceOp] = None,
                          name: Optional[str] = None,
                          process_set: Optional[ProcessSet] = None):
    """Reference: tf grouped_reducescatter — one grouped submission."""
    return _run_grouped(
        lambda ts: _ops.grouped_reducescatter(
            ts, op=op if op is not None else Sum, name=name,
            process_set=process_set),
        tensors, "grouped_reducescatter",
    )


# -- allgather / broadcast ---------------------------------------------------


def allgather(tensor, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None):
    """Concatenate each rank's tensor along axis 0; first dims may differ
    per rank (reference: HorovodAllgather's uneven recvcounts)."""
    tensor = tf.convert_to_tensor(tensor)
    if _is_symbolic(tensor):
        _reject_in_jit("allgather")
    return _run(
        lambda t: _ops.allgather(t, name=name, process_set=process_set),
        tensor, preserve_shape=False,
    )


def broadcast(tensor, root_rank: int, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None):
    tensor = tf.convert_to_tensor(tensor)
    if _is_symbolic(tensor) and _xla_path():
        from . import xla_ops

        return xla_ops.xla_broadcast(tensor, root_rank, name=name,
                                     process_set=process_set)
    return _run(
        lambda t: _ops.broadcast(t, root_rank, name=name,
                                 process_set=process_set),
        tensor,
    )


# -- alltoall / reducescatter ------------------------------------------------


def alltoall(tensor, splits=None, name: Optional[str] = None,
             process_set: Optional[ProcessSet] = None):
    """Returns (received, received_splits) like the reference's
    HorovodAlltoall."""
    _check_xla_error()
    tensor = tf.convert_to_tensor(tensor)
    have_splits = splits is not None
    if have_splits:
        splits = tf.convert_to_tensor(splits)

    def run(a, s=None):
        received, recv_splits = _ops.alltoall(
            _to_torch(a.numpy()),
            splits=None if s is None else [int(v) for v in s.numpy()],
            name=name, process_set=process_set,
        )
        return _to_numpy(received), _to_numpy(recv_splits).astype(np.int32)

    symbolic = _is_symbolic(tensor) or (have_splits and _is_symbolic(splits))
    if symbolic:
        _reject_in_jit("alltoall")
    if not symbolic:
        received, recv_splits = run(tensor, splits if have_splits else None)
        return (tf.convert_to_tensor(received, dtype=tensor.dtype),
                tf.convert_to_tensor(recv_splits, tf.int32))

    inputs = [tensor, splits] if have_splits else [tensor]
    received, recv_splits = tf.py_function(
        run, inputs, Tout=[tensor.dtype, tf.int32]
    )
    received.set_shape([None] + list(tensor.shape)[1:])
    recv_splits.set_shape([None])
    return received, recv_splits


def reducescatter(tensor, op: Optional[ReduceOp] = None,
                  name: Optional[str] = None,
                  process_set: Optional[ProcessSet] = None):
    tensor = tf.convert_to_tensor(tensor)
    if _is_symbolic(tensor):
        _reject_in_jit("reducescatter")
    return _run(
        lambda t: _ops.reducescatter(t, op=op, name=name,
                                     process_set=process_set),
        tensor, preserve_shape=False,
    )


# -- control -----------------------------------------------------------------


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    _check_xla_error()
    _ops.barrier(process_set=process_set)


def join() -> int:
    """Reference: HorovodJoin — returns the last joining rank.  The
    port's ``join`` returns the rank at world 1 and raises across
    processes until its native controller is ported."""
    return _ops.join()
