"""XLA-compilable TF collectives (reference: tensorflow/xla_mpi_ops.cc).

Port of ``horovod_tpu/tensorflow/xla_ops.py``.  The reference's XLA ops
let ``hvd.allreduce`` live inside ``tf.function(jit_compile=True)``; the
``tf.py_function`` route cannot (py_function has no XLA lowering):

- a tiny C++ custom-call target (``src/xla_bridge.cc``, this package's
  own copy) registered into the process-wide
  ``xla::CustomCallTargetRegistry`` that TF's compiled programs consult
  (shared via libtensorflow_cc.so.2), built at first use with g++
  against the pip TF headers into ``build/horovod_tpu_torch/`` (named by
  a hash of the source and the TF version);
- ops emitted from Python as ``XlaCustomCallV2`` — registered in TF's op
  registry (its C++ wrapper ships in libtensorflow_cc) though absent from
  ``tf.raw_ops``, so it is applied through ``op_def_library``;
- a ctypes callback that dispatches each custom call to the package's
  collectives (:mod:`..ops.collective_ops`, the buffers crossing to this
  rank's device as torch tensors), so a jit-compiled step's allreduce
  pairs with its peers' eager ones call for call.

Shape-preserving collectives only (allreduce, grouped allreduce,
broadcast): XLA requires static result shapes, and allgather/alltoall
results are data-dependent — the reference's scoping, whose XLA op set
is allreduce-only.

A collective's error inside a compiled program cannot raise through XLA;
the callback records it, returns identity data, re-raises it at the
next collective call (:func:`maybe_reraise`) and, unless
``HVD_TPU_TF_XLA_ASYNC_RAISE=0``, raises its class on the main thread
at once.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import sys
import threading
from typing import Optional

import numpy as np
import tensorflow as tf

from ..ops import collective_ops as _engine_ops
from ..ops.reduce_ops import ReduceOp
from ..runner.launch import TF_BRIDGE_SRC, tf_bridge_path
from ..utils.logging import get_logger
from .mpi_ops import _to_numpy, _to_torch

# Everything here runs at trace time from inside tf.function bodies, where
# AutoGraph rewrites called functions; an AutoGraph-converted ctypes
# callback raises inside the C callback ("Exception ignored while creating
# argument"), so the whole module opts out.
_no_autograph = tf.autograph.experimental.do_not_convert

_SRC = str(TF_BRIDGE_SRC)
_TARGET = "hvd_tpu_torch_tf_collective"

_lock = threading.Lock()
_lib = None
_load_attempted = False
#: why the bridge could not be built or loaded (None: not tried, or fine)
_build_error: Optional[str] = None
_last_error: Optional[BaseException] = None


# -- build + load ------------------------------------------------------------


def lib_path() -> str:
    """Where the bridge's library is (or will be) built: under
    ``build/horovod_tpu_torch/``, named by a hash of the source and the
    TF version."""
    return str(tf_bridge_path(tf.__version__))


@_no_autograph
def _build_and_load():
    """Compile (if missing) and dlopen the bridge; returns the CDLL or
    None, with the reason kept in ``_build_error`` and logged once.

    The system g++ against the pip TF headers, linking
    libtensorflow_cc.so.2 so the registry singleton is the live one."""
    global _lib, _load_attempted, _build_error
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        try:
            import shutil
            import subprocess

            tf_dir = tf.sysconfig.get_lib()
            if not os.path.exists(
                    os.path.join(tf_dir, "libtensorflow_cc.so.2")):
                raise RuntimeError(
                    f"libtensorflow_cc.so.2 is not shipped in {tf_dir}")
            out = lib_path()
            if not os.path.exists(out):
                if shutil.which("g++") is None:
                    raise RuntimeError("no g++ on PATH")
                os.makedirs(os.path.dirname(out), exist_ok=True)
                # per-pid temp + atomic rename: concurrent workers (a
                # launch of N on a fresh checkout) all build; without it
                # one dlopens a half-written ELF
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = (["g++", "-O2", "-fPIC", "-shared"]
                       + tf.sysconfig.get_compile_flags()
                       + ["-o", tmp, _SRC, f"-L{tf_dir}",
                          "-l:libtensorflow_cc.so.2",
                          f"-Wl,-rpath,{tf_dir}"])
                try:
                    res = subprocess.run(cmd, capture_output=True, text=True,
                                         timeout=300)
                    if res.returncode != 0:
                        raise RuntimeError(
                            f"g++ exited {res.returncode}:\n"
                            f"{res.stderr[-4000:]}")
                    os.replace(tmp, out)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            lib = ctypes.CDLL(out)  # the static registrar fires at load
            lib.hvd_tpu_torch_tf_set_callback(_CB_REF)
            _lib = lib
        except Exception as e:
            _lib = None
            _build_error = f"{type(e).__name__}: {e}"
            get_logger().warning(
                "TF XLA collective bridge unavailable (%s); "
                "jit_compile=True steps with collectives will raise — "
                "plain graph/eager paths are unaffected", _build_error)
        return _lib


@_no_autograph
def available() -> bool:
    if os.environ.get("HOROVOD_ENABLE_XLA_OPS", "").lower() in ("0", "false"):
        return False
    return _build_and_load() is not None


@_no_autograph
def require():
    """The loaded bridge, or ``RuntimeError`` carrying why it could not
    be built or loaded."""
    lib = _build_and_load()
    if lib is None:
        raise RuntimeError(
            "a collective inside tf.function(jit_compile=True) needs the "
            "XLA custom-call bridge (horovod_tpu_torch/tensorflow/src/"
            f"xla_bridge.cc), which could not be built or loaded: "
            f"{_build_error}")
    return lib


@_no_autograph
def in_jit_trace(consider_env: bool = True) -> bool:
    """True when the current trace belongs to a jit_compile=True
    tf.function.  TF exposes no public trace-time signal, so walk the
    stack for the polymorphic Function driving the trace and read its
    jit_compile (innermost non-None wins, matching must-compile
    clustering).

    With ``consider_env`` (the lowering decision), HOROVOD_ENABLE_XLA_OPS
    =1/true forces the XLA lowering for every graph-mode collective (the
    reference's env contract — meaningful when the graph compiles, e.g.
    under TF auto-clustering).  Callers asking "is this REALLY a
    must-compile trace?" (e.g. the allgather rejection) pass
    consider_env=False so the force flag cannot break plain-graph ops
    that work fine through py_function."""
    if consider_env and os.environ.get(
            "HOROVOD_ENABLE_XLA_OPS", "").lower() in ("1", "true"):
        return True
    # raw frame walk, NOT inspect.stack(): this runs once per symbolic
    # collective during tracing (hundreds of times for a big tape), and
    # inspect.stack materializes source lines for every frame
    fr = sys._getframe(1)
    while fr is not None:
        slf = fr.f_locals.get("self")
        if slf is not None:
            jc = getattr(slf, "_jit_compile", None)
            if jc is None:
                ft = getattr(slf, "function_type", None)
                jc = getattr(ft, "jit_compile", None) if ft is not None \
                    else None
            if jc is not None:
                return bool(jc)
        fr = fr.f_back
    return False


def maybe_reraise() -> None:
    """Re-raise a collective's error captured inside a compiled program
    (the custom call cannot raise through XLA — identity data was
    returned)."""
    global _last_error
    err, _last_error = _last_error, None
    if err is not None:
        raise err


# -- the callback ------------------------------------------------------------


def _np_dtype(name: str):
    if name == "bfloat16":
        return np.dtype(tf.bfloat16.as_numpy_dtype)
    return np.dtype(name)


@_no_autograph
def _callback(meta_p, meta_len, ins, outs):
    global _last_error
    meta = json.loads(ctypes.string_at(meta_p, meta_len))
    specs = meta["tensors"]
    arrays = []
    for i, spec in enumerate(specs):
        dt = _np_dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize if shape \
            else dt.itemsize
        buf = ctypes.string_at(ins[i], nbytes)
        arrays.append(np.frombuffer(buf, dtype=dt).reshape(shape))
    try:
        results = _dispatch(meta, arrays)
    except BaseException as e:  # noqa: BLE001 — must not unwind into XLA
        get_logger().error(
            "collective failed inside a jit-compiled step: %s: %s "
            "(identity data returned; the error re-raises on the driving "
            "thread at the step boundary)", type(e).__name__, e)
        _last_error = e
        _async_raise_on_main(e)
        results = arrays
    for i, (res, spec) in enumerate(zip(results, specs)):
        dt = _np_dtype(spec["dtype"])
        res = np.ascontiguousarray(np.asarray(res, dtype=dt))
        if res.shape != tuple(spec["shape"]):
            # never overrun XLA's statically-sized output buffer: a
            # shape-deviating result becomes a recorded error + identity
            # data, not heap corruption deep in the TF runtime
            get_logger().error(
                "collective result shape %s != declared %s; identity "
                "data returned", res.shape, tuple(spec["shape"]))
            _last_error = _last_error or ValueError(
                f"collective result shape {res.shape} != declared "
                f"{tuple(spec['shape'])}")
            res = arrays[i]
        ctypes.memmove(outs[i], res.ctypes.data, res.nbytes)


def _async_raise_on_main(err: BaseException) -> None:
    """Surface an in-compiled-step collective error on the main thread.

    A cached jit_compile=True train loop may never re-enter trace-time
    code (where ``maybe_reraise`` runs) nor any eager collective — the
    error would otherwise be swallowed forever and training would
    continue on identity (un-reduced) data.  A custom call cannot raise
    through XLA, so inject the exception CLASS asynchronously into the
    main thread (fires at the next bytecode boundary — i.e. when the
    compiled step returns); the instance detail stays in ``_last_error``
    for ``maybe_reraise``.  HorovodInternalError reaches the elastic run
    wrapper's recovery exactly as on the eager path.  Disable with
    HVD_TPU_TF_XLA_ASYNC_RAISE=0 (then only logging + deferred re-raise
    remain)."""
    if os.environ.get("HVD_TPU_TF_XLA_ASYNC_RAISE", "1") in ("0", "false"):
        return
    try:
        cls = type(err) if isinstance(err, Exception) else RuntimeError
        tid = threading.main_thread().ident
        if tid is None or tid == threading.get_ident():
            return
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(tid), ctypes.py_object(cls))
    except Exception:  # pragma: no cover — raising must never recurse
        pass


def _resolve_process_set(set_id: int):
    if set_id < 0:
        return None
    from ..common.basics import _require_init

    return _require_init().process_set_registry.get(set_id)


def _dispatch(meta, arrays):
    kind = meta["kind"]
    ps = _resolve_process_set(meta.get("process_set", -1))
    ts = [_to_torch(a) for a in arrays]
    if kind == "allreduce":
        out = [_engine_ops.allreduce(
            ts[0], average=meta["average"],
            op=None if meta["op"] is None else ReduceOp(meta["op"]),
            prescale_factor=meta["prescale"],
            postscale_factor=meta["postscale"],
            name=meta["name"], process_set=ps)]
    elif kind == "grouped_allreduce":
        out = _engine_ops.grouped_allreduce(
            ts, average=meta["average"],
            op=None if meta["op"] is None else ReduceOp(meta["op"]),
            prescale_factor=meta["prescale"],
            postscale_factor=meta["postscale"],
            name=meta["name"], process_set=ps)
    elif kind == "broadcast":
        out = [_engine_ops.broadcast(
            ts[0], meta["root_rank"], name=meta["name"], process_set=ps)]
    else:
        raise ValueError(f"unknown collective kind {kind!r}")
    return [_to_numpy(o) for o in out]


# The CFUNCTYPE object must be created OUTSIDE any tf.function trace
# (AutoGraph would convert _callback) and stay referenced for the process
# lifetime (ctypes callbacks die with their wrapper object).
_CB_REF = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_uint32,
    ctypes.POINTER(ctypes.c_void_p),
    ctypes.POINTER(ctypes.c_void_p))(_callback)


# -- op emission -------------------------------------------------------------


@_no_autograph
def _emit(kind: str, tensors, **meta_fields):
    """Build one XlaCustomCallV2 over ``tensors`` (+ the meta operand)."""
    from tensorflow.python.framework import op_def_library

    maybe_reraise()
    tensors = [tf.convert_to_tensor(t) for t in tensors]
    for t in tensors:
        if not t.shape.is_fully_defined():
            raise ValueError(
                "XLA collectives need static shapes; got "
                f"{t.shape} for a {kind} inside jit_compile")
    meta = json.dumps({
        "kind": kind,
        "tensors": [{"dtype": t.dtype.name, "shape": t.shape.as_list()}
                    for t in tensors],
        **meta_fields,
    }).encode()
    hdr = struct.pack("<II", len(meta), len(tensors)) + meta
    meta_t = tf.constant(np.frombuffer(hdr, np.uint8))
    out = op_def_library.apply_op(
        "XlaCustomCallV2",
        operands=[meta_t] + tensors,
        call_target_name=_TARGET,
        backend_config="",
        has_side_effect=True,
        result_dtypes=[t.dtype for t in tensors],
        result_shapes=[t.shape for t in tensors],
    )
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _set_id(process_set) -> int:
    return -1 if process_set is None else process_set.process_set_id


def xla_allreduce(tensor, average=None, name=None, op=None,
                  prescale_factor=1.0, postscale_factor=1.0,
                  process_set=None):
    return _emit(
        "allreduce", [tensor], average=average, name=name,
        op=None if op is None else int(op), prescale=prescale_factor,
        postscale=postscale_factor, process_set=_set_id(process_set))[0]


def xla_grouped_allreduce(tensors, average=None, name=None, op=None,
                          prescale_factor=1.0, postscale_factor=1.0,
                          process_set=None):
    return _emit(
        "grouped_allreduce", tensors, average=average, name=name,
        op=None if op is None else int(op), prescale=prescale_factor,
        postscale=postscale_factor, process_set=_set_id(process_set))


def xla_broadcast(tensor, root_rank, name=None, process_set=None):
    return _emit(
        "broadcast", [tensor], root_rank=int(root_rank), name=name,
        process_set=_set_id(process_set))[0]
