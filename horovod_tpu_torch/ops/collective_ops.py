"""Collectives with Horovod's API, over ``torch.distributed``.

Port of ``horovod_tpu/ops/collective_ops.py`` (the eager API) with the
arithmetic of ``horovod_tpu/ops/spmd_ops.py``.  There is no separate
SPMD layer: with one process per GPU every rank already runs the same
program, so these calls are what a ``shard_map``-ed step's collectives
were (the ``spmd_ops`` names stay queued in ROADMAP).

* Every op takes a tensor or a list / tuple / dict of tensors and
  returns new tensors; the inputs are left alone.
* Every op takes ``process_set=`` (:mod:`..common.process_sets`): it
  runs inside the set's group, ranks (``root_rank`` excepted, a world
  rank as in the reference) count within the set, and a process outside
  the set raises ``ProcessSetError``.
* ``allreduce`` fuses the leaves into per-dtype buckets
  (:mod:`.fusion`), one collective per bucket.  ``Average`` is SUM
  followed by a division by the set's size in the tensor's dtype — as
  ``spmd_ops.allreduce`` does, and never ``dist.ReduceOp.AVG`` (gloo
  lacks it, NCCL rounds differently).  Pre- and postscale factors
  multiply in the tensor's dtype before and after the reduction, and
  only Sum and Average take them.  ``Adasum`` goes through
  :mod:`.adasum`, one combination per fused bucket.
* The gradient reductions (the optimizers' buckets, ZeRO's
  reduce-scatter, :func:`reducescatter`) add a floating-point sum over
  three or more ranks in rank order, element by element, whatever
  buffer an element lies in: an all-to-all hands each rank its slice of
  every contribution, it adds them in rank order, and an allgather
  returns the sums (a reduce-scatter skips the allgather).  A ring
  allreduce adds in an order that depends on where an element falls in
  the ring's segments, so the same gradient reduced in differently cut
  buckets — overlapped or not, ZeRO's flat buffers or the replicated
  buckets — would differ in its last bits.  With this order they are
  bit-equal, as the JAX package's are under XLA.  ``allreduce`` called
  directly keeps the library's sum, which took 0.55x the rank-ordered
  sum's time for gpt_small's 551 MB of gradients on four H100s over
  NCCL.  Over one or two ranks, and for integers, the two give the
  same bits.
* With ``HOROVOD_HIERARCHICAL_ALLREDUCE`` (``HVD_TPU_``) set, a Sum or
  Average allreduce over the world process set takes the two-level path
  (:mod:`.hierarchical`: local reduce-scatter, cross hop, local
  all-gather) when the world spans more than one slice
  (:mod:`..common.topology`), bucket by bucket, bool buckets excepted;
  the cross hop travels in ``HVD_TPU_DCN_WIRE_DTYPE`` where that names
  a 16-bit float.  Every other call stays flat, which is the
  reference's rule, not a fallback; a routed call whose layout cannot
  be resolved raises.  Each routed bucket books its modeled per-tier
  bytes (``comm_model.modeled_collective_bytes``) into
  ``hvd_tpu_collective_{ici,dcn}_bytes_total``; a flat Sum/Average
  allreduce, reduce-scatter or allgather books its ring stream there
  too, on the cross tier when the world spans slices (the
  bottleneck-link view), else on the local one.  Inside
  :func:`recording` the flat-buffer primitives record each
  ``torch.distributed`` call as they issue it (the measured side of
  the byte model).
* The ``*_async`` forms return a :class:`Handle` at once;
  :func:`synchronize` waits for it and returns the result, :func:`poll`
  says whether it is done.
* ``join()`` returns the rank at world 1 and raises across processes,
  as the reference does without its native controller (ROADMAP).
* Every public collective, sync and async, and every gradient bucket
  of the optimizers records itself as the JAX package's collectives
  do: ``hvd_tpu_collectives_total`` (path ``eager``) and
  ``hvd_tpu_collective_bytes_total`` at submission; an ``ENQUEUE``
  span around the submission and a ``COMM`` span from the submission
  until the result is ready, both bridged into ``torch.profiler`` as
  ``hvd_tpu::<name>::<activity>`` and recorded at the trace sites
  ``collective.enqueue`` / ``collective.exec``
  (:mod:`..utils.profiler`); the ``COMM`` span's interval in
  ``hvd_tpu_collective_latency_seconds``; and, while a Chrome timeline
  is open (:func:`~..common.basics.start_timeline`), its ``COMM``
  begin/end pair.  The label is the caller's ``name``, else the op's
  name (a bucket's: ``bucket.<b>``).  An async op's span ends in its
  :class:`Handle`'s ``wait``.  An NCCL ``wait`` does not block the
  host, so while a timeline is open the span ends only once a CUDA
  event recorded after the result has completed: the span covers the
  transfer.  With no timeline open nothing synchronises.
* A backend failure while an op completes — a peer died mid-collective
  (gloo: the closed connection; NCCL: ``DistBackendError``) — raises
  :class:`~..common.exceptions.HorovodInternalError`, the signal the
  elastic loop catches to roll its state back (reference: NCCL abort →
  HorovodInternalError; ``horovod_tpu/ops/engine.py`` ``_run``).  NCCL
  does not notice a dead peer by itself: a survivor blocks until the
  elastic worker's failure watchdog exec-restarts it.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common import basics, topology
from ..common.exceptions import HorovodInternalError, ProcessSetError
from ..metrics import instruments as _metrics
from ..utils import profiler as _profiler
from . import hierarchical
from .comm_model import collective_record, modeled_collective_bytes
from .fusion import FusionPlan, fuse, fusion_threshold, unfuse
from .reduce_ops import Average, ReduceOp, Sum

# torch renamed the flat-buffer collectives (2.13 warns on the old names,
# older releases lack the new ones)
_all_gather_flat_op = getattr(dist, "all_gather_single",
                              dist.all_gather_into_tensor)
_reduce_scatter_flat_op = getattr(dist, "reduce_scatter_single",
                                  dist.reduce_scatter_tensor)

#: torch.distributed's own failure types (every one a RuntimeError)
_DIST_ERRORS = tuple(getattr(dist, n) for n in (
    "DistBackendError", "DistNetworkError", "DistStoreError")
    if hasattr(dist, n))
#: what gloo's plain RuntimeError says when a peer is gone
_PEER_LOST = ("Connection closed by peer", "Connection reset by peer",
              "Broken pipe", "Connection refused", "Timed out")


@contextlib.contextmanager
def peer_failures():
    """Turn a backend failure raised inside the block (a dead peer) into
    :class:`HorovodInternalError`; any other error passes unchanged."""
    try:
        yield
    except HorovodInternalError:
        raise
    except RuntimeError as e:
        if isinstance(e, _DIST_ERRORS) or any(m in str(e)
                                              for m in _PEER_LOST):
            raise HorovodInternalError(str(e)) from e
        raise


_DIST_OP = {ReduceOp.SUM: dist.ReduceOp.SUM,
            ReduceOp.AVERAGE: dist.ReduceOp.SUM,
            ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def _flatten(tree: Any):
    """``(leaves, build)``: the tensors of a tensor / list / tuple / dict
    tree in order, and a function rebuilding the tree from new leaves."""
    leaves: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return len(leaves) - 1
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        raise TypeError(f"collectives take tensors, lists, tuples and "
                        f"dicts of tensors, not {type(x).__name__}")

    skeleton = walk(tree)

    def build(values):
        def fill(s):
            if isinstance(s, int):
                return values[s]
            if isinstance(s, dict):
                return {k: fill(v) for k, v in s.items()}
            return type(s)(fill(v) for v in s)
        return fill(skeleton)

    return leaves, build


def _scope(process_set=None) -> Tuple[Any, int, int]:
    """``(group, size, rank in the set)`` of ``process_set`` (default:
    the world) for this process."""
    st = basics._require_init()
    ps = st.process_set_registry.resolve(process_set)
    group = ps.group  # raises when the set is not attached
    return group, ps.size(), ps.rank_in_set(st.rank)


def _scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    if factor == 1.0:
        return x
    return x * torch.tensor(factor, dtype=x.dtype, device=x.device)


def _divide(x: torch.Tensor, n: int) -> torch.Tensor:
    if n == 1 and x.is_floating_point():  # x / 1 is x, bit for bit
        return x
    return x / torch.tensor(n, dtype=x.dtype, device=x.device)


# -- instruments -------------------------------------------------------------

#: labelled children of the collective instruments, taken once each
_CHILDREN: dict = {}


def _child(metric, *labels):
    key = (metric.name,) + labels
    c = _CHILDREN.get(key)
    if c is None:
        c = _CHILDREN[key] = metric.labels(*labels)
    return c


def _count_submission(opname: str, path: str = "eager", tree: Any = None,
                      n: int = 1) -> None:
    """Bump the submission counters (per-op count + payload bytes).
    ``n`` is the number of API-level submissions this call represents
    (the JAX package's batched path books one per tensor)."""
    _child(_metrics.COLLECTIVES, opname, path).inc(n)
    leaves = _flatten(tree)[0] if tree is not None else ()
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    if nbytes:
        _child(_metrics.COLLECTIVE_BYTES, opname).inc(nbytes)


def _device_ready(value: Any) -> None:
    """Block the host until the card has produced ``value``'s tensors:
    an event recorded on the current stream after them (the collective
    works' ``wait`` ordered that stream after the transfer)."""
    for dev in {t.device for t in _flatten(value)[0] if t.is_cuda}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class _CommSpan:
    """One collective's ``COMM`` span, opened at its submission and
    closed by :meth:`end` once the result is ready: the profiler bridge
    (``collective.exec``), ``OP_LATENCY`` and, when a timeline is open
    at submission, its begin/end pair."""

    __slots__ = ("label", "opname", "timeline", "bridge", "t0")

    def __init__(self, label: str, opname: str):
        self.label, self.opname = label, opname
        self.timeline = tl = basics._state.timeline
        if tl is not None:
            tl.start(label, "COMM")
        self.bridge = _profiler.span(label, "COMM")
        self.bridge.__enter__()
        self.t0 = time.perf_counter()

    def end(self, value: Any = None) -> None:
        tl = self.timeline
        if tl is not None and value is not None:
            _device_ready(value)
        _child(_metrics.OP_LATENCY, self.opname).observe(
            time.perf_counter() - self.t0)
        self.bridge.__exit__(None, None, None)
        if tl is not None:
            tl.end(self.label, "COMM")


def _submit(name: Optional[str], opname: str, tree: Any,
            start: Callable[[], "Handle"]) -> "Handle":
    """Submit one collective: ``start()`` launches it and returns its
    :class:`Handle`, inside an ``ENQUEUE`` span, with a ``COMM`` span
    open from here until the handle's result is ready."""
    label = name or opname
    span = _CommSpan(label, opname)
    try:
        with _profiler.span(label, "ENQUEUE"):
            handle = start()
    except BaseException:
        span.end()
        raise
    finally:
        _count_submission(opname, "eager", tree)
    handle._span = span
    return handle


class Handle:
    """An op in flight (reference: horovod/torch/handle_manager.h): the
    ``torch.distributed`` works it waits on, the epilogue that turns
    their buffers into the result, and the op's ``COMM`` span, which
    ends when ``wait`` has the result."""

    __slots__ = ("_works", "_finish", "_value", "_span")

    def __init__(self, works: Sequence, finish: Callable[[], Any]):
        self._works = list(works)
        self._finish = finish
        self._value = None
        self._span: Optional[_CommSpan] = None

    def wait(self) -> Any:
        if self._finish is not None:
            span, self._span = self._span, None
            try:
                with peer_failures():
                    for w in self._works:
                        w.wait()
                    self._value = self._finish()
            except BaseException:
                if span is not None:
                    span.end()
                raise
            self._finish = None
            if span is not None:
                span.end(self._value)
        return self._value

    def done(self) -> bool:
        return self._finish is None or all(w.is_completed()
                                           for w in self._works)


def _ready(value: Any) -> Handle:
    return Handle([], lambda: value)


def synchronize(handle: Handle) -> Any:
    """Wait for ``handle`` and return its result."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    """True when ``handle``'s op has completed."""
    return handle.done()


def _normalize_op(op: Optional[ReduceOp], average: Optional[bool]
                  ) -> ReduceOp:
    """The reference's average/op reconciliation."""
    if op is not None and average is not None:
        raise ValueError("specify either op or average, not both")
    if op is None:
        op = Average if (average is None or average) else Sum
    return ReduceOp(op)


# -- hierarchical routing and tier accounting --------------------------------


def _route(rop: ReduceOp, process_set=None,
           hierarchical: Optional[bool] = None) -> Optional[topology.Tiers]:
    """This rank's two-level tiers when a ``rop`` reduction over
    ``process_set`` takes the two-level path, else None: the flag
    (``hierarchical``, default ``HOROVOD_HIERARCHICAL_ALLREDUCE``) is
    on, the op is Sum or Average, the set is the world, and the world
    spans more than one slice (reference: ``engine._route_hierarchical``;
    bool buffers stay flat where they are reduced).  A layout that
    cannot be resolved raises."""
    st = basics._require_init()
    if hierarchical is None:
        hierarchical = bool(st.config is not None
                            and st.config.hierarchical_allreduce)
    if not hierarchical or rop not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        return None
    if st.process_set_registry.resolve(process_set).process_set_id != 0:
        return None
    return topology.tiers()


def routes_hierarchical(op: ReduceOp, process_set=None) -> bool:
    """Whether an allreduce with ``op`` over ``process_set`` takes the
    two-level path (reference: ``CollectiveEngine.routes_hierarchical``)."""
    return _route(ReduceOp(op), process_set) is not None


def _dcn_compression(explicit=None):
    """The cross-hop compression of a routed call: ``explicit`` when
    given, else the one ``init`` resolved from
    ``HVD_TPU_DCN_WIRE_DTYPE`` (stateless, no error feedback) or None."""
    if explicit is not None:
        return explicit
    return basics._require_init().dcn_compression


def _account_tier_bytes(ici: int, dcn: int) -> None:
    if ici:
        _metrics.COLLECTIVE_ICI_BYTES.inc(int(ici))
    if dcn:
        _metrics.COLLECTIVE_DCN_BYTES.inc(int(dcn))


def _account_flat(nbytes: int, n: int, factor: float = 2.0) -> None:
    """Book a flat collective's ring stream over ``n`` ranks,
    ``factor·(n-1)/n·nbytes`` (2 for an allreduce, 1 for a
    reduce-scatter or allgather), on the cross tier when the world
    spans slices and on the local tier otherwise."""
    if n <= 1 or not nbytes:
        return
    stream = int(factor * (n - 1) * nbytes // n)
    layout = basics._state.layout
    if layout is not None and layout.tiers is not None:
        _account_tier_bytes(0, stream)
    else:
        _account_tier_bytes(stream, 0)


def _account_hierarchical(buf: torch.Tensor, tiers: topology.Tiers,
                          wire) -> None:
    """Book one routed buffer's modeled per-tier bytes."""
    m = modeled_collective_bytes(
        (buf.numel(),), tiers.size, tiers.n_ici,
        wire_dtype=None if wire is None else wire.wire_dtype,
        dtype=buf.dtype)
    _account_tier_bytes(m["ici_bytes"], m["dcn_bytes"])


# -- the sum of a flat buffer ------------------------------------------------

#: the open :func:`recording` block's list, or None
_records: Optional[List[dict]] = None


@contextlib.contextmanager
def recording():
    """Collect a record (``comm_model.collective_record``) of every
    ``torch.distributed`` call that the flat-buffer primitives below
    issue inside the block: the op they hand to the backend, the bytes
    of the buffer they hand over and the group's world ranks.  Yields
    the list, which ``comm_model.measured_tier_bytes`` reads."""
    global _records
    outer, _records = _records, []
    try:
        yield _records
    finally:
        if outer is not None:
            outer.extend(_records)
        _records = outer


def _record(op: str, t: torch.Tensor, group) -> None:
    if _records is not None:
        ranks = dist.get_process_group_ranks(
            dist.group.WORLD if group is None else group)
        _records.append(collective_record(
            op, t.numel() * t.element_size(), ranks))


def _all_gather_flat(out: torch.Tensor, inp: torch.Tensor, group=None,
                     async_op: bool = False):
    """``all_gather_into_tensor``, recorded."""
    _record("all_gather", out, group)
    return _all_gather_flat_op(out, inp, group=group, async_op=async_op)


def _all_to_all_flat(out: torch.Tensor, inp: torch.Tensor, group=None,
                     async_op: bool = False):
    """``all_to_all_single`` in equal splits, recorded."""
    _record("all_to_all", inp, group)
    return dist.all_to_all_single(out, inp, group=group, async_op=async_op)


def _rank_ordered(dtype: torch.dtype, n: int) -> bool:
    """Whether a sum over ``n`` ranks goes through the rank-ordered
    exchange (floating point over three or more ranks)."""
    return n > 2 and (dtype.is_floating_point or dtype.is_complex)


def _sum_rows(rows: torch.Tensor) -> torch.Tensor:
    """Row 0 + row 1 + ... in that order, element by element."""
    acc = rows[0].clone()
    for j in range(1, rows.shape[0]):
        acc += rows[j]
    return acc


def _pad_to(buf: torch.Tensor, n: int) -> torch.Tensor:
    pad = (-buf.numel()) % n
    if not pad:
        return buf
    return torch.cat([buf, buf.new_zeros(pad)])


_side_streams: dict = {}


def _side_stream(device: torch.device):
    """One stream per card for the rank-ordered sum's middle step."""
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


def _reduce_scatter_start(buf: torch.Tensor, group, n: int, me: int
                          ) -> Tuple[List, Callable[[], torch.Tensor]]:
    """Start this rank's 1/n slice of the sum of a 1-D buffer whose
    length divides by ``n`` (the slices in rank order): ``(works,
    result)``, where ``result()`` is the slice once the works are
    done."""
    if n == 1:
        out = buf.clone()
        return [], lambda: out
    if _rank_ordered(buf.dtype, n):
        recv = torch.empty_like(buf)
        work = _all_to_all_flat(recv, buf, group=group, async_op=True)
        return [work], lambda: _sum_rows(recv.view(n, -1))
    if basics._require_init().backend == "nccl":
        part = buf.new_empty(buf.numel() // n)
        _record("reduce_scatter", buf, group)
        work = _reduce_scatter_flat_op(part, buf, group=group, async_op=True)
        return [work], lambda: part
    # gloo: reduce all, keep the slice
    full = buf.clone()
    _record("all_reduce", full, group)
    work = dist.all_reduce(full, group=group, async_op=True)
    return [work], lambda: full.view(n, -1)[me].clone()


def _sum_async(buf: torch.Tensor, group, n: int, me: int, ordered: bool
               ) -> Tuple[List, Callable[[], torch.Tensor]]:
    """Start the sum of a 1-D buffer across the set: ``(works, result)``
    where ``result()`` is the summed buffer once the works are done.
    ``buf`` must be the caller's own copy: it may be summed in place.
    ``ordered``: add in rank order (the gradient reductions).

    The rank-ordered sum waits on neither the calling thread nor its
    stream.  On a card its middle step (wait for the all-to-all, add the
    rows, start the allgather) runs on a side stream, so a bucket
    launched from a backward hook holds neither the hook nor the
    backward's stream.  The buffers are allocated on the caller's
    stream before the all-to-all is issued, and the side stream waits
    for the all-to-all, which comes after all the caller's stream did
    before; the caller's stream may reuse the all-to-all's buffers only
    once the side stream is past them.  Over gloo the middle step runs
    when the handle is waited on; every rank waits on its handles in
    the same order, so the allgathers pair up."""
    if not (ordered and _rank_ordered(buf.dtype, n)):
        _record("all_reduce", buf, group)
        return [dist.all_reduce(buf, group=group, async_op=True)], \
            lambda: buf
    numel = buf.numel()
    buf = _pad_to(buf, n)
    recv = torch.empty_like(buf)
    full = torch.empty_like(buf)
    a2a = _all_to_all_flat(recv, buf, group=group, async_op=True)

    def gather():
        a2a.wait()
        return _all_gather_flat(full, _sum_rows(recv.view(n, -1)),
                                group=group, async_op=True)

    if buf.is_cuda:
        side = _side_stream(buf.device)
        with torch.cuda.stream(side):
            work = gather()
        buf.record_stream(side)
        recv.record_stream(side)
        return [work], lambda: full[:numel]
    return [a2a], lambda: (gather().wait(), full[:numel])[1]


def _allreduce_flat_async(buf: torch.Tensor, rop: ReduceOp, group, n: int,
                          me: int, process_set, ordered: bool,
                          tiers: Optional[topology.Tiers] = None,
                          wire=None
                          ) -> Tuple[List, Callable[[], torch.Tensor]]:
    """Start the reduction of a 1-D buffer (the caller's own copy) with
    ``rop``: ``(works, result)``.  Average divides the sum by ``n`` in
    the buffer's dtype once the works are done.  With ``tiers``
    (:func:`_route`'s) a Sum or Average of a non-bool buffer takes the
    two-level path, its cross hop in ``wire``'s dtype where that narrows
    it."""
    if tiers is not None and rop in (ReduceOp.SUM, ReduceOp.AVERAGE) \
            and buf.dtype != torch.bool:
        _account_hierarchical(buf, tiers, wire)
        works, res = hierarchical.two_level_sum_start(buf, tiers, wire)
        if rop == ReduceOp.AVERAGE:
            return works, lambda: _divide(res()[0], n)
        return works, lambda: res()[0]
    if rop in (ReduceOp.SUM, ReduceOp.AVERAGE):
        _account_flat(buf.numel() * buf.element_size(), n)
    if rop == ReduceOp.ADASUM:
        from .adasum import adasum_allreduce

        out = adasum_allreduce(buf, process_set)
        return [], lambda: out
    if rop in (ReduceOp.SUM, ReduceOp.AVERAGE):
        works, res = _sum_async(buf, group, n, me, ordered)
        if rop == ReduceOp.AVERAGE:
            return works, lambda: _divide(res(), n)
        return works, res
    _record("all_reduce", buf, group)
    return [dist.all_reduce(buf, op=_DIST_OP[rop], group=group,
                            async_op=True)], lambda: buf


# -- allreduce ---------------------------------------------------------------


def _allreduce_async(tensor: Any, rop: ReduceOp, prescale_factor: float,
                     postscale_factor: float, process_set, ordered: bool,
                     hierarchical: Optional[bool] = None,
                     dcn_compression=None) -> Handle:
    """The fused allreduce's launch: one reduction a fusion bucket, each
    routed by :func:`_route` (``hierarchical`` None = the flag);
    ``dcn_compression`` None = the ``HVD_TPU_DCN_WIRE_DTYPE`` one."""
    sum_like = rop in (ReduceOp.SUM, ReduceOp.AVERAGE)
    if not sum_like and (prescale_factor != 1.0 or postscale_factor != 1.0):
        raise ValueError(
            f"prescale/postscale factors are not supported with op={rop!r}")
    group, n, me = _scope(process_set)
    tiers = _route(rop, process_set, hierarchical) if n > 1 else None
    wire = _dcn_compression(dcn_compression) if tiers is not None else None
    leaves, build = _flatten(tensor)
    plan = FusionPlan(leaves, fusion_threshold())
    works, results = [], []
    for b in fuse(leaves, plan):
        w, res = _allreduce_flat_async(_scale(b, prescale_factor), rop,
                                       group, n, me, process_set, ordered,
                                       tiers, wire)
        works += w
        results.append(res)

    def finish():
        out = [_scale(res(), postscale_factor) for res in results]
        return build(unfuse(out, plan))

    return Handle(works, finish)


def allreduce_async(tensor: Any, average: Optional[bool] = None,
                    name: Optional[str] = None, op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set=None) -> Handle:
    """Start a fused allreduce of a tensor or tree; returns a
    :class:`Handle` (``name`` labels its spans)."""
    rop = _normalize_op(op, average)
    return _submit(name, "allreduce", tensor, lambda: _allreduce_async(
        tensor, rop, prescale_factor, postscale_factor, process_set,
        ordered=False))


def allreduce(tensor: Any, average: Optional[bool] = None,
              name: Optional[str] = None, op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set=None) -> Any:
    """Fused allreduce of a tensor or tree (reference:
    horovod/torch/mpi_ops.py allreduce)."""
    return allreduce_async(tensor, average, name, op, prescale_factor,
                           postscale_factor, process_set).wait()


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            **kwargs) -> Handle:
    """Start an allreduce of a list of tensors as one fused group."""
    return allreduce_async(list(tensors), **kwargs)


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      **kwargs) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one fused group (reference:
    grouped_allreduce; ``allreduce``'s keyword arguments)."""
    return list(grouped_allreduce_async(tensors, **kwargs).wait())


# -- allgather ---------------------------------------------------------------


def _gather_dim0s(counts: torch.Tensor, group, n: int) -> List[List[int]]:
    """Every rank's int64 vector ``counts``, in set-rank order."""
    rows = [torch.empty_like(counts) for _ in range(n)]
    dist.all_gather(rows, counts, group=group)
    return [[int(v) for v in r] for r in rows]


def _gather_leaf(t: torch.Tensor, group, n: int) -> torch.Tensor:
    if t.dim() == 0:
        raise ValueError("allgather needs tensors of rank >= 1")
    dim0 = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = [r[0] for r in _gather_dim0s(dim0, group, n)]
    most = max(sizes)
    buf = t.contiguous()
    if t.shape[0] < most:  # ranks may hold different first dims
        pad = torch.zeros((most - t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        buf = torch.cat([buf, pad])
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    _account_flat(n * buf.numel() * buf.element_size(), n, 1.0)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])


def allgather_async(tensor: Any, name: Optional[str] = None,
                    process_set=None) -> Handle:
    """Start an allgather (the result is ready when it returns: the
    first dims are exchanged before the data)."""
    def start():
        group, n, _ = _scope(process_set)
        leaves, build = _flatten(tensor)
        return _ready(build([_gather_leaf(t, group, n) for t in leaves]))

    return _submit(name, "allgather", tensor, start)


def allgather(tensor: Any, name: Optional[str] = None,
              process_set=None) -> Any:
    """Concatenate every rank's tensor along dim 0 (reference:
    horovod/torch/mpi_ops.py allgather); first dims may differ."""
    return allgather_async(tensor, name, process_set).wait()


def grouped_allgather(tensors: Sequence[torch.Tensor],
                      name: Optional[str] = None,
                      process_set=None) -> List[torch.Tensor]:
    """Allgather a list of tensors with one exchange of first dims and
    one gather per dtype (reference: grouped_allgather): each rank's
    tensors ravel into one buffer, and the gathered buffer is cut back
    per (rank, tensor)."""
    tensors = list(tensors)
    if not tensors:
        return []
    if any(t.dim() == 0 for t in tensors):
        raise ValueError("allgather needs tensors of rank >= 1")
    return _submit(name, "allgather", tensors, lambda: _ready(
        _grouped_allgather(tensors, process_set))).wait()


def _grouped_allgather(tensors: List[torch.Tensor], process_set
                       ) -> List[torch.Tensor]:
    group, n, _ = _scope(process_set)
    dev = tensors[0].device
    dim0s = _gather_dim0s(torch.tensor([t.shape[0] for t in tensors],
                                       dtype=torch.int64, device=dev),
                          group, n)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(str(t.dtype), []).append(i)
    outs: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for _, idxs in sorted(by_dtype.items()):
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        gathered = _gather_leaf(flat, group, n)
        rows = {i: math.prod(tensors[i].shape[1:]) for i in idxs}
        segments = {i: [] for i in idxs}
        off = 0
        for r in range(n):
            for i in idxs:
                k = dim0s[r][i] * rows[i]
                segments[i].append(gathered[off:off + k].view(
                    (dim0s[r][i],) + tuple(tensors[i].shape[1:])))
                off += k
        for i in idxs:
            outs[i] = torch.cat(segments[i])
    return outs


# -- broadcast ---------------------------------------------------------------


def broadcast_async(tensor: Any, root_rank: int, name: Optional[str] = None,
                    process_set=None) -> Handle:
    """Start a broadcast from world rank ``root_rank`` (a member of the
    set)."""
    st = basics._require_init()
    if not 0 <= root_rank < st.size:
        raise ValueError(f"root_rank {root_rank} outside world of size "
                         f"{st.size}")
    ps = st.process_set_registry.resolve(process_set)
    if not ps.included(root_rank):
        raise ProcessSetError(f"root_rank {root_rank} is not a member of "
                              f"process set {ps.process_set_id}")
    group, _, _ = _scope(process_set)
    leaves, build = _flatten(tensor)

    def start():
        out, works = [], []
        for t in leaves:
            buf = t.detach().clone().contiguous()
            wire = buf.view(torch.uint8) if buf.dtype == torch.bool else buf
            works.append(dist.broadcast(wire, src=root_rank, group=group,
                                        async_op=True))
            out.append(buf)
        return Handle(works, lambda: build(out))

    return _submit(name, "broadcast", tensor, start)


def broadcast(tensor: Any, root_rank: int, name: Optional[str] = None,
              process_set=None) -> Any:
    """Every rank receives ``root_rank``'s value (reference:
    horovod/torch/mpi_ops.py broadcast)."""
    return broadcast_async(tensor, root_rank, name, process_set).wait()


# -- alltoall ----------------------------------------------------------------


def alltoall_async(tensor: torch.Tensor,
                   splits: Optional[Sequence[int]] = None,
                   name: Optional[str] = None, process_set=None) -> Handle:
    """Start an alltoall; the handle's result is ``(received,
    received_splits)``."""
    group, n, me = _scope(process_set)
    if tensor.dim() == 0:
        raise ValueError("alltoall requires ndim >= 1")
    dim0 = tensor.shape[0]
    if splits is None:
        if dim0 % n:
            raise ValueError(f"alltoall dim0 ({dim0}) must divide evenly "
                             f"by {n} when no splits are given")
        send = [dim0 // n] * n
    else:
        send = [int(s) for s in (splits.tolist() if isinstance(
            splits, torch.Tensor) else splits)]
        if len(send) != n or sum(send) != dim0 or min(send) < 0:
            raise ValueError(f"splits must be shape ({n},) of non-negative "
                             f"counts summing to dim0 of the input")

    def start():
        all_splits = _gather_dim0s(torch.tensor(
            send, dtype=torch.int64, device=tensor.device), group, n)
        recv = [all_splits[p][me] for p in range(n)]
        x = tensor.contiguous()
        wire = x.view(torch.uint8) if x.dtype == torch.bool else x
        out = wire.new_empty((sum(recv),) + tuple(x.shape[1:]))
        work = dist.all_to_all_single(out, wire, output_split_sizes=recv,
                                      input_split_sizes=send, group=group,
                                      async_op=True)
        recv_splits = torch.tensor(recv, dtype=torch.int32)

        def finish():
            return (out.view(torch.bool) if x.dtype == torch.bool else out,
                    recv_splits)

        return Handle([work], finish)

    return _submit(name, "alltoall", tensor, start)


def alltoall(tensor: torch.Tensor, splits: Optional[Sequence[int]] = None,
             name: Optional[str] = None, process_set=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk i of dim 0 goes to rank i, the received chunks concatenate
    in rank order (reference: horovod/torch/mpi_ops.py alltoall).  Even
    chunks without ``splits``; ``splits`` gives this rank's send counts.
    Returns ``(received, received_splits)``."""
    return alltoall_async(tensor, splits, name, process_set).wait()


# -- reducescatter -----------------------------------------------------------


def reducescatter_async(tensor: Any, op: ReduceOp = Sum,
                        name: Optional[str] = None,
                        process_set=None) -> Handle:
    """Start a reduce-scatter of a tensor or tree (each leaf's dim 0
    must divide by the set's size, as ``spmd_ops.reducescatter``
    requires)."""
    op = Sum if op is None else ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("reducescatter supports Sum and Average")
    group, n, me = _scope(process_set)
    leaves, build = _flatten(tensor)
    for t in leaves:
        if t.dim() == 0 or t.shape[0] % n:
            raise ValueError(f"reducescatter needs dim 0 divisible by "
                             f"{n}, got shape {tuple(t.shape)}")

    def start():
        works, results = [], []
        for t in leaves:
            _account_flat(t.numel() * t.element_size(), n, 1.0)
            w, res = _reduce_scatter_start(
                t.detach().reshape(-1).contiguous(), group, n, me)
            works += w
            results.append(res)

        def finish():
            out = []
            for t, res in zip(leaves, results):
                part = res().view((t.shape[0] // n,) + tuple(t.shape[1:]))
                out.append(_divide(part, n) if op == ReduceOp.AVERAGE
                           else part)
            return build(out)

        return Handle(works, finish)

    return _submit(name, "reducescatter", tensor, start)


def reducescatter(tensor: Any, op: ReduceOp = Sum,
                  name: Optional[str] = None, process_set=None) -> Any:
    """Reduce across ranks, then keep this rank's slice of dim 0
    (reference: horovod/torch/mpi_ops.py reducescatter).  Sum or
    Average; Average divides in the tensor's dtype."""
    return reducescatter_async(tensor, op, name, process_set).wait()


def grouped_reducescatter_async(tensors: Sequence[torch.Tensor],
                                op: ReduceOp = Sum,
                                name: Optional[str] = None,
                                process_set=None) -> Handle:
    """Start a reduce-scatter of a list of tensors as one group."""
    if not tensors:
        return _ready([])
    return reducescatter_async(list(tensors), op, name, process_set)


def grouped_reducescatter(tensors: Sequence[torch.Tensor],
                          op: ReduceOp = Sum, name: Optional[str] = None,
                          process_set=None) -> List[torch.Tensor]:
    """Reduce-scatter a list of tensors as one group (reference:
    grouped_reducescatter)."""
    return list(grouped_reducescatter_async(tensors, op, name,
                                            process_set).wait())


# -- barrier / join ----------------------------------------------------------


def barrier(process_set=None) -> None:
    """Block until every rank of the set arrives (reference:
    horovod_barrier)."""
    st = basics._require_init()
    group, _, _ = _scope(process_set)

    def start():
        with peer_failures():
            if st.backend == "nccl":
                dist.barrier(group=group, device_ids=[st.device.index])
            else:
                dist.barrier(group=group)
        return _ready(None)

    _submit(None, "barrier", None, start).wait()


def join() -> int:
    """Signal that this rank is out of data (reference:
    horovod/torch/mpi_ops.py join).  At world 1 it returns the rank.
    Across processes the reference needs its native controller to keep
    a joined rank taking part in its peers' collectives; the port has no
    such controller yet (ROADMAP), so it raises."""
    st = basics._require_init()
    if st.size == 1:
        return st.rank
    raise NotImplementedError(
        "join() across processes needs the native controller, which is "
        "not ported")
