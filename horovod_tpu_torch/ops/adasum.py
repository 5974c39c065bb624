"""Adasum: scale-invariant gradient combination.

Port of ``horovod_tpu/ops/adasum.py`` (reference: horovod/common/ops/
adasum/adasum.h and adasum_mpi_operations.cc).  Two gradients a, b
combine as

    adasum(a, b) = (1 - a·b / (2‖a‖²)) a  +  (1 - a·b / (2‖b‖²)) b

which counts the component both push in once and keeps orthogonal
components additive.  The ranks combine pairwise: ranks past the largest
power of two m fold into ranks 0..excess-1 first, then an XOR hypercube
over the m low ranks (at round k a rank combines with the one whose rank
differs in bit k), then the folded ranks receive the result back.
Adasum is not associative, so this pairing is part of the result: the
JAX package's :func:`adasum_combine_rows` pairs identically, and the
tests hold the two against each other.

Each exchange is one ``dist.batch_isend_irecv`` pair.  Dot products and
norms accumulate in fp32 whatever the gradient's dtype (the reference's
fp16 care in adasum.h's DispatchComputeDotAndNormSqrds); the
coefficients are cast to the gradient's dtype before they scale it.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist


def _adasum_pair(v: torch.Tensor, pv: torch.Tensor) -> torch.Tensor:
    f32 = torch.float32
    a, b = v.to(f32), pv.to(f32)
    d = (a * b).sum()
    na = (a * a).sum()
    nb = (b * b).sum()
    one = torch.ones((), dtype=f32, device=v.device)
    ca = torch.where(na > 0, 1.0 - d / (2.0 * na), one).to(v.dtype)
    cb = torch.where(nb > 0, 1.0 - d / (2.0 * nb), one).to(v.dtype)
    return ca * v + cb * pv


def _low_pow2(n: int) -> int:
    """The largest power of two <= n."""
    m = 1
    while m * 2 <= n:
        m *= 2
    return m


def adasum_combine_rows(u: torch.Tensor) -> torch.Tensor:
    """Adasum-combine the rows of an (n, d) stack into one (d,) vector,
    with the same fold-then-hypercube pairing as
    :func:`adasum_allreduce` (one process holding every contribution)."""
    n = int(u.shape[0])
    if n == 1:
        return u[0]
    m = _low_pow2(n)
    rows = [u[i] for i in range(n)]
    for i in range(n - m):
        rows[i] = _adasum_pair(rows[i], rows[m + i])
    rows = rows[:m]
    step = 1
    while step < m:
        rows = [_adasum_pair(rows[i], rows[i ^ step]) for i in range(m)]
        step <<= 1
    return rows[0]


def _p2p(ops) -> None:
    for w in dist.batch_isend_irecv(ops):
        w.wait()


def _peer(group, peer: int) -> int:
    return peer if group is None else dist.get_global_rank(group, peer)


def _send(vec: torch.Tensor, peer: int, group) -> None:
    _p2p([dist.P2POp(dist.isend, vec, _peer(group, peer), group)])


def _recv(like: torch.Tensor, peer: int, group) -> torch.Tensor:
    out = torch.empty_like(like)
    _p2p([dist.P2POp(dist.irecv, out, _peer(group, peer), group)])
    return out


def _exchange(vec: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send ``vec`` to group rank ``peer`` and receive its vector."""
    out = torch.empty_like(vec)
    peer = _peer(group, peer)
    _p2p([dist.P2POp(dist.isend, vec, peer, group),
          dist.P2POp(dist.irecv, out, peer, group)])
    return out


def adasum_allreduce(tensor: Any, process_set: Optional[Any] = None) -> Any:
    """Adasum-allreduce a tensor or a list / tuple / dict of tensors
    across the ranks of ``process_set`` (default: the world).

    The leaves are flattened into one vector in the first leaf's dtype,
    so the dot products span the whole gradient (the reference's
    whole-buffer semantics for a fused entry set); each leaf comes back
    in its own dtype and shape."""
    from .collective_ops import _flatten, _scope

    group, n, me = _scope(process_set)
    leaves, build = _flatten(tensor)
    if not leaves:
        return tensor
    dtype = leaves[0].dtype
    vec = torch.cat([t.detach().reshape(-1).to(dtype) for t in leaves])
    if n > 1:
        vec = vec.contiguous()
        m = _low_pow2(n)
        excess = n - m
        if me >= m:  # fold: hand this rank's vector to rank me - m
            _send(vec, me - m, group)
        else:
            if me < excess:
                vec = _adasum_pair(vec, _recv(vec, me + m, group))
            step = 1
            while step < m:
                vec = _adasum_pair(vec, _exchange(vec, me ^ step, group))
                step <<= 1
        # unfold: the folded ranks receive the combined vector back
        if me < excess:
            _send(vec, me + m, group)
        elif me >= m:
            vec = _recv(vec, me - m, group)
    out, offset = [], 0
    for t in leaves:
        k = t.numel()
        out.append(vec[offset:offset + k].reshape(t.shape).to(t.dtype))
        offset += k
    return build(out)
