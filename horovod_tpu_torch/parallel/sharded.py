"""Multi-axis training: dp × sp × tp over one process per GPU.

Port of ``horovod_tpu/parallel/sharded.py``: a transformer whose batch
is sharded over ``dp``, its sequence over ``sp`` (Ulysses all-to-alls
around attention, or the ring) and its weights over ``tp`` (Megatron
column/row layers).  The JAX package builds a (dp, sp, tp) mesh and
compiles one ``shard_map`` program; the port gives each mesh axis a
process set (:func:`multi_axis_mesh`), each rank holds its slices, and
each collective is an autograd function with its transpose written by
hand (``tensor_parallel``, ``ulysses``, ``ring_attention``).

The step (:func:`make_sharded_train_step`) computes the TRUE gradient
of the global loss — Megatron's ``f``/``g`` around each tp layer, then
the mean over the (dp, sp) ranks through the port's bucketed reducer;
tp-sharded parameters train on their own slices.  The JAX step takes
its gradient inside ``shard_map`` and gets the tp-sharded leaves' (and
the leaves upstream of a tp layer) wrong at tp > 1 (ROADMAP §C5); its
forward and losses are the port's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common import basics
from ..common.device import resolve_device
from ..models._remat import remat_call
from ..models.transformer import causal_dot_attention, resolve_remat_policies
from ..ops import collective_ops
from ..ops.flash_attention import flash_attention
from ..ops.reduce_ops import Average
from ..optim import _BucketReducer
from ..training import softmax_cross_entropy
from ._mesh_utils import axis_size_or_1 as _axis_size
from .ring_attention import ring_attention
from .tensor_parallel import (
    TensorParallelAttention, TensorParallelMlp, lecun_normal_,
)
from .ulysses import ulysses_attention

DP_AXIS, SP_AXIS, TP_AXIS = "dp", "sp", "tp"
#: flax ``nn.LayerNorm``'s epsilon (torch's default is 1e-5)
_LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class MultiAxisMesh:
    """The (dp, sp, tp) mesh as this rank sees it: the axis sizes, its
    index on each, and the process sets of the axes through it:
    ``tp_set`` (its tp peers, innermost), ``sp_set`` (its sequence
    peers) and ``rep_set`` (the dp × sp ranks at its tp index: the
    gradient mean's).  The default mesh is one rank without sets."""

    dp: int = 1
    sp: int = 1
    tp: int = 1
    dp_idx: int = 0
    sp_idx: int = 0
    tp_idx: int = 0
    tp_set: Any = None
    sp_set: Any = None
    rep_set: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DP_AXIS: self.dp, SP_AXIS: self.sp, TP_AXIS: self.tp}


def multi_axis_mesh(dp: int, sp: int = 1, tp: int = 1,
                    devices=None) -> MultiAxisMesh:
    """Build the (dp, sp, tp) mesh over the first ``dp·sp·tp`` ranks
    (or the ranks ``devices`` lists), ``tp`` innermost: rank
    ``(d·sp + s)·tp + t`` sits at (d, s, t), so the axis with per-layer
    collectives spans neighbouring ranks (one host's NVLink).  Every
    process calls it with the same arguments: it creates every axis
    group, in the same order (``dist.new_group`` is collective)."""
    st = basics._require_init()
    ranks = list(devices) if devices is not None else list(range(st.size))
    n = dp * sp * tp
    if len(ranks) < n:
        raise ValueError(f"need {n} devices, have {len(ranks)}")
    ranks = ranks[:n]
    reg = st.process_set_registry
    at = lambda d, s, t: ranks[(d * sp + s) * tp + t]  # noqa: E731
    tps = {(d, s): reg.find_or_add([at(d, s, t) for t in range(tp)])
           for d in range(dp) for s in range(sp)}
    sps = {(d, t): reg.find_or_add([at(d, s, t) for s in range(sp)])
           for d in range(dp) for t in range(tp)}
    reps = {t: reg.find_or_add([at(d, s, t) for d in range(dp)
                                for s in range(sp)]) for t in range(tp)}
    if st.rank not in ranks:
        raise ValueError(f"rank {st.rank} is not in the mesh's ranks {ranks}")
    i = ranks.index(st.rank)
    d, s, t = i // (sp * tp), (i // tp) % sp, i % tp
    return MultiAxisMesh(dp, sp, tp, d, s, t, tp_set=tps[d, s],
                         sp_set=sps[d, t], rep_set=reps[t])


def _make_attn_fn(attention_impl: str, causal: bool,
                  window: Optional[int], mesh: MultiAxisMesh) -> Callable:
    """The per-block attention over the sp axis: ``"ulysses"`` (dense
    local attention between two all-to-alls, as the JAX closure runs
    it: no kernel), ``"ring"`` (dense blocks) or ``"ring_flash"`` (the
    flash kernels, B1–B3 and the ``kv_offset`` form B9).  At sp = 1
    each is its single-device attention."""
    if attention_impl not in ("ulysses", "ring", "ring_flash"):
        raise ValueError(
            f"unknown attention_impl {attention_impl!r}; "
            "expected 'ulysses', 'ring' or 'ring_flash'")

    def attn_fn(q, k, v):
        if attention_impl in ("ring", "ring_flash"):
            impl = "flash" if attention_impl == "ring_flash" else "dense"
            if _axis_size(mesh.sp_set) == 1:
                if impl == "flash":
                    return flash_attention(q, k, v, causal=causal,
                                           window=window)
                return causal_dot_attention(q, k, v, causal=causal,
                                            window=window)
            return ring_attention(q, k, v, impl=impl, causal=causal,
                                  window=window, process_set=mesh.sp_set)
        if _axis_size(mesh.sp_set) == 1:
            return causal_dot_attention(q, k, v, causal=causal,
                                        window=window)
        return ulysses_attention(q, k, v, process_set=mesh.sp_set,
                                 causal=causal, window=window)

    return attn_fn


class _LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics in fp32, eps 1e-6, ``scale``
    and ``bias``, the result in ``dtype``."""

    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones((dim,), device=device))
        self.bias = nn.Parameter(torch.zeros((dim,), device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias,
                            _LN_EPS).to(self.dtype)


class _MultiAxisBlock(nn.Module):
    """One pre-norm decoder block of :class:`MultiAxisTransformer` (the
    unit a remat policy wraps)."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int, dtype,
                 attn_fn: Callable, tp_set, device):
        super().__init__()
        self.ln1 = _LayerNorm(d_model, dtype, device)
        self.attn = TensorParallelAttention(
            num_heads, head_dim, d_model, tp_set, attn_fn=attn_fn,
            dtype=dtype, device=device)
        self.ln2 = _LayerNorm(d_model, dtype, device)
        self.mlp = TensorParallelMlp(d_model, 4 * d_model, tp_set,
                                     dtype=dtype, device=device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class MultiAxisTransformer(nn.Module):
    """Decoder-only LM over the (dp, sp, tp) mesh.

    ``forward(tokens)`` takes this rank's (B/dp, S/sp) token shard and
    returns its logits; attention composes TP head-sharding with the
    sequence-parallel scheme over sp:

      * ``attention_impl='ulysses'`` (default): all-to-alls re-shard
        sequence↔heads around dense local attention, so the local head
        count H/tp must divide by sp;
      * ``'ring'`` / ``'ring_flash'``: the sequence stays sharded and
        K/V rotate over the sp ranks (dense blocks or the flash
        kernels); ``window`` also cuts the causal rotation.

    Weights: ``embed`` (vocab, d) (the tied head), ``pos_embed``
    (seq_len, d) sliced at ``sp_idx · S_local``, each block
    ``block_{i}.{ln1, attn.qkv, attn.proj, ln2, mlp.wi, mlp.wo}`` at this
    rank's tp slices, ``ln_f``: fp32 masters, computed in ``dtype``.
    ``remat_policy``: None, a remat policy name for every block or one
    per block (``models/_remat.py``), applied in training with grad on.
    ``mesh`` defaults to one rank (no collectives)."""

    def __init__(self, vocab: int, d_model: int, num_heads: int,
                 num_layers: int, seq_len: int, dtype=torch.float32,
                 attention_impl: str = "ulysses", causal: bool = True,
                 window: Optional[int] = None, remat_policy: Any = None,
                 mesh: Optional[MultiAxisMesh] = None, device=None):
        super().__init__()
        self.mesh = mesh = mesh or MultiAxisMesh()
        if seq_len % mesh.sp:
            raise ValueError(f"seq_len {seq_len} not divisible by sp="
                             f"{mesh.sp}")
        dev = resolve_device(device)
        self.vocab, self.d_model, self.num_heads = vocab, d_model, num_heads
        self.num_layers, self.seq_len, self.dtype = num_layers, seq_len, dtype
        self.attention_impl, self.causal, self.window = (
            attention_impl, causal, window)
        self.remat_policy = remat_policy
        self.policies = resolve_remat_policies(remat_policy, num_layers)
        attn_fn = _make_attn_fn(attention_impl, causal, window, mesh)
        self.embed = nn.Parameter(torch.empty((vocab, d_model), device=dev))
        self.pos_embed = nn.Parameter(torch.empty((seq_len, d_model),
                                                  device=dev))
        for i in range(num_layers):
            self.add_module(f"block_{i}", _MultiAxisBlock(
                d_model, num_heads, d_model // num_heads, dtype, attn_fn,
                mesh.tp_set, dev))
        self.ln_f = _LayerNorm(d_model, dtype, dev)

    def forward(self, tokens):
        s_local = tokens.shape[1]
        x = self.embed[tokens].to(self.dtype)
        off = self.mesh.sp_idx * s_local
        x = x + self.pos_embed[off:off + s_local].to(self.dtype)[None]
        remat = self.training and torch.is_grad_enabled()
        for i in range(self.num_layers):
            block = getattr(self, f"block_{i}")
            x = remat_call(block, self.policies[i], x) if remat else block(x)
        x = self.ln_f(x)
        return x @ self.embed.to(self.dtype).t()  # tied head


def param_specs(model_or_params) -> Dict[str, tuple]:
    """The Megatron layout of each parameter, by name: ``(None, "tp")``
    for the column kernels (``qkv``, ``wi``; ``("tp",)`` for
    ``wi.bias``), ``("tp", None)`` for the row kernels (``proj``,
    ``wo``), ``()`` (replicated) for everything else — the JAX
    ``PartitionSpec`` trees, as tuples."""
    params = model_or_params.state_dict() \
        if isinstance(model_or_params, nn.Module) else model_or_params

    def spec(name, leaf):
        if leaf.ndim == 2:
            if "qkv" in name or "wi" in name:
                return (None, TP_AXIS)  # column-parallel
            if "proj" in name or "wo" in name:
                return (TP_AXIS, None)  # row-parallel
        if leaf.ndim == 1 and "wi.bias" in name:
            return (TP_AXIS,)
        return ()

    return {k: spec(k, v) for k, v in params.items()}


def init_sharded(model: MultiAxisTransformer, seed: int = 0
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """Initialize ``model``'s parameters in place and return ``(its
    state dict, param_specs)``.

    Replicated leaves must be identical on every rank, so they draw
    from a generator seeded with ``seed``; tp-sharded leaves are
    DISTINCT slices of a larger matrix, so they draw from one seeded
    with ``seed`` and this rank's tp index (the Megatron per-partition
    init: a shared draw would make the tp slices equal, and gradient
    symmetry keep them so).  Draws: ``embed`` and ``pos_embed``
    N(0, 0.02), kernels lecun-normal on their local fan-in, norm scales
    one, biases zero."""
    dev = model.embed.device
    base = torch.Generator(dev).manual_seed(seed)
    folded = torch.Generator(dev).manual_seed(
        seed * 1_000_003 + 1 + model.mesh.tp_idx)
    specs = param_specs(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draws = []
            for g in (base, folded):
                t = torch.empty_like(p)
                if name in ("embed", "pos_embed"):
                    t.normal_(0.0, 0.02, generator=g)
                elif name.endswith("kernel"):
                    lecun_normal_(t, t.shape[0], g)
                elif name.endswith("scale"):
                    t.fill_(1.0)
                else:
                    t.zero_()
                draws.append(t)
            p.copy_(draws[1] if TP_AXIS in specs[name] else draws[0])
    return model.state_dict(), specs


def init_opt_sharded(make_optimizer: Callable, model: nn.Module
                     ) -> Tuple[Any, Dict[str, tuple]]:
    """The optimizer over this rank's parameters, its state laid out as
    they are: ``(make_optimizer(model.parameters()), specs)`` where each
    parameter's state (momenta, moments) takes its ``param_specs`` entry
    — a tp-sharded leaf's state is its slice's, as the JAX
    ``opt_state_specs`` matches optax's moment subtrees to their
    parameters."""
    return make_optimizer(model.parameters()), param_specs(model)


def make_sharded_train_step(model: MultiAxisTransformer, optimizer,
                            mesh: Optional[MultiAxisMesh] = None,
                            overlap: bool = False,
                            bucket_bytes: Optional[int] = None) -> Callable:
    """The multi-axis train step, ``step(state, tokens, targets) ->
    (state, loss)`` (``state`` from ``training.create_train_state(model,
    optimizer)``; ``tokens``/``targets`` this rank's (B/dp, S/sp)
    shard): forward (TP × SP), the true gradient (Megatron's f/g: the
    loss, replicated over tp, counted once), the mean over the (dp, sp)
    ranks through the port's bucketed gradient reduction over
    ``mesh.rep_set`` — launched from the backward's hooks with
    ``overlap=True`` (``bucket_bytes``, default
    ``HVD_TPU_OVERLAP_BUCKET_BYTES``), after it without — then
    ``optimizer`` (the inner one) steps.  tp-sharded parameters are not
    reduced over tp: each rank trains its slice.  Needs ``hvd.init()``
    (the default mesh's reduction is the world's, of one rank).
    ``loss`` is the (dp, sp) mean of the ranks' mean fp32 cross
    entropy."""
    mesh = mesh or model.mesh
    reducer = _BucketReducer(model.parameters(), op=Average,
                             process_set=mesh.rep_set,
                             bucket_bytes=bucket_bytes, overlap=overlap,
                             always_armed=False)

    def step(state, tokens, targets):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("state does not carry this step's model and "
                             "optimizer")
        optimizer.zero_grad(set_to_none=True)
        loss = softmax_cross_entropy(model(tokens).float(), targets)
        reducer.backward(loss)
        reducer.synchronize()
        optimizer.step()
        loss = loss.detach()
        if _axis_size(mesh.rep_set) > 1:
            loss = collective_ops.allreduce(loss, op=Average,
                                            process_set=mesh.rep_set)
        return dataclasses.replace(state, step=state.step + 1), loss

    step.reducer = reducer
    return step
