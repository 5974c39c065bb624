"""GPT-style decoder-only transformer in PyTorch, for serving and training.

Port of ``horovod_tpu/models/transformer.py``: the same config, the same
pre-norm blocks (RMSNorm eps 1e-5, RoPE, GQA attention, SiLU-gated MLP,
tied embedding) and the same numerics, so logits and gradients match the
flax model on the same weights.  Four attention paths:

* ``paged`` (the serving engine's): K/V are written into and gathered
  from the paged cache (``serving/kv_cache.py``) and attention runs
  through the hand-written kernel of ``ops/flash_attention.py`` — for
  ``attention_impl`` "dot" and "flash" alike, as in the JAX package;
* ``"flash"`` (training): :func:`~horovod_tpu_torch.ops.flash_attention.
  flash_attention`, whose forward and backward are the hand-written
  kernels;
* ``"ring"`` / ``"ring_flash"`` (long context): the sequence sharded
  over the ranks, :func:`~horovod_tpu_torch.parallel.ring_attention.
  ring_attention` with the dense or the flash-kernel impl;
* ``"dot"``: the plain dense :func:`causal_dot_attention` (the oracle).

``TransformerConfig.shard_axis`` (a process set) slices the model
Megatron-style over the set's ranks, as the JAX config's mesh axis
does: each rank holds its query and kv heads and its slice of the MLP
hidden, and the attention output and MLP down projections each end in
one all-reduce (``parallel/tensor_parallel.py``'s ``f``/``g``); the
tensor-sharded serving engine runs it.

Weights keep the flax layout and names (``embed.embedding``,
``layer_{i}.attn.{q,k,v}.kernel`` (D, H, hd), ``attn.o.kernel``
(H, hd, D), ``mlp.{gate,up,down}.kernel``, ``ln{1,2}.scale``,
``ln_f.scale``).  Norm scales are fp32.  Matrices may be fp32 — the
training masters, as flax keeps them — or already ``cfg.dtype`` — the
serving copy: each is cast to ``cfg.dtype`` where it is used, as flax
casts before every product, and for a weight already in ``cfg.dtype``
that cast is a no-op.

Activation remat follows the JAX config: ``remat_policy`` (one of
:data:`REMAT_POLICIES` for every block, or one name per block) with the
legacy ``remat=True`` meaning ``dots_no_batch``.  Where the JAX model
remats — in training (``model.train()``, grad enabled) and never on the
paged serving path — each block whose policy is not ``none`` runs
through ``torch.utils.checkpoint`` (:mod:`._remat` says how each policy
maps).  Under every policy but ``none`` the flash forward runs again in
the backward: two sm90 forward launches a layer a step, one dq and one
dkv.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common import basics
from ..common.device import resolve_device
from ..ops.flash_attention import (
    flash_attention, flash_chunk_attention, flash_decode_paged,
)
from ..parallel.ring_attention import ring_attention
from ..parallel.tensor_parallel import copy_to_tp, reduce_from_tp
from ._remat import remat_call

_NORM_EPS = 1e-5

# Named activation-remat policies for the decoder blocks (the JAX
# package's names; each value names the jax.checkpoint_policies member
# the policy mirrors, None = save nothing or no remat).  What the
# backward may read from the forward without recomputing:
#   none          — every intermediate saved (no remat)
#   dots          — every product's output saved, the rest recomputed
#   dots_no_batch — the outputs of products without a batch dimension
#                   saved (a decoder block's projections; the dense
#                   attention's batched products are recomputed)
#   full          — nothing but the block input
REMAT_POLICIES = {
    "none": None,
    "dots": "checkpoint_dots",
    "dots_no_batch": "checkpoint_dots_with_no_batch_dims",
    "full": None,
}


def resolve_remat_policies(policy, num_layers: int,
                           default: str = "none"):
    """Normalize a remat-policy selection to one name per block.

    ``policy`` may be None (→ ``default`` everywhere), a single policy
    name applied to every block, or a sequence of ``num_layers`` names
    selecting per block (e.g. remat only the deep half of the stack).
    """
    if policy is None:
        policy = default
    if isinstance(policy, str):
        policies = (policy,) * num_layers
    else:
        policies = tuple(policy)
        if len(policies) != num_layers:
            raise ValueError(
                f"per-block remat policy needs {num_layers} entries, "
                f"got {len(policies)}"
            )
    for p in policies:
        if p not in REMAT_POLICIES:
            raise ValueError(
                f"unknown remat policy {p!r}; expected one of "
                f"{sorted(REMAT_POLICIES)}"
            )
    return policies


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Model shape and numerics (the JAX config's fields this port runs;
    ``d_model = num_heads * head_dim``)."""

    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 12
    #: GQA: K/V heads shared by num_heads/num_kv_heads query heads each
    #: (None = MHA)
    num_kv_heads: Optional[int] = None
    head_dim: int = 64
    mlp_ratio: int = 4
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    #: 'dot' | 'flash' | 'ring' | 'ring_flash' (the paged serving path
    #: runs the kernel for 'dot' and 'flash' and refuses the ring impls)
    attention_impl: str = "dot"
    #: the ring impls' sequence axis (the reference's mesh axis name).  A
    #: port with one process per GPU has one axis, so any name means the
    #: sequence is sharded over the world group, in rank order: each
    #: rank feeds its S_local tokens, and default positions become global
    #: (``rank * S_local + arange``).  None keeps shard-local default
    #: positions (the ring itself still spans the world)
    seq_axis_name: Optional[str] = None
    causal: bool = True
    #: sliding window: each token attends the last `window` positions,
    #: itself included
    window: Optional[int] = None
    #: remat every block in training; legacy switch: True ≡
    #: remat_policy="dots_no_batch"
    remat: bool = False
    #: None (derive from ``remat``), a REMAT_POLICIES name for every
    #: block, or a tuple of num_layers names, one per block — e.g.
    #: ("none",)*6 + ("full",)*6 remats only the deep half
    remat_policy: Any = None
    #: Megatron-style tensor sharding: the process set (the reference's
    #: mesh axis) the model's weights are sliced over.  With a set of n
    #: ranks each rank holds H/n query heads, H_kv/n kv heads (the
    #: paged pool shards with them) and F/n of the MLP hidden, and the
    #: two row-parallel projections (attention output, MLP down) end in
    #: ONE all-reduce each: two a block.  None or a set of one is the
    #: unsharded model.  num_heads, num_kv_heads and d_model*mlp_ratio
    #: must divide by the set's size.
    shard_axis: Any = None

    def __post_init__(self):
        kv = self.num_kv_heads
        if kv is not None and (kv <= 0 or self.num_heads % kv):
            raise ValueError(
                f"num_heads ({self.num_heads}) must be a multiple of "
                f"num_kv_heads ({kv})")
        tp = self.shards
        if tp > 1:
            hidden = self.d_model * self.mlp_ratio
            if self.num_heads % tp or self.kv_heads % tp or hidden % tp:
                raise ValueError(
                    f"shard_axis of size {tp} must divide num_heads "
                    f"({self.num_heads}), num_kv_heads ({self.kv_heads}) "
                    f"and d_model*mlp_ratio ({hidden})")
        if self.window is not None and self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.remat_policy is not None:
            # normalize early so invalid names fail at config build, and
            # store a hashable tuple (the dataclass is frozen/hashable)
            object.__setattr__(
                self, "remat_policy",
                self.remat_policy if isinstance(self.remat_policy, str)
                else tuple(self.remat_policy))
            resolve_remat_policies(self.remat_policy, self.num_layers)

    def block_remat_policies(self):
        """Per-block policy names (``remat_policy`` resolved, with the
        legacy ``remat`` bool as the default)."""
        return resolve_remat_policies(
            self.remat_policy, self.num_layers,
            default="dots_no_batch" if self.remat else "none")

    @property
    def d_model(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def shards(self) -> int:
        """Size of ``shard_axis`` (1 without one)."""
        return 1 if self.shard_axis is None else self.shard_axis.size()


def rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding; x: (B, S, H, D), positions: (B, S).
    ``freqs`` is built in float64 numpy and used in fp32, as in flax."""
    d = x.shape[-1]
    freqs = 1.0 / (10000.0 ** (np.arange(0, d, 2) / d))
    freqs = torch.as_tensor(freqs, dtype=torch.float32, device=x.device)
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sliding_mask(q_pos, k_pos, causal=True, window=None):
    """(Sq, Sk) bool mask: causal ``q_pos >= k_pos``; window: the last
    ``window`` positions, itself included (symmetric when
    bidirectional)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    delta = q_pos[:, None] - k_pos[None, :]
    mask = (delta >= 0) if causal else torch.ones_like(delta, dtype=torch.bool)
    if window is not None:
        reach = delta if causal else delta.abs()
        mask = mask & (reach < window)
    return mask


def causal_dot_attention(q, k, v, *, q_offset=0, k_offset=0, causal=True,
                         window=None):
    """Dense attention; q: (B, S, H, D), k/v: (B, S, H_kv, D), H_kv | H
    (GQA grouped in the einsums, nothing repeated).  Logits in the input
    dtype divided by sqrt(D) in that dtype, softmax in fp32, probabilities
    cast back to the input dtype — the JAX oracle's numerics."""
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    if h_kv <= 0 or h % h_kv:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({h_kv})")
    scale = torch.tensor(math.sqrt(d), dtype=torch.float32).to(q.dtype)
    qg = q.reshape(b, s_q, h_kv, h // h_kv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).reshape(
        b, h, s_q, s_k) / scale.to(q.device)
    logits = logits.float()
    if causal or window is not None:
        mask = sliding_mask(
            q_offset + torch.arange(s_q, device=q.device),
            k_offset + torch.arange(s_k, device=q.device),
            causal=causal, window=window)
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum(
        "bhgqk,bkhd->bqhgd", probs.reshape(b, h_kv, h // h_kv, s_q, s_k), v,
    ).reshape(b, s_q, h, d)


def param_shapes(cfg: TransformerConfig, param_dtype=None
                 ) -> Dict[str, tuple]:
    """``{state-dict key: (shape, dtype)}`` in creation order — the one
    definition :class:`Transformer`, :func:`init_params` and the flax
    bridge share.  Matrices are ``param_dtype`` (default ``cfg.dtype``,
    the serving copy; fp32 for training masters), norm scales fp32.  Under
    ``cfg.shard_axis`` the sliced leaves have this rank's shapes."""
    tp = cfg.shards
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.num_heads // tp, cfg.kv_heads // tp
    f = d * cfg.mlp_ratio // tp
    w, n = param_dtype or cfg.dtype, torch.float32
    out = {"embed.embedding": ((cfg.vocab_size, d), w)}
    for i in range(cfg.num_layers):
        p = f"layer_{i}."
        out.update({
            p + "ln1.scale": ((d,), n),
            p + "attn.q.kernel": ((d, h, hd), w),
            p + "attn.k.kernel": ((d, kv, hd), w),
            p + "attn.v.kernel": ((d, kv, hd), w),
            p + "attn.o.kernel": ((h, hd, d), w),
            p + "ln2.scale": ((d,), n),
            p + "mlp.gate.kernel": ((d, f), w),
            p + "mlp.up.kernel": ((d, f), w),
            p + "mlp.down.kernel": ((f, d), w),
        })
    out["ln_f.scale"] = ((d,), n)
    return out


class _Weight(nn.Module):
    """One trainable parameter named like its flax leaf (``kernel`` /
    ``scale`` / ``embedding``)."""

    def __init__(self, name: str, shape, dtype, device):
        super().__init__()
        self.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device)))


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: variance in fp32, ``mul = rsqrt(var + eps) *
    scale`` in fp32, ``y = x * mul``, cast to ``dtype``."""

    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.empty((dim,), dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        mul = torch.rsqrt(var + _NORM_EPS) * self.scale
        return (xf * mul).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.cfg = cfg
        d, hd, tp = cfg.d_model, cfg.head_dim, cfg.shards
        for name, heads in (("q", cfg.num_heads), ("k", cfg.kv_heads),
                            ("v", cfg.kv_heads)):
            self.add_module(name, _Weight("kernel", (d, heads // tp, hd),
                                          cfg.dtype, device))
        self.o = _Weight("kernel", (cfg.num_heads // tp, hd, d), cfg.dtype,
                         device)

    def _proj(self, x, w):
        d, heads, hd = w.shape
        return (x @ w.reshape(d, heads * hd)).reshape(
            *x.shape[:-1], heads, hd)

    def forward(self, x, positions, paged=None, layer: int = 0):
        cfg = self.cfg
        w = cfg.dtype  # flax casts each fp32 kernel before its product
        # under shard_axis this rank projects its own heads (Megatron's
        # f in front: the input's gradient sums over the set)
        x = copy_to_tp(x, cfg.shard_axis)
        q = rope(self._proj(x, self.q.kernel.to(w)), positions)
        k = rope(self._proj(x, self.k.kernel.to(w)), positions)
        v = self._proj(x, self.v.kernel.to(w))
        if paged is not None:
            # serving path: chunk mode writes each row's chunk at its own
            # offset then attends the gathered pages with per-row global
            # offsets; decode writes the one new token then attends the
            # pages in place, through the block tables
            if cfg.attention_impl not in ("dot", "flash"):
                raise ValueError(
                    f"paged serving supports attention_impl 'dot'/'flash', "
                    f"not {cfg.attention_impl!r}")
            if not cfg.causal:
                raise ValueError("paged serving requires causal=True")
            if paged.mode == "chunk":
                paged.write_chunk(layer, k, v)
                gk, gv, kv_start = paged.gather(
                    layer, window=cfg.window, q_span=k.shape[1])
                out = flash_chunk_attention(
                    q, gk, gv, paged.lens, window=cfg.window,
                    kv_start=kv_start)
            else:
                paged.write_decode(layer, k, v)
                out = flash_decode_paged(
                    q, paged.k, paged.v, paged.tables, paged.lens + 1,
                    layer=layer, window=cfg.window,
                    max_pages=paged.gather_pages)
        elif cfg.attention_impl in ("ring", "ring_flash"):
            out = ring_attention(
                q, k, v, axis_name=cfg.seq_axis_name,
                impl="flash" if cfg.attention_impl == "ring_flash"
                else "dense", causal=cfg.causal, window=cfg.window)
        elif cfg.attention_impl == "flash":
            out = flash_attention(q, k, v, causal=cfg.causal,
                                  window=cfg.window)
        elif cfg.attention_impl != "dot":
            raise ValueError(
                f"unknown attention_impl {cfg.attention_impl!r}")
        else:
            out = causal_dot_attention(q, k, v, causal=cfg.causal,
                                       window=cfg.window)
        h, hd, d = self.o.kernel.shape
        out = out.reshape(*out.shape[:-2], h * hd) @ \
            self.o.kernel.to(w).reshape(h * hd, d)
        # row-parallel: the local heads' partial outputs, one all-reduce
        return reduce_from_tp(out, cfg.shard_axis)


class MlpBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_model * cfg.mlp_ratio // cfg.shards
        self.dtype = cfg.dtype
        self.shard_axis = cfg.shard_axis
        self.gate = _Weight("kernel", (d, f), cfg.dtype, device)
        self.up = _Weight("kernel", (d, f), cfg.dtype, device)
        self.down = _Weight("kernel", (f, d), cfg.dtype, device)

    def forward(self, x):
        w = self.dtype
        x = copy_to_tp(x, self.shard_axis)
        out = (F.silu(x @ self.gate.kernel.to(w))
               * (x @ self.up.kernel.to(w))) @ self.down.kernel.to(w)
        return reduce_from_tp(out, self.shard_axis)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.mlp = MlpBlock(cfg, device)

    def forward(self, x, positions, paged=None, layer: int = 0):
        x = x + self.attn(self.ln1(x), positions, paged=paged, layer=layer)
        return x + self.mlp(self.ln2(x))


class Transformer(nn.Module):
    """Decoder-only LM: ``forward(tokens, positions=None, paged=None) ->
    logits`` (in ``cfg.dtype``, as flax's ``Embed.attend`` returns them).
    In training mode with grad enabled and no ``paged`` state, each
    block remats under ``cfg.block_remat_policies()``.

    ``params`` (a state dict as from :func:`init_params` or
    :func:`~horovod_tpu_torch.models.convert.params_from_flax`, matrices
    in ``cfg.dtype`` or fp32) is adopted without a copy, on the device it
    lies on; without it the weights are uninitialized storage on
    ``device`` (default: the first CUDA card; raises without one).  Every
    weight is a trainable parameter."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.cfg = cfg
        build_on = "meta" if params is not None else resolve_device(device)
        self.embed = _Weight("embedding", (cfg.vocab_size, cfg.d_model),
                             cfg.dtype, build_on)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", Block(cfg, build_on))
        self.ln_f = RMSNorm(cfg.d_model, cfg.dtype, build_on)
        if params is not None:
            for key, (shape, dtype) in param_shapes(cfg).items():
                t = params.get(key)
                allowed = (dtype,) if key.endswith(".scale") else \
                    (cfg.dtype, torch.float32)
                if t is None or tuple(t.shape) != shape \
                        or t.dtype not in allowed:
                    got = None if t is None else (tuple(t.shape), t.dtype)
                    raise ValueError(
                        f"param {key}: want {shape} in {allowed}, got {got}")
            self.load_state_dict(params, strict=True, assign=True)

    def forward(self, tokens, positions=None, paged=None):
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
            if cfg.attention_impl in ("ring", "ring_flash") and \
                    cfg.seq_axis_name:
                # the sequence is sharded over the ranks: global position
                # = rank * S_local + local offset (RoPE must match the
                # global offsets ring attention masks with)
                positions = positions + basics.rank() * tokens.shape[1]
            positions = positions.expand(tokens.shape)
        # nn.Embed: the gathered rows in cfg.dtype
        x = self.embed.embedding[tokens].to(cfg.dtype)
        # remat where the JAX model applies it: training, never serving
        remat = self.training and torch.is_grad_enabled() and paged is None
        policies = cfg.block_remat_policies() if remat else None
        for i in range(cfg.num_layers):
            block = getattr(self, f"layer_{i}")
            if policies is None:
                x = block(x, positions, paged, i)
            else:
                x = remat_call(block, policies[i], x, positions)
        x = self.ln_f(x)
        # flax Embed.attend: the fp32 query and the table, cast to
        # cfg.dtype
        return x.float().to(cfg.dtype) @ self.embed.embedding.to(
            cfg.dtype).t()


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None, param_dtype=None) -> Dict[str, torch.Tensor]:
    """Random weights at flax's init scales, made on ``device`` from
    ``generator`` (which must live on that device): embedding
    ``N(0, 1/d_model)``; every kernel lecun-normal (a normal truncated at
    two standard deviations, scaled so its std is ``1/sqrt(fan_in)``,
    fan_in = the contracted input width); norm scales ones.  Matrices
    come in ``param_dtype``: ``cfg.dtype`` by default (serving), fp32
    for the training masters."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for key, (shape, dtype) in param_shapes(cfg, param_dtype).items():
            # drawn in fp32, then cast (as flax casts its fp32 params)
            t = torch.empty(shape, dtype=torch.float32, device=dev)
            if key.endswith(".scale"):
                t.fill_(1.0)
            elif key == "embed.embedding":
                t.normal_(0.0, 1.0 / math.sqrt(cfg.d_model),
                          generator=generator)
            else:
                fan_in = shape[0] * shape[1] if key.endswith("o.kernel") \
                    else shape[0]
                std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            out[key] = t.to(dtype)
    return out


def modeled_activation_bytes(cfg: TransformerConfig, batch: int,
                             seq: Optional[int] = None) -> dict:
    """Modeled forward-to-backward activation bytes under the config's
    remat policies: the JAX package's model, copied unchanged (its
    tests pin the arithmetic), with ``act`` the itemsize of
    ``cfg.dtype``.

    Counts, per block, the tensors the backward reads without
    recomputation (attention-impl-agnostic: flash never materializes
    the S×S probabilities):

      none          — block input, ln1/ln2 outputs, q, k, v, attention
                      context, gate, up, silu(gate)*up
      dots          — block input + matmul outputs only (q, k, v,
                      context, o-proj, gate, up, down-proj)
      dots_no_batch — block input only (the model's own account; JAX's
                      policy in fact keeps the projection outputs, as
                      the port's does: ROADMAP.md §C2)
      full          — block input only

    Returns ``{"total_bytes", "per_block_bytes": {policy: bytes},
    "policies"}``; ``total_bytes`` sums the per-block figure over the
    resolved per-block policies.
    """
    s = int(seq if seq is not None else cfg.max_seq_len)
    act = cfg.dtype.itemsize
    kv_heads = cfg.num_kv_heads or cfg.num_heads
    bsd = batch * s * cfg.d_model * act          # one (B, S, D) tensor
    kv = 2 * batch * s * kv_heads * cfg.head_dim * act   # K and V
    f = batch * s * cfg.d_model * cfg.mlp_ratio * act    # one MLP hidden
    per_block = {
        "none": 5 * bsd + kv + 3 * f,   # input, ln1, q, ctx, ln2 + k,v
                                        # + gate, up, silu(gate)*up
        "dots": 5 * bsd + kv + 2 * f,   # input, q, ctx, o, down + k,v
                                        # + gate, up
        "dots_no_batch": bsd,           # block input only
        "full": bsd,                    # block input only
    }
    policies = cfg.block_remat_policies()
    return {
        "total_bytes": sum(per_block[p] for p in policies),
        "per_block_bytes": per_block,
        "policies": policies,
    }


# Named sizes (the JAX package's presets).
def gpt_small(**kw) -> TransformerConfig:
    """GPT-2-small widths: 12 layers, 12 heads of 64, d_model 768 (depth
    may be cut with ``num_layers``)."""
    kw.setdefault("num_layers", 12)
    return TransformerConfig(num_heads=12, head_dim=64, **kw)


def gpt_tiny(**kw) -> TransformerConfig:
    return TransformerConfig(vocab_size=256, num_layers=2, num_heads=2,
                             head_dim=16, max_seq_len=128, **kw)


def llama_7b(**kw) -> TransformerConfig:
    return TransformerConfig(vocab_size=32000, num_layers=32, num_heads=32,
                             head_dim=128, max_seq_len=4096, **kw)


def llama3_8b(**kw) -> TransformerConfig:
    """Llama-3-8B layout: GQA with 8 K/V heads over 32 query heads."""
    kw.setdefault("num_layers", 32)
    return TransformerConfig(vocab_size=128256, num_heads=32,
                             num_kv_heads=8, head_dim=128,
                             max_seq_len=8192, **kw)
