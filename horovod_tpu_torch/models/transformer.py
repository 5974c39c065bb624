"""GPT-style decoder-only transformer in PyTorch (forward only).

Port of ``horovod_tpu/models/transformer.py`` for serving: the same
config, the same pre-norm blocks (RMSNorm eps 1e-5, RoPE, GQA
attention, SiLU-gated MLP, tied embedding) and the same numerics, so
logits match the flax model on the same weights.  Two attention paths:

* ``paged`` (the serving engine's): K/V are written into and gathered
  from the paged cache (``serving/kv_cache.py``) and attention runs
  through the hand-written kernel of ``ops/flash_attention.py`` — for
  ``attention_impl`` "dot" and "flash" alike, as in the JAX package;
* the plain dense ``"dot"`` path (:func:`causal_dot_attention`), which
  the cache-free oracle uses.

A non-paged ``"flash"`` forward needs the backward kernels and comes
with the training slice; it raises ``NotImplementedError`` until then.

Weights keep the flax layout and names (``embed.embedding``,
``layer_{i}.attn.{q,k,v}.kernel`` (D, H, hd), ``attn.o.kernel``
(H, hd, D), ``mlp.{gate,up,down}.kernel``, ``ln{1,2}.scale``,
``ln_f.scale``).  Matrices are stored in ``cfg.dtype``: flax casts its
fp32 kernels to ``cfg.dtype`` before every product, so storing them cast
is bit-equivalent.  Norm scales stay fp32 (flax multiplies them in fp32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common.device import resolve_device
from ..ops.flash_attention import flash_chunk_attention, flash_decode_attention

_NORM_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Model shape and numerics (the JAX config's serving-relevant
    fields; ``d_model = num_heads * head_dim``)."""

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
    #: 'dot' | 'flash' (the paged serving path runs the kernel for both)
    attention_impl: str = "dot"
    causal: bool = True
    #: sliding window: each token attends the last `window` positions,
    #: itself included
    window: Optional[int] = None

    def __post_init__(self):
        kv = self.num_kv_heads
        if kv is not None and (kv <= 0 or self.num_heads % kv):
            raise ValueError(
                f"num_heads ({self.num_heads}) must be a multiple of "
                f"num_kv_heads ({kv})")
        if self.window is not None and self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")

    @property
    def d_model(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


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


def param_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """``{state-dict key: (shape, dtype)}`` in creation order — the one
    definition :class:`Transformer`, :func:`init_params` and the flax
    bridge share."""
    d, hd, h, kv = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.kv_heads
    f = d * cfg.mlp_ratio
    w, n = cfg.dtype, torch.float32
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
    """One parameter named like its flax leaf (``kernel`` / ``scale`` /
    ``embedding``)."""

    def __init__(self, name: str, shape, dtype, device):
        super().__init__()
        self.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device),
            requires_grad=False))


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: variance in fp32, ``mul = rsqrt(var + eps) *
    scale`` in fp32, ``y = x * mul``, cast to ``dtype``."""

    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.empty((dim,), dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        mul = torch.rsqrt(var + _NORM_EPS) * self.scale
        return (xf * mul).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        for name, heads in (("q", cfg.num_heads), ("k", cfg.kv_heads),
                            ("v", cfg.kv_heads)):
            self.add_module(name, _Weight("kernel", (d, heads, hd),
                                          cfg.dtype, device))
        self.o = _Weight("kernel", (cfg.num_heads, hd, d), cfg.dtype, device)

    def _proj(self, x, w):
        d, heads, hd = w.shape
        return (x @ w.reshape(d, heads * hd)).reshape(
            *x.shape[:-1], heads, hd)

    def forward(self, x, positions, paged=None, layer: int = 0):
        cfg = self.cfg
        q = rope(self._proj(x, self.q.kernel), positions)
        k = rope(self._proj(x, self.k.kernel), positions)
        v = self._proj(x, self.v.kernel)
        if paged is not None:
            # serving path: chunk mode writes each row's chunk at its own
            # offset then attends the gathered pages with per-row global
            # offsets; decode writes the one new token then attends
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
                gk, gv, kv_start = paged.gather(layer, window=cfg.window)
                out = flash_decode_attention(
                    q, gk, gv, paged.lens + 1, window=cfg.window,
                    kv_start=kv_start)
        elif cfg.attention_impl == "flash":
            raise NotImplementedError(
                "the non-paged flash forward needs the backward kernels and "
                "comes with the training slice; use attention_impl='dot' or "
                "the paged serving path")
        elif cfg.attention_impl != "dot":
            raise NotImplementedError(
                f"attention_impl {cfg.attention_impl!r} is not ported yet")
        else:
            out = causal_dot_attention(q, k, v, causal=cfg.causal,
                                       window=cfg.window)
        h, hd, d = self.o.kernel.shape
        return out.reshape(*out.shape[:-2], h * hd) @ \
            self.o.kernel.reshape(h * hd, d)


class MlpBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_model * cfg.mlp_ratio
        self.gate = _Weight("kernel", (d, f), cfg.dtype, device)
        self.up = _Weight("kernel", (d, f), cfg.dtype, device)
        self.down = _Weight("kernel", (f, d), cfg.dtype, device)

    def forward(self, x):
        return (F.silu(x @ self.gate.kernel) * (x @ self.up.kernel)) \
            @ self.down.kernel


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

    ``params`` (a state dict as from :func:`init_params` or
    :func:`~horovod_tpu_torch.models.convert.params_from_flax`) is
    adopted without a copy, on the device it lies on; without it the
    weights are uninitialized storage on ``device`` (default: the first
    CUDA card; raises without one)."""

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
            want = param_shapes(cfg)
            for key, (shape, dtype) in want.items():
                t = params.get(key)
                if t is None or tuple(t.shape) != shape or t.dtype != dtype:
                    got = None if t is None else (tuple(t.shape), t.dtype)
                    raise ValueError(
                        f"param {key}: want {(shape, dtype)}, got {got}")
            self.load_state_dict(params, strict=True, assign=True)

    def forward(self, tokens, positions=None, paged=None):
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(
                tokens.shape[1], device=tokens.device).expand(tokens.shape)
        x = self.embed.embedding[tokens]
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, positions, paged, i)
        x = self.ln_f(x)
        # flax Embed.attend: the fp32 query is cast back to cfg.dtype
        return x.float().to(cfg.dtype) @ self.embed.embedding.t()


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Dict[str, torch.Tensor]:
    """Random weights at flax's init scales, made on ``device`` from
    ``generator`` (which must live on that device): embedding
    ``N(0, 1/d_model)``; every kernel lecun-normal (a normal truncated at
    two standard deviations, scaled so its std is ``1/sqrt(fan_in)``,
    fan_in = the contracted input width); norm scales ones."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for key, (shape, dtype) in param_shapes(cfg).items():
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


# Named sizes (the JAX package's presets).
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
