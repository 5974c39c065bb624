"""Weights carried across from and back to the JAX package.

:func:`params_from_flax` takes the JAX ``Transformer``'s params tree as
numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX side) and
returns the port's state dict: the same leaf names, ``/`` becoming
``.`` (``embed/embedding`` -> ``embed.embedding``,
``layer_3/attn/q/kernel`` -> ``layer_3.attn.q.kernel``), norm scales
fp32 and matrices either cast to ``cfg.dtype`` (the serving copy: what
flax does before each product) or kept fp32 (``param_dtype=
torch.float32``: the training masters, as flax keeps them).
:func:`params_to_numpy_tree` goes back, so trained weights can be laid
beside the JAX ones.  :func:`resnet_params_from_flax` and
:func:`resnet_params_to_flax` do the same for the ResNet (and the small
models): the flax names, conv kernels HWIO <-> OIHW, ``batch_stats`` <->
the norms' running buffers.  :func:`shard_params` slices a full
``Transformer`` tree for one rank of a tensor-sharded model, and
:func:`multi_axis_params_from_flax` takes the JAX
``MultiAxisTransformer``'s global tree to one rank's slices.  This
module never imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..parallel.tensor_parallel import shard_slice, transformer_shard_specs
from .transformer import TransformerConfig, param_shapes


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def params_from_flax(np_tree: Mapping, cfg: TransformerConfig,
                     device=None, param_dtype=None
                     ) -> Dict[str, torch.Tensor]:
    """The port's state dict from a flax params tree of numpy arrays,
    matrices in ``param_dtype`` (default ``cfg.dtype``).  Every leaf the
    config needs must be present with its flax shape, and nothing else
    may be: a mismatch raises ``ValueError``."""
    from ..common.device import resolve_device

    dev = resolve_device(device)
    flat = _flatten(np_tree)
    want = param_shapes(cfg, param_dtype)
    extra = sorted(set(flat) - set(want))
    missing = sorted(set(want) - set(flat))
    if extra or missing:
        raise ValueError(f"params tree does not match the config: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    out: Dict[str, torch.Tensor] = {}
    for key, (shape, dtype) in want.items():
        arr = flat[key]
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: flax shape {arr.shape}, config wants "
                             f"{shape}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))  # own copy
        out[key] = t.to(device=dev, dtype=dtype)
    return out


def shard_params(params: Mapping, cfg: TransformerConfig, rank: int,
                 shards: int) -> dict:
    """Rank ``rank``'s slices of a full ``Transformer`` tree — the
    port's state dict or a flax-shaped nested tree of numpy arrays or
    tensors — for ``shards``-way tensor sharding
    (:func:`~horovod_tpu_torch.parallel.tensor_parallel.
    transformer_shard_specs`: q/k/v and o on their head dim, gate/up
    and down on F, each cut into ``shards`` contiguous slices as
    ``shard_map`` cuts them); replicated leaves pass through.  Each cut
    leaf is a copy that owns its memory, so the full tree can be freed.
    Raises ``ValueError`` when ``shards`` does not divide the heads,
    the kv heads and the MLP hidden, or when a leaf is not at its full
    shape."""
    hidden = cfg.d_model * cfg.mlp_ratio
    if shards < 1 or cfg.num_heads % shards or cfg.kv_heads % shards \
            or hidden % shards:
        raise ValueError(
            f"shards ({shards}) must divide num_heads ({cfg.num_heads}), "
            f"num_kv_heads ({cfg.kv_heads}) and d_model*mlp_ratio "
            f"({hidden})")
    if not 0 <= rank < shards:
        raise ValueError(f"rank {rank} outside {shards} shards")
    full = {k: shape for k, (shape, _) in param_shapes(cfg).items()}

    def walk(tree, specs, prefix):
        out = {}
        for key, val in tree.items():
            name = f"{prefix}{key}"
            if isinstance(val, Mapping):
                out[key] = walk(val, specs[key], name + ".")
                continue
            if tuple(val.shape) != full.get(name, tuple(val.shape)):
                raise ValueError(f"{name}: shape {tuple(val.shape)}, the "
                                 f"full tree's is {full[name]}")
            if specs[key] is None or shards == 1:
                out[key] = val
            else:
                cut = shard_slice(val, specs[key], rank, shards)
                out[key] = cut.clone(memory_format=torch.contiguous_format) \
                    if isinstance(cut, torch.Tensor) else np.array(cut)
        return out

    return walk(params, transformer_shard_specs(params), "")


def multi_axis_params_from_flax(np_tree: Mapping, model, mesh=None
                                ) -> Dict[str, torch.Tensor]:
    """This rank's state dict for ``model`` (a
    :class:`~horovod_tpu_torch.parallel.sharded.MultiAxisTransformer`)
    from the JAX ``MultiAxisTransformer``'s GLOBAL params tree (numpy
    arrays, as ``init_sharded`` lays them out): every tp-sharded leaf
    cut on its ``param_specs`` dimension into the tp ranks' contiguous
    slices — the fused ``qkv`` kernel's slice is this rank's
    ``(3, H/tp, d)`` columns, as ``shard_map`` hands them to each chip —
    and the rest taken whole.  ``mesh`` defaults to the model's."""
    from ..parallel.sharded import param_specs

    mesh = mesh or model.mesh
    flat = _flatten(np_tree)
    want = model.state_dict()
    extra = sorted(set(flat) - set(want))
    missing = sorted(set(want) - set(flat))
    if extra or missing:
        raise ValueError(f"flax tree does not match the model: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    specs = param_specs(model)
    out: Dict[str, torch.Tensor] = {}
    for key, target in want.items():
        dim = specs[key].index("tp") if "tp" in specs[key] else None
        arr = shard_slice(np.asarray(flat[key], dtype=np.float32), dim,
                          mesh.tp_idx, mesh.tp)
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{key}: flax shape {flat[key].shape} gives "
                             f"{arr.shape} at tp={mesh.tp}, the model "
                             f"wants {tuple(target.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=target.device, dtype=target.dtype)
    return out


def params_to_numpy_tree(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The flax-shaped nested dict of fp32 numpy arrays for a port state
    dict (``model.state_dict()``): the inverse of
    :func:`params_from_flax`'s renaming."""
    return _unflatten({key: t.detach().to("cpu", torch.float32).numpy()
                       for key, t in state_dict.items()})


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


def _conv_kernel(key: str, ndim: int) -> bool:
    return ndim == 4 and key.endswith(".kernel")


def resnet_params_from_flax(params_np: Mapping, batch_stats_np: Mapping,
                            model: torch.nn.Module
                            ) -> Dict[str, torch.Tensor]:
    """``model``'s state dict from a flax ``ResNet``'s ``params`` and
    ``batch_stats`` trees of numpy arrays (the same names: ``conv_init``,
    ``bn_init``, ``BottleneckBlock_i/Conv_k``, ``BatchNorm_k``,
    ``conv_proj``, ``norm_proj``, ``head``; the batch statistics land in
    each norm's ``mean``/``var`` buffers).  Conv kernels go from flax's
    HWIO to the port's OIHW.  Every tensor comes fp32 on the model's
    device; load it with ``model.load_state_dict``.  A name or shape
    that does not match the model raises ``ValueError``.  The small
    models (:mod:`.simple`, no ``batch_stats``) convert the same way."""
    flat = _flatten(params_np)
    stats = _flatten(batch_stats_np)
    both = sorted(set(flat) & set(stats))
    if both:
        raise ValueError(f"leaves in both params and batch_stats: {both[:5]}")
    flat.update(stats)
    want = model.state_dict()
    extra = sorted(set(flat) - set(want))
    missing = sorted(set(want) - set(flat))
    if extra or missing:
        raise ValueError(f"flax tree does not match the model: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    out: Dict[str, torch.Tensor] = {}
    for key, target in want.items():
        arr = np.array(flat[key], dtype=np.float32)  # own copy
        if _conv_kernel(key, arr.ndim):
            arr = arr.transpose(3, 2, 0, 1)
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{key}: flax shape {flat[key].shape} gives "
                             f"{arr.shape}, the model wants "
                             f"{tuple(target.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=target.device, dtype=target.dtype)
    return out


def resnet_params_to_flax(model: torch.nn.Module) -> Tuple[dict, dict]:
    """``(params, batch_stats)`` flax trees of fp32 numpy arrays for
    ``model``: the inverse of :func:`resnet_params_from_flax` (conv
    kernels back to HWIO; the norms' ``mean``/``var`` buffers into
    ``batch_stats``)."""
    buffers = {name for name, _ in model.named_buffers()}
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    for key, t in model.state_dict().items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        if _conv_kernel(key, arr.ndim):
            arr = arr.transpose(2, 3, 1, 0)
        (stats if key in buffers else params)[key] = arr
    return _unflatten(params), _unflatten(stats)
