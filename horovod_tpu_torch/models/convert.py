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
beside the JAX ones.  This module never imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

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


def params_to_numpy_tree(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The flax-shaped nested dict of fp32 numpy arrays for a port state
    dict (``model.state_dict()``): the inverse of
    :func:`params_from_flax`'s renaming."""
    tree: dict = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy()
    return tree
