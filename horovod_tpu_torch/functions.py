"""State synchronisation helpers.

Port of ``horovod_tpu/functions.py`` (reference parity:
horovod/torch/functions.py).  As in the reference's PyTorch flavour, the
parameter and optimizer-state broadcasts work **in place** on the
caller's tensors (the JAX package returns new pytrees because its arrays
are immutable), fused into per-dtype buckets so a model's hundreds of
tensors take a handful of collectives.  Every exchange goes through
the public collectives (``ops/collective_ops.py``), so it books their
counters, bytes and spans; a dead peer raises
``HorovodInternalError`` (``collective_ops.peer_failures``).
"""

from __future__ import annotations

import pickle
from typing import Any, Iterable, List, Mapping, Tuple, Union

import torch

from .common import basics
from .ops import collective_ops
from .ops.fusion import FusionPlan, fuse, fusion_threshold, unfuse


def _named_tensors(params) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict(keep_vars=True).items())
    if isinstance(params, Mapping):
        return list(params.items())
    return list(params)


def _check_root(root_rank: int) -> None:
    n = basics.size()
    if not 0 <= root_rank < n:
        raise ValueError(f"root_rank {root_rank} outside world of size {n}")


def _broadcast_inplace(tensors: List[torch.Tensor], root_rank: int) -> None:
    _check_root(root_rank)
    if not tensors:
        return
    dev = basics.device()
    with torch.no_grad():
        # the collective runs on the rank's device; host-side entries
        # (torch keeps an optimizer's step counts on the CPU) ride along
        plan = FusionPlan(tensors, fusion_threshold())
        bufs = collective_ops.broadcast(
            fuse([t.to(dev) for t in tensors], plan), root_rank)
        for t, new in zip(tensors, unfuse(bufs, plan)):
            t.copy_(new)


def broadcast_parameters(params: Union[torch.nn.Module, Mapping,
                                       Iterable[Tuple[str, torch.Tensor]]],
                         root_rank: int = 0):
    """Overwrite every rank's parameters with ``root_rank``'s, in place:
    a module, a state dict, or ``named_parameters()`` pairs (reference:
    broadcast_parameters, used at train start so every rank begins from
    identical weights).  Returns ``params``."""
    tensors = [t for _, t in _named_tensors(params)
               if isinstance(t, torch.Tensor)]
    _broadcast_inplace([t.data if isinstance(t, torch.nn.Parameter) else t
                        for t in tensors], root_rank)
    return params


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0):
    """Give every rank ``root_rank``'s per-parameter optimizer state
    (reference: broadcast_optimizer_state).

    Torch optimizers make their state lazily, at the first step, so a
    rank that has neither stepped nor loaded a checkpoint holds none.
    The root's layout (each parameter's keys, with the dtype and shape
    of each tensor entry and the value of each other entry) goes first,
    as a pickled object; every rank then lays its state out to match,
    reusing the tensors it has and allocating the ones it lacks, and
    the tensors follow in fused buckets, in place.  Hyperparameters in
    ``param_groups`` are deterministic replicas and stay local, as the
    JAX package keeps its non-array leaves.  Returns ``optimizer``."""
    _check_root(root_rank)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    layout = None
    if basics.rank() == root_rank:
        layout = [
            {key: (("tensor", value.dtype, tuple(value.shape),
                    value.device.type == "cpu")
                   if isinstance(value, torch.Tensor) else ("value", value))
             for key, value in sorted(optimizer.state.get(p, {}).items())}
            for p in params]
    layout = broadcast_object(layout, root_rank)
    if len(layout) != len(params):
        raise ValueError(f"optimizer has {len(params)} parameters, root "
                         f"rank {root_rank}'s has {len(layout)}")
    tensors = []
    for p, entries in zip(params, layout):
        have = optimizer.state.get(p, {})
        state = {}
        for key, (kind, *spec) in entries.items():
            if kind == "value":
                state[key] = spec[0]
                continue
            dtype, shape, on_host = spec
            t = have.get(key)
            if not (isinstance(t, torch.Tensor) and t.dtype == dtype
                    and tuple(t.shape) == shape):
                # torch keeps some entries (an Adam step count) on the
                # host whatever the parameter's device
                t = torch.zeros(shape, dtype=dtype,
                                device="cpu" if on_host else p.device)
            state[key] = t
            tensors.append(t)
        if state:
            optimizer.state[p] = state
        else:
            optimizer.state.pop(p, None)
    _broadcast_inplace(tensors, root_rank)
    return optimizer


def _pickled(obj: Any) -> torch.Tensor:
    """``obj`` pickled into a uint8 tensor on the rank's device."""
    data = bytearray(pickle.dumps(obj))
    return torch.frombuffer(data, dtype=torch.uint8).to(basics.device())


def _unpickled(buf: torch.Tensor) -> Any:
    return pickle.loads(buf.cpu().numpy().tobytes())


def _set_size(process_set) -> int:
    return basics._require_init().process_set_registry.resolve(
        process_set).size()


def broadcast_object(obj: Any, root_rank: int = 0, name=None,
                     process_set=None) -> Any:
    """``root_rank``'s picklable object on every rank of the set
    (reference: broadcast_object): the root pickles it, and its size,
    then its bytes, go out through two broadcasts."""
    if _set_size(process_set) == 1:
        return obj
    dev = basics.device()
    payload = _pickled(obj) if basics.rank() == root_rank else None
    size = torch.tensor([0 if payload is None else payload.numel()],
                        dtype=torch.int64, device=dev)
    size = int(collective_ops.broadcast(size, root_rank, name=name,
                                        process_set=process_set)[0])
    if payload is None:
        payload = torch.zeros(size, dtype=torch.uint8, device=dev)
    return _unpickled(collective_ops.broadcast(payload, root_rank,
                                               name=name,
                                               process_set=process_set))


def allgather_object(obj: Any, name=None, process_set=None) -> list:
    """Every set rank's picklable object, in rank order (reference:
    allgather_object): the sizes go first, then every rank's bytes,
    padded to the longest."""
    if _set_size(process_set) == 1:
        return [obj]
    payload = _pickled(obj)
    sizes = collective_ops.allgather(
        torch.tensor([payload.numel()], dtype=torch.int64,
                     device=payload.device), name=name,
        process_set=process_set).tolist()
    padded = torch.zeros((1, max(sizes)), dtype=torch.uint8,
                         device=payload.device)
    padded[0, :payload.numel()] = payload
    rows = collective_ops.allgather(padded, name=name,
                                    process_set=process_set)
    return [_unpickled(row[:n]) for row, n in zip(rows, sizes)]
