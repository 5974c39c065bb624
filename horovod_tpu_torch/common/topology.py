"""Slice topology and the two-level (local x cross) process groups.

Port of ``horovod_tpu/common/topology.py`` for one process per GPU.
There the world is a mesh of chips and a hierarchical layout reshapes
it into a 2-D ``(dcn, ici)`` mesh; here a rank is a process, and the
same layout is a grid of world ranks: row ``d`` is slice ``d`` (the
ranks that share the fast fabric, NVLink within a host), column ``i``
holds the ranks at position ``i`` of every slice.  Each rank reduces
over two ``torch.distributed`` groups, the analog of the reference
Horovod's local and cross communicators (NCCLHierarchicalAllreduce):

* its **local** group, the ranks of its own slice (the ICI tier of the
  JAX package's names);
* its **cross** group, the ranks at its position in every slice (the
  DCN tier).

:func:`slice_ids` resolves in the reference's order:

1. ``HVD_TPU_SLICE_SIZE`` groups consecutive ranks into slices of that
   size; it must divide the world (``ValueError``);
2. one slice per host, from the launcher's placement (``local_size``
   ranks a host, ranks numbered host by host, as
   :func:`~.basics.cross_rank` assumes), when every host holds the same
   number: the GPU counterpart of the runtime's ``slice_index`` and of
   the reference's per-process fallback;
3. otherwise a single slice (no cross tier).

``init()`` resolves the layout once and, when it has more than one
slice, builds every slice's local group and every position's cross
group there, in one fixed order on every rank: ``dist.new_group`` is
collective over the world, and only ``init`` is reached by every rank
at the same point.  ``shutdown()`` drops them, and the next ``init``
(an elastic reset included) builds them anew.  A layout error (an
override that does not divide the world) is kept and raised by the
first call that needs the layout, as the reference raises from
``slice_ids()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from .retry import env_int

#: Name of the world data-parallel axis (a label here: there is no mesh).
WORLD_AXIS = "hvd"
#: Labels of the two tiers: across slices and within a slice.
DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def resolve_slice_ids(size: int, local_size: int) -> List[int]:
    """The slice of every world rank, in rank order (module docstring):
    the ``HVD_TPU_SLICE_SIZE`` override, else one slice per host when
    hosts hold equal numbers of ranks, else one slice."""
    override = env_int("HVD_TPU_SLICE_SIZE", 0)
    if override > 0:
        if size % override:
            raise ValueError(
                f"HVD_TPU_SLICE_SIZE={override} does not divide the "
                f"{size}-rank world into equal slices")
        return [r // override for r in range(size)]
    if 0 < local_size < size and size % local_size == 0:
        return [r // local_size for r in range(size)]
    return [0] * size


def slice_groups(ids: Sequence[int]) -> Optional[List[List[int]]]:
    """Ranks of each slice, slices in id order; None for a single slice
    or slices of unequal size (no rectangular local/cross split)."""
    groups: dict = {}
    for r, s in enumerate(ids):
        groups.setdefault(s, []).append(r)
    if len(groups) <= 1 or len({len(g) for g in groups.values()}) != 1:
        return None
    return [groups[s] for s in sorted(groups)]


@dataclasses.dataclass(frozen=True)
class Tiers:
    """This rank's view of the two-level layout: the rank grid
    (``grid[d][i]`` = the world rank at position ``i`` of slice ``d``),
    its own cell ``(slice_index, position)`` and its two groups."""

    grid: Tuple[Tuple[int, ...], ...]
    slice_index: int
    position: int
    local_group: Any
    cross_group: Any

    @property
    def n_dcn(self) -> int:
        """Slices: the size of the cross group."""
        return len(self.grid)

    @property
    def n_ici(self) -> int:
        """Ranks a slice: the size of the local group."""
        return len(self.grid[0])

    @property
    def size(self) -> int:
        return self.n_dcn * self.n_ici

    def slice_ids(self) -> List[int]:
        """Slice of every world rank (the tier attribution of
        ``comm_model.measured_tier_bytes``)."""
        ids = [0] * self.size
        for d, row in enumerate(self.grid):
            for r in row:
                ids[r] = d
        return ids


@dataclasses.dataclass
class Layout:
    """What ``init`` resolved: the slice ids (or the error resolving
    them raised) and, over more than one slice, this rank's tiers."""

    size: int
    ids: Optional[List[int]] = None
    error: Optional[Exception] = None
    tiers: Optional[Tiers] = None

    def slice_ids(self) -> List[int]:
        if self.error is not None:
            raise self.error
        return list(self.ids)


def build(rank: int, size: int, local_size: int) -> Layout:
    """Resolve the layout and build the groups (every rank calls this at
    the same point of ``init``, after the world group exists)."""
    import torch.distributed as dist

    try:
        ids = resolve_slice_ids(size, local_size)
    except ValueError as e:
        return Layout(size=size, error=e)
    layout = Layout(size=size, ids=ids)
    groups = slice_groups(ids)
    if groups is None:
        return layout
    # collective over the world: every rank creates every group, member
    # or not, slices first, then positions
    local = [dist.new_group(g) for g in groups]
    cross = [dist.new_group([g[i] for g in groups])
             for i in range(len(groups[0]))]
    d = next(k for k, g in enumerate(groups) if rank in g)
    i = groups[d].index(rank)
    layout.tiers = Tiers(grid=tuple(tuple(g) for g in groups),
                         slice_index=d, position=i,
                         local_group=local[d], cross_group=cross[i])
    return layout


def _layout() -> Layout:
    from .basics import _require_init

    return _require_init().layout


def slice_ids() -> List[int]:
    """The slice of every world rank, in rank order."""
    return _layout().slice_ids()


def num_slices() -> int:
    """Number of slices (cross-tier groups); 1 = no cross tier."""
    return len(set(slice_ids()))


def slice_size() -> int:
    """Ranks a slice (the local group's size)."""
    return _layout().size // num_slices()


def process_slice_groups() -> Optional[List[List[int]]]:
    """Member ranks of each slice (one process per GPU: the ranks), or
    None for a single slice or unequal slices, where the two-level
    exchanges run flat."""
    return slice_groups(slice_ids())


def tiers() -> Optional[Tiers]:
    """This rank's two-level groups, or None when the world is one
    slice.  Raises the error resolving the layout raised."""
    layout = _layout()
    if layout.error is not None:
        raise layout.error
    return layout.tiers


def hierarchical_mesh(num_groups: Optional[int] = None) -> np.ndarray:
    """The ``(dcn, ici)`` grid of world ranks for two-level reductions
    (the JAX package returns a 2-D ``Mesh`` of chips; a rank is a
    process here).  ``num_groups`` defaults to the detected slices, one
    row each, ranks in world order within a row; an explicit count
    reshapes the world into that many equal consecutive rows."""
    size = _layout().size
    if num_groups is None:
        ids = slice_ids()
        rows = [[r for r in range(size) if ids[r] == s]
                for s in sorted(set(ids))]
        return np.asarray(rows, dtype=np.int64)
    if num_groups <= 0 or size % num_groups:
        raise ValueError(f"cannot split {size} ranks into {num_groups} "
                         f"equal groups")
    return np.arange(size, dtype=np.int64).reshape(num_groups, -1)
