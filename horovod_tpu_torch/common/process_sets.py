"""Process sets: subsets of the world's ranks with their own collective
scope.

Port of ``horovod_tpu/common/process_sets.py``.  There a set owns a
sub-mesh of chips; here, with one process per GPU, a set owns a
``torch.distributed`` group over its ranks (``dist.new_group``), and the
collectives of :mod:`..ops.collective_ops` take ``process_set=`` to run
inside that group.  Set 0 is the world, attached at ``init()``; its
group is the default one.

``dist.new_group`` is itself collective: every process of the world
must call it, members or not, and in the same order.  So
``add_process_set`` / ``remove_process_set`` must be called
symmetrically on every process, as in the reference.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

from .exceptions import ProcessSetError


class ProcessSet:
    """A subset of world ranks with its own ``torch.distributed`` group
    (reference: horovod/common/process_set.h)."""

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        self.process_set_id: Optional[int] = None
        self.ranks: Optional[List[int]] = (sorted(ranks) if ranks is not None
                                           else None)
        self._group = None

    def _attach(self, set_id: int, group) -> None:
        self.process_set_id = set_id
        self._group = group

    @property
    def group(self):
        """The set's ``torch.distributed`` group (``None`` is the default
        group, the world's)."""
        if self.process_set_id is None:
            raise ProcessSetError(
                "process set is not attached (call add_process_set)")
        return self._group

    def size(self) -> int:
        if self.ranks is None:
            raise ProcessSetError("process set is not attached")
        return len(self.ranks)

    def rank_in_set(self, world_rank: int) -> int:
        """Position of a world rank inside this set."""
        try:
            return self.ranks.index(world_rank)
        except (ValueError, AttributeError):
            raise ProcessSetError(
                f"world rank {world_rank} is not a member of process set "
                f"{self.process_set_id}")

    def included(self, world_rank: int) -> bool:
        return self.ranks is not None and world_rank in self.ranks

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


#: The world process set, always id 0 (reference: global_process_set).
global_process_set = ProcessSet()


def _check_ranks(ranks: List[int], world_size: int) -> None:
    for r in ranks:
        if not 0 <= r < world_size:
            raise ProcessSetError(
                f"rank {r} out of range for world size {world_size}")
    if len(set(ranks)) != len(ranks):
        raise ProcessSetError(f"duplicate ranks in process set: {ranks}")


class ProcessSetRegistry:
    """Set ids to :class:`ProcessSet` (reference: process_set.cc's
    ProcessSetTable): ids are assigned monotonically, id 0 is the world,
    a removed id is not reused."""

    def __init__(self):
        self._lock = threading.Lock()
        self._table: Dict[int, ProcessSet] = {}
        self._next_id = 0
        self._world_size = 0

    def attach_world(self, world_size: int) -> None:
        with self._lock:
            self._table.clear()
            self._world_size = int(world_size)
            global_process_set.ranks = list(range(world_size))
            global_process_set._attach(0, None)
            self._table[0] = global_process_set
            self._next_id = 1

    def detach(self) -> None:
        """Forget every set (at ``shutdown()``; the groups die with the
        default process group)."""
        with self._lock:
            for ps in self._table.values():
                ps.process_set_id = None
                ps._group = None
            global_process_set.ranks = None
            self._table.clear()
            self._next_id = 0

    def add(self, process_set: ProcessSet) -> ProcessSet:
        with self._lock:
            if process_set.process_set_id is not None:
                raise ProcessSetError("process set is already registered")
            if process_set.ranks is None:
                process_set.ranks = list(range(self._world_size))
            _check_ranks(process_set.ranks, self._world_size)
            for existing in self._table.values():
                if existing.ranks == process_set.ranks:
                    raise ProcessSetError(
                        f"a process set with ranks {existing.ranks} "
                        f"already exists")
            set_id = self._next_id
            self._next_id += 1
            # collective over the world: every process creates the group,
            # members or not, in the same order
            group = dist.new_group(process_set.ranks)
            process_set._attach(set_id, group)
            self._table[set_id] = process_set
            return process_set

    def remove(self, process_set: ProcessSet) -> None:
        with self._lock:
            set_id = process_set.process_set_id
            if set_id == 0:
                raise ProcessSetError("cannot remove the global process set")
            if set_id is None or set_id not in self._table:
                raise ProcessSetError("process set is not registered")
            del self._table[set_id]
            group = process_set._group
            process_set.process_set_id = None
            process_set._group = None
            if group not in (None, dist.GroupMember.NON_GROUP_MEMBER):
                dist.destroy_process_group(group)

    def find_or_add(self, ranks: Sequence[int]) -> ProcessSet:
        """The registered set over exactly ``ranks``, else a new one
        (``add``: collective over the world, so every process calls it
        with the same ranks in the same order)."""
        want = sorted(ranks)
        with self._lock:
            for ps in self._table.values():
                if ps.ranks == want:
                    return ps
        return self.add(ProcessSet(want))

    def ids(self) -> List[int]:
        with self._lock:
            return sorted(self._table)

    def resolve(self, process_set: Optional[ProcessSet]) -> ProcessSet:
        return process_set if process_set is not None else global_process_set
