"""Framework exceptions (copied from ``horovod_tpu/common/exceptions.py``).

``HorovodInternalError`` is raised when a collective fails mid-flight and
is the signal an elastic loop catches to roll state back;
``HostsUpdatedInterrupt`` announces a membership change with the state
intact.  The elastic loop itself is not ported yet.
"""

from __future__ import annotations


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class HorovodInternalError(HorovodTpuError):
    """A collective operation failed and the communicator must be rebuilt
    (reference: horovod/common/exceptions.py)."""


class HostsUpdatedInterrupt(HorovodTpuError):
    """The elastic driver notified a membership change (reference:
    horovod/common/elastic.py).  Unlike ``HorovodInternalError`` the
    current state is intact."""

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class NotInitializedError(HorovodTpuError):
    """An API needing ``init()`` was called before initialization."""

    def __init__(self, what: str = "Framework"):
        super().__init__(
            f"{what} has not been initialized; call "
            f"horovod_tpu_torch.init() first.")


class ProcessSetError(HorovodTpuError):
    """An invalid process-set operation (reference: horovod/common/
    exceptions.py)."""
