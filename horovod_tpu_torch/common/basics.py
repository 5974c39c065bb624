"""Lifecycle and topology over ``torch.distributed``.

Port of ``horovod_tpu/common/basics.py``.  The process model differs
from the JAX package's on purpose: there one process drives many chips
inside one SPMD program and a rank is a chip; here, as in the original
Horovod, there is **one process per GPU**, and a rank is that process.
Each rank runs its own copy of the training step, and collectives cross
processes through ``torch.distributed`` — NCCL on the card, gloo on the
CPU (what the tests use).

Where the ranks come from:

* a launcher's environment: torchrun's ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` (and ``MASTER_ADDR`` /
  ``MASTER_PORT`` for its ``env://`` rendezvous), or, where torchrun's
  are absent, the JAX package's launcher variables that this package's
  own launcher (``python -m horovod_tpu_torch.runner``) and the elastic
  rendezvous export: ``HVD_TPU_COORDINATOR`` (``host:port`` of rank 0's
  ``tcp://`` store), ``HVD_TPU_NUM_PROCESSES``, ``HVD_TPU_PROCESS_ID``,
  ``HVD_TPU_LOCAL_RANK`` and ``HVD_TPU_LOCAL_SIZE``; under the elastic
  driver (``HVD_TPU_ELASTIC=1``) :func:`init` first rendezvouses for
  this epoch's assignment;
* explicit ``rank=`` / ``size=`` / ``init_method=`` arguments (the tests
  pass a ``file://`` store in a temporary directory);
* neither: a single process is world 1, and its rendezvous is a file
  store in a fresh temporary directory — never a fixed TCP port.

``init`` resolves the slice layout and builds the two-level
collectives' local and cross groups (:mod:`.topology`).  It opens the
Chrome timeline when ``HVD_TPU_TIMELINE`` (or ``HOROVOD_TIMELINE``)
names a file, as the JAX package's Python fallback
does; :func:`start_timeline` / :func:`stop_timeline` open and close one
at runtime.  It also sets the ``hvd_tpu_process_info`` identity gauge.
"""

from __future__ import annotations

import atexit
import datetime
import os
import shutil
import tempfile
import threading
from typing import Optional, Union

import torch
import torch.distributed as dist

from ..utils.logging import get_logger
from .exceptions import NotInitializedError
from .process_sets import ProcessSetRegistry
from .retry import env_float


class _State:
    def __init__(self):
        self.lock = threading.RLock()
        self.initialized = False
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.device: Optional[torch.device] = None
        self.backend: Optional[str] = None
        self.store_dir: Optional[str] = None
        #: the ``device`` argument of the last init (an elastic reset
        #: re-initializes in process with it)
        self.device_arg = None
        #: the process group is left to process exit (see _abandon)
        self.abandoned = False
        #: the open Chrome timeline (utils/timeline.py), or None
        self.timeline = None
        #: write a CYCLE instant per gradient flush into the timeline
        self.mark_cycles = False
        self.process_set_registry = ProcessSetRegistry()
        #: the knobs read at init (utils/env_parser.Config)
        self.config = None
        #: the routed collectives' cross-hop wire, resolved at init from
        #: ``config.dcn_wire_dtype`` (compression.DcnCompression or None)
        self.dcn_compression = None
        #: the slice layout and two-level groups (common/topology.py)
        self.layout = None


_state = _State()
#: collectives that wait longer than this fail instead of hanging (and
#: the rendezvous's deadline), unless ``HVD_TPU_BOOT_TIMEOUT`` is set
_TIMEOUT_S = 600.0
#: the launcher's variables (``runner/launch.py`` and the elastic
#: rendezvous set them; a garbled value raises)
ENV_NUM_PROCESSES = "HVD_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "HVD_TPU_PROCESS_ID"
ENV_LOCAL_RANK = "HVD_TPU_LOCAL_RANK"
ENV_LOCAL_SIZE = "HVD_TPU_LOCAL_SIZE"


def _timeout() -> datetime.timedelta:
    """``init_process_group``'s timeout: ``HVD_TPU_BOOT_TIMEOUT`` seconds
    when it is > 0, else :data:`_TIMEOUT_S`.  The JAX package hands the
    variable to ``jax.distributed.initialize`` as the deadline to reach
    the coordination service; ``torch.distributed`` has one timeout for
    the rendezvous and for every collective of the group after it."""
    boot = env_float("HVD_TPU_BOOT_TIMEOUT", 0.0)
    return datetime.timedelta(seconds=boot if boot > 0 else _TIMEOUT_S)


def _env(name: str, fallback: Optional[str] = None) -> Optional[int]:
    """An integer from torchrun's variable ``name``, else from the JAX
    package's launcher variable ``fallback``."""
    for key in (name, fallback):
        raw = os.environ.get(key) if key else None
        if raw not in (None, ""):
            return int(raw)
    return None


def init(device: Optional[Union[str, torch.device]] = None, *,
         rank: Optional[int] = None, size: Optional[int] = None,
         init_method: Optional[str] = None,
         backend: Optional[str] = None) -> None:
    """Join the job (idempotent).

    ``device=None`` runs on the card ``local_rank`` over NCCL and raises
    without one; ``device="cpu"`` runs on the CPU over gloo; an explicit
    CUDA device is taken as given.  ``rank``/``size`` override the
    launcher's environment (the ranks then share one host);
    ``init_method`` is any ``torch.distributed`` URL (default:
    ``env://`` under torchrun, ``tcp://<HVD_TPU_COORDINATOR>`` under
    this package's launcher, a temporary file store for a lone
    process).  ``backend`` defaults to gloo on the CPU and NCCL on a
    card; ``backend="gloo"`` with a card lets several ranks share one
    card (NCCL refuses two ranks on one GPU), its collectives staged
    through the host.  Under the elastic driver the first call
    rendezvouses for the epoch's assignment
    (``elastic.worker.ensure_assignment``)."""
    with _state.lock:
        if _state.initialized:
            return
        if rank is None and size is None and init_method is None:
            from ..elastic.worker import ensure_assignment

            ensure_assignment()
        torchrun = _env("WORLD_SIZE") is not None
        coordinator = os.environ.get("HVD_TPU_COORDINATOR")
        launched = torchrun or _env(ENV_NUM_PROCESSES) is not None
        size = size if size is not None else (
            _env("WORLD_SIZE", ENV_NUM_PROCESSES) or 1)
        rank = rank if rank is not None else (
            _env("RANK", ENV_PROCESS_ID) or 0)
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside world of size {size}")
        local_rank = _env("LOCAL_RANK", ENV_LOCAL_RANK)
        if local_rank is None:
            local_rank = 0 if launched else rank
        local_size = _env("LOCAL_WORLD_SIZE", ENV_LOCAL_SIZE) or size
        if init_method is None and launched:
            init_method = ("tcp://" + coordinator
                           if coordinator and not torchrun else "env://")
        dev = _resolve(device, local_rank)
        from ..utils.env_parser import Config

        config = Config.from_env()
        if config.timeline_filename:  # opened first: a bad path joins nothing
            _open_timeline(config.timeline_filename,
                           config.timeline_mark_cycles, rank)
        backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
        timeout = _timeout()
        try:
            if init_method is None and size == 1 and not launched:
                _state.store_dir = tempfile.mkdtemp(prefix="hvd_torch_store_")
                store = dist.FileStore(
                    os.path.join(_state.store_dir, "store"), 1)
                dist.init_process_group(backend, store=store, rank=0,
                                        world_size=1, timeout=timeout)
            else:
                dist.init_process_group(backend, init_method=init_method or
                                        "env://", rank=rank,
                                        world_size=size, timeout=timeout)
        except BaseException:
            _close_timeline()
            raise
        _state.device_arg = device
        _state.rank, _state.size = rank, size
        _state.local_rank, _state.local_size = local_rank, local_size
        _state.device, _state.backend = dev, backend
        _state.process_set_registry.attach_world(size)
        from . import topology

        try:  # every rank builds the two-level groups here, in one order
            _state.layout = topology.build(rank, size, local_size)
        except BaseException:
            _state.process_set_registry.detach()
            dist.destroy_process_group()
            _close_timeline()
            raise
        from ..compression import dcn_compression_from_name

        _state.config = config
        _state.dcn_compression = dcn_compression_from_name(
            config.dcn_wire_dtype)
        # fault injection: this rank's HVD_TPU_CHAOS plan (no spec = one
        # module bool per injection point)
        from .. import chaos as _chaos

        _chaos.install_from_env(rank=rank)
        from ..metrics import instruments as _instruments

        # one process per GPU: the world size is the process count
        _instruments.PROCESS_INFO.labels(
            str(rank), str(local_rank), str(size), str(size)).set(1)
        _state.initialized = True
        get_logger().info("initialized: rank %d of %d on %s (%s)",
                          rank, size, dev, backend)


def _open_timeline(file_path: str, mark_cycles: bool, rank: int) -> None:
    from ..utils.timeline import Timeline

    try:
        _state.timeline = Timeline(file_path, rank=rank)
    except OSError as e:
        raise ValueError(f"cannot open {file_path!r}: {e}") from e
    _state.mark_cycles = bool(mark_cycles)


def start_timeline(file_path: str, mark_cycles: bool = True) -> None:
    """Begin writing the Chrome-trace timeline at runtime (reference:
    hvd.start_timeline / horovod_start_timeline in operations.cc) — the
    programmatic alternative to setting ``HVD_TPU_TIMELINE`` before
    init.  ``mark_cycles``: write a ``CYCLE`` instant per gradient flush
    of a training step.  Raises ``ValueError`` when a timeline is
    already open or the file cannot be opened."""
    st = _require_init()
    with st.lock:
        if st.timeline is not None:
            raise ValueError(
                "timeline already active (stop_timeline() first)")
        _open_timeline(file_path, mark_cycles, st.rank)


def stop_timeline() -> None:
    """Close the runtime timeline (reference: hvd.stop_timeline)."""
    st = _require_init()
    with st.lock:
        _close_timeline()


def _close_timeline() -> None:
    if _state.timeline is not None:
        _state.timeline.close()
        _state.timeline = None
    _state.mark_cycles = False


def _resolve(device, local_rank: int) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the ranks on the CPU over gloo")
        count = torch.cuda.device_count()
        if local_rank >= count:
            raise RuntimeError(f"local rank {local_rank} has no card "
                               f"({count} visible): one process per GPU")
        dev = torch.device("cuda", local_rank)
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               f"device is available")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def shutdown() -> None:
    """Leave the job: destroy the process group this module created and
    remove its temporary store (reference: horovod_shutdown)."""
    with _state.lock:
        if not _state.initialized:
            return
        _close_timeline()
        _state.process_set_registry.detach()
        _state.layout = None
        if dist.is_initialized() and not _state.abandoned:
            dist.destroy_process_group()
        _state.abandoned = False
        if _state.store_dir is not None:
            shutil.rmtree(_state.store_dir, ignore_errors=True)
            _state.store_dir = None
        _state.initialized = False
        _state.device = _state.backend = None


atexit.register(shutdown)


def _abandon() -> None:
    """Let :func:`shutdown` skip ``destroy_process_group``: a peer is in
    exec-restart recovery and will never take part again
    (``elastic.worker.clean_shutdown``), so the group is left to process
    exit, which closes its sockets.  Rank and size stay readable."""
    with _state.lock:
        _state.abandoned = True


def _require_init() -> _State:
    if not _state.initialized:
        raise NotInitializedError()
    return _state


def is_initialized() -> bool:
    return _state.initialized


def rank() -> int:
    """This process's rank (reference: horovod_rank)."""
    return _require_init().rank


def size() -> int:
    """Number of ranks = processes = GPUs (reference: horovod_size)."""
    return _require_init().size


def local_rank() -> int:
    """Rank among the processes of this host; picks the card."""
    return _require_init().local_rank


def local_size() -> int:
    """Processes on this host."""
    return _require_init().local_size


def cross_rank() -> int:
    """Index of this host (reference: horovod_cross_rank)."""
    st = _require_init()
    return st.rank // st.local_size


def cross_size() -> int:
    """Number of hosts (reference: horovod_cross_size)."""
    st = _require_init()
    return max(1, st.size // st.local_size)


def is_homogeneous() -> bool:
    """Equal process counts on every host."""
    st = _require_init()
    return st.size % st.local_size == 0


def device() -> torch.device:
    """The device this rank runs on."""
    return _require_init().device


# Build-capability probes (reference: horovod/common/basics.py).
def nccl_built() -> bool:
    return dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()


def mpi_built() -> bool:
    return dist.is_mpi_available()


def mpi_enabled() -> bool:
    return False  # the port runs over NCCL or gloo


def gloo_enabled() -> bool:
    return _state.initialized and _state.backend == "gloo"


def cuda_built() -> bool:
    return torch.version.cuda is not None


def rocm_built() -> bool:
    return getattr(torch.version, "hip", None) is not None


def xla_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False


def native_built() -> bool:
    """The JAX package's C++ controller core is not ported (NCCL and gloo
    do its work here)."""
    return False
