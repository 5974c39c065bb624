"""Checkpoint save/resume helpers.

Port of ``horovod_tpu/checkpoint.py`` (reference parity: rank 0 writes a
framework checkpoint, resume re-broadcasts from root — the
``torch.save`` + ``broadcast_parameters`` + ``broadcast_optimizer_state``
pattern of Horovod's PyTorch examples):

  * :func:`save_checkpoint` — rank 0 writes ``<dir>/ckpt-<step>``: a
    ``torch.save`` of ``{"step", "model", "optimizer"}`` state dicts (the
    JAX package writes a flax msgpack of its state pytree);
  * :func:`restore_checkpoint` — loads the newest usable checkpoint with
    ``weights_only=True`` into the live :class:`~.training.TrainState`,
    in place; with ``broadcast=True`` only rank 0 reads the file and the
    state reaches every rank through the port's broadcasts;
  * :func:`save_state_checkpoint` / :func:`peek_state_checkpoint` /
    :func:`restore_state_checkpoint` — the same contract for object
    states (pickled snapshots), the elastic auto-resume feed.

The frame is the JAX package's byte for byte, so either package reads
the other's files: every write is CRASH-ATOMIC (a ``ckpt-<step>.tmp.<pid>``
temp in the same directory, fsync'd, published with ``os.replace``) and
CHECKSUMMED (``HVDTPU-CRC32`` header + 8 hex digits of the payload's
CRC32); a file failing its checksum is skipped with a loud log and the
readers fall back to the next-oldest ring entry; files without the
header load unverified.  Object-state payloads start with the
``HVDTPU-STATE1`` magic, so a cross-family read fails loudly.  The
``checkpoint.payload`` chaos site sees the exact bytes about to be
published (after the checksum, so an injected flip is detectable).
Use one family per directory: both share the ``ckpt-<step>`` names.
"""

from __future__ import annotations

import io
import os
import pickle
import re
import time
import zlib
from typing import Any, List, Optional, Tuple

import torch

from . import chaos as _chaos
from . import trace
from .common import basics
from .functions import (
    broadcast_object, broadcast_optimizer_state, broadcast_parameters,
)
from .utils.logging import get_logger

_CKPT_RE = re.compile(r"^ckpt-(\d+)$")
_TMP_RE = re.compile(r"^ckpt-\d+\.tmp\.\d+$")

#: Header distinguishing pickled object-state checkpoints from the
#: training-state ones (both live under the same ckpt-N names so
#: latest_checkpoint() serves either family).
_STATE_MAGIC = b"HVDTPU-STATE1\n"

#: Content-integrity header: ``magic + crc32 as 8 hex chars + \n`` wraps
#: every published payload (either family).  Files without it are
#: pre-checksum checkpoints and load unverified.
_CKSUM_MAGIC = b"HVDTPU-CRC32\n"
_CKSUM_HEAD = len(_CKSUM_MAGIC) + 9  # 8 hex digits + newline

#: directories whose non-state entries peek_state_checkpoint already
#: warned about (once per process)
_warned_non_state_dirs: set = set()


def _is_root() -> bool:
    return not basics.is_initialized() or basics.rank() == 0


def _atomic_publish(directory: str, name: str, payload: bytes) -> str:
    """Write ``payload`` to ``<directory>/<name>`` crash-atomically:
    unique same-directory temp (two savers can't collide), fsync, then
    ``os.replace`` — readers only ever see absent or complete files.
    The payload is wrapped in the CRC32 header; the
    ``checkpoint.payload`` chaos site sees the exact bytes about to hit
    disk (a ``drop`` rule silently loses the write)."""
    # the directory must exist even when a DROP rule loses the write:
    # the caller's pruning pass lists it unconditionally
    os.makedirs(directory, exist_ok=True)
    payload = (_CKSUM_MAGIC + b"%08x\n" % zlib.crc32(payload) + payload)
    if _chaos.active:
        out = _chaos.point("checkpoint.payload", payload)
        if out is _chaos.DROP:
            return os.path.join(directory, name)  # write silently lost
        payload = out
    path = os.path.join(directory, name)
    tmp = f"{path}.tmp.{os.getpid()}"
    with trace.span("checkpoint.publish", name=name, bytes=len(payload)):
        try:
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic publish
        except BaseException:
            # a failed/interrupted save must not leave the temp behind
            # when we still control the process (a SIGKILL leaves it
            # for _prune)
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
    return path


def _state_bytes(state: Any, step: int) -> bytes:
    buf = io.BytesIO()
    torch.save({"step": int(step), "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}, buf)
    return buf.getvalue()


def save_checkpoint(directory: str, state: Any, step: int,
                    keep: int = 3) -> Optional[str]:
    """Rank-0 checkpoint write of a :class:`~.training.TrainState` (its
    model's and optimizer's state dicts and ``step``; reference: the
    ``if hvd.rank() == 0: torch.save(...)`` idiom).  Keeps the newest
    ``keep`` entries.  Returns the path written (root only)."""
    if not _is_root():
        return None
    path = _atomic_publish(directory, f"ckpt-{int(step)}",
                           _state_bytes(state, step))
    _prune(directory, keep)
    return path


def _prune(directory: str, keep: int) -> None:
    ckpts = []
    for name in os.listdir(directory):
        if (m := _CKPT_RE.match(name)):
            ckpts.append((int(m.group(1)), name))
        elif _TMP_RE.match(name):
            # debris from a writer killed mid-save: sweep it, but only
            # once it is old (a fresh temp may belong to a concurrent
            # saver still writing)
            tmp_path = os.path.join(directory, name)
            try:
                if time.time() - os.path.getmtime(tmp_path) > 300:
                    os.remove(tmp_path)
            except OSError:
                pass
    ckpts.sort()
    for _, name in ckpts[:-keep] if keep else []:
        try:
            os.remove(os.path.join(directory, name))
        except OSError:
            pass  # a concurrent pruner got it


def _ring_newest_first(directory: str) -> List[Tuple[int, str]]:
    """Every ``ckpt-N`` in the directory as ``(step, path)``, newest
    first — the fallback order corrupt-file recovery walks."""
    if not os.path.isdir(directory):
        return []
    ckpts = sorted(
        ((int(m.group(1)), name)
         for name in os.listdir(directory)
         if (m := _CKPT_RE.match(name))),
        reverse=True,
    )
    return [(step, os.path.join(directory, name)) for step, name in ckpts]


def latest_checkpoint(directory: str) -> Optional[str]:
    ring = _ring_newest_first(directory)
    return ring[0][1] if ring else None


def _read_verified(path: str) -> Optional[bytes]:
    """Read a checkpoint file and verify its content checksum.  Returns
    the inner payload, or None (with a LOUD log) when the stored CRC32
    does not match.  Files without the checksum header pass through
    unverified."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_CKSUM_MAGIC):
        return blob  # pre-checksum checkpoint: load unverified
    head = blob[len(_CKSUM_MAGIC):_CKSUM_HEAD]
    payload = blob[_CKSUM_HEAD:]
    try:
        want = int(head[:8], 16)
    except ValueError:
        want = -1
    got = zlib.crc32(payload)
    if got != want:
        get_logger().error(
            "checkpoint: %s FAILED its content checksum (stored %s, "
            "computed %08x) — corrupt or torn file; SKIPPING it and "
            "falling back to the next-oldest ring entry",
            path, head[:8].decode("ascii", "replace"), got,
        )
        return None
    return payload


def discard_newer_than(directory: str, step: int) -> List[str]:
    """Remove every ``ckpt-N`` with ``N > step`` (the integrity guard's
    rollback primitive: checkpoints after the last verified step must
    not win auto-resume).  Returns the removed paths."""
    removed = []
    for s, path in _ring_newest_first(directory):
        if s <= step:
            break
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            pass  # a concurrent survivor's rollback got it first
    return removed


def checkpoint_step(path: str) -> Optional[int]:
    """The step encoded in a ``ckpt-N`` path, or None."""
    m = _CKPT_RE.match(os.path.basename(path))
    return int(m.group(1)) if m else None


def _load_latest(directory: str) -> Optional[dict]:
    """Newest-first ring walk: the first entry that verifies and loads
    (``weights_only=True``, onto the host), skipping checksum-failed and
    undecodable ones loudly; None when nothing usable remains."""
    for _step, path in _ring_newest_first(directory):
        payload = _read_verified(path)
        if payload is None:
            continue  # checksum failure already logged loudly
        if payload.startswith(_STATE_MAGIC):
            raise ValueError(
                f"{path} is an object STATE checkpoint "
                "(save_state_checkpoint format); restore it with "
                "restore_state_checkpoint, or keep training-state and "
                "object-state checkpoints in separate directories")
        try:
            return torch.load(io.BytesIO(payload), map_location="cpu",
                              weights_only=True)
        except Exception as e:
            get_logger().error(
                "checkpoint: %s undecodable (%s: %s); skipping it and "
                "falling back to the next-oldest ring entry",
                path, type(e).__name__, e,
            )
    return None


def _apply(state: Any, blob: dict) -> Any:
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    return state


def restore_checkpoint(directory: str, state: Any,
                       broadcast: bool = True) -> Any:
    """Restore the newest USABLE checkpoint into the live ``state`` (a
    :class:`~.training.TrainState`), in place: its model's and
    optimizer's state dicts and its step.  Returns ``state`` (unchanged
    when no checkpoint exists).

    With ``broadcast=True`` only rank 0 needs to see the file: it loads,
    and every rank then takes rank 0's parameters and buffers
    (``broadcast_parameters``), optimizer state
    (``broadcast_optimizer_state``, plus the ``param_groups``
    hyperparameters) and step.  A newest entry failing its checksum (or
    undecodable) is skipped with a loud log and the next-oldest ring
    entry loads instead."""
    multi = basics.is_initialized() and basics.cross_size() > 1
    if not multi or not broadcast:
        blob = _load_latest(directory)
        return state if blob is None else _apply(state, blob)
    blob = _load_latest(directory) if basics.rank() == 0 else None
    if not broadcast_object(blob is not None, root_rank=0):
        return state
    if blob is not None:
        _apply(state, blob)
    broadcast_parameters(state.model, root_rank=0)
    broadcast_optimizer_state(state.optimizer, root_rank=0)
    groups = broadcast_object(
        [{k: v for k, v in g.items() if k != "params"}
         for g in state.optimizer.param_groups], root_rank=0)
    for group, hyper in zip(state.optimizer.param_groups, groups):
        group.update(hyper)
    state.step = broadcast_object(state.step, root_rank=0)
    return state


# -- object-state checkpoints (elastic auto-resume feed) ----------------------


def save_state_checkpoint(directory: str, state: Any, step: int,
                          keep: int = 3, *, snapshot: Any = None,
                          all_ranks: bool = False) -> Optional[str]:
    """Persist an object state's snapshot as ``ckpt-<step>`` (rank 0
    only; crash-atomic).  The state must expose ``_snapshot()``;
    anything picklable inside survives.  ``snapshot`` publishes an
    already-taken snapshot instead; ``all_ranks=True`` bypasses the
    rank-0 gate."""
    if not all_ranks and not _is_root():
        return None
    payload = _STATE_MAGIC + pickle.dumps(
        {"step": int(step),
         "snapshot": state._snapshot() if snapshot is None else snapshot}
    )
    path = _atomic_publish(directory, f"ckpt-{int(step)}", payload)
    _prune(directory, keep)
    return path


def peek_state_checkpoint(directory: str) -> Optional[Tuple[int, Any]]:
    """Load the newest USABLE state checkpoint as ``(step, snapshot)``
    without touching any live state; None when the directory holds none
    (or only training-state checkpoints).  Usable: the checksum verifies
    (or pre-checksum format) and the pickle decodes; a corrupt newest
    entry is skipped with a loud log."""
    for _step, path in _ring_newest_first(directory):
        payload = _read_verified(path)
        if payload is None:
            continue  # checksum failure already logged loudly
        if not payload.startswith(_STATE_MAGIC):
            if directory not in _warned_non_state_dirs:
                _warned_non_state_dirs.add(directory)
                get_logger().warning(
                    "checkpoint: %s is not a state checkpoint (training-"
                    "state family, pre-checksum file, or corrupted "
                    "header); skipping such entries in the ring walk",
                    path)
            continue
        try:
            blob = pickle.loads(payload[len(_STATE_MAGIC):])
            return int(blob["step"]), blob["snapshot"]
        # a corrupt/alien file can raise nearly anything out of pickle:
        # resumability must not crash-loop a booting worker on one bad
        # file, so skip it and fall back
        except Exception as e:
            get_logger().error(
                "checkpoint: %s unusable (%s: %s); skipping it and "
                "falling back to the next-oldest ring entry",
                path, type(e).__name__, e,
            )
    return None


def restore_state_checkpoint(directory: str, state: Any) -> Optional[int]:
    """Apply the latest state checkpoint's snapshot to ``state`` (every
    rank reads locally).  Returns the restored step, or None when
    nothing was restored."""
    found = peek_state_checkpoint(directory)
    if found is None:
        return None
    step, snapshot = found
    state._apply_snapshot(snapshot)
    if hasattr(state, "save"):
        state.save()  # the restored view becomes the committed baseline
    return step
