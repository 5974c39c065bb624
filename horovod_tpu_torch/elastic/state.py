"""Elastic state: commit / restore / sync.

Port of ``horovod_tpu/elastic/state.py`` (reference parity:
horovod/common/elastic.py ``State``, ``ObjectState`` and
horovod/torch/elastic/state.py ``TorchState``).  The contract is the
same: the user registers everything that must survive a membership
change in a ``State``; ``commit()`` snapshots it (and polls for
membership updates); on failure the elastic ``run`` wrapper calls
``restore()`` and re-rendezvouses; ``sync()`` broadcasts rank 0's view to
everyone after each (re)initialization.

Snapshots hold HOST copies only (CPU tensors, numpy, plain values): an
exec-restart carries them across ``execv``, which drops the CUDA context
and the NCCL communicators with the process image, and a checkpoint
pickles them.  ``restore`` copies them back in place: a module's
``load_state_dict`` writes into its existing parameters on their device,
so the optimizer and a training step's gradient hooks (``optim.py``)
stay bound to the same ``Parameter`` objects.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def _host_copy(x: Any) -> Any:
    """A deep copy of ``x`` with every tensor a CPU copy (containers
    rebuilt, everything else deep-copied)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: _host_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and type(x) in (list, tuple):
        return type(x)(_host_copy(v) for v in x)
    return copy.deepcopy(x)


def _restore_value(current: Any, saved: Any) -> Any:
    """``saved`` as the attribute's new value: copied in place into a
    tensor of the same shape and dtype (on its own device), else a fresh
    copy (a tensor moves to the device of the tensor it replaces)."""
    if isinstance(current, torch.Tensor) and isinstance(saved, torch.Tensor):
        if current.shape == saved.shape and current.dtype == saved.dtype:
            with torch.no_grad():
                current.copy_(saved)
            return current
        return saved.to(current.device, copy=True)
    return _host_copy(saved)


def _is_optimizer(v: Any) -> bool:
    return hasattr(v, "param_groups") and hasattr(v, "state_dict")


class State:
    """Abstract elastic state (reference: common/elastic.py State)."""

    def __init__(self):
        self._reset_callbacks: List[Callable[[], None]] = []

    def register_reset_callbacks(
        self, callbacks: List[Callable[[], None]]
    ) -> None:
        """Callbacks to run after a reset changed the world size
        (reference: State.register_reset_callbacks — e.g. rescale the
        learning rate to the new number of workers)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def reset(self) -> None:
        """Framework hook invoked on world-size change."""

    def commit(self) -> None:
        """Snapshot + poll for membership updates (reference: State.commit
        = save() then check_host_updates())."""
        # chaos: the per-step injection point of the elastic worker —
        # kill,at=N self-kills at training step N (the classic elastic
        # fault); hang freezes mid-step, which only heartbeats can see
        from .. import chaos as _chaos

        if _chaos.active:
            _chaos.raise_point("elastic.commit")
        self.save()
        self.check_host_updates()

    def check_host_updates(self) -> None:
        """Raise ``HostsUpdatedInterrupt`` if the driver announced a
        membership change (reference: State.check_host_updates reading the
        WorkerNotificationManager queue)."""
        from .worker import notification_manager

        notification_manager.check_for_updates()

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    # -- checkpoint auto-resume (docs/FAULT_TOLERANCE.md) -------------------

    def enable_auto_resume(self, directory: str,
                           step_attr: str = "step") -> None:
        """Arm reset-epoch auto-resume: on every (re)boot and membership
        reset, the run wrapper restores this state from the newest
        ``checkpoint.save_state_checkpoint`` in ``directory`` IF that
        checkpoint is ahead of the state's own ``step_attr`` — a freshly
        spawned replacement worker resumes at the fleet's step instead of
        zero, and a whole-job restart resumes instead of starting over.
        Survivors (whose live state is at or past the checkpoint) keep
        their state; the post-reset ``sync()`` then converges everyone on
        rank 0's view."""
        self._resume_dir = directory
        self._resume_step_attr = step_attr

    def maybe_auto_resume(self) -> Optional[int]:
        """No-op unless :meth:`enable_auto_resume` armed a directory;
        subclasses with snapshots implement the restore."""
        return None

    def _materialize_to_host(self) -> None:
        """The JAX package converts live device arrays to host buffers
        before its backend teardown; torch tensors outlive a process
        group, and snapshots are host copies already."""


class ObjectState(State):
    """State made of arbitrary picklable attributes (reference:
    common/elastic.py ObjectState).  Tensors in attribute values are
    snapshotted as CPU copies; objects exposing ``state_dict``/
    ``load_state_dict`` (an ``nn.Module``, an optimizer, the
    ``ElasticSampler``) are snapshotted through that interface."""

    def __init__(self, **kwargs):
        super().__init__()
        self._attrs: Dict[str, Any] = {}
        for k, v in kwargs.items():
            self._attrs[k] = v
        self._saved: Optional[Dict[str, Any]] = None
        self.save()

    # Attribute routing: user fields live in _attrs so save/restore/sync
    # can enumerate them.
    def __getattr__(self, name):
        attrs = self.__dict__.get("_attrs")
        if attrs is not None and name in attrs:
            return attrs[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_") or "_attrs" not in self.__dict__:
            super().__setattr__(name, value)
        else:
            self._attrs[name] = value

    def _snapshot(self) -> Dict[str, Any]:
        snap = {}
        for k, v in self._attrs.items():
            if hasattr(v, "state_dict") and hasattr(v, "load_state_dict"):
                snap[k] = ("__state_dict__", _host_copy(v.state_dict()))
            else:
                snap[k] = ("__value__", _host_copy(v))
        return snap

    def _apply_snapshot(self, snap: Dict[str, Any]) -> None:
        for k, (kind, payload) in snap.items():
            cur = self._attrs.get(k)
            if kind == "__state_dict__" and k in self._attrs:
                # a module copies in place (its load_state_dict writes
                # into the live parameters); anything else gets its own
                # copy, so a later in-place update cannot reach the
                # committed snapshot
                cur.load_state_dict(
                    payload if isinstance(cur, torch.nn.Module)
                    else _host_copy(payload))
            else:
                self._attrs[k] = _restore_value(cur, payload)

    def save(self) -> None:
        self._saved = self._snapshot()

    def restore(self) -> None:
        if self._saved is not None:
            self._apply_snapshot(self._saved)

    def sync(self) -> None:
        """Broadcast rank 0's state to all workers (reference:
        ObjectState.sync via broadcast_object)."""
        from .. import functions

        snap = functions.broadcast_object(self._snapshot(), root_rank=0)
        self._apply_snapshot(snap)
        self.save()

    def maybe_auto_resume(self) -> Optional[int]:
        """Restore from the newest state checkpoint when it is AHEAD of
        this state (see :meth:`State.enable_auto_resume`).  Returns the
        restored step, or None when nothing applied."""
        directory = getattr(self, "_resume_dir", None)
        if not directory:
            return None
        from .. import checkpoint as _checkpoint
        from ..metrics import instruments as _metrics
        from ..utils.logging import get_logger

        # cheap gate first: the step is IN the filename, so the common
        # case (a survivor whose live state is already at/past the
        # checkpoint) never reads or unpickles the snapshot blob at all
        latest = _checkpoint.latest_checkpoint(directory)
        if latest is None:
            return None
        named_step = _checkpoint.checkpoint_step(latest)
        step_attr = getattr(self, "_resume_step_attr", "step")
        current = self._attrs.get(step_attr)
        try:
            if (current is not None and named_step is not None
                    and int(current) >= named_step):
                return None  # live state is at/past the checkpoint
        except (TypeError, ValueError):
            pass  # non-numeric step attr: the checkpoint wins
        found = _checkpoint.peek_state_checkpoint(directory)
        if found is None:
            return None
        ckpt_step, snapshot = found
        try:
            if current is not None and int(current) >= ckpt_step:
                return None  # a newer save landed between the two reads
        except (TypeError, ValueError):
            pass
        t0 = time.perf_counter()
        self._apply_snapshot(snapshot)
        self.save()
        _metrics.RECOVERY_SECONDS.labels("auto_resume").set(
            time.perf_counter() - t0)
        get_logger().info(
            "elastic: auto-resumed from checkpoint step %d (was %s)",
            ckpt_step, current,
        )
        return ckpt_step


class TpuState(ObjectState):
    """The training loop's state: an ``nn.Module``, its optimizer and any
    scalars (the counterpart of the original Horovod's ``TorchState``,
    under the JAX package's name)::

        state = hvd.elastic.TpuState(model=model, optimizer=opt,
                                     epoch=0, batch=0)

        @hvd.elastic.run
        def train(state):
            for state.epoch in range(state.epoch, epochs):
                ...
                state.commit()

    ``save``/``commit`` take host copies of the module's and the
    optimizer's state dicts; ``restore`` copies them back in place;
    ``sync`` is ``broadcast_parameters`` + ``broadcast_optimizer_state``
    from rank 0 (in place, over the fused collectives) and one
    ``broadcast_object`` for everything else."""

    def sync(self) -> None:
        from .. import functions

        rest = {}
        for k, v in self._attrs.items():
            if isinstance(v, torch.nn.Module):
                functions.broadcast_parameters(v, root_rank=0)
            elif _is_optimizer(v):
                functions.broadcast_optimizer_state(v, root_rank=0)
                rest[k] = ("__param_groups__", [
                    {g: x for g, x in group.items() if g != "params"}
                    for group in v.param_groups])
            elif hasattr(v, "state_dict") and hasattr(v, "load_state_dict"):
                rest[k] = ("__state_dict__", _host_copy(v.state_dict()))
            else:
                rest[k] = ("__value__", _host_copy(v))
        rest = functions.broadcast_object(rest, root_rank=0)
        for k, (kind, payload) in rest.items():
            if kind == "__param_groups__":
                for group, hyper in zip(self._attrs[k].param_groups,
                                        payload):
                    group.update(hyper)
            else:
                self._apply_snapshot({k: (kind, payload)})
        self.save()
