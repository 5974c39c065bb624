"""Elastic training: fault-tolerant, resizable worker sets.

Port of ``horovod_tpu/elastic`` (reference parity: horovod/common/
elastic.py + horovod/torch/elastic/* + horovod/runner/elastic/*).  Usage
mirrors the reference::

    import horovod_tpu_torch as hvd
    hvd.init()

    state = hvd.elastic.TpuState(model=model, optimizer=opt,
                                 epoch=0, batch=0)

    @hvd.elastic.run
    def train(state):
        for state.epoch in range(state.epoch, num_epochs):
            ...
            state.batch = i
            if i % 10 == 0:
                state.commit()

    train(state)

Launch with ``python -m horovod_tpu_torch.runner -np 2 --min-np 1
--max-np 4 --host-discovery-script ./discover.sh python train.py``.
"""

from __future__ import annotations

import functools

from ..common.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from .sampler import ElasticSampler
from .state import ObjectState, State, TpuState
from .worker import clean_shutdown, elastic_enabled, \
    maybe_restore_after_restart, notification_manager, reset_world, \
    restart_after_failure

__all__ = [
    "State", "ObjectState", "TpuState", "ElasticSampler", "run",
    "HorovodInternalError", "HostsUpdatedInterrupt",
]


def run(func):
    """Elastic execution wrapper (reference: common/elastic.py run_fn —
    the sync/try/catch/reset loop)."""

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        notification_manager.init()
        # the failure watchdog restarts from this state's last commit if a
        # peer dies while the main thread is stuck in a dead collective
        notification_manager.watch_state(state)
        maybe_restore_after_restart(state)
        skip_sync = False
        while True:
            # reset-epoch auto-resume (no-op unless state.enable_auto_resume
            # armed a checkpoint directory): a replacement worker with no
            # exec-restart snapshot picks up the fleet's last checkpoint
            # BEFORE sync, so a fresh rank 0 seeds peers from the
            # checkpoint instead of from scratch
            state.maybe_auto_resume()
            if not skip_sync:
                state.sync()
            try:
                result = func(state, *args, **kwargs)
                if elastic_enabled():
                    # leave the process group in lockstep rather than
                    # from interpreter-exit finalizers
                    clean_shutdown()
                return result
            except HorovodInternalError:
                # a peer died mid-collective: roll back to the last commit
                state.restore()
                if not elastic_enabled():
                    # no driver to re-rendezvous with: surface the
                    # original failure with the state restored
                    raise
                restart_after_failure(state)  # does not return
                skip_sync = False
            except HostsUpdatedInterrupt as e:
                # membership change: keep current state.  If it was caused
                # by a peer failure, take the restart path with the live
                # state snapshot instead.  The driver TOLD us about this
                # failure, so don't report it back (that would spawn a
                # fresh failure epoch for the world it is rebuilding)
                if getattr(e, "due_to_failure", False) and elastic_enabled():
                    restart_after_failure(state,  # does not return
                                          notify_driver=False)
                skip_sync = e.skip_sync
            reset_world(state)

    return wrapper
