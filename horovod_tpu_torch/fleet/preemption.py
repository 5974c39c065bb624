"""Preemption notices as a first-class, chaos-drillable event.

Copied from ``horovod_tpu/fleet/preemption.py``.  Cloud preemption
arrives as SIGTERM with a short grace window; without a handler the
process dies, the driver blacklists the slot, and recovery re-prefills
from the last commit.  A *notice*, handled, is strictly better: the
worker takes a PLANNED snapshot of its live progress and leaves cleanly,
so nothing is lost and the driver books a scale-down instead of a
failure.

:class:`PreemptionGuard` implements the notice path (docs/FLEET.md):

1. **SIGTERM** (or the chaos drill below) starts the leave;
2. **report**: the driver is told ``leaving`` over the notification
   connection FIRST, so the vacating worker's clean exit is booked as a
   planned departure (``_Worker.leaving``), its slot is held against an
   immediate refill, and the survivors get a planned (failure=False)
   reset epoch;
3. **planned snapshot**: a bounded live snapshot
   (``HVD_TPU_ELASTIC_PLANNED_SNAPSHOT_SECONDS`` budget, the same
   machinery the elastic watchdog uses; host copies, ``TpuState``'s)
   falls back to the last commit if the main thread is wedged; when
   checkpoint auto-resume is armed the snapshot is ALSO published as a
   ``ckpt-<step>`` state checkpoint — from any rank — so a replacement
   worker elsewhere resumes the preempted worker's progress;
4. **leave**: ``hvd_tpu_recovery_seconds{phase="planned"}`` records
   the notice-to-exit wall time, then the process exits 0.

The chaos site ``fleet.preempt`` makes the whole path drillable: the
guard's poll thread evaluates it every ``HVD_TPU_FLEET_PREEMPT_POLL``
seconds, and a ``kill`` rule with a NEGATIVE ``code`` delivers that
signal to the process instead of exiting —
``fleet.preempt:kill,code=-15,at=4`` is a SIGTERM preemption notice on
the 4th poll, grace path and all.  ``kill`` with the default positive
code stays a hard preemption.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import Callable, Optional

from .. import chaos
from ..common.retry import env_float
from ..metrics import instruments as _instr
from ..utils.logging import get_logger

__all__ = ["PreemptionGuard"]

ENV_POLL = "HVD_TPU_FLEET_PREEMPT_POLL"


class PreemptionGuard:
    """Install with the job's elastic state to honor preemption
    notices with a planned snapshot + clean leave (module docstring).

    ``on_leave`` (optional) receives ``{"step", "planned_s",
    "snapshot"}`` just before the process exits — soak harnesses log
    it; production leaves it None."""

    def __init__(self, state, *,
                 on_leave: Optional[Callable[[dict], None]] = None,
                 poll_s: Optional[float] = None,
                 clock=time.time):
        self.state = state
        self.on_leave = on_leave
        self.poll_s = (env_float(ENV_POLL, 0.5)
                       if poll_s is None else float(poll_s))
        self._clock = clock
        self._leaving = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev_handler = None

    def install(self) -> "PreemptionGuard":
        """Arm the SIGTERM handler (main thread only — signal module
        contract) and start the notice-poll thread."""
        self._prev_handler = signal.signal(signal.SIGTERM, self._handler)
        self._thread = threading.Thread(
            target=self._poll_loop, name="hvd_tpu_fleet_preempt",
            daemon=True)
        self._thread.start()
        return self

    def uninstall(self) -> None:
        self._stop.set()
        if self._prev_handler is not None:
            signal.signal(signal.SIGTERM, self._prev_handler)
            self._prev_handler = None

    # -- notice sources ------------------------------------------------------

    def _poll_loop(self) -> None:
        """The metadata-poll stand-in: real clouds surface preemption
        through a poll or a signal; chaos drills both through the
        ``fleet.preempt`` site (a negative-code kill rule = deliver
        the signal, a plain kill = hard preemption)."""
        while not self._stop.wait(self.poll_s):
            chaos.point("fleet.preempt")

    def _handler(self, signum, frame) -> None:
        # handlers must return fast; the leave runs on its own thread
        # (the main thread is mid-training and the snapshot machinery
        # is deadline-bounded against exactly that)
        if self._leaving.is_set():
            return
        self._leaving.set()
        get_logger().warning(
            "fleet: preemption notice (signal %d) — planned snapshot, "
            "then leaving", signum)
        threading.Thread(target=self._leave, name="hvd_tpu_fleet_leave",
                         daemon=True).start()

    # -- the leave -----------------------------------------------------------

    def _leave(self) -> None:
        from ..elastic import worker as _worker

        t0 = self._clock()
        _instr.FLEET_PREEMPTIONS.inc()
        budget = env_float("HVD_TPU_ELASTIC_PLANNED_SNAPSHOT_SECONDS",
                           30.0)
        # 1) tell the driver FIRST: the 'leaving' mark must be in place
        #    before our exit code 0 can be observed, or the driver
        #    books job completion / failure instead of a scale-down.
        #    report_leaving blocks for the driver's ack (deterministic);
        #    an un-acked report (old driver, lost conn) gets a small
        #    grace as a best effort
        if _worker.elastic_enabled():
            acked = _worker.notification_manager.report_leaving(
                "preemption notice; planned snapshot then leave")
            if not acked:
                time.sleep(0.25)
        # 2) planned snapshot: bounded live attempt, commit fallback —
        #    the same keep-state contract as the planned watchdog
        snap, ok = _worker._bounded_live_snapshot(self.state, budget)
        kind = "live"
        if not ok:
            snap = getattr(self.state, "_saved", None)
            kind = "commit" if snap is not None else "none"
            if snap is None:
                get_logger().error(
                    "fleet: no live snapshot and no commit — leaving "
                    "bare; progress on this worker since boot is lost")
        # 3) publish for the fleet: with auto-resume armed, the
        #    snapshot becomes a state checkpoint ANY replacement can
        #    pick up (save_state_checkpoint's rank-0 gate is bypassed —
        #    the preempted worker IS the authority on its progress)
        ckpt_dir = getattr(self.state, "_resume_dir", None)
        step = 0
        if snap is not None:
            step_attr = getattr(self.state, "_resume_step_attr", "step")
            try:
                step = int(getattr(self.state, step_attr, 0))
            except (TypeError, ValueError):
                step = 0
            if ckpt_dir:
                from .. import checkpoint as _ckpt

                try:
                    _ckpt.save_state_checkpoint(
                        ckpt_dir, self.state, step, snapshot=snap,
                        all_ranks=True)
                except Exception as e:
                    get_logger().warning(
                        "fleet: leave checkpoint failed (%s); the "
                        "commit/auto-resume path still applies", e)
        planned_s = self._clock() - t0
        _instr.RECOVERY_SECONDS.labels("planned").set(planned_s)
        try:
            from .. import trace as _trace
            from ..trace import flight as _flight

            _trace.event("fleet.preempt", step=step, planned_s=planned_s,
                         snapshot=kind)
            _flight.maybe_dump("preempt", extra={"step": step,
                                                 "snapshot": kind})
        except Exception:
            pass
        get_logger().warning(
            "fleet: planned leave complete in %.2fs (snapshot=%s, "
            "step=%d); exiting 0", planned_s, kind, step)
        if self.on_leave is not None:
            try:
                self.on_leave({"step": step, "planned_s": planned_s,
                               "snapshot": kind})
            except Exception:
                pass
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
