"""Worker-side elastic plumbing: driver notifications + re-rendezvous.

Port of ``horovod_tpu/elastic/worker.py`` (reference parity:
horovod/runner/elastic/worker.py WorkerNotificationService/Manager — the
in-worker listener the driver pushes ``HostsUpdated`` events to — plus
the reset path of horovod/common/elastic.py: new rendezvous, rebuilt
communicators, new rank/size).

Wire protocol (line-delimited JSON over TCP to the driver, every line
HMAC-signed with the job secret, ``common/wire_auth.py``):

  worker → driver  {"type": "register", "worker_id": k}      (persistent)
  driver → worker  {"type": "hosts_updated", "epoch": n}     (pushed)
  worker → driver  {"type": "rendezvous", "worker_id": k}    (fresh conn)
  driver → worker  {"type": "assignment", "rank": r, "num_processes": n,
                    "coordinator": "h:p", "native_port": p, "epoch": e}
               or  {"type": "shutdown"}

The assignment is exported as the launcher's ``HVD_TPU_*`` variables,
which ``basics.init`` reads: ``coordinator`` becomes rank 0's
``tcp://`` store.  A membership change of a multi-process world
exec-restarts every worker in place (same PID) with its state in a memfd
(:func:`_persist_and_exec`): the new image drops the old process group,
the CUDA context and the NCCL communicators wholesale, as the JAX
package's drops its coordination client.  A world of one re-initializes
in process (``basics.shutdown`` → rendezvous → ``basics.init``).
"""

from __future__ import annotations

import json
import os
import socket
import threading
from typing import Optional

from ..common import wire_auth
from ..common.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from ..common.retry import env_float, env_int, retry_call
from ..metrics import instruments as _metrics
from ..metrics.exposition import register_health_source
from ..utils.logging import get_logger

ENV_ELASTIC = "HVD_TPU_ELASTIC"
ENV_DRIVER = "HVD_TPU_ELASTIC_DRIVER"
ENV_WORKER_ID = "HVD_TPU_ELASTIC_WORKER_ID"
ENV_RESTORE = "HVD_TPU_ELASTIC_RESTORE"

ENV_RESTARTED = "HVD_TPU_ELASTIC_RESTARTED"
# memfd-based state handoff: the snapshot lives in RAM on an inherited
# fd (execv keeps non-CLOEXEC fds), so restart cost does not ride disk
# bandwidth
ENV_RESTORE_FD = "HVD_TPU_ELASTIC_RESTORE_FD"
# restart-cost accounting riding across the execv boundary: persist
# seconds, snapshot bytes, exec wallclock
ENV_T_PERSIST = "HVD_TPU_ELASTIC_T_PERSIST"
ENV_SNAP_BYTES = "HVD_TPU_ELASTIC_SNAP_BYTES"
ENV_T_EXEC = "HVD_TPU_ELASTIC_T_EXEC"
# cumulative exec-restart count, carried across the execv boundary so the
# metrics counter survives the process image being replaced
ENV_RESTART_COUNT = "HVD_TPU_ELASTIC_RESTART_COUNT"

#: timing of the most recent exec-restart, filled by
#: maybe_restore_after_restart on the post-boot side:
#: {persist_s, snapshot_bytes, reboot_s, restore_s, total_s}
last_restart_stats: Optional[dict] = None

_ASSIGNMENT_ENV = (
    "HVD_TPU_COORDINATOR", "HVD_TPU_NUM_PROCESSES", "HVD_TPU_PROCESS_ID",
    "HVD_TPU_NATIVE_PORT",
)

_RENDEZVOUS_TIMEOUT = env_float("HVD_TPU_ELASTIC_TIMEOUT", 600.0)

# Per-attempt connect timeout for driver sockets; attempts ride the
# shared backoff+jitter policy (common/retry.py) under the overall
# rendezvous budget — a driver briefly down costs a retry, not the
# worker.
_CONNECT_TIMEOUT = env_float("HVD_TPU_ELASTIC_CONNECT_TIMEOUT", 10.0)


def _connect_driver(site: str, budget: float) -> socket.socket:
    return retry_call(
        lambda: socket.create_connection(_driver_addr(),
                                         timeout=_CONNECT_TIMEOUT),
        site=site,
        timeout=budget,
        retry_on=(OSError,),
        describe=f"elastic driver connect ({site})",
    )


# How long after a failure=True notification the main thread gets to begin
# recovery on its own (reach a host-update check or catch the collective
# error) before the notification thread force-restarts the worker.  Under
# NCCL a survivor of a dead peer blocks inside the collective until the
# process group's timeout: this watchdog is what rescues it, by
# exec-restart.  The default leaves legitimate >10 s non-collective phases
# (eval, checkpoint writes) a margin.
_FAILURE_GRACE = env_float("HVD_TPU_ELASTIC_FAILURE_GRACE_SECONDS", 10.0)

# When the watchdog fires on a PLANNED membership change (failure=False),
# the keep-state contract says live progress must survive.  The watchdog
# first attempts a live snapshot under this deadline; only if the snapshot
# itself blocks (the main thread really is wedged in a collective the
# change killed, and the snapshot needs that device) does it fall back to
# the last committed snapshot.
_PLANNED_SNAPSHOT_TIMEOUT = env_float(
    "HVD_TPU_ELASTIC_PLANNED_SNAPSHOT_SECONDS", 30.0)


def elastic_enabled() -> bool:
    return os.environ.get(ENV_ELASTIC, "0") in ("1", "true")


def _driver_addr() -> tuple:
    host, port = os.environ[ENV_DRIVER].rsplit(":", 1)
    return host, int(port)


def _worker_id() -> int:
    # contract-ok: env -- driver-assigned identity; garbage must crash
    return int(os.environ[ENV_WORKER_ID])


def _free_local_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _send_line(sock: socket.socket, obj: dict) -> None:
    # every control message carries the per-job HMAC
    obj = wire_auth.sign_message(obj, wire_auth.job_secret())
    sock.sendall((json.dumps(obj) + "\n").encode())


def _recv_line(f) -> Optional[dict]:
    line = f.readline()
    if not line:
        return None
    msg = wire_auth.verify_message(json.loads(line),
                                   wire_auth.job_secret())
    if msg is None:
        # unsigned/forged message on an authenticated job: treat the
        # peer as gone (same handling as EOF) rather than act on it
        get_logger().warning(
            "elastic: dropping control message with missing/invalid "
            "signature")
    return msg


class WorkerNotificationManager:
    """Receives membership-change pushes from the driver (reference:
    runner/elastic/worker.py WorkerNotificationManager — there a listening
    service; here an outbound persistent connection, which also gives the
    driver a liveness channel per worker)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending_epoch: Optional[int] = None
        self._pending_failure = False
        self._thread: Optional[threading.Thread] = None
        self._sock: Optional[socket.socket] = None
        self._watched_state = None
        self._watchdog_armed = False
        # set when the driver acks a 'leaving' report: the departure is
        # BOOKED driver-side and the worker may exit without racing the
        # driver's exit observation (fleet/preemption.py)
        self._leaving_acked = threading.Event()

    def watch_state(self, state) -> None:
        """Register the state whose last committed snapshot the failure
        watchdog should carry across a forced exec-restart."""
        with self._lock:
            self._watched_state = state

    def init(self) -> None:
        if not elastic_enabled() or self._thread is not None:
            return
        # /healthz reflects this worker's membership state: a pending
        # failure notification means a peer died and this worker is about
        # to take the recovery path
        register_health_source("elastic_worker", self._health)
        sock = _connect_driver("elastic.notify_connect",
                               budget=_CONNECT_TIMEOUT * 3)
        _send_line(sock, {"type": "register", "worker_id": _worker_id()})
        sock.settimeout(None)
        self._sock = sock
        self._thread = threading.Thread(
            target=self._listen, args=(sock,), daemon=True
        )
        self._thread.start()

    def _listen(self, sock: socket.socket) -> None:
        f = sock.makefile("r")
        while True:
            try:
                msg = _recv_line(f)
            except (OSError, ValueError):
                return
            if msg is None:
                return
            if msg.get("type") == "leaving_ack":
                self._leaving_acked.set()
            elif msg.get("type") == "hosts_updated":
                arm = False
                with self._lock:
                    self._pending_epoch = msg.get("epoch")
                    self._pending_failure = bool(msg.get("failure"))
                    if not self._watchdog_armed:
                        self._watchdog_armed = arm = True
                get_logger().info(
                    "elastic: hosts updated (epoch %s, failure=%s)",
                    msg.get("epoch"), msg.get("failure"),
                )
                if arm:
                    threading.Thread(
                        target=self._failure_watchdog, daemon=True
                    ).start()

    def _failure_watchdog(self) -> None:
        """The membership changed.  If the main thread is wedged inside a
        collective that can never complete — a peer died mid-op (NCCL
        blocks rather than raising), OR a peer saw a planned change first
        and exec-restarted while we were still blocked waiting for its
        contribution — no exception ever reaches the elastic run wrapper.
        After a grace period, recover from here: persist the last
        *committed* state and exec-restart the worker.  (Rolling a planned
        change back to the last commit is safe: post-boot ``sync()``
        re-seeds from rank 0.)"""
        import time

        deadline = time.time() + _FAILURE_GRACE
        while time.time() < deadline:
            time.sleep(0.1)
            with self._lock:
                if self._pending_epoch is None:
                    # the main thread picked the update up (reset_world
                    # cleared it) — recovery is proceeding normally
                    self._watchdog_armed = False
                    return
        with self._lock:
            if self._pending_epoch is None:
                self._watchdog_armed = False
                return
            state = self._watched_state
            failure = self._pending_failure
        if failure:
            get_logger().warning(
                "elastic: main thread did not begin recovery within %.1fs of "
                "a peer failure (likely blocked in a dead collective); "
                "forcing exec-restart from the last commit", _FAILURE_GRACE,
            )
            # On a FAILURE the committed snapshot ONLY, never a live
            # state._snapshot(): the main thread may be mid-batch
            # (inconsistent fields), and a live snapshot's device-to-host
            # copies could block behind the very dead collective this
            # thread is rescuing it from.  With no commit yet, restart
            # bare and let post-boot state.sync() re-seed from rank 0.
            snap = getattr(state, "_saved", None) if state is not None else None
            _persist_and_exec(snap)
            return
        # PLANNED change (failure=False): the contract is keep-state.  The
        # main thread may merely be in a long non-collective phase (eval, a
        # checkpoint write) rather than wedged — rolling back to the last
        # commit would silently discard live progress.  Attempt a live
        # snapshot under a bounded deadline first; it can only block if
        # the main thread really is stuck in a collective the membership
        # change killed, and then the commit fallback applies.  Residual
        # risk, accepted: a main thread actively MUTATING state can be
        # caught mid-update (each field consistent, cross-field skew
        # possible); post-boot sync() re-seeds every peer from rank 0.
        get_logger().warning(
            "elastic: main thread did not begin recovery within %.1fs of a "
            "planned membership change; attempting a live state snapshot "
            "(%.0fs budget) before exec-restart",
            _FAILURE_GRACE, _PLANNED_SNAPSHOT_TIMEOUT,
        )
        snap, ok = _bounded_live_snapshot(state, _PLANNED_SNAPSHOT_TIMEOUT)
        with self._lock:
            if self._pending_epoch is None:
                # the main thread began recovery while we were snapshotting
                # — stand down and let it drive its own restart
                self._watchdog_armed = False
                return
        if not ok:
            snap = getattr(state, "_saved", None) if state is not None else None
            if snap is None:
                get_logger().error(
                    "elastic: live snapshot timed out and no commit exists "
                    "— restarting bare; ALL training progress on this "
                    "worker is lost.  Call state.commit() periodically to "
                    "bound this loss."
                )
            else:
                get_logger().warning(
                    "elastic: live snapshot timed out; falling back to the "
                    "last committed snapshot (progress since the last "
                    "commit is lost)"
                )
        _persist_and_exec(snap)

    def _health(self):
        with self._lock:
            pending = self._pending_epoch
            failure = self._pending_failure
        return not failure, {
            "pending_epoch": pending,
            "pending_failure": failure,
            "worker_id": env_int(ENV_WORKER_ID, -1),
        }

    def report_leaving(self, reason: str, ack_timeout: float = 2.0
                       ) -> bool:
        """Worker->driver notice of a PLANNED departure (preemption:
        SIGTERM grace -> snapshot -> exit 0), sent before the exit so
        the driver marks the worker ``leaving`` — its clean exit then
        books as a scale-down, never as job completion or a failure.
        BLOCKS (bounded) for the driver's ``leaving_ack`` so the mark is
        booked, not merely in a socket buffer, before the caller exits;
        returns whether the ack arrived."""
        self._leaving_acked.clear()
        self._report("leaving", reason)
        return self._leaving_acked.wait(ack_timeout)

    def report_failing(self, reason: str) -> None:
        """Best-effort worker->driver failure report on the persistent
        notification connection, sent on the way into exec-restart
        recovery.  The driver rebroadcasts it as a ``failure=True``
        membership push, so every OTHER worker starts recovery from its
        own commit poll within a step instead of discovering the failure
        whenever this process's exec closes its sockets."""
        self._report("failing", reason)

    def report_integrity_failure(self, reason: str) -> None:
        """A ``failing`` report carrying the INTEGRITY flag: this rank
        was attributed as computing wrong values (guard.py, silent
        corruption).  Beyond the normal failure epoch, the driver
        QUARANTINES this worker's whole host."""
        self._report("failing", reason, integrity=True)

    def _report(self, kind: str, reason: str,
                integrity: bool = False) -> None:
        with self._lock:
            sock = self._sock
        if sock is None:
            return
        try:
            msg = {"type": kind,
                   "worker_id": _worker_id(),
                   "reason": reason[:512]}
            if integrity:
                msg["integrity"] = True
            _send_line(sock, msg)
        except (OSError, KeyError, ValueError):
            pass  # the report is an optimization, never a requirement

    def check_for_updates(self) -> None:
        """Raise HostsUpdatedInterrupt if an update is pending (reference:
        State.check_host_updates draining the manager's queue)."""
        with self._lock:
            pending = self._pending_epoch
            failure = self._pending_failure
        if pending is not None:
            exc = HostsUpdatedInterrupt()
            exc.due_to_failure = failure
            raise exc

    def clear(self) -> None:
        with self._lock:
            self._pending_epoch = None
            self._pending_failure = False


notification_manager = WorkerNotificationManager()


def rendezvous() -> dict:
    """Block until the driver hands this worker its assignment for the
    next epoch (reference: the elastic rendezvous server handing out
    rank/size on each reset)."""
    sock = _connect_driver("elastic.rendezvous", budget=_RENDEZVOUS_TIMEOUT)
    sock.settimeout(_RENDEZVOUS_TIMEOUT)  # assignment wait, not connect
    try:
        _send_line(sock, {"type": "rendezvous", "worker_id": _worker_id()})
        f = sock.makefile("r")
        msg = _recv_line(f)
        if msg is not None and msg.get("type") == "allocate_ports":
            # we are the rank-0-elect: allocate the epoch's store port on
            # THIS host so the bind cannot race a remote probe
            _send_line(sock, {
                "type": "ports",
                "coordinator_port": _free_local_port(),
                "native_port": _free_local_port(),
            })
            msg = _recv_line(f)
    finally:
        sock.close()
    if msg is None:
        raise HorovodInternalError("elastic driver closed during rendezvous")
    if msg.get("type") == "shutdown":
        get_logger().info("elastic: driver requested shutdown")
        # a displaced worker arrives here via exec-restart with a live
        # state snapshot it will never load — release it on the way out
        fd_env = os.environ.pop(ENV_RESTORE_FD, None)
        if fd_env is not None:
            try:
                os.close(int(fd_env))
            except (OSError, ValueError):
                pass
        path = os.environ.pop(ENV_RESTORE, None)
        if path and os.path.exists(path):
            os.remove(path)
        raise SystemExit(0)
    if msg.get("type") != "assignment":
        raise HorovodInternalError(f"unexpected rendezvous reply: {msg}")
    return msg


def apply_assignment(msg: dict) -> None:
    """Export the assignment as the launcher's env (the variables
    ``python -m horovod_tpu_torch.runner`` sets) so ``hvd.init()`` picks
    it up unchanged."""
    os.environ["HVD_TPU_COORDINATOR"] = msg["coordinator"]
    os.environ["HVD_TPU_NUM_PROCESSES"] = str(msg["num_processes"])
    os.environ["HVD_TPU_PROCESS_ID"] = str(msg["rank"])
    os.environ["HVD_TPU_NATIVE_PORT"] = str(msg["native_port"])
    if "local_rank" in msg:
        os.environ["HVD_TPU_LOCAL_RANK"] = str(msg["local_rank"])
        os.environ["HVD_TPU_LOCAL_SIZE"] = str(msg["local_size"])


def ensure_assignment() -> None:
    """First-boot hook called from ``hvd.init()``: in elastic mode the
    spawn env carries only the driver address, so rendezvous for the
    initial world here (the reference's first rendezvous)."""
    if not elastic_enabled() or "HVD_TPU_COORDINATOR" in os.environ:
        return
    notification_manager.init()
    apply_assignment(rendezvous())


def recovery_pending() -> bool:
    """True when fleet recovery is known to be in flight on this worker:
    a membership/failure notification is unconsumed."""
    mgr = notification_manager
    with mgr._lock:
        return mgr._pending_epoch is not None


def clean_shutdown() -> None:
    """Coordinated end of an elastic job: a barrier across the members
    while every worker is still in controlled code, so no member tears
    its process group (and rank 0 its store) down under a peer still
    finishing; the group itself is destroyed by ``basics.shutdown`` at
    exit, and rank and size stay readable for the caller's epilogue.

    With recovery IN FLIGHT the barrier is skipped entirely (the
    restarting peers will never arrive) and the group is abandoned to
    process exit (``basics._abandon``), as the JAX package skips its
    coordination service's shutdown barrier."""
    from ..common import basics
    from ..ops import collective_ops

    if not basics.is_initialized():
        return
    if recovery_pending():
        get_logger().warning(
            "elastic: fleet recovery in flight at job completion; "
            "skipping the shutdown barrier (it could never complete)")
        basics._abandon()
        return
    try:
        if basics.size() > 1:
            collective_ops.barrier()
    except Exception as e:
        get_logger().info("elastic: shutdown barrier raised (%s)", e)
        basics._abandon()


def reset_world(state) -> None:
    """Reset for a PLANNED membership change (reference: common/elastic.py
    _reset + the 'full communicator rebuild' step).

    Multi-process worlds exec-restart with the LIVE state rather than
    re-initializing in process: a peer can be blocked inside a
    collective when the first member tears down (notification skew), and
    exec-restart needs no cross-member teardown at all — the process
    image (process group, CUDA context, NCCL communicators, collectives
    mid-flight) is replaced wholesale, and the memfd snapshot + post-boot
    ``sync()`` keep the reference's keep-state-on-planned-change
    semantics.  A world of one rebuilds in process."""
    from ..common import basics

    state._materialize_to_host()
    notification_manager.clear()
    if basics._require_init().size > 1:
        get_logger().info(
            "elastic: membership change — exec-restarting with live state"
        )
        snap = state._snapshot() if hasattr(state, "_snapshot") else None
        _persist_and_exec(snap)  # does not return
    # single-process world: nothing to barrier with — rebuild in process
    device = basics._state.device_arg
    basics.shutdown()
    msg = rendezvous()
    apply_assignment(msg)
    basics.init(device)
    state.on_reset()
    get_logger().info(
        "elastic: reset complete — epoch=%s rank=%s/%s",
        msg.get("epoch"), msg.get("rank"), msg.get("num_processes"),
    )


def restart_after_failure(state, notify_driver: bool = True) -> None:
    """Peer-death recovery: persist the last committed state and
    exec-restart this worker in place (same PID — the driver's process
    table is undisturbed), rejoining via rendezvous on boot.

    ``notify_driver=False`` when this restart was ORDERED by a driver
    failure notification: re-reporting it would make the driver start yet
    another failure epoch for the world it is already rebuilding.  Report
    only locally detected failures.

    The reference aborts its NCCL communicators and keeps the process;
    the port re-execs, as the JAX package does: the new image holds no
    process group, CUDA context or communicator of the dead world, and
    the state handoff + post-boot ``state.sync()`` reproduce the
    reference's restore-then-rebroadcast semantics."""
    # Deliberately do NOT stand the failure watchdog down here: taking the
    # live snapshot can itself block (a device-to-host copy queued behind
    # a collective that involves the dead peer), and the watchdog
    # exec-restarting from the last commit is the correct backstop.  A
    # concurrent double-restart is safe: execv is the last action of
    # either thread and whichever reaches it first wins.
    #
    # Tell the driver FIRST: it rebroadcasts failure=True to the other
    # members, whose commit polls then begin their own recovery within a
    # step.
    if notify_driver:
        notification_manager.report_failing(
            "control-plane failure; exec-restarting")
    snap = state._snapshot() if hasattr(state, "_snapshot") else None
    get_logger().info("elastic: peer failure — exec-restarting this worker")
    _persist_and_exec(snap)


def _bounded_live_snapshot(state, timeout_s: float):
    """Attempt ``state._snapshot()`` on a side thread under a deadline.

    Returns ``(snapshot, True)`` on success, ``(None, False)`` when the
    state has no snapshot hook, the snapshot raised, or it blocked past
    the deadline (the thread is daemonic; an abandoned attempt cannot
    keep the process alive, and the caller exec-restarts anyway)."""
    if state is None or not hasattr(state, "_snapshot"):
        return None, False
    box = {}

    def _snap():
        try:
            box["snap"] = state._snapshot()
        except BaseException as e:  # device errors are not Exception-only
            box["err"] = e

    t = threading.Thread(target=_snap, daemon=True)
    t.start()
    t.join(timeout_s)
    if "snap" in box:
        return box["snap"], True
    if "err" in box:
        get_logger().warning(
            "elastic: live snapshot raised %s: %s",
            type(box["err"]).__name__, box["err"],
        )
    return None, False


def _persist_and_exec(snap) -> None:
    """Write the state snapshot for the next boot and exec-restart in
    place (same PID).  Safe from any thread: execv replaces the whole
    process image.  The snapshot holds host copies only (``TpuState``'s
    ``_snapshot``): nothing in it refers to the CUDA context the exec
    drops."""
    import pickle
    import sys
    import tempfile
    import time

    if snap is not None:
        t0 = time.time()
        try:
            # RAM-backed handoff: flags=0 clears python's MFD_CLOEXEC
            # default so execv keeps the fd; the kernel reclaims the
            # memory when the post-boot load closes it — no disk write,
            # no leaked file if the reboot dies
            mfd = os.memfd_create("hvd_tpu_elastic_state", 0)
        except (AttributeError, OSError):
            mfd = None
        if mfd is not None:
            with os.fdopen(mfd, "wb", closefd=False) as f:
                pickle.dump(snap, f, protocol=pickle.HIGHEST_PROTOCOL)
            size = os.lseek(mfd, 0, os.SEEK_CUR)
            os.lseek(mfd, 0, os.SEEK_SET)
            os.environ[ENV_RESTORE_FD] = str(mfd)
        else:  # pre-memfd kernels: disk tempfile
            fd, path = tempfile.mkstemp(prefix="hvd_tpu_elastic_state_")
            with os.fdopen(fd, "wb") as f:
                pickle.dump(snap, f, protocol=pickle.HIGHEST_PROTOCOL)
            size = os.path.getsize(path)
            os.environ[ENV_RESTORE] = path
        os.environ[ENV_T_PERSIST] = f"{time.time() - t0:.4f}"
        os.environ[ENV_SNAP_BYTES] = str(size)
    # marked even with no snapshot: the post-boot wrapper must still fire
    # the user's reset callbacks (the restart IS the reset)
    os.environ[ENV_RESTARTED] = "1"
    count = env_int(ENV_RESTART_COUNT, 0)
    os.environ[ENV_RESTART_COUNT] = str(count + 1)
    try:
        # flight recorder: execv replaces the image and the span rings
        # with it — the last N seconds leave as a crash bundle first
        # (HVD_TPU_TRACE_BUNDLE_DIR opts in)
        from .. import trace as _trace
        from ..trace import flight as _flight

        _trace.event("elastic.restart", restarts=count + 1)
        _flight.maybe_dump("restart", extra={"restarts": count + 1})
    except Exception:
        pass
    for k in _ASSIGNMENT_ENV:
        os.environ.pop(k, None)
    sys.stdout.flush()
    sys.stderr.flush()
    os.environ[ENV_T_EXEC] = f"{time.time():.4f}"
    os.execv(sys.executable, [sys.executable] + sys.argv)


def maybe_restore_after_restart(state) -> None:
    """On wrapper entry after an exec-restart, reload the persisted
    snapshot, fire the user's reset callbacks (a restart IS the reset —
    reference: _reset invoking on_reset after every membership change),
    then the normal ``state.sync()`` re-broadcasts rank 0's authoritative
    copy."""
    import pickle
    import time

    global last_restart_stats

    restarted = os.environ.pop(ENV_RESTARTED, None) is not None
    t_exec = os.environ.pop(ENV_T_EXEC, None)
    persist_s = env_float(ENV_T_PERSIST, 0.0)
    snap_bytes = env_int(ENV_SNAP_BYTES, 0)
    os.environ.pop(ENV_T_PERSIST, None)
    os.environ.pop(ENV_SNAP_BYTES, None)
    # reboot = execv → wrapper entry: interpreter + torch import, boot
    # rendezvous, hvd.init against the new world
    reboot_s = (time.time() - float(t_exec)) if t_exec else 0.0
    restore_s = 0.0
    snap = _NOTHING = object()
    fd_env = os.environ.pop(ENV_RESTORE_FD, None)
    path = os.environ.pop(ENV_RESTORE, None)
    if fd_env is not None:
        t0 = time.time()
        try:
            with os.fdopen(int(fd_env), "rb") as f:  # close frees the RAM
                snap = pickle.load(f)
        except Exception as e:
            # a lost/garbled/unloadable handoff must not crash-loop the
            # worker: boot bare and let post-boot sync() re-seed from
            # rank 0
            get_logger().error(
                "elastic: state handoff unusable (%s: %s); continuing "
                "without the snapshot — sync() re-seeds from rank 0",
                type(e).__name__, e,
            )
            snap = _NOTHING
    elif path and os.path.exists(path):
        t0 = time.time()
        try:
            with open(path, "rb") as f:
                snap = pickle.load(f)
        except Exception as e:  # same crash-loop guard as the fd path
            get_logger().error(
                "elastic: state snapshot file unusable (%s: %s); "
                "continuing without it — sync() re-seeds from rank 0",
                type(e).__name__, e,
            )
            snap = _NOTHING
        os.remove(path)
    if snap is not _NOTHING:
        if snap is not None and hasattr(state, "_apply_snapshot"):
            state._apply_snapshot(snap)
            state.save()
        restore_s = time.time() - t0
        get_logger().info(
            "elastic: state restored after worker restart"
        )
    if restarted:
        last_restart_stats = {
            "persist_s": persist_s,
            "snapshot_bytes": snap_bytes,
            "reboot_s": reboot_s,
            "restore_s": restore_s,
            "total_s": persist_s + reboot_s + restore_s,
        }
        # restore the CUMULATIVE restart count: execv replaced the process
        # image (and with it the fresh registry's zero), the env carried
        # the true total across the boundary
        total_restarts = env_int(ENV_RESTART_COUNT, 1)
        already = _metrics.ELASTIC_RESTARTS.get()
        if total_restarts > already:
            _metrics.ELASTIC_RESTARTS.inc(total_restarts - already)
        for phase in ("persist", "reboot", "restore", "total"):
            _metrics.ELASTIC_RESTART_SECONDS.labels(phase).set(
                last_restart_stats[f"{phase}_s"]
            )
        _metrics.ELASTIC_SNAPSHOT_BYTES.set(snap_bytes)
        # the headline fault-tolerance number: detection-to-trainable
        # wall time of this recovery (docs/FAULT_TOLERANCE.md)
        _metrics.RECOVERY_SECONDS.labels("restart").set(
            last_restart_stats["total_s"])
        get_logger().info(
            "elastic: restart cost %.2fs total (persist %.2fs, "
            "reboot %.2fs, restore %.2fs; snapshot %d bytes)",
            last_restart_stats["total_s"], persist_s, reboot_s,
            restore_s, snap_bytes,
        )
        # reset callbacks fire on every exec-restart, snapshot or not —
        # a restart with no committed state is still a membership reset
        state.on_reset()
