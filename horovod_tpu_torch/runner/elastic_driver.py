"""Elastic driver: discovery polling, worker lifecycle, rendezvous.

Port of ``horovod_tpu/runner/elastic_driver.py`` (reference parity:
horovod/runner/elastic/driver.py ElasticDriver, discovery.py
HostDiscoveryScript, registration.py / rendezvous.py).  The same set of
responsibilities:

  * poll ``--host-discovery-script`` (~1 s) for the current ``host:slots``
    set;
  * spawn one worker process per slot (localhost exec or ssh), each told
    only the driver's address + a stable worker id — world shape always
    arrives via rendezvous;
  * detect failures (process exit, a worker's ``failing`` report),
    blacklist the failed slot, and drive a reset epoch: push
    ``hosts_updated`` to survivors, collect rendezvous requests from the
    expected member set, hand out rank/size/coordinator assignments;
  * quarantine a whole host after an integrity attribution (``guard.py``);
  * enforce ``--min-np`` (wait for capacity, bounded by
    HVD_TPU_ELASTIC_TIMEOUT) and ``--max-np`` (cap spawned slots), and
    honor the fleet autoscaler's ``request_world_size``;
  * declare success when every live worker exits 0.

The assignment makes the lowest worker id rank 0, whose host then serves
the epoch's ``torch.distributed`` TCP store (``coordinator``) — the
analog of the reference restarting its rendezvous server on reset.
Every control line is HMAC-signed with the job secret, in the JAX
package's format: a driver of either package can speak to a worker of
the other.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..common import wire_auth
from ..common.retry import env_float, retry_call
from ..elastic.worker import ENV_DRIVER, ENV_ELASTIC, ENV_WORKER_ID
from ..metrics import instruments as _metrics
from ..utils.logging import get_logger
from .launch import _TORCHRUN_ENV

_LOCAL_HOSTS = ("localhost", "127.0.0.1")


def _signed_line(obj: dict) -> bytes:
    """One HMAC-signed JSON line (reference: secret.py-signed RPC)."""
    return (json.dumps(
        wire_auth.sign_message(obj, wire_auth.job_secret())
    ) + "\n").encode()


def _verified(msg: dict) -> Optional[dict]:
    """Verify+strip the signature; None = forged/unsigned (drop peer)."""
    out = wire_auth.verify_message(msg, wire_auth.job_secret())
    if out is None:
        get_logger().warning(
            "elastic driver: dropping control message with "
            "missing/invalid signature")
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class HostDiscovery:
    """Wraps the user's discovery script (reference:
    runner/elastic/discovery.py HostDiscoveryScript): executable printing
    one ``host`` or ``host:slots`` per line.

    The script is an external dependency that flakes in real clusters
    (cloud API hiccup, ssh probe timing out), so invocations ride the
    shared backoff+jitter policy: ``HVD_TPU_DISCOVERY_TIMEOUT`` seconds
    per attempt (default 30), ``HVD_TPU_DISCOVERY_RETRIES`` attempts
    (default 3) before the failure surfaces to the poll loop — which
    already tolerates it by keeping the previous host set."""

    def __init__(self, script: str, default_slots: int = 1):
        self.script = script
        self.default_slots = default_slots
        self.timeout = env_float("HVD_TPU_DISCOVERY_TIMEOUT", 30.0)
        self.retries = int(env_float("HVD_TPU_DISCOVERY_RETRIES", 3))

    def _run_script(self) -> str:
        out = subprocess.run(
            [self.script], capture_output=True, text=True,
            timeout=self.timeout,
        )
        if out.returncode != 0:
            raise RuntimeError(
                f"host discovery script failed ({out.returncode}): "
                f"{out.stderr.strip()}"
            )
        return out.stdout

    def find_available_hosts(self) -> List[Tuple[str, int]]:
        try:
            stdout = retry_call(
                self._run_script,
                site="elastic.discovery",
                retry_on=(RuntimeError, OSError,
                          subprocess.TimeoutExpired),
                attempts=max(1, self.retries),
                describe=f"host discovery ({self.script})",
            )
        except RuntimeError:
            raise
        except (OSError, subprocess.TimeoutExpired) as e:
            # normalize to the contract the poll loops catch
            # (`except RuntimeError` keeps the previous host set) — a
            # persistent flake must degrade the poll, never crash the
            # driver and reap the fleet
            raise RuntimeError(f"host discovery failed: {e}") from e
        hosts = []
        for line in stdout.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                h, s = line.rsplit(":", 1)
                hosts.append((h, int(s)))
            else:
                hosts.append((line, self.default_slots))
        return hosts


class _Worker:
    def __init__(self, worker_id: int, host: str, slot: int,
                 proc: subprocess.Popen):
        self.worker_id = worker_id
        self.host = host
        self.slot = slot
        self.proc = proc
        self.exit_code: Optional[int] = None
        # slot removed by discovery: the worker stays a member until the
        # next rendezvous, where it is told to shut down (it arrives
        # there via its own exec-restart; no cross-member teardown)
        self.leaving = False

    @property
    def alive(self) -> bool:
        # exit_code only — NOT a live proc.poll().  Deaths must become
        # visible through the monitor's detection pass (which blacklists
        # the slot) before any membership decision sees them; a live poll
        # here let a just-died worker vanish from _occupied_slots() while
        # its slot was not yet blacklisted, so the discovery poll
        # "refilled" the dead slot with a fresh worker (failure=False)
        # instead of taking the failure-recovery path.
        return self.exit_code is None


class ElasticDriver:
    """See module docstring.  One instance per elastic job."""

    def __init__(
        self,
        command: List[str],
        discovery: HostDiscovery,
        min_np: int,
        max_np: Optional[int] = None,
        knob_env: Optional[Dict[str, str]] = None,
        poll_interval: float = 1.0,
        timeout: Optional[float] = None,
        verbose: bool = False,
    ):
        self.command = command
        self.discovery = discovery
        self.min_np = min_np
        self.max_np = max_np
        self.knob_env = knob_env or {}
        self.poll_interval = poll_interval
        self.timeout = timeout or env_float("HVD_TPU_ELASTIC_TIMEOUT",
                                            600.0)
        self.verbose = verbose
        # per-job control-plane secret: signs the driver<->worker JSON
        # lines; exported through the driver's own environ so _spawn's
        # env copies inherit it
        os.environ.setdefault(wire_auth.SECRET_ENV, wire_auth.make_secret())

        # reentrant: _desired_slots guards the hold map internally and
        # is called both with and without the lock held (the min-np
        # refill wait holds it; the discovery reconcile does not)
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._workers: Dict[int, _Worker] = {}
        self._blacklist: set = set()  # (host, slot) pairs
        # hosts quarantined after an integrity attribution (guard.py):
        # a machine whose chip computed wrong values leaves the spawn
        # pool entirely — EVERY slot it advertises is skipped, not just
        # the one the attributed worker held (docs/FAULT_TOLERANCE.md)
        self._host_blacklist: set = set()
        self._next_worker_id = 0
        self._epoch = 0
        # rendezvous state: worker_id -> socket awaiting an assignment
        self._pending_rendezvous: Dict[int, socket.socket] = {}
        self._notify_socks: Dict[int, socket.socket] = {}
        self._server: Optional[socket.socket] = None
        self._shutdown = False
        # a live worker reported control-plane failure ("failing" line):
        # drives a failure=True reset epoch even with no process exit
        self._failure_reported = False
        # -- fleet autoscaling state (docs/FLEET.md) -----------------------
        # explicit world-size target (request_world_size); None = track
        # discovery capacity, the pre-fleet behavior, unchanged
        self._world_target: Optional[int] = None
        # wake the discovery poll immediately after a resize request
        self._poll_asap = False
        # a 'leaving' worker's clean exit must trigger a planned reset
        # epoch for the survivors (the preemption path: the worker
        # leaves FIRST, unlike driver-ordered scale-down)
        self._leaver_exited = False
        # (host, slot) -> monotonic expiry: slots vacated by preemption
        # are held against immediate refill (the machine is going away;
        # discovery is the authority again once the hold expires)
        self._slot_hold: Dict[Tuple[str, int], float] = {}
        self._autoscaler = None

    # -- server ------------------------------------------------------------

    def _start_server(self) -> Tuple[str, int]:
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("", 0))
        srv.listen(128)
        self._server = srv
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return socket.gethostname(), srv.getsockname()[1]

    def _accept_loop(self) -> None:
        while not self._shutdown:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handle_conn, args=(conn,), daemon=True
            ).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            f = conn.makefile("r")
            line = f.readline()
            if not line:
                conn.close()
                return
            msg = json.loads(line)
        except (OSError, ValueError):
            conn.close()
            return
        msg = _verified(msg)
        if msg is None:
            conn.close()
            return
        kind = msg.get("type")
        wid = msg.get("worker_id")
        if kind == "register":
            with self._cv:
                self._notify_socks[wid] = conn
            # keep the socket open (its EOF doubles as a liveness signal)
            # and keep READING it: a worker entering exec-restart recovery
            # reports "failing" here so the driver can push failure=True
            # to the other members immediately — their recovery then
            # starts from their own commit polls instead of waiting on
            # the failing process's exit
            self._drain_notify_conn(wid, conn, f)
        elif kind == "rendezvous":
            with self._cv:
                self._pending_rendezvous[wid] = conn
                self._cv.notify_all()
        else:
            conn.close()

    def _drain_notify_conn(self, wid, conn: socket.socket, f) -> None:
        """Read worker->driver reports on the registered connection until
        EOF (runs on the per-connection handler thread)."""
        while not self._shutdown:
            try:
                line = f.readline()
            except OSError:
                return
            if not line:
                return  # EOF: liveness handled by the send path
            try:
                msg = _verified(json.loads(line))
            except ValueError:
                continue
            if msg is None:
                continue
            if msg.get("type") == "failing":
                get_logger().warning(
                    "elastic: worker %s reports failure: %s",
                    wid, msg.get("reason", ""))
                with self._cv:
                    if msg.get("integrity"):
                        self._quarantine_host(wid)
                    self._failure_reported = True
                    self._cv.notify_all()
            elif msg.get("type") == "leaving":
                # planned departure (preemption notice): mark the
                # worker leaving BEFORE its exit 0 can be observed (so
                # it books as a scale-down, not job completion) and
                # hold its slot against an immediate refill
                get_logger().warning(
                    "elastic: worker %s leaving (planned): %s",
                    wid, msg.get("reason", ""))
                with self._cv:
                    w = self._workers.get(wid)
                    if w is not None:
                        w.leaving = True
                        self._slot_hold[(w.host, w.slot)] = (
                            time.monotonic() + env_float(
                                "HVD_TPU_FLEET_REFILL_HOLD", 60.0))
                    self._cv.notify_all()
                # ack on the same connection: the worker's leave path
                # waits for this before exiting, so the 'leaving' mark
                # is BOOKED (not merely in a socket buffer) when the
                # exit 0 lands — a slow reader thread can't mis-book
                # the preemption as job completion
                try:
                    conn.sendall(_signed_line({"type": "leaving_ack"}))
                except OSError:
                    pass

    def _quarantine_host(self, wid: int) -> None:
        """Integrity attribution (guard.py closed loop): quarantine the
        attributed worker's WHOLE host — a lying chip taints its
        machine, and refilling any of its slots would hand the fleet
        back to it.  SIBLING workers still running there are hard-
        killed too: leaving them computing would keep re-tripping the
        guard until the survivors' rollback fuse kills the whole job;
        their exits book through ``_observe_exits`` as normal failures.
        Caller must hold ``self._cv``."""
        w = self._workers.get(wid)
        if w is None or w.host in self._host_blacklist:
            return
        self._host_blacklist.add(w.host)
        _metrics.GUARD_QUARANTINES.inc()
        get_logger().error(
            "elastic: host %s QUARANTINED after integrity attribution "
            "of worker %s", w.host, wid)
        for s in self._workers.values():
            if s.alive and s.host == w.host and s.worker_id != wid:
                get_logger().error(
                    "elastic: killing worker %d — sibling slot on "
                    "quarantined host %s", s.worker_id, s.host)
                try:
                    s.proc.kill()
                except OSError:
                    pass

    # -- worker lifecycle --------------------------------------------------

    def _spawn(self, host: str, slot: int, driver_addr: str) -> _Worker:
        wid = self._next_worker_id
        self._next_worker_id += 1
        # a driver itself launched under a launcher (this one or
        # torchrun) must not leak its own placement into workers; the
        # rendezvous assignment supplies theirs
        env = {k: v for k, v in os.environ.items()
               if k not in _TORCHRUN_ENV}
        env.pop("HVD_TPU_LOCAL_RANK", None)
        env.pop("HVD_TPU_LOCAL_SIZE", None)
        env.update(self.knob_env)
        env[ENV_ELASTIC] = "1"
        env[ENV_DRIVER] = driver_addr
        env[ENV_WORKER_ID] = str(wid)
        if host in _LOCAL_HOSTS:
            proc = subprocess.Popen(self.command, env=env)
        else:
            # secret via ssh stdin, never the argv (cmdline is world-
            # readable on both hosts for the job's lifetime)
            secret = env.get(wire_auth.SECRET_ENV, "")
            env_prefix = " ".join(
                f"{k}={subprocess.list2cmdline([v])}"
                for k, v in env.items()
                if k.startswith("HVD_TPU_") and k != wire_auth.SECRET_ENV
            )
            remote = (f"IFS= read -r {wire_auth.SECRET_ENV} && "
                      f"export {wire_auth.SECRET_ENV} && "
                      f"cd {os.getcwd()} && {env_prefix} "
                      + subprocess.list2cmdline(self.command))
            proc = subprocess.Popen(
                ["ssh", "-o", "StrictHostKeyChecking=no", host, remote],
                stdin=subprocess.PIPE,
            )
            proc.stdin.write((secret + "\n").encode())
            proc.stdin.close()
        w = _Worker(wid, host, slot, proc)
        self._workers[wid] = w
        _metrics.ELASTIC_SPAWNS.inc()
        if self.verbose:
            print(f"[runner elastic] spawned worker {wid} on {host}:{slot}",
                  file=sys.stderr)
        return w

    def _observe_exits(self) -> Tuple[bool, bool]:
        """Poll every worker process once and book-keep any deaths: record
        the exit code, drop the notification socket, blacklist the slot on
        failure, flag job completion on a clean active exit.  This is the
        ONLY place exits become visible (``_Worker.alive`` deliberately
        reads the recorded code, not the live process), so every code path
        that waits on workers must call it — otherwise a death during that
        wait is invisible (or worse, visible without its blacklist).
        Caller must hold ``self._cv``.  Returns (any_exit, any_failure)."""
        log = get_logger()
        any_exit = any_failure = False
        for w in list(self._workers.values()):
            if w.exit_code is None:
                code = w.proc.poll()
                if code is not None:
                    w.exit_code = code
                    any_exit = True
                    self._notify_socks.pop(w.worker_id, None)
                    if code == 0 and not w.leaving:
                        # a clean exit of an active member means training
                        # completed: the job is winding down — stop
                        # spawning into freed slots.  (A 'leaving' worker
                        # exiting 0 is just a scale-down; elasticity must
                        # survive it.)
                        self._completing = True
                    elif code == 0 and w.leaving:
                        # a preempted worker left on its own (unlike a
                        # driver-ordered scale-down, where the epoch ran
                        # first): the survivors need a planned reset epoch
                        # contract-ok: locks -- _observe_exits runs with self._cv held (docstring contract; every caller acquires it)
                        self._leaver_exited = True
                    if code != 0:
                        log.warning(
                            "elastic: worker %d (%s:%d) failed with exit "
                            "code %d", w.worker_id, w.host, w.slot, code)
                        self._blacklist.add((w.host, w.slot))
                        any_failure = True
                        _metrics.ELASTIC_FAILURES.inc()
        return any_exit, any_failure

    def _alive_workers(self) -> List[_Worker]:
        return [w for w in self._workers.values() if w.alive]

    def _occupied_slots(self) -> set:
        return {(w.host, w.slot) for w in self._workers.values() if w.alive}

    def _desired_slots(self, hosts: List[Tuple[str, int]]) -> List[Tuple[str, int]]:
        # the hold map is written by the notification-reader thread
        # (a 'leaving' report) — expire + snapshot it under the lock
        # (reentrant, so callers already holding _cv are fine)
        now = time.monotonic()
        with self._cv:
            for k in [k for k, exp in self._slot_hold.items()
                      if exp <= now]:
                del self._slot_hold[k]
            held = set(self._slot_hold)
        slots = []
        for h, n in hosts:
            if h in self._host_blacklist:
                continue  # quarantined after integrity attribution
            for s in range(n):
                if (h, s) not in self._blacklist and (h, s) not in held:
                    slots.append((h, s))
        if self.max_np is not None:
            slots = slots[: self.max_np]
        # the autoscaler's explicit target caps capacity-tracking: the
        # LOWEST slots stay, so a shrink always removes the same
        # (deterministic) members and a later grow refills from where
        # it shrank
        if self._world_target is not None:
            slots = slots[: self._world_target]
        return slots

    # -- autoscaler entry point (docs/FLEET.md) ----------------------------

    def request_world_size(self, n: Optional[int]) -> int:
        """Resize the training world to ``n`` workers, honored at the
        next epoch boundary: the discovery reconcile spawns into free
        (non-blacklisted, non-held) slots to grow, or marks the
        highest-slot members ``leaving`` to shrink — those members get
        the driver's ``shutdown`` reply at the rendezvous their next
        commit check delivers them to, so no step is ever cut mid-air.
        The explicit entry point the fleet autoscaler calls instead of
        faking failures (upstream elastic's only lever).

        ``n`` is clamped to ``[min_np, max_np]``; ``None`` returns the
        driver to pure capacity tracking (every discovered slot, the
        pre-fleet behavior).  Thread-safe; returns the clamped target
        (or -1 for None).  Fewer discovered slots than the target is
        not an error — the world converges as far as capacity allows,
        and further when discovery finds more."""
        with self._cv:
            if n is not None:
                n = max(self.min_np, int(n))
                if self.max_np is not None:
                    n = min(n, self.max_np)
            self._world_target = n
            self._poll_asap = True
            self._cv.notify_all()
        get_logger().info("elastic: world-size target set to %s", n)
        return -1 if n is None else n

    def current_world(self) -> int:
        """Live, non-leaving workers — the autoscaler's ``current``."""
        with self._cv:
            return sum(1 for w in self._workers.values()
                       if w.alive and not w.leaving)

    # -- rendezvous epoch --------------------------------------------------

    def _query_ports(self, sock: socket.socket):
        """Ask the rank-0-elect worker to allocate the epoch's
        coordinator (store) port, and the JAX package's native port, on
        its host.  The reply deadline is
        ``HVD_TPU_ELASTIC_NOTIFY_TIMEOUT`` (default 30 s) — env-tunable
        because a loaded rank-0 host legitimately takes longer than a
        hard-coded 30 under CI-grade contention."""
        try:
            sock.sendall(_signed_line({"type": "allocate_ports"}))
            sock.settimeout(env_float("HVD_TPU_ELASTIC_NOTIFY_TIMEOUT",
                                      30.0))
            reply = _verified(json.loads(sock.makefile("r").readline()))
            sock.settimeout(None)
            if reply is None or reply.get("type") != "ports":
                return None
            return reply
        except (OSError, ValueError):
            return None

    def _notify_hosts_updated(self, failure: bool = False) -> None:
        """Push the membership change; ``failure=True`` tells survivors a
        peer died, so they must take the restart recovery path (a graceful
        in-process teardown would trip on the dead peer's barrier).

        A survivor dying MID-NOTIFY must not take the monitor down: every
        send failure is caught (any exception, not just OSError) and the
        remaining survivors are still notified.  The dead socket is
        dropped; the death itself is booked by ``_observe_exits`` — the
        ONE place exits become visible (exit code + blacklist + metrics +
        completion flag) — which the very next ``_complete_rendezvous``
        wait iteration runs.  A send failure with the process still alive
        is the normal exec-restart window (the restarting worker's socket
        closed at execv; it re-registers after boot).

        Sends run OUTSIDE the driver lock: a frozen worker whose recv
        buffer fills would otherwise block ``sendall`` while holding the
        only lock, deadlocking every other driver thread."""
        with self._cv:
            targets = list(self._notify_socks.items())
            line = _signed_line({"type": "hosts_updated",
                                 "epoch": self._epoch,
                                 "failure": failure})
        dead = []
        for wid, sock in targets:
            try:
                sock.sendall(line)
            except Exception:
                dead.append(wid)
        if dead:
            with self._cv:
                for wid in dead:
                    self._notify_socks.pop(wid, None)

    def _complete_rendezvous(self, driver_host: str) -> bool:
        """Wait until every live worker has requested rendezvous, then
        hand out assignments.  Returns False on timeout/below-min-np."""
        deadline = time.time() + self.timeout
        with self._cv:
            while True:
                # full bookkeeping, not a bare poll: a worker that crashes
                # during rendezvous must blacklist its slot too, or the
                # discovery poll refills it into a crash loop
                self._observe_exits()
                expected = {w.worker_id for w in self._alive_workers()}
                have = set(self._pending_rendezvous)
                if not expected:
                    return False
                if expected <= have:
                    break
                if time.time() > deadline:
                    return False
                self._cv.wait(timeout=0.2)

            members = sorted(
                wid for wid in expected if not self._workers[wid].leaving
            )
            if not members:
                return False
            self._members = list(members)
            rank0 = self._workers[members[0]]
            coord_host = ("127.0.0.1" if rank0.host in _LOCAL_HOSTS
                          else rank0.host)
            # two-phase: the rank-0-elect allocates the ports ON ITS OWN
            # HOST (probing them here would race/miss on a remote machine
            # — reference analog: the rendezvous server owning its port)
            ports = self._query_ports(self._pending_rendezvous[members[0]])
            if ports is None:
                return False
            coordinator = f"{coord_host}:{ports['coordinator_port']}"
            native_port = ports["native_port"]
            # per-host placement for hvd.local_rank()/local_process_count()
            # (reference: the per-host slot numbering horovodrun exports)
            host_members: Dict[str, List[int]] = {}
            for wid in members:
                host_members.setdefault(
                    self._workers[wid].host, []
                ).append(wid)
            for rank, wid in enumerate(members):
                sock = self._pending_rendezvous.pop(wid)
                peers = host_members[self._workers[wid].host]
                reply = {
                    "type": "assignment",
                    "rank": rank,
                    "num_processes": len(members),
                    "coordinator": coordinator,
                    "native_port": native_port,
                    "local_rank": peers.index(wid),
                    "local_size": len(peers),
                    "epoch": self._epoch,
                }
                try:
                    sock.sendall(_signed_line(reply))
                except OSError:
                    pass
                sock.close()
            # leaving workers (removed slots) and latecomers from dead
            # epochs are told to shut down; they clean up their restart
            # state file and exit 0
            for wid, sock in list(self._pending_rendezvous.items()):
                if wid not in members:
                    try:
                        sock.sendall(_signed_line({"type": "shutdown"}))
                    except OSError:
                        pass
                    sock.close()
                    self._pending_rendezvous.pop(wid, None)
            # "failing" reports that arrived while THIS epoch was being
            # arranged are part of the failure it just recovered from —
            # carrying them forward would trigger a spurious next epoch
            # (a genuinely new failure gets re-reported or shows up as an
            # out-of-band rendezvous)
            self._failure_reported = False
            _metrics.ELASTIC_RENDEZVOUS.inc()
            _metrics.ELASTIC_WORLD_SIZE.set(len(members))
            _metrics.ELASTIC_EPOCH.set(self._epoch)
            if self.verbose:
                print(f"[runner elastic] epoch {self._epoch}: world="
                      f"{len(members)} coordinator={coordinator}",
                      file=sys.stderr)
        return True

    def _reconcile(self, hosts: List[Tuple[str, int]],
                   local_addr: str) -> bool:
        """Converge the spawned-worker set onto the desired slot set
        (discovery capacity minus blacklist/holds, capped by max-np and
        the autoscaler's :meth:`request_world_size` target): spawn into
        added slots, mark workers on removed slots ``leaving`` (they
        stay members until the next rendezvous hands them ``shutdown``
        — the epoch boundary).  Returns whether membership changed, so
        the caller drives the reset epoch.  A method (not loop-inline)
        so resize unit tests exercise both directions processlessly."""
        desired = set(self._desired_slots(hosts))
        with self._cv:
            occupied = self._occupied_slots()
            added = desired - occupied
            # already-leaving workers are in flight toward their
            # shutdown reply — re-marking them every poll would spin
            # membership epochs until they exit
            removed = {(w.host, w.slot) for w in self._alive_workers()
                       if not w.leaving} - desired
            if not added and not removed:
                return False
            for w in self._alive_workers():
                if (w.host, w.slot) in removed:
                    # keep it alive through the next rendezvous; it
                    # exits after the "shutdown" reply
                    w.leaving = True
            for h, s in sorted(added):
                self._spawn(h, s, local_addr)
        return True

    # -- main loop ---------------------------------------------------------

    def run(self) -> int:
        from .launch import ensure_sigterm_unwinds

        # a terminated driver must unwind so the finally below reaps the
        # worker fleet instead of orphaning it
        restore_handler = ensure_sigterm_unwinds()
        # driver-side scrape endpoint (its own env var: the driver shares
        # a host with worker 0, so it must not claim the workers' base
        # port): HVD_TPU_DRIVER_METRICS_PORT, same off-by-default rules
        from ..metrics import exposition as _exposition
        from ..utils.logging import set_log_context

        # the driver shares the workers' log formatter: its records
        # carry rank="driver" so a collated multi-process log separates
        # cleanly (HVD_TPU_LOG_JSON gives the machine-ingestable form)
        set_log_context(rank="driver")
        # ... and the workers' /trace surface: the driver records real
        # spans of its own (fleet.scale decisions), so the recorder
        # installs FULLY here — rank -1 keeps its exports/bundles off
        # every worker's pid lane in a merge, and the flight baseline
        # makes driver bundles carry true metric DELTAS
        from .. import trace as _trace

        _trace.install_from_env(rank=-1)
        _exposition.maybe_start_from_env(
            env_var="HVD_TPU_DRIVER_METRICS_PORT")
        host, port = self._start_server()
        # workers resolve the driver by this address; local workers can
        # always use loopback
        driver_addr = f"{host}:{port}"
        try:
            return self._run(driver_addr, host)
        finally:
            self._shutdown = True
            if self._autoscaler is not None:
                self._autoscaler.stop()
            try:
                self._server.close()
            except OSError:
                pass
            from .launch import reap_workers

            # terminate → grace → kill: a worker may handle SIGTERM
            # itself (the preemption guard's planned leave)
            reap_workers([w.proc for w in self._workers.values()
                          if w.alive])
            restore_handler()

    def _run(self, driver_addr: str, driver_host: str) -> int:
        log = get_logger()
        # a resize plan whose first entry is t=0 sets the INITIAL world
        # target too (the autoscaler only starts after the first
        # rendezvous — without this, a "start at 2 of 4 slots" drill
        # would boot at capacity and immediately shrink)
        from ..fleet.policy import plan_from_env

        plan = plan_from_env()
        if plan is not None and plan.plan[0][0] <= 0:
            self.request_world_size(plan.plan[0][1])
        # wait for the initial host set to satisfy min_np
        deadline = time.time() + self.timeout
        while True:
            hosts = self.discovery.find_available_hosts()
            slots = self._desired_slots(hosts)
            if len(slots) >= self.min_np:
                break
            if time.time() > deadline:
                print(f"[runner elastic] timed out waiting for >= "
                      f"{self.min_np} slots", file=sys.stderr)
                return 1
            time.sleep(self.poll_interval)

        local_addr = driver_addr
        if all(h in _LOCAL_HOSTS for h, _ in slots):
            local_addr = f"127.0.0.1:{driver_addr.rsplit(':', 1)[1]}"
        with self._cv:
            for h, s in slots:
                self._spawn(h, s, local_addr)
        if not self._complete_rendezvous(driver_host):
            return 1

        # fleet autoscaler (docs/FLEET.md): a timed drill plan
        # (HVD_TPU_FLEET_PLAN) or armed SLO targets start the loop
        # that drives request_world_size; nothing set = pre-fleet
        # capacity tracking, untouched
        from ..fleet.autoscaler import maybe_training_autoscaler

        self._autoscaler = maybe_training_autoscaler(
            self.request_world_size, self.current_world,
            min_size=self.min_np, max_size=self.max_np)
        if self._autoscaler is not None:
            self._autoscaler.start()

        last_poll = time.time()
        while True:
            time.sleep(0.1)
            with self._cv:
                _, had_failure = self._observe_exits()
                if self._failure_reported:
                    # a live member says its control plane died: run a
                    # failure reset epoch now — survivors recover from
                    # their commit polls instead of waiting for the
                    # failing process's death to close sockets
                    self._failure_reported = False
                    had_failure = True
                membership_changed = had_failure
                alive = self._alive_workers()
            if not alive and not membership_changed:
                # job over: success iff every member of the final epoch
                # exited cleanly (recovered-from failures of earlier
                # epochs don't count against the job — reference behavior)
                members = getattr(self, "_members", [])
                ok = members and all(
                    self._workers[wid].exit_code == 0 for wid in members
                )
                return 0 if ok else 1

            # a leaving (preempted) worker's clean exit happened: the
            # survivors need a planned reset epoch NOW, and a resize
            # request wants its reconcile before the next poll tick
            with self._cv:
                if self._leaver_exited:
                    self._leaver_exited = False
                    membership_changed = True
                poll_now = self._poll_asap
                self._poll_asap = False

            # discovery poll (suspended once the job is completing)
            if not getattr(self, "_completing", False) and (
                    poll_now
                    or time.time() - last_poll >= self.poll_interval):
                last_poll = time.time()
                try:
                    hosts = self.discovery.find_available_hosts()
                except RuntimeError as e:
                    log.warning("elastic: discovery failed: %s", e)
                    hosts = None
                if hosts is not None:
                    membership_changed |= self._reconcile(hosts,
                                                          local_addr)

            # a worker that exec-restarted itself (failure recovery) shows
            # up as an out-of-band rendezvous request: serve it with a new
            # epoch even if no process exit was observed
            with self._cv:
                if self._pending_rendezvous and not membership_changed:
                    membership_changed = True

            if membership_changed:
                with self._cv:
                    alive = self._alive_workers()
                if len(alive) < self.min_np:
                    # wait (bounded) for discovery to refill capacity
                    refill_deadline = time.time() + self.timeout
                    while len(alive) < self.min_np:
                        if time.time() > refill_deadline:
                            print("[runner elastic] world below --min-np "
                                  "and no new hosts; aborting",
                                  file=sys.stderr)
                            return 1
                        time.sleep(self.poll_interval)
                        try:
                            hosts = self.discovery.find_available_hosts()
                        except RuntimeError:
                            continue
                        with self._cv:
                            # a worker dying during this wait must be
                            # reaped (and its slot blacklisted) here, or
                            # the ghost counts toward min_np below; a
                            # crash also upgrades the pending notification
                            # to failure=True so survivors take the
                            # restart-recovery path, not the graceful one
                            had_failure |= self._observe_exits()[1]
                            desired = set(self._desired_slots(hosts))
                            for h, s in sorted(desired -
                                               self._occupied_slots()):
                                self._spawn(h, s, local_addr)
                            alive = self._alive_workers()
                self._epoch += 1
                self._notify_hosts_updated(failure=had_failure)
                if not self._complete_rendezvous(driver_host):
                    print("[runner elastic] rendezvous failed; aborting",
                          file=sys.stderr)
                    return 1
