"""The port's launcher (``python -m horovod_tpu_torch.runner``), its
control-plane signing (``common/wire_auth.py``), the elastic driver's
bookkeeping and the preemption notice — the tests of the JAX package's
``tests/test_launcher.py``, ``tests/test_control_auth.py`` (wire auth),
``tests/test_fleet.py`` (driver resize, preemption) that apply, and:

* a message signed by either package's ``wire_auth`` verifies in the
  other, and so do the drivers' ``_signed_line`` / ``_verified`` and
  the workers' ``_send_line`` / ``_recv_line``;
* ``-np 2`` and ``-np 3`` gloo jobs whose ranks check every collective
  and the placement the launcher exported.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from horovod_tpu.common import wire_auth as jwire
from horovod_tpu.elastic import worker as jworker
from horovod_tpu.runner import elastic_driver as jdriver
from horovod_tpu_torch.common import wire_auth
from horovod_tpu_torch.elastic import worker as tworker
from horovod_tpu_torch.runner import elastic_driver as ed
from horovod_tpu_torch.runner import launch

ROOT = Path(__file__).resolve().parents[1]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")


# -- parsing and configuration -----------------------------------------------


def test_host_parsing():
    assert launch.parse_host_spec("h1:4,h2:2") == [("h1", 4), ("h2", 2)]
    assert launch.parse_host_spec("h1") == [("h1", 1)]


def test_hostfile_parsing(tmp_path):
    f = tmp_path / "hosts"
    f.write_text("# comment\nnode1 slots=8\nnode2 slots=4\n")
    assert launch.parse_hostfile(str(f)) == [("node1", 8), ("node2", 4)]


def test_check_build():
    out = launch.check_build()
    assert "horovod_tpu_torch" in out and "gloo" in out and "NCCL" in out
    assert "flash_fwd_sm90.cu" in out  # the kernels' build status
    assert set(launch.kernels_built()) == {
        "flash_fwd.cu", "flash_fwd_sm90.cu", "flash_decode.cu",
        "flash_bwd.cu", "flash_bwd_sm90.cu", "fused_norm.cu"}
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "--check-build"],
        env=_env(), cwd=str(ROOT), capture_output=True, text=True,
        timeout=60)
    assert res.returncode == 0 and "Available backends" in res.stdout


def test_config_file_to_env(tmp_path):
    import yaml

    from horovod_tpu_torch.runner.config_parser import (
        config_to_env, load_config_file,
    )

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "fusion_threshold": 1234, "autotune": True, "log_level": "debug",
    }))
    args = launch.build_parser().parse_args(
        ["--cycle-time-ms", "2.5", "--", "true"]
    )
    env = config_to_env(args, load_config_file(str(cfg)))
    assert env["HVD_TPU_FUSION_THRESHOLD"] == "1234"
    assert env["HVD_TPU_AUTOTUNE"] == "1"
    assert env["HVD_TPU_CYCLE_TIME"] == "2.5"  # CLI wins layering intact
    assert env["HVD_TPU_LOG_LEVEL"] == "debug"


def test_np_exceeding_slots_rejected(capsys):
    rc = launch.run_commandline(["-np", "4", "-H", "localhost:2", "--",
                                 "true"])
    assert rc == 2
    assert launch.run_commandline(["--min-np", "2", "--", "true"]) == 2


def test_worker_env_carries_placement_and_drops_torchrun():
    base = {"RANK": "5", "WORLD_SIZE": "8", "MASTER_PORT": "1", "PATH": "p"}
    env = launch._worker_env(base, launch._with_job_secret({}),
                             "127.0.0.1:1234", 99, 3, 2, True,
                             local_rank=2, local_size=3)
    assert "RANK" not in env and "WORLD_SIZE" not in env
    assert "MASTER_PORT" not in env and env["PATH"] == "p"
    assert env["HVD_TPU_COORDINATOR"] == "127.0.0.1:1234"
    assert (env["HVD_TPU_NUM_PROCESSES"], env["HVD_TPU_PROCESS_ID"],
            env["HVD_TPU_LOCAL_RANK"], env["HVD_TPU_LOCAL_SIZE"]) == \
        ("3", "2", "2", "3")
    assert env["HVD_TPU_DISABLE_NATIVE"] == "1"
    assert len(env[wire_auth.SECRET_ENV]) == 64


# -- real jobs ---------------------------------------------------------------

WORKER = textwrap.dedent(r'''
    import os, sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    n = int(sys.argv[1])
    assert "RANK" not in os.environ and "WORLD_SIZE" not in os.environ
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    assert size == n and rank == int(os.environ["HVD_TPU_PROCESS_ID"])
    assert hvd.local_rank() == rank and hvd.local_size() == n
    assert len(os.environ["HVD_TPU_SECRET"]) == 64
    out = hvd.allreduce(torch.tensor([float(rank)]))
    assert out.item() == np.mean(np.arange(n)), out
    out = hvd.allreduce(torch.ones(4), op=hvd.Sum, prescale_factor=2.0)
    assert torch.equal(out, torch.full((4,), 2.0 * n))
    out = hvd.allreduce(torch.tensor([rank + 1, 10 - rank], dtype=torch.int32),
                        op=hvd.Min)
    assert out.tolist() == [1, 10 - (n - 1)]
    out = hvd.allreduce(torch.tensor([rank + 1]), op=hvd.Max)
    assert out.tolist() == [n]
    tree = hvd.allreduce({"a": torch.full((3,), float(rank)),
                          "b": torch.ones(2, 2)}, op=hvd.Sum)
    assert torch.equal(tree["b"], torch.full((2, 2), float(n)))
    g = hvd.allgather(torch.full((rank + 1, 2), float(rank)))
    assert g.shape == (n * (n + 1) // 2, 2)
    b = hvd.broadcast(torch.tensor([float(rank)] * 3), root_rank=n - 1)
    assert b.tolist() == [float(n - 1)] * 3
    assert hvd.broadcast_object({"r": rank}, root_rank=1) == {"r": 1}
    assert hvd.allgather_object(rank) == list(range(n))
    rs = hvd.reducescatter(torch.ones(2 * n), op=hvd.Sum)
    assert torch.equal(rs, torch.full((2,), float(n)))
    if n >= 3:
        ps = hvd.add_process_set([0, 2])
        if rank in (0, 2):
            out = hvd.allreduce(torch.tensor([float(rank)]), op=hvd.Sum,
                                process_set=ps)
            assert out.item() == 2.0
    hvd.barrier()
    print(f"WORKER_OK rank={rank}", flush=True)
''')


def _run_runner(args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", *args],
        env=_env(), cwd=str(ROOT), capture_output=True, text=True,
        timeout=timeout)


@pytest.mark.parametrize("np_,extra", [(2, ["--disable-native"]), (3, [])],
                         ids=["np2_disable_native", "np3"])
def test_runner_multiprocess_collectives(np_, extra):
    """np real gloo processes through the launcher: the placement it
    exported and every collective, checked on each rank (-np 3 adds a
    process set)."""
    res = _run_runner(["-np", str(np_), *extra, "--", sys.executable, "-c",
                       WORKER, str(np_)])
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr}"
    assert res.stdout.count("WORKER_OK") == np_


def test_runner_failure_propagates():
    res = _run_runner(["-np", "2", "--", sys.executable, "-c",
                       "import sys; sys.exit(3)"])
    assert res.returncode == 3


# -- wire auth ---------------------------------------------------------------


def test_sign_verify_roundtrip():
    secret = wire_auth.make_secret()
    msg = {"type": "rendezvous", "worker_id": 3}
    signed = wire_auth.sign_message(msg, secret)
    assert "hmac" in signed
    assert wire_auth.verify_message(signed, secret) == msg


def test_verify_rejects_tamper_and_missing():
    secret = wire_auth.make_secret()
    signed = wire_auth.sign_message({"type": "assignment", "rank": 0},
                                    secret)
    tampered = dict(signed)
    tampered["rank"] = 1
    assert wire_auth.verify_message(tampered, secret) is None
    assert wire_auth.verify_message({"type": "assignment"}, secret) is None
    wrong = wire_auth.sign_message({"type": "assignment", "rank": 0},
                                   wire_auth.make_secret())
    assert wire_auth.verify_message(wrong, secret) is None


def test_no_secret_passthrough():
    msg = {"type": "register"}
    assert wire_auth.sign_message(msg, None) == msg
    assert wire_auth.verify_message(msg, None) == msg


MESSAGES = [
    {"type": "register", "worker_id": 0},
    {"type": "assignment", "rank": 2, "num_processes": 4,
     "coordinator": "127.0.0.1:9", "native_port": 7, "local_rank": 0,
     "local_size": 2, "epoch": 3},
    {"type": "failing", "worker_id": 5, "reason": "x" * 40,
     "integrity": True},
    {"type": "hosts_updated", "epoch": 1, "failure": False},
]


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_wire_auth_verifies_across_packages(i):
    """A message signed by either package verifies in the other: the
    same canonical JSON, the same HMAC."""
    secret = wire_auth.make_secret()
    msg = MESSAGES[i]
    port_signed = wire_auth.sign_message(msg, secret)
    ref_signed = jwire.sign_message(msg, secret)
    assert port_signed == ref_signed
    assert jwire.verify_message(port_signed, secret) == msg
    assert wire_auth.verify_message(ref_signed, secret) == msg
    assert jwire.verify_message(port_signed, wire_auth.make_secret()) is None


def test_driver_and_worker_lines_verify_across_packages(monkeypatch):
    """The drivers' signed lines and the workers' (``_send_line`` over a
    socket pair) verify in the other package's reader."""
    monkeypatch.setenv(wire_auth.SECRET_ENV, wire_auth.make_secret())
    for msg in MESSAGES:
        for sign, verify in ((ed._signed_line, jdriver._verified),
                             (jdriver._signed_line, ed._verified)):
            assert verify(json.loads(sign(msg))) == msg
        for send, recv in ((tworker._send_line, jworker._recv_line),
                           (jworker._send_line, tworker._recv_line)):
            a, b = socket.socketpair()
            with a, b:
                send(a, msg)
                assert recv(b.makefile("r")) == msg
    forged = (json.dumps({"type": "shutdown"}) + "\n").encode()
    assert ed._verified(json.loads(forged)) is None


def test_elastic_driver_drops_unsigned_register(monkeypatch):
    monkeypatch.setenv(wire_auth.SECRET_ENV, wire_auth.make_secret())
    driver = ed.ElasticDriver(command=["true"], discovery=None, min_np=1)
    host, port = driver._start_server()
    try:
        # unsigned register: the driver must close the socket unacted
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall((json.dumps(
            {"type": "register", "worker_id": 0}) + "\n").encode())
        s.settimeout(10)
        assert s.recv(1) == b""  # server closed on us
        s.close()
        assert driver._notify_socks == {}

        # signed register (by the JAX package's signer): accepted
        s2 = socket.create_connection(("127.0.0.1", port), timeout=10)
        s2.sendall((json.dumps(jwire.sign_message(
            {"type": "register", "worker_id": 0},
            wire_auth.job_secret())) + "\n").encode())
        deadline = time.time() + 10
        while time.time() < deadline and 0 not in driver._notify_socks:
            time.sleep(0.05)
        assert 0 in driver._notify_socks
        s2.close()
    finally:
        driver._shutdown = True
        driver._server.close()


# -- driver resize and quarantine --------------------------------------------


class _FakeProc:
    def __init__(self):
        self.code = None
        self.killed = False

    def poll(self):
        return self.code

    def kill(self):
        self.killed = True


def _stub_driver(slots=4, min_np=1, max_np=None):
    drv = ed.ElasticDriver(
        command=["true"], discovery=None, min_np=min_np, max_np=max_np)

    def fake_spawn(host, slot, addr):
        w = ed._Worker(drv._next_worker_id, host, slot, _FakeProc())
        drv._next_worker_id += 1
        drv._workers[w.worker_id] = w
        return w

    drv._spawn = fake_spawn
    return drv, [("localhost", slots)]


def test_request_world_size_grows_and_shrinks():
    drv, hosts = _stub_driver(slots=4, min_np=1, max_np=None)
    assert drv.request_world_size(2) == 2
    assert drv._reconcile(hosts, "addr")
    assert drv.current_world() == 2
    assert {(w.host, w.slot) for w in drv._workers.values()} == \
        {("localhost", 0), ("localhost", 1)}
    drv.request_world_size(4)
    assert drv._reconcile(hosts, "addr")
    assert drv.current_world() == 4
    # shrink: the HIGHEST slots get leaving marks, nobody is killed
    drv.request_world_size(2)
    assert drv._reconcile(hosts, "addr")
    leaving = {(w.host, w.slot) for w in drv._workers.values()
               if w.alive and w.leaving}
    assert leaving == {("localhost", 2), ("localhost", 3)}
    assert drv.current_world() == 2
    assert all(w.alive for w in drv._workers.values())
    assert not drv._reconcile(hosts, "addr")


def test_request_world_size_clamps_and_resets():
    drv, hosts = _stub_driver(slots=4, min_np=2, max_np=3)
    assert drv.request_world_size(1) == 2   # min_np floor
    assert drv.request_world_size(99) == 3  # max_np ceiling
    assert drv._reconcile(hosts, "addr")
    assert drv.current_world() == 3
    assert drv.request_world_size(None) == -1
    assert not drv._reconcile(hosts, "addr")  # max_np 3 == current
    drv.max_np = None
    assert drv._reconcile(hosts, "addr")
    assert drv.current_world() == 4


def test_resize_respects_blacklist_and_holds():
    drv, hosts = _stub_driver(slots=4)
    drv._blacklist.add(("localhost", 0))
    drv._slot_hold[("localhost", 1)] = time.monotonic() + 60  # hold
    drv.request_world_size(4)
    drv._reconcile(hosts, "addr")
    used = {(w.host, w.slot) for w in drv._workers.values() if w.alive}
    assert used == {("localhost", 2), ("localhost", 3)}
    drv._slot_hold[("localhost", 1)] = time.monotonic() - 1
    drv._reconcile(hosts, "addr")
    used = {(w.host, w.slot) for w in drv._workers.values() if w.alive}
    assert ("localhost", 1) in used


def test_leaving_exit_books_scale_down_not_completion():
    drv, hosts = _stub_driver(slots=2)
    drv.request_world_size(2)
    drv._reconcile(hosts, "addr")
    w = next(iter(drv._workers.values()))
    w.leaving = True
    w.proc.code = 0
    with drv._cv:
        any_exit, any_failure = drv._observe_exits()
    assert any_exit and not any_failure
    assert not getattr(drv, "_completing", False)
    assert drv._leaver_exited


def test_integrity_report_quarantines_the_whole_host():
    """A ``failing`` report with the integrity flag (the guard's
    quarantine) blacklists every slot of the worker's host and kills its
    siblings there; other hosts keep their slots."""
    drv, _ = _stub_driver()
    hosts = [("hostA", 2), ("hostB", 2)]
    drv._reconcile(hosts, "addr")
    victim = next(w for w in drv._workers.values() if w.host == "hostA")
    with drv._cv:
        drv._quarantine_host(victim.worker_id)
    assert drv._host_blacklist == {"hostA"}
    assert [w.proc.killed for w in drv._workers.values()
            if w.host == "hostA" and w is not victim] == [True]
    assert all(h == "hostB" for h, _ in drv._desired_slots(hosts))


# -- preemption notice -------------------------------------------------------

_GUARD_SCRIPT = textwrap.dedent("""
    import json, os, signal, sys, time
    import torch
    from horovod_tpu_torch.elastic.state import ObjectState
    from horovod_tpu_torch.fleet.preemption import PreemptionGuard
    from horovod_tpu_torch.metrics import instruments as instr

    out = sys.argv[1]
    state = ObjectState(step=0, weight=torch.zeros(()))
    state.enable_auto_resume(sys.argv[2], step_attr="step")

    def on_leave(info):
        info["recovery_planned_s"] = instr.RECOVERY_SECONDS.labels(
            "planned").get()
        with open(out, "w") as f:
            json.dump(info, f)

    PreemptionGuard(state, on_leave=on_leave, poll_s=10.0).install()
    for i in range(1000):
        state.weight = state.weight + 1.0
        state.step = int(state.step) + 1
        state.commit()
        if state.step == 5:
            os.kill(os.getpid(), signal.SIGTERM)  # the notice
        time.sleep(0.02)
    sys.exit(3)  # the guard must have exited us long before
""")


def test_preemption_guard_sigterm_snapshot_leave(tmp_path):
    """A real SIGTERM: bounded planned snapshot, checkpoint published
    (any rank), recovery_seconds{planned} set, exit 0."""
    from horovod_tpu_torch import checkpoint as ckpt_mod

    out = tmp_path / "leave.json"
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD_SCRIPT, str(out), str(ckpt)],
        env=_env(), timeout=60, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    info = json.loads(out.read_text())
    assert info["snapshot"] in ("live", "commit")
    assert info["step"] >= 5
    assert 0 <= info["planned_s"] < 35.0
    assert info["recovery_planned_s"] == pytest.approx(
        info["planned_s"], abs=1.0)
    step, snap = ckpt_mod.peek_state_checkpoint(str(ckpt))
    assert step >= 5 and float(snap["weight"][1]) == float(step)
