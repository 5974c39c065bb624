"""Elastic jobs through the port's launcher (``python -m
horovod_tpu_torch.runner --host-discovery-script ...``), gloo workers on
the CPU — the technique of the JAX package's ``tests/test_elastic.py``
(itself the reference's test/integration/test_elastic_torch.py): a
discovery script reads a mutable hosts file; the tests mutate it or
``kill -9`` a worker and assert the training bookkeeping survived.

Each batch "trains" by allreducing a gradient of 1.0 (Average) into the
state's weight and commits, so the final weight must equal the number of
batches EXACTLY: a lost or duplicated batch would show.  A worker holds
at batch ``hold`` (committing, not training) until the world reaches the
size the test ends at, so the membership change always lands mid-run
however slow the host is.

This file: scale-up 1→2 and kill -9 recovery 2→1;
``test_torch_elastic_resize.py``: scale-down with a 100 MB state and a
terminated driver reaping its workers.
"""

import json
import os
import signal
import stat
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
#: the elastic driver's bound on rendezvous and refill waits in the jobs
JOB_TIMEOUT_S = 45
#: the whole job's bound
RUN_TIMEOUT_S = 150

WORKER = r'''
import json, os, sys, time
import numpy as np
import torch
import horovod_tpu_torch as hvd


def log(logdir, **kv):
    wid = os.environ.get("HVD_TPU_ELASTIC_WORKER_ID", "na")
    with open(os.path.join(logdir, f"worker_{wid}.log"), "a") as f:
        f.write(json.dumps(kv) + "\n")


logdir, batches = sys.argv[1], int(sys.argv[2])
final_world, hold = int(sys.argv[3]), int(sys.argv[4])
ballast = int(sys.argv[5]) if len(sys.argv) > 5 else 0
hvd.init(device="cpu")
log(logdir, event="init", rank=hvd.rank(), world=hvd.size(),
    pid=os.getpid())
extra = {"ballast": np.ones(ballast // 8)} if ballast else {}
state = hvd.elastic.TpuState(weight=torch.zeros((), dtype=torch.float64),
                             batch=0, **extra)


def on_reset():
    from horovod_tpu_torch.elastic import worker as elastic_worker

    log(logdir, event="reset", world=hvd.size())
    if elastic_worker.last_restart_stats:
        log(logdir, event="restart_stats",
            **elastic_worker.last_restart_stats)


state.register_reset_callbacks([on_reset])


@hvd.elastic.run
def train(state):
    while state.batch < batches:
        if state.batch >= hold and hvd.size() != final_world:
            state.commit()  # wait here for the membership change
            time.sleep(0.05)
            continue
        grad = hvd.allreduce(torch.ones((), dtype=torch.float64),
                             op=hvd.Average)
        state.weight = state.weight + grad
        state.batch += 1
        state.commit()
        log(logdir, event="batch", batch=state.batch, world=hvd.size(),
            rank=hvd.rank(), weight=float(state.weight))
        time.sleep(0.02)
    return float(state.weight)


final = train(state)
assert abs(final - batches) < 1e-9, (final, batches)
log(logdir, event="done", weight=final, world=hvd.size(), rank=hvd.rank())
'''


def write_discovery(tmp_path, hosts_content):
    hosts = tmp_path / "hosts.txt"
    hosts.write_text(hosts_content)
    script = tmp_path / "discover.sh"
    script.write_text(f"#!/bin/sh\ncat {hosts}\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return hosts, script


def elastic_job(tmp_path, hosts_content, *, batches, final_world, hold,
                min_np=1, ballast=None):
    """Start the launcher in elastic mode on the worker above:
    ``(process, hosts file, log directory)``."""
    hosts, script = write_discovery(tmp_path, hosts_content)
    logdir = tmp_path / "logs"
    logdir.mkdir()
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           "--host-discovery-script", str(script), "--min-np", str(min_np),
           "--", sys.executable, str(worker), str(logdir), str(batches),
           str(final_world), str(hold)]
    if ballast:
        cmd.append(str(ballast))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               HVD_TPU_ELASTIC_TIMEOUT=str(JOB_TIMEOUT_S))
    proc = subprocess.Popen(cmd, env=env, cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, hosts, logdir


def read_logs(logdir):
    events = []
    for name in sorted(os.listdir(logdir)):
        with open(os.path.join(logdir, name)) as f:
            for line in f:
                ev = json.loads(line)
                ev["worker"] = name
                events.append(ev)
    return events


def wait_for(proc, logdir, pred, what, timeout=90):
    """Poll the workers' logs until ``pred(events)``; fail (killing the
    job) on timeout or an early exit."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        events = read_logs(logdir)
        if pred(events):
            return events
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    proc.kill()
    out, err = proc.communicate()
    pytest.fail(f"{what} never happened (rc={proc.returncode}):\n"
                f"{err[-3000:]}")


def finish(proc, what):
    try:
        out, err = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"{what} job hung:\n{err[-3000:]}")
    assert proc.returncode == 0, f"stdout:{out[-2000:]}\nstderr:{err[-3000:]}"
    return out, err


def test_elastic_scale_up(tmp_path):
    """Start at 1 worker, add a slot mid-run, finish at 2: every worker
    ends with weight == batches, and worker 0 really trained alone
    first (its world-1 reset happens in process)."""
    proc, hosts, logdir = elastic_job(tmp_path, "localhost:1\n",
                                      batches=24, final_world=2, hold=6)
    wait_for(proc, logdir, lambda ev: any(
        e["event"] == "batch" and e["batch"] >= 3 for e in ev),
        "training alone")
    hosts.write_text("localhost:2\n")
    finish(proc, "elastic scale-up")
    events = read_logs(logdir)
    dones = [e for e in events if e["event"] == "done"]
    assert len(dones) == 2, f"expected 2 finishers: {dones}"
    assert all(e["world"] == 2 for e in dones)
    assert all(e["weight"] == 24.0 for e in dones)
    assert any(e["event"] == "batch" and e["world"] == 1 for e in events)
    assert any(e["event"] == "reset" and e["world"] == 2 for e in events)


def test_elastic_fault_recovery(tmp_path):
    """Kill -9 rank 1 while both train; the survivor's allreduce raises
    HorovodInternalError (gloo: the closed peer), it rolls back to its
    last commit, exec-restarts with the memfd snapshot and finishes
    alone with the exact weight."""
    proc, hosts, logdir = elastic_job(tmp_path, "localhost:2\n",
                                      batches=24, final_world=1, hold=6)
    events = wait_for(proc, logdir, lambda ev: any(
        e["event"] == "batch" and e["world"] == 2 and e["batch"] >= 2
        for e in ev), "training in the 2-world")
    victim = next(e["pid"] for e in events
                  if e["event"] == "init" and e["rank"] == 1)
    os.kill(victim, signal.SIGKILL)
    _, err = finish(proc, "elastic fault-recovery")
    events = read_logs(logdir)
    dones = [e for e in events if e["event"] == "done"]
    assert len(dones) == 1 and dones[0]["world"] == 1, dones
    assert dones[0]["weight"] == 24.0
    # the survivor recovered via exec-restart: it initialized twice
    # (first in the 2-world, then alone), same pid, and trained in both
    survivor = dones[0]["worker"]
    inits = [e for e in events
             if e["event"] == "init" and e["worker"] == survivor]
    assert [e["world"] for e in inits] == [2, 1], inits
    assert len({e["pid"] for e in inits}) == 1
    assert any(e["event"] == "restart_stats" and e["worker"] == survivor
               for e in events)
    assert any(e["event"] == "batch" and e["world"] == 1
               and e["worker"] == survivor for e in events)
    assert "failed with exit code -9" in err
