"""Elastic scale-down through the port's launcher, with the restart
cost of a 100 MB state, and a terminated driver reaping its workers
(the JAX package's ``tests/test_elastic.py`` scale-down, restart-cost
and reaping tests on the port).  The job and its worker are
``test_torch_elastic_jobs.py``'s."""

import os
import signal
import time

import pytest

from test_torch_elastic_jobs import (
    elastic_job, finish, read_logs, wait_for,
)

BALLAST = 100_000_000


def test_elastic_scale_down_restart_cost_100mb(tmp_path):
    """Start at 2 workers with 100 MB of state each, remove a slot
    mid-run: the displaced worker takes the rendezvous "shutdown" reply
    and exits 0, the survivor exec-restarts with its LIVE state (a
    planned change: no rollback) and finishes every batch alone.  The
    restart carried the 100 MB in its memfd, and the snapshot's write
    and read are a small part of the restart."""
    proc, hosts, logdir = elastic_job(tmp_path, "localhost:2\n",
                                      batches=20, final_world=1, hold=6,
                                      ballast=BALLAST)
    wait_for(proc, logdir, lambda ev: any(
        e["event"] == "batch" and e["world"] == 2 for e in ev),
        "2-world training")
    hosts.write_text("localhost:1\n")
    _, err = finish(proc, "elastic scale-down")
    events = read_logs(logdir)
    dones = [e for e in events if e["event"] == "done"]
    assert len(dones) == 1 and dones[0]["world"] == 1, dones
    # no lost or duplicated batches across the resize
    assert dones[0]["weight"] == 20.0
    assert any(e["event"] == "batch" and e["world"] == 2 for e in events)
    assert any(e["event"] == "batch" and e["world"] == 1 for e in events)
    # GRACEFUL path, not crash recovery: nobody failed
    assert "failed with exit code" not in err, err[-2000:]
    stats = [e for e in events if e["event"] == "restart_stats"]
    assert stats, "no restart_stats event after the planned change"
    for s in stats:
        assert s["snapshot_bytes"] > BALLAST, s
        assert s["persist_s"] + s["restore_s"] < 10.0, s
        assert s["total_s"] < 60.0, s


def test_terminated_driver_reaps_workers(tmp_path):
    """SIGTERM on the launcher takes the worker fleet down with it."""
    proc, hosts, logdir = elastic_job(tmp_path, "localhost:2\n",
                                      batches=10000, final_world=2,
                                      hold=10000, min_np=2)
    try:
        events = wait_for(proc, logdir, lambda ev: sum(
            1 for e in ev if e["event"] == "init") >= 2,
            "worker initialization")
        pids = [e["pid"] for e in events if e["event"] == "init"]
        proc.terminate()
        proc.wait(timeout=30)
        deadline = time.time() + 15
        alive = pids
        while time.time() < deadline and alive:
            alive = []
            for pid in pids:
                try:
                    os.kill(pid, 0)
                    alive.append(pid)
                except OSError:
                    pass
            time.sleep(0.2)
        for pid in alive:  # clean up before failing
            os.kill(pid, signal.SIGKILL)
        if alive:
            pytest.fail(f"orphaned workers survived driver SIGTERM: {alive}")
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
