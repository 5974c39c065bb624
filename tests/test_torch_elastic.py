"""The port's elastic state, sampler and run loop (``horovod_tpu_torch.
elastic``) — the unit tests of ``tests/test_elastic.py`` on the port,
and the checks it adds:

* ``ElasticSampler`` gives the JAX package's indices for the same size,
  world, rank, seed, epoch and progress;
* ``TpuState`` (module + optimizer + scalars) snapshots host copies and
  restores them IN PLACE: the same ``Parameter`` objects, so a training
  step built before the restore keeps working and reproduces the run;
* a dead peer under gloo raises ``HorovodInternalError`` from the
  port's collectives (spawned ranks);
* the memfd exec-restart hands a committed snapshot to the next process
  image (a spawned process that execs itself).

The jobs through the launcher (scale-up, kill -9 recovery, scale-down)
are in ``test_torch_elastic_jobs.py`` and ``test_torch_elastic_resize.py``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu.elastic.sampler import ElasticSampler as JaxSampler
from horovod_tpu_torch import elastic
from horovod_tpu_torch.common.exceptions import (
    HorovodInternalError, HostsUpdatedInterrupt,
)
from horovod_tpu_torch.elastic import ElasticSampler, ObjectState, TpuState

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def world_one():
    """A world of one on the CPU (the state's sync broadcasts need it)."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


# -- unit: state ------------------------------------------------------------

def test_object_state_commit_restore():
    state = ObjectState(weight=torch.ones((2,)), epoch=0)
    state.weight = state.weight + 5.0
    state.epoch = 3
    state.restore()  # nothing committed since construction
    np.testing.assert_allclose(state.weight.numpy(), [1.0, 1.0])
    assert state.epoch == 0

    state.weight = state.weight + 2.0
    state.epoch = 7
    state.commit()
    state.weight = state.weight * 100
    state.restore()
    np.testing.assert_allclose(state.weight.numpy(), [3.0, 3.0])
    assert state.epoch == 7


def test_object_state_snapshots_are_host_arrays():
    """Snapshots hold CPU copies that share no storage with the live
    tensors (a later in-place update never reaches them)."""
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    w = torch.ones((3,))
    state = TpuState(model=model, optimizer=opt, w=w)
    state.commit()
    kind, payload = state._saved["w"]
    assert kind == "__value__" and payload.device.type == "cpu"
    assert payload.data_ptr() != w.data_ptr()
    kind, sd = state._saved["model"]
    assert kind == "__state_dict__"
    assert sd["weight"].data_ptr() != model.weight.data_ptr()
    kind, osd = state._saved["optimizer"]
    exp_avg = osd["state"][0]["exp_avg"]
    assert exp_avg.data_ptr() != opt.state[model.weight]["exp_avg"].data_ptr()
    with torch.no_grad():
        w.add_(1.0)
        model.weight.add_(1.0)
    assert float(state._saved["w"][1][0]) == 1.0
    state._materialize_to_host()  # a no-op: torch tensors outlive groups
    assert state.w is w


def test_object_state_sync_single_process():
    state = ObjectState(x=1)
    state.x = 42
    state.sync()  # world has one process: identity, but must re-save
    state.x = 0
    state.restore()
    assert state.x == 42


def test_state_dict_objects_roundtrip():
    sampler = ElasticSampler(10, shuffle=False)
    state = ObjectState(sampler=sampler, epoch=0)
    sampler.record_batch(0, 2)
    state.commit()
    sampler.record_batch(1, 2)
    assert len(sampler.processed_indices) == 4
    state.restore()
    assert len(sampler.processed_indices) == 2
    assert state.sampler is sampler  # restored through load_state_dict


def test_tpu_state_restores_in_place_and_training_resumes(world_one):
    """Commit after step 2, train on, restore: the module's Parameters
    are the same objects at the same storage, the optimizer state is
    the committed one, and the step built before the restore (whose
    gradient hooks are bound to those Parameters) re-runs steps 3-4 to
    the uninterrupted run's bits."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import MLP

    model = MLP(8, features=(16,), num_classes=10, device="cpu",
                generator=torch.Generator().manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    step = training.data_parallel_train_step(model, opt, overlap=True)
    ts = training.create_train_state(model, opt)
    rs = np.random.RandomState(0)
    batches = [(torch.from_numpy(rs.rand(4, 8).astype(np.float32)),
                torch.from_numpy(rs.randint(0, 10, (4,)))) for _ in range(4)]
    ids = [(id(p), p.data_ptr()) for p in model.parameters()]
    state = TpuState(model=model, optimizer=opt, step=0)
    losses = []
    for i, (x, y) in enumerate(batches):
        ts, loss = step(ts, x, y)
        losses.append(loss.item())
        state.step = i + 1
        if i == 1:
            state.commit()
    final = [p.detach().clone() for p in model.parameters()]
    state.restore()
    assert state.step == 2
    assert [(id(p), p.data_ptr()) for p in model.parameters()] == ids
    again = []
    for x, y in batches[2:]:
        ts, loss = step(ts, x, y)
        again.append(loss.item())
    assert again == losses[2:]
    for a, b in zip(final, model.parameters()):
        assert torch.equal(a, b)


def test_tpu_state_sync_and_auto_resume(world_one, tmp_path):
    """sync() at world 1 (broadcast_parameters + the optimizer state +
    one object broadcast) keeps everything; auto-resume restores a
    state checkpoint that is ahead of the live step, and only then."""
    from horovod_tpu_torch import checkpoint

    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.5, momentum=0.9)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    state = TpuState(model=model, optimizer=opt, step=5,
                     sampler=ElasticSampler(6, shuffle=False))
    before = model.weight.detach().clone()
    state.sync()
    assert torch.equal(model.weight, before)
    assert opt.param_groups[0]["lr"] == 0.5 and state.step == 5
    checkpoint.save_state_checkpoint(str(tmp_path), state, 5)
    with torch.no_grad():
        model.weight.zero_()
    state.step = 7
    state.enable_auto_resume(str(tmp_path))
    assert state.maybe_auto_resume() is None  # live state is ahead
    state.step = 3
    assert state.maybe_auto_resume() == 5
    assert state.step == 5 and torch.equal(model.weight, before)


# -- unit: sampler ----------------------------------------------------------

def test_elastic_sampler_shards_and_records():
    s = ElasticSampler(12, shuffle=False)
    s.num_replicas, s.rank = 2, 0
    s._reshard()
    assert len(s) == 6
    assert list(iter(s)) == [0, 1, 2, 3, 4, 5]
    # one global batch of size 2 consumes 2 indices from each replica
    s.record_batch(0, 2)
    assert sorted(s.processed_indices) == [0, 1, 6, 7]
    # resharding over a new world covers exactly the remaining indices
    s.num_replicas, s.rank = 4, 3
    s._reshard()
    remaining = set(range(12)) - {0, 1, 6, 7}
    shards = [list(s._shard_for(r)) for r in range(4)]
    assert set(sum(shards, [])) == remaining
    assert all(len(sh) == 2 for sh in shards)


def test_elastic_sampler_set_epoch_resets_progress():
    s = ElasticSampler(8, shuffle=True, seed=1)
    s.num_replicas, s.rank = 1, 0
    s.record_batch(0, 4)
    assert len(s.processed_indices) == 4
    s.set_epoch(1)
    assert s.processed_indices == []
    assert len(s) == 8
    # epoch shuffles differ
    s2 = ElasticSampler(8, shuffle=True, seed=1)
    s2.num_replicas, s2.rank = 1, 0
    s2.set_epoch(2)
    assert list(iter(s)) != list(iter(s2))


SAMPLER_CASES = [
    # size, world, rank, seed, epoch, batches recorded (of size 3)
    (37, 1, 0, 0, 0, 0),
    (37, 3, 2, 5, 1, 2),
    (100, 4, 1, 11, 3, 5),
    (64, 2, 0, 7, 0, 4),
    (10, 3, 1, 2, 9, 1),
]


@pytest.mark.parametrize("size,world,rank,seed,epoch,done", SAMPLER_CASES)
def test_elastic_sampler_matches_reference(size, world, rank, seed, epoch,
                                           done):
    """Same size, world, rank, seed, epoch and progress: the port's
    indices, shards and state_dict are the JAX package's, and so are
    they after a reshard onto another world."""
    got, want = ElasticSampler(size, seed=seed), JaxSampler(size, seed=seed)
    for s in (got, want):
        s.num_replicas, s.rank = world, rank
        s.set_epoch(epoch)
        for b in range(done):
            s.record_batch(b, 3)
    assert list(iter(got)) == list(iter(want))
    assert got.state_dict() == want.state_dict()
    for s in (got, want):
        s.num_replicas, s.rank = world + 1, 0
        s._reshard()
    assert [list(got._shard_for(r)) for r in range(world + 1)] == \
        [list(want._shard_for(r)) for r in range(world + 1)]
    fresh = ElasticSampler(size, seed=seed)
    fresh.num_replicas, fresh.rank = world, rank
    fresh.load_state_dict(want.state_dict())
    assert fresh.processed_indices == want.processed_indices


# -- unit: run wrapper ------------------------------------------------------

def test_run_wrapper_restores_then_restarts_on_internal_error(monkeypatch):
    class Restarted(Exception):
        pass

    seen = {}

    def fake_restart(state):
        seen["value_at_restart"] = state.value
        raise Restarted()  # the real one exec-replaces the process

    monkeypatch.setattr(elastic, "elastic_enabled", lambda: True)
    monkeypatch.setattr(elastic, "restart_after_failure", fake_restart)

    state = ObjectState(value=0)

    @elastic.run
    def train(state):
        state.value = 999  # uncommitted progress that must roll back
        raise HorovodInternalError("peer died")

    with pytest.raises(Restarted):
        train(state)
    assert seen["value_at_restart"] == 0  # restored before the restart


def test_run_wrapper_reraises_without_elastic_driver():
    state = ObjectState(value=0)

    @elastic.run
    def train(state):
        state.value = 999
        raise HorovodInternalError("peer died")

    # no driver to re-rendezvous with: the original failure surfaces,
    # with the state rolled back to the last commit
    with pytest.raises(HorovodInternalError):
        train(state)
    assert state.value == 0


def _fired_watchdog(monkeypatch, state, failure, snapshot_timeout=5.0):
    """Drive WorkerNotificationManager._failure_watchdog to the point of
    forced restart and capture what snapshot it would persist."""
    from horovod_tpu_torch.elastic import worker as w

    persisted = {}

    def fake_persist(snap):
        persisted["snap"] = snap
        raise SystemExit(0)  # the real one execv-replaces the process

    monkeypatch.setattr(w, "_persist_and_exec", fake_persist)
    monkeypatch.setattr(w, "_FAILURE_GRACE", 0.2)
    monkeypatch.setattr(w, "_PLANNED_SNAPSHOT_TIMEOUT", snapshot_timeout)

    mgr = w.WorkerNotificationManager()
    mgr.watch_state(state)
    mgr._pending_epoch = 1
    mgr._pending_failure = failure
    with pytest.raises(SystemExit):
        mgr._failure_watchdog()
    return persisted["snap"]


def test_watchdog_failure_rolls_back_to_commit(monkeypatch):
    state = ObjectState(value=1)
    state.commit()
    state.value = 999  # uncommitted live progress
    snap = _fired_watchdog(monkeypatch, state, failure=True)
    assert snap is not None
    restored = ObjectState(value=0)
    restored._apply_snapshot(snap)
    assert restored.value == 1


def test_watchdog_planned_change_keeps_live_state(monkeypatch):
    state = ObjectState(value=1)
    state.commit()
    state.value = 999
    snap = _fired_watchdog(monkeypatch, state, failure=False)
    restored = ObjectState(value=0)
    restored._apply_snapshot(snap)
    assert restored.value == 999


def test_watchdog_planned_change_falls_back_when_snapshot_blocks(monkeypatch):
    state = ObjectState(value=1)
    state.commit()
    state.value = 999

    real_snapshot = state._snapshot

    def blocked_snapshot():
        time.sleep(60)
        return real_snapshot()

    state._snapshot = blocked_snapshot
    snap = _fired_watchdog(
        monkeypatch, state, failure=False, snapshot_timeout=0.3
    )
    restored = ObjectState(value=0)
    restored._apply_snapshot(snap)
    assert restored.value == 1


def test_run_wrapper_keeps_state_on_hosts_updated(monkeypatch):
    monkeypatch.setattr(elastic, "reset_world", lambda state: None)

    state = ObjectState(value=0, attempts=0)

    @elastic.run
    def train(state):
        state.attempts += 1
        if state.attempts == 1:
            state.value = 7  # planned update: state survives un-rolled-back
            raise HostsUpdatedInterrupt(skip_sync=True)
        return state.value

    assert train(state) == 7


# -- spawned processes --------------------------------------------------------

DEAD_PEER = r'''
import os, sys, time
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import HorovodInternalError

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
hvd.init(device="cpu", rank=rank, size=2, init_method=f"file://{store}")
hvd.allreduce(torch.ones(3))
if rank == 1:
    os._exit(9)
time.sleep(0.5)
kinds = []
for call in (lambda: hvd.allreduce(torch.ones(3)),
             lambda: hvd.broadcast_object("x", root_rank=1),
             lambda: hvd.allgather_object(1)):
    try:
        call()
        kinds.append("none")
    except HorovodInternalError:
        kinds.append("HorovodInternalError")
    except Exception as e:
        kinds.append(type(e).__name__)
open(out, "w").write(",".join(kinds))
os._exit(0)
'''


def test_dead_peer_raises_horovod_internal_error(tmp_path):
    """gloo reports a closed peer as a plain RuntimeError; the port's
    collectives (an allreduce's wait, the object broadcasts) turn it
    into HorovodInternalError, the signal elastic.run recovers from."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = tmp_path / "kinds.txt"
    procs = [subprocess.Popen(
        [sys.executable, "-c", DEAD_PEER, str(r), str(tmp_path / "store"),
         str(out)], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=60)[0] for p in procs]
    assert procs[0].returncode == 0, logs[0][-3000:]
    assert out.read_text().split(",") == ["HorovodInternalError"] * 3


EXEC_RESTART = r'''
import json, os, sys
import numpy as np
import torch
from horovod_tpu_torch.elastic import TpuState, worker

out = sys.argv[1]
model = torch.nn.Linear(4, 3)
state = TpuState(model=model, step=0, ballast=np.arange(1000.0))
state.register_reset_callbacks([lambda: open(out + ".reset", "a").write("r")])
worker.maybe_restore_after_restart(state)
if worker.last_restart_stats is None:
    with torch.no_grad():
        model.weight.fill_(3.0)
    state.step = 7
    state.commit()
    state.step = 99  # uncommitted: restart_after_failure carries the LIVE
    worker.restart_after_failure(state)  # snapshot; does not return
json.dump({"step": state.step, "w": float(model.weight[0, 0]),
           "ballast": float(state.ballast.sum()),
           "stats": worker.last_restart_stats, "pid": os.getpid()},
          open(out, "w"))
'''


def test_exec_restart_carries_the_snapshot(tmp_path):
    """restart_after_failure persists the state in a memfd and execs the
    same program in place (same PID); the new image's
    maybe_restore_after_restart loads it, books the restart split and
    fires the reset callbacks."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("HVD_TPU_ELASTIC", None)
    out = tmp_path / "out.json"
    script = tmp_path / "restart.py"
    script.write_text(EXEC_RESTART)
    proc = subprocess.Popen([sys.executable, str(script), str(out)],
                            env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    log = proc.communicate(timeout=60)[0]
    assert proc.returncode == 0, log[-3000:]
    res = json.loads(out.read_text())
    assert res["pid"] == proc.pid
    assert res["step"] == 99 and res["w"] == 3.0
    assert res["ballast"] == float(np.arange(1000.0).sum())
    stats = res["stats"]
    assert stats["snapshot_bytes"] > 8000
    assert stats["total_s"] >= stats["reboot_s"] > 0
    assert (tmp_path / "out.json.reset").read_text() == "r"
