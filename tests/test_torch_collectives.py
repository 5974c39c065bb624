"""The port's collectives against the JAX package's, bit for bit.

Integer and dyadic inputs (exact in fp32 whatever the order of the sum)
go through the port at world 2 and 4 — one process per rank, gloo over
a ``file://`` store in the test's temporary directory — and through the
JAX package's ``spmd_ops`` under ``shard_map`` on 2 or 4 of the virtual
CPU devices.  Sum, Average, Min, Max (with pre/postscale on Sum),
allgather, broadcast and reducescatter must be bit-equal, rank by rank.
The fusion plan's bucket layout must equal the JAX one, and the
lifecycle (``init``/``shutdown``, world 1 without a launcher) and the
async handles are checked in process.
"""

import os
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.ops import spmd_ops
from horovod_tpu.ops.reduce_ops import ReduceOp as JReduceOp
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import fusion as tfusion

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 120


def spawn_ranks(code, world, tmp_path, *args, timeout=JOIN_TIMEOUT_S):
    """Run ``code`` in ``world`` processes (argv: rank, world, store
    path, output path, *args), joined with a timeout that fails the test
    instead of hanging the suite; returns each rank's ``.npz`` output."""
    store = tmp_path / "store"
    outs = [tmp_path / f"rank{r}.npz" for r in range(world)]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        log = open(tmp_path / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world), str(store),
             str(outs[r]), *map(str, args)],
            cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} of {world} did not finish in "
                            f"{timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{r}.log").read_text()
    return [dict(np.load(o)) for o in outs]


def rank_inputs(rank):
    """Rank ``rank``'s integer and dyadic inputs (the workers and the
    JAX side draw the same ones)."""
    rs = np.random.RandomState(100 + rank)
    ints = rs.randint(-1000, 1000, (5, 6)).astype(np.int32)
    dyadic = (rs.randint(-2 ** 10, 2 ** 10, (8, 3)) / 64.0).astype(
        np.float32)
    return ints, dyadic


WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
assert (hvd.rank(), hvd.size(), hvd.local_rank()) == (rank, world, rank)
rs = np.random.RandomState(100 + rank)
ints = torch.from_numpy(rs.randint(-1000, 1000, (5, 6)).astype(np.int32))
dyadic = torch.from_numpy(
    (rs.randint(-2 ** 10, 2 ** 10, (8, 3)) / 64.0).astype(np.float32))
res = {}
for name, op in (("sum", hvd.Sum), ("average", hvd.Average),
                 ("min", hvd.Min), ("max", hvd.Max)):
    got = hvd.allreduce({"i": ints, "d": [dyadic]}, op=op)
    res[name + "_int"] = got["i"].numpy()
    res[name + "_dyadic"] = got["d"][0].numpy()
res["scaled"] = hvd.allreduce(dyadic, op=hvd.Sum, prescale_factor=0.5,
                              postscale_factor=4.0).numpy()
h = hvd.allreduce_async(dyadic, op=hvd.Sum)
res["async"] = hvd.synchronize(h).numpy()
assert hvd.poll(h)
res["grouped"] = np.concatenate([t.reshape(-1).numpy() for t in
                                 hvd.grouped_allreduce([dyadic, dyadic * 2])])
res["allgather"] = hvd.allgather(dyadic).numpy()
res["allgather_int"] = hvd.allgather(ints).numpy()
res["broadcast"] = hvd.broadcast(dyadic, root_rank=world - 1).numpy()
res["reducescatter"] = hvd.reducescatter(dyadic, op=hvd.Sum).numpy()
res["reducescatter_avg"] = hvd.reducescatter(dyadic, op=hvd.Average).numpy()
# ragged first dims gather in rank order
res["ragged"] = hvd.allgather(torch.full((rank + 1, 2), rank)).numpy()
res["object"] = np.array(hvd.broadcast_object({"r": rank}, 1)["r"])
res["objects"] = np.array([o["r"] for o in hvd.allgather_object({"r": rank})])
hvd.barrier()
np.savez(out, **res)
hvd.shutdown()
"""


OPT_STATE_WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
res = {}
for name, make in (
        ("adamw", lambda ps: torch.optim.AdamW(ps, lr=1e-2)),
        ("sgd", lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9))):
    torch.manual_seed(7)  # the same weights on every rank
    model = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Linear(4, 3))
    opt = make(model.parameters())
    # only the root has stepped (as after loading a checkpoint there):
    # the other rank has no state yet
    if rank == 0:
        for i in range(2):
            model(torch.full((2, 5), float(i + 1))).square().sum().backward()
            opt.step()
            opt.zero_grad()
        for j, p in enumerate(model.parameters()):
            for key, v in opt.state[p].items():
                if isinstance(v, torch.Tensor):
                    res[f"{name}/before/{j}/{key}"] = v.numpy().copy()
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    hvd.broadcast_parameters(model, root_rank=0)
    for j, p in enumerate(model.parameters()):
        for key, v in opt.state[p].items():
            res[f"{name}/after/{j}/{key}"] = v.numpy().copy()
    # one more identical step keeps the ranks in lockstep
    model(torch.ones(2, 5)).square().sum().backward()
    opt.step()
    for j, p in enumerate(model.parameters()):
        res[f"{name}/param/{j}"] = p.detach().numpy().copy()
# the other way round: a root with no state empties the stepped rank's
model = torch.nn.Linear(3, 2)
opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
if rank == 1:
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
hvd.broadcast_optimizer_state(opt, root_rank=0)
res["emptied"] = np.array(len(opt.state))
np.savez(out, **res)
hvd.shutdown()
"""


def test_broadcast_optimizer_state_to_unstepped_rank(tmp_path):
    """Rank 0 has stepped AdamW and momentum SGD, rank 1 has not: after
    broadcast_optimizer_state both hold rank 0's state (exp_avg,
    exp_avg_sq, step; momentum_buffer) and step on in lockstep."""
    r0, r1 = spawn_ranks(OPT_STATE_WORKER, 2, tmp_path)
    before = {k.replace("/before/", "/after/"): v for k, v in r0.items()
              if "/before/" in k}
    assert {k for k in before if k.startswith("adamw/")} == {
        f"adamw/after/{j}/{key}" for j in range(4)
        for key in ("step", "exp_avg", "exp_avg_sq")}
    assert {k for k in before if k.startswith("sgd/")} == {
        f"sgd/after/{j}/momentum_buffer" for j in range(4)}
    for key, want in before.items():
        for got in (r0, r1):
            assert got[key].dtype == want.dtype, key
            np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert set(r0) == set(r1) | set(k for k in r0 if "/before/" in k)
    for key in r1:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    assert int(r0["emptied"]) == int(r1["emptied"]) == 0


def _spmd(world, fn, *per_rank):
    """Run ``fn`` per rank under shard_map on ``world`` virtual devices;
    ``per_rank`` are lists of each rank's inputs.  Returns the per-rank
    outputs as a list."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("hvd",))
    stacked = [jnp.stack([jnp.asarray(x) for x in xs]) for xs in per_rank]

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("hvd"),) * len(stacked),
             out_specs=P("hvd"), check_vma=False)
    def body(*xs):
        return fn(*(x[0] for x in xs))[None]

    out = np.asarray(body(*stacked))
    return list(out)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_bit_equal_to_spmd_ops(world, tmp_path):
    got = spawn_ranks(WORKER, world, tmp_path)
    ints = [rank_inputs(r)[0] for r in range(world)]
    dyadic = [rank_inputs(r)[1] for r in range(world)]
    want = {}
    for name, op in (("sum", JReduceOp.SUM), ("average", JReduceOp.AVERAGE),
                     ("min", JReduceOp.MIN), ("max", JReduceOp.MAX)):
        red = lambda x, op=op: spmd_ops.allreduce(x, op=op,  # noqa: E731
                                                  axis="hvd")
        want[name + "_int"] = _spmd(world, red, ints)
        want[name + "_dyadic"] = _spmd(world, red, dyadic)
    want["scaled"] = _spmd(world, lambda x: spmd_ops.allreduce(
        x, op=JReduceOp.SUM, axis="hvd", prescale_factor=0.5,
        postscale_factor=4.0), dyadic)
    want["async"] = want["sum_dyadic"]
    want["allgather"] = _spmd(
        world, lambda x: spmd_ops.allgather(x, axis="hvd"), dyadic)
    want["allgather_int"] = _spmd(
        world, lambda x: spmd_ops.allgather(x, axis="hvd"), ints)
    want["broadcast"] = _spmd(world, lambda x: spmd_ops.broadcast(
        x, world - 1, axis="hvd"), dyadic)
    want["reducescatter"] = _spmd(world, lambda x: spmd_ops.reducescatter(
        x, op=JReduceOp.SUM, axis="hvd"), dyadic)
    want["reducescatter_avg"] = _spmd(world, lambda x: spmd_ops.reducescatter(
        x, op=JReduceOp.AVERAGE, axis="hvd"), dyadic)
    for r in range(world):
        for key, per_rank in want.items():
            a, b = got[r][key], per_rank[r]
            assert a.dtype == b.dtype and a.shape == b.shape, (key, r)
            np.testing.assert_array_equal(a, b, err_msg=f"{key} rank {r}")
        # grouped_allreduce's default op is Average
        grouped = np.concatenate([want["average_dyadic"][r].reshape(-1),
                                  2 * want["average_dyadic"][r].reshape(-1)])
        np.testing.assert_array_equal(got[r]["grouped"], grouped)
        ragged = np.concatenate([np.full((i + 1, 2), i)
                                 for i in range(world)])
        np.testing.assert_array_equal(got[r]["ragged"], ragged)
        assert int(got[r]["object"]) == 1
        np.testing.assert_array_equal(got[r]["objects"], np.arange(world))


@pytest.mark.parametrize("threshold", [0, 64, 4096, 1 << 20])
def test_fusion_plan_layout_matches_jax(threshold):
    specs = [((3, 4), "float32"), ((5,), "int32"), ((100,), "float32"),
             ((2, 2), "bfloat16"), ((1000,), "float32"), ((7,), "int32"),
             ((1,), "float32"), ((16, 16), "bfloat16"), ((9,), "float32")]
    jplan = jfusion.FusionPlan.from_specs(specs, threshold)
    tplan = tfusion.FusionPlan.from_specs(
        [(s, getattr(torch, d)) for s, d in specs], threshold)
    assert [(str(t).replace("torch.", ""), idx)
            for t, idx in tplan.buckets] == \
        [(str(d), list(idx)) for d, idx in jplan.buckets]
    leaves = [torch.arange(int(np.prod(s))).reshape(s).to(getattr(torch, d))
              for s, d in specs]
    back = tfusion.unfuse(tfusion.fuse(leaves, tplan), tplan)
    assert all(torch.equal(a, b) for a, b in zip(back, leaves))


def test_world_one_lifecycle_and_errors(monkeypatch):
    """A lone process with no launcher is world 1 over a temporary file
    store; collectives are identities there; errors are the reference's."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hvd.init()
    assert not hvd.is_initialized()
    with pytest.raises(Exception, match="not been initialized"):
        hvd.rank()
    hvd.init(device="cpu")
    try:
        assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
                hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
        assert hvd.gloo_enabled() and hvd.gloo_built()
        assert not hvd.mpi_enabled() and not hvd.native_built()
        x = torch.tensor([1.5, -2.0])
        assert torch.equal(hvd.allreduce(x), x)
        assert torch.equal(hvd.allgather(x), x)
        with pytest.raises(ValueError, match="root_rank"):
            hvd.broadcast(x, root_rank=1)
        with pytest.raises(ValueError, match="either op or average"):
            hvd.allreduce(x, average=True, op=hvd.Sum)
        with pytest.raises(ValueError, match="prescale"):
            hvd.allreduce(x, op=hvd.Max, prescale_factor=2.0)
        # Adasum is ported: over one rank it is the identity
        assert torch.equal(hvd.allreduce(x, op=hvd.Adasum), x)
        with pytest.raises(ValueError, match="Sum and Average"):
            hvd.reducescatter(x, op=hvd.Min)
    finally:
        hvd.shutdown()
    assert not hvd.is_initialized()
