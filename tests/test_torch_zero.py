"""ZeRO stage 1 (``ZeroPlan``, ``ZeroDistributedOptimizer``,
``training.zero_train_setup``) against the replicated optimizer and the
JAX package.

* ``ZeroPlan``: buckets, sizes, padding, byte counts and the flattened
  buffers equal the JAX package's ``horovod_tpu.optim.ZeroPlan`` on the
  same leaves, permuted lists included.
* World 2 and 4, one process per rank over gloo: a seeded fp32 MLP, each
  rank on its shard of a global batch, three steps.  With SGD (momentum
  0.9) the ZeRO trainer's parameters and losses are bit-equal to the
  replicated ``data_parallel_train_step``'s, with and without overlap,
  through ``ZeroDistributedOptimizer`` with
  ``backward_passes_per_step=2`` against the hooked
  ``DistributedOptimizer``, and through the replicated fallback
  (``HVD_TPU_ZERO_MIN_BYTES`` above the model's size).  The flat shard's
  arithmetic is the replicated one element by element, and the
  reductions add the ranks in rank order whatever buffer an element
  lies in.  With AdamW the parameters must agree to 1e-6 of each
  tensor's largest |value| (observed: 0 on the CPU, where flat and
  per-tensor AdamW take the same single-tensor path); each rank's
  optimizer state is its shard's: at most 1/world of the replicated
  state plus the padding.
* World 1, in process: the ZeRO trainer on the port's flash transformer
  (gpt_tiny-sized, fp32, AdamW) within ``test_torch_training``'s AdamW
  tolerances of the JAX data-parallel step, and the refusals.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.optim import ZeroPlan as JZeroPlan
from horovod_tpu_torch import training
from horovod_tpu_torch.models import params_to_numpy_tree
from horovod_tpu_torch.optim import ZeroPlan, state_bytes

from test_torch_collectives import spawn_ranks
from test_torch_training import (OPTS, STEPS, _assert_close, _jax_run,
                                 _port_model, _tokens)

ADAMW_REL_TOL = 1e-6

SPECS = [((3, 4), "float32"), ((5,), "int32"), ((100,), "float32"),
         ((7, 7), "bfloat16"), ((16, 16), "float32"), ((1,), "int32")]


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("perm", [None, (3, 0, 5, 4, 1, 2)])
def test_zero_plan_matches_jax(world, perm):
    specs = SPECS if perm is None else [SPECS[i] for i in perm]
    rs = np.random.RandomState(world)
    arrays = [(rs.randn(*s) * 8).astype(d if d != "bfloat16" else
                                        np.float32) for s, d in specs]
    tl = [torch.from_numpy(a).to(getattr(torch, d))
          for a, (_, d) in zip(arrays, specs)]
    jl = [jnp.asarray(a, d) for a, (_, d) in zip(arrays, specs)]
    a, b = ZeroPlan(tl, world), JZeroPlan(jl, world)
    assert [(dt, idxs) for dt, idxs in a.buckets] == \
        [(dt, idxs) for dt, idxs in b.buckets]
    for attr in ("sizes", "bucket_sizes", "shard_sizes", "padded_sizes",
                 "total_bytes", "padded_bytes", "shard_bytes"):
        assert getattr(a, attr) == getattr(b, attr), attr
    bufs = a.flatten(tl)
    for got, want in zip(bufs, b.flatten(jl)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    for got, leaf in zip(a.unflatten(bufs), tl):
        assert torch.equal(got, leaf)
    for me in range(world):  # a rank's shard is its slice of the buffers
        for got, buf, s in zip(a.shards(tl, me), bufs, a.shard_sizes):
            assert torch.equal(got, buf[me * s:(me + 1) * s])


def test_state_bytes():
    m = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(m.parameters())
    m(torch.ones(1, 4)).sum().backward()
    opt.step()
    # exp_avg and exp_avg_sq per parameter, plus a 0-d fp32 step each
    assert state_bytes(opt.state) == 2 * 15 * 4 + 2 * 4
    assert state_bytes({"a": [torch.zeros(3, dtype=torch.bfloat16)],
                        "b": 7}) == 6


HELPERS = r"""
import numpy as np
import torch

GLOBAL_B, ZSTEPS = 8, 3


def mlp():
    rs = np.random.RandomState(21)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 5))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                rs.randn(*p.shape).astype(np.float32) * 0.5))
    return model


def batch():
    rs = np.random.RandomState(22)
    return (torch.from_numpy(rs.randn(GLOBAL_B, 8).astype(np.float32)),
            torch.from_numpy(rs.randn(GLOBAL_B, 5).astype(np.float32)))


def loss_fn(out, y):
    return (out - y).pow(2).mean()


def sgd(ps):
    return torch.optim.SGD(ps, lr=0.1, momentum=0.9)


def adamw(ps):
    return torch.optim.AdamW(ps, lr=1e-2, weight_decay=1e-4)
"""
exec(HELPERS)

WORKER = HELPERS + r"""
import os
import sys
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.optim import state_bytes

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
x, y = batch()
rows = GLOBAL_B // world
x, y = x[rank * rows:(rank + 1) * rows], y[rank * rows:(rank + 1) * rows]
res = {}


def record(tag, model, losses, opt_state):
    res[tag + "/losses"] = np.array(losses)
    for j, p in enumerate(model.parameters()):
        res[f"{tag}/param{j}"] = p.detach().numpy().copy()
    res[tag + "/state_bytes"] = np.array(state_bytes(opt_state))


for name, make in (("sgd", sgd), ("adamw", adamw)):
    model = mlp()
    opt = make(model.parameters())
    step = training.data_parallel_train_step(model, opt, loss_fn=loss_fn)
    state = training.create_train_state(model, opt)
    losses = []
    for _ in range(ZSTEPS):
        state, loss = step(state, x, y)
        losses.append(float(loss))
    record(name + "/replicated", model, losses, opt.state)
    variants = [("zero", {}), ("zero_overlap", dict(overlap=True,
                                                    bucket_bytes=256))]
    if name == "sgd":
        variants.append(("fallback", {}))
    for tag, kw in variants:
        # the replicated fallback: more bytes than the model holds
        os.environ["HVD_TPU_ZERO_MIN_BYTES"] = \
            str(1 << 30) if tag == "fallback" else "0"
        model = mlp()
        state, step = training.zero_train_setup(model, make(
            model.parameters()), loss_fn=loss_fn, **kw)
        losses = []
        for _ in range(ZSTEPS):
            state, loss = step(state, x, y)
            losses.append(float(loss))
        record(f"{name}/{tag}", model, losses, state.optimizer.state)
        res[f"{name}/{tag}/sharded"] = np.array(state.optimizer.sharded)
# backward_passes_per_step=2 over the two halves of the rank's rows
os.environ["HVD_TPU_OVERLAP_BUCKET_BYTES"] = "256"
h = rows // 2
for tag in ("dist_opt", "zero_opt"):
    model = mlp()
    if tag == "dist_opt":
        opt = hvd.DistributedOptimizer(sgd(model.parameters()),
                                       backward_passes_per_step=2)
    else:
        opt = hvd.ZeroDistributedOptimizer(sgd(model.parameters()),
                                           backward_passes_per_step=2)
    for _ in range(2):
        opt.zero_grad()
        for sl in (slice(0, h), slice(h, rows)):
            loss_fn(model(x[sl]), y[sl]).backward()
        opt.step()
    record("bpps2/" + tag, model, [], opt.state)
np.savez(out, **res)
hvd.shutdown()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_zero_matches_replicated(world, tmp_path):
    got = spawn_ranks(WORKER, world, tmp_path)
    nparam = 6
    for r in range(world):
        res = got[r]

        def params(tag):
            return [res[f"{tag}/param{j}"] for j in range(nparam)]

        for tag in ("sgd/zero", "sgd/zero_overlap", "sgd/fallback"):
            np.testing.assert_array_equal(res[tag + "/losses"],
                                          res["sgd/replicated/losses"])
            for a, b in zip(params(tag), params("sgd/replicated")):
                np.testing.assert_array_equal(a, b, err_msg=tag)
        for a, b in zip(params("bpps2/zero_opt"), params("bpps2/dist_opt")):
            np.testing.assert_array_equal(a, b)
        assert bool(res["sgd/zero/sharded"])
        assert not bool(res["sgd/fallback/sharded"])
        for tag in ("adamw/zero", "adamw/zero_overlap"):
            for a, b in zip(params(tag), params("adamw/replicated")):
                assert np.abs(a - b).max() <= \
                    ADAMW_REL_TOL * np.abs(b).max(), tag
            # the shard's state: 1/world of the replicated, plus padding
            full = int(res["adamw/replicated/state_bytes"])
            mine = int(res[tag + "/state_bytes"])
            assert mine < full
            assert mine <= full / world + 2 * 4 * world + 4
        # every rank holds the same parameters
        for tag in ("sgd/zero", "adamw/zero", "adamw/zero_overlap"):
            for a, b in zip(params(tag), [got[0][f"{tag}/param{j}"]
                                          for j in range(nparam)]):
                np.testing.assert_array_equal(a, b)


@pytest.fixture
def world_one(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_zero_transformer_matches_jax(world_one):
    """The ZeRO trainer (AdamW over the flat shard) on the port's flash
    transformer against the JAX data-parallel step, within
    ``test_torch_training``'s AdamW tolerances; with overlap, bit-equal
    to without."""
    init, want_losses, want_params = _jax_run(1, OPTS["adamw"][0]())
    runs = []
    for overlap in (False, True):
        model = _port_model(init)
        state, step = training.zero_train_setup(
            model, OPTS["adamw"][1](model.parameters()), overlap=overlap,
            bucket_bytes=16 * 1024)
        toks = torch.from_numpy(_tokens()).long()
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, toks[:, :-1], toks[:, 1:])
            losses.append(float(loss))
        assert state.step == STEPS and state.optimizer.sharded
        runs.append((losses, params_to_numpy_tree(model.state_dict())))
        _assert_close("adamw", losses, runs[-1][1], want_losses, want_params)
    assert runs[0][0] == runs[1][0]


def test_zero_refusals(world_one):
    model = torch.nn.Linear(3, 2)
    # the two-level exchange is ported (test_torch_zero_hierarchical.py);
    # a world of one slice keeps the flat exchange
    ef = hvd.DcnCompression("bfloat16", error_feedback=True)
    zopt = hvd.ZeroDistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                         lr=0.1),
                                        hierarchical=True, dcn_compression=ef)
    assert zopt.tiers is None and zopt.sharded
    with pytest.raises(ValueError, match="error_feedback"):
        training.zero_train_setup(model, torch.optim.SGD(
            model.parameters(), lr=0.1), hierarchical=True,
            dcn_compression=ef, overlap=True)
    with pytest.raises(ValueError, match="Sum/Average"):
        hvd.ZeroDistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                     lr=0.1), op=hvd.Max)
    with pytest.raises(ValueError, match="Sum/Average"):
        training.zero_train_setup(model, torch.optim.SGD(
            model.parameters(), lr=0.1), op=hvd.Adasum, overlap=True)
