"""Hierarchical ZeRO and the routed training steps, world 4 over gloo.

Four ranks, two slices of two (``HVD_TPU_SLICE_SIZE=2``), one process
each:

* ``ZeroDistributedOptimizer(hierarchical=True)`` on a ReLU MLP with
  dyadic weights, inputs and SGD step: its parameters are bit-equal to
  the flat ZeRO's after the first step (every partial sum of the
  gradients exact) and within 1e-6 of the largest after three (the
  later gradients are not dyadic, and the two-level sum associates
  them otherwise); the overlapped hierarchical ZeRO step's are
  bit-equal to the plain one's; its exchange is the
  reference's three collectives (``zero.grads.local``,
  ``zero.grads.cross``, ``zero.updates.local``, each on the Chrome
  timeline) and its measured per-tier bytes are theirs.  With AdamW
  each rank keeps the state of 1/n_local of the parameters (1/2 here),
  flat ZeRO 1/world.
* With ``DcnCompression("bfloat16", error_feedback=True)`` the residual
  lives in the optimizer's state: a ``state_dict`` round trip into a
  fresh optimizer and an ``elastic.TpuState`` save/restore keep it, and
  the next step from either is bit-identical to the run it came from;
  the parameters stay within 2e-2 of flat ZeRO's.  Error feedback with
  overlap, in ``allreduce_gradients`` and in ``DistributedOptimizer``
  raises.
* gpt_tiny: ``zero_train_setup(hierarchical=True)`` against the flat
  ZeRO trainer, and ``data_parallel_train_step`` with
  ``HOROVOD_HIERARCHICAL_ALLREDUCE`` on against off: losses within 1e-5
  relative; the overlapped and plain hierarchical steps bit-identical.
"""

import numpy as np
import pytest

from horovod_tpu_torch.ops import comm_model as tcm

from test_torch_collectives import spawn_ranks

WORLD, N_LOCAL = 4, 2
LOSS_REL_TOL = 1e-5
STEPS = 3

WORKER = r"""
import os
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic, training
from horovod_tpu_torch.metrics import instruments as I
from horovod_tpu_torch.models import Transformer, gpt_tiny, init_params
from horovod_tpu_torch.ops import collective_ops as co
from horovod_tpu_torch.ops import comm_model as cm
from horovod_tpu_torch.optim import state_bytes

rank, world, store, out, tmp = int(sys.argv[1]), int(sys.argv[2]), \
    sys.argv[3], sys.argv[4], sys.argv[5]
os.environ["HVD_TPU_SLICE_SIZE"] = "2"
os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "0"
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
STEPS, EF_STEPS = 3, 4
res = {}


def mlp():
    rs = np.random.RandomState(5)
    m = torch.nn.Sequential(torch.nn.Linear(3, 8), torch.nn.ReLU(),
                            torch.nn.Linear(8, 2))
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(
                rs.randint(-4, 5, p.shape).astype(np.float32) / 8))
    return m


def batch(seed, dyadic=True):
    rs = np.random.RandomState(seed)
    if dyadic:
        x = rs.randint(-8, 9, (4, 3)).astype(np.float32) / 16
        y = rs.randint(-8, 9, (4, 2)).astype(np.float32) / 16
    else:
        x, y = rs.randn(4, 3).astype(np.float32), rs.randn(4, 2).astype(
            np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def mse(out, y):
    return (out - y).pow(2).sum() / 8  # a dyadic mean


def params(m):
    return np.concatenate([p.detach().reshape(-1).numpy() for p in
                           m.parameters()])


def run(tag, make, steps=STEPS, dyadic=True, **kw):
    m = mlp()
    state, step = training.zero_train_setup(m, make(m.parameters()),
                                            loss_fn=mse, **kw)
    x, y = batch(10 + rank, dyadic)
    losses = []
    for _ in range(steps):
        state, loss = step(state, x, y)
        losses.append(float(loss))
    res[tag] = params(m)
    res[tag + "/losses"] = np.array(losses)
    res[tag + "/state_bytes"] = np.array(state_bytes(
        [{k: v for k, v in st.items() if k != "dcn_residual"}
         for st in state.optimizer.state.values()]))
    return m, state, step


def sgd(ps):
    return torch.optim.SGD(ps, lr=0.125)


def adamw(ps):
    return torch.optim.AdamW(ps, lr=1e-2, weight_decay=1e-4)


# dyadic SGD: hierarchical, flat and overlapped hierarchical ZeRO; one
# step (every partial sum of the gradients exact), then three
run("sgd1/hier", sgd, steps=1, hierarchical=True)
run("sgd1/flat", sgd, steps=1)
_, st, _ = run("sgd/hier", sgd, hierarchical=True)
res["sgd/hier/tiers"] = np.array(st.optimizer.tiers is not None)
res["sgd/hier/plan_world"] = np.array(st.optimizer.plans[0].world)
run("sgd/flat", sgd)
run("sgd/hier_overlap", sgd, hierarchical=True, overlap=True,
    bucket_bytes=64)
# one step's collectives: names on the timeline, bytes per tier
m = mlp()
state, step = training.zero_train_setup(m, sgd(m.parameters()), loss_fn=mse,
                                        hierarchical=True)
x, y = batch(10 + rank)
tl = os.path.join(tmp, f"timeline{rank}.json")
hvd.start_timeline(tl)
ici, dcn = I.COLLECTIVE_ICI_BYTES.get(), I.COLLECTIVE_DCN_BYTES.get()
with co.recording() as rec:
    step(state, x, y)
res["zero_counters"] = np.array([I.COLLECTIVE_ICI_BYTES.get() - ici,
                                 I.COLLECTIVE_DCN_BYTES.get() - dcn])
hvd.stop_timeline()
res["timeline"] = np.array(open(tl).read())
t = state.optimizer.tiers
meas = cm.measured_tier_bytes(rec, t.slice_ids())
res["zero_ops"] = np.array([o["op"] + ":" + o["tier"] + ":" +
                            str(o["group_size"]) for o in meas["ops"]])
res["zero_bytes"] = np.array([meas["ici_bytes"], meas["dcn_bytes"]])
res["zero_padded"] = np.array(state.optimizer.plans[0].padded_sizes[0])
# AdamW: the state shards over the slice
run("adamw/hier", adamw, hierarchical=True)
run("adamw/flat", adamw)
m = mlp()
rep = adamw(m.parameters())
rstep = training.data_parallel_train_step(m, rep, loss_fn=mse)
rstep(training.create_train_state(m, rep), *batch(10 + rank))
res["adamw/replicated/state_bytes"] = np.array(state_bytes(rep.state))
# error feedback: the residual in the optimizer's state
comp = hvd.DcnCompression("bfloat16", error_feedback=True)
m, state, step = run("ef/hier", sgd, dyadic=False, hierarchical=True,
                     dcn_compression=comp)
run("ef/flat", sgd, dyadic=False)
zopt = state.optimizer
sd = zopt.state_dict()
res["ef/keys"] = np.array(sorted(sd["state"][0]))
res["ef/residual"] = sd["state"][0]["dcn_residual"].numpy()
x, y = batch(10 + rank, dyadic=False)
ts = elastic.TpuState(model=m, optimizer=zopt, step=STEPS)
ts.save()
m2 = mlp()
state2, step2 = training.zero_train_setup(m2, sgd(m2.parameters()),
                                          loss_fn=mse, hierarchical=True,
                                          dcn_compression=comp)
m2.load_state_dict(m.state_dict())
state2.optimizer.load_state_dict(sd)
step(state, x, y)
res["ef/next"] = params(m)
step2(state2, x, y)
res["ef/loaded_next"] = params(m2)
ts.restore()  # back to the saved step, residual included
res["ef/restored_residual"] = zopt.state_dict()["state"][0][
    "dcn_residual"].numpy()
step(state, x, y)
res["ef/restored_next"] = params(m)
refusals = []
try:
    training.zero_train_setup(mlp(), sgd(mlp().parameters()),
                              hierarchical=True, dcn_compression=comp,
                              overlap=True)
except ValueError as e:
    refusals.append(str(e))
try:
    hvd.allreduce_gradients([torch.ones(3)], dcn_compression=comp)
except ValueError as e:
    refusals.append(str(e))
try:
    hvd.DistributedOptimizer(sgd(mlp().parameters()), dcn_compression=comp)
except ValueError as e:
    refusals.append(str(e))
res["refusals"] = np.array(refusals)
# error feedback step by step, for the numpy reference: every rank's
# gradient bucket before each step, the parameters after it and the
# residual it keeps
m = mlp()
zopt = hvd.ZeroDistributedOptimizer(sgd(m.parameters()), hierarchical=True,
                                    dcn_compression=comp)
plan, ps, shard = zopt.plans[0], zopt._groups[0], zopt._shards[0][0]
x, y = batch(10 + rank, dyadic=False)
grads, prms, resid = [], [params(m)], []
for _ in range(EF_STEPS):
    zopt.zero_grad()
    mse(m(x), y).backward()
    grads.append(plan.flatten([p.grad for p in ps])[0].numpy().copy())
    zopt.step()
    prms.append(params(m))
    resid.append(zopt.optimizer.state[shard]["dcn_residual"].numpy().copy())
res["efref/grads"] = np.array(grads)
res["efref/params"] = np.array(prms)
res["efref/residual"] = np.array(resid)
# gpt_tiny: hierarchical against flat, overlapped against plain
cfg = gpt_tiny(dtype=torch.float32, attention_impl="flash")
toks = torch.from_numpy(np.random.RandomState(30 + rank).randint(
    0, cfg.vocab_size, (2, 17)))
xs, ys = toks[:, :-1], toks[:, 1:]


def tiny():
    return Transformer(cfg, params=init_params(
        cfg, torch.Generator().manual_seed(0), "cpu",
        param_dtype=torch.float32))


def drive(tag, make_step):
    m = tiny()
    state, step = make_step(m)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, xs, ys)
        losses.append(float(loss))
    res[tag + "/losses"] = np.array(losses)
    res[tag] = params(m)


def zero(hier):
    return lambda m: training.zero_train_setup(m, adamw(m.parameters()),
                                               hierarchical=hier)


def dp(overlap):
    def make(m):
        opt = adamw(m.parameters())
        return (training.create_train_state(m, opt),
                training.data_parallel_train_step(m, opt, overlap=overlap,
                                                  bucket_bytes=4096))
    return make


drive("tiny/zero_hier", zero(True))
drive("tiny/zero_flat", zero(False))
with co.recording() as rec:
    drive("tiny/dp_flat", dp(False))
res["tiny/dp_flat/local_calls"] = np.array(
    sum(o["group_size"] == 2 for o in rec))
hvd.shutdown()
# the flag is read at init
os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
hvd.init(device="cpu", rank=rank, size=world,
         init_method="file://" + store + ".flag")
with co.recording() as rec:
    drive("tiny/dp_hier", dp(False))
res["tiny/dp_hier/local_calls"] = np.array(
    sum(o["group_size"] == 2 for o in rec))
drive("tiny/dp_hier_overlap", dp(True))
np.savez(out, **res)
hvd.shutdown()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero_hier")
    return spawn_ranks(WORKER, WORLD, tmp, str(tmp), timeout=240)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                        / np.abs(np.asarray(b))))


def test_hierarchical_zero_bit_equal_flat_zero(ranks):
    for r in ranks:
        assert bool(r["sgd/hier/tiers"])
        assert int(r["sgd/hier/plan_world"]) == N_LOCAL
        # dyadic gradients: the two association orders give one sum
        np.testing.assert_array_equal(r["sgd1/hier"], r["sgd1/flat"])
        # later steps' gradients are not dyadic: (slice sums) added
        # across slices is another association than rank order
        np.testing.assert_allclose(r["sgd/hier"], r["sgd/flat"], rtol=0,
                                   atol=1e-6 * np.abs(r["sgd/flat"]).max())
        np.testing.assert_array_equal(r["sgd/hier/losses"][:2],
                                      r["sgd/flat/losses"][:2])
        np.testing.assert_array_equal(r["sgd/hier"], ranks[0]["sgd/hier"])
    assert ranks[0]["sgd/hier/losses"][-1] < ranks[0]["sgd/hier/losses"][0]


def test_overlapped_hierarchical_zero_bit_equal(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["sgd/hier_overlap"], r["sgd/hier"])


def test_the_three_collectives_and_their_tier_bytes(ranks):
    for r in ranks:
        tl = str(r["timeline"])
        for name in ("zero.grads.local", "zero.grads.cross",
                     "zero.updates.local"):
            assert name in tl, name
        # the calls as issued: gloo's stand-in for the local
        # reduce-scatter (an all-to-all of the bucket), the cross sum of
        # the shard, the local all-gather, then the step's loss averaged
        # over the world
        assert list(r["zero_ops"]) == [
            "all_to_all:ici:2", "all_reduce:dcn:2", "all_gather:ici:2",
            "all_reduce:dcn:4"]
        padded = int(r["zero_padded"])  # one fp32 bucket
        model = tcm.modeled_collective_bytes((padded,), WORLD, N_LOCAL)
        loss = 2 * (WORLD - 1) * 4 // WORLD  # the loss's flat all-reduce
        # the counters book the exchange's modeled bytes (hop by hop)
        np.testing.assert_array_equal(
            r["zero_counters"],
            [model["ici_bytes"], model["dcn_bytes"] + loss])
        # the issued calls: the all-to-all streams a reduce-scatter's
        # bytes, so the local tier is the model's
        np.testing.assert_array_equal(
            r["zero_bytes"], [model["ici_bytes"],
                              model["dcn_bytes"] + loss])


def test_hierarchical_adamw_state_is_sharded_over_the_slice(ranks):
    for r in ranks:
        rep = int(r["adamw/replicated/state_bytes"])
        hier = int(r["adamw/hier/state_bytes"])
        flat = int(r["adamw/flat/state_bytes"])
        # the moments of 1/n_local (1/world) of the padded parameters
        assert hier < rep / N_LOCAL + 64 and hier > rep / N_LOCAL - 64
        assert flat < rep / WORLD + 64
        np.testing.assert_allclose(r["adamw/hier"], r["adamw/flat"],
                                   rtol=1e-6, atol=1e-6)


def test_error_feedback_residual_survives_state_dict_and_tpu_state(ranks):
    for r in ranks:
        assert "dcn_residual" in set(r["ef/keys"])
        assert np.abs(r["ef/residual"]).max() > 0
        np.testing.assert_array_equal(r["ef/loaded_next"], r["ef/next"])
        np.testing.assert_array_equal(r["ef/restored_residual"],
                                      r["ef/residual"])
        np.testing.assert_array_equal(r["ef/restored_next"], r["ef/next"])
        np.testing.assert_allclose(r["ef/hier"], r["ef/flat"], rtol=2e-2,
                                   atol=1e-4)
        np.testing.assert_array_equal(r["ef/hier"], ranks[0]["ef/hier"])


def _bf16(x):
    """Round fp32 to bfloat16, to nearest even (the wire cast), back in
    fp32; finite values within bfloat16's range."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1)))
            & np.uint32(0xFFFF0000)).view(np.float32)


def _ef_reference(grads, p0, lr=np.float32(0.125), feedback=True):
    """Hierarchical ZeRO with a bf16 wire and error feedback, in numpy:
    ``grads[k][r]`` is rank r's padded gradient bucket at step k.  Rank
    r sits at slice d = r // 2, position i = r % 2 and holds chunk i.
    A step: each slice's sum (its two ranks), chunk i of it plus the
    rank's residual, rounded to bf16 (the new residual is what the
    rounding lost), the slices' bf16 chunks summed in fp32 in slice
    order, divided by the world, and an SGD step on the parameters
    (``feedback=False``: no residual is added back).  Returns the parameters after each step and each rank's residuals."""
    steps, world, padded = grads.shape
    s = padded // N_LOCAL
    p = p0.astype(np.float32).copy()
    res = [None] * world
    params, residuals = [], []
    for k in range(steps):
        slice_sums = [grads[k][2 * d] + grads[k][2 * d + 1]
                      for d in range(world // N_LOCAL)]
        wires = {}
        for r in range(world):
            d, i = divmod(r, N_LOCAL)
            comp = slice_sums[d][i * s:(i + 1) * s]
            if res[r] is not None and feedback:
                comp = comp + res[r]
            wires[r] = _bf16(comp)
            res[r] = comp - wires[r]
        g = np.concatenate([
            (wires[i] + wires[N_LOCAL + i]) / np.float32(WORLD)
            for i in range(N_LOCAL)])
        p = p + (-lr) * g[:p.size]
        params.append(p.copy())
        residuals.append([x.copy() for x in res])
    return params, residuals


def test_reference_bf16_rounding():
    x = np.array([1.0, 1 + 2 ** -8, 1 + 3 * 2 ** -8, 1 + 2 ** -9, -3.0,
                  1 / 3], np.float32)
    np.testing.assert_array_equal(
        _bf16(x), [1.0, 1.0, 1 + 2 ** -6, 1.0, -3.0, 0.333984375])


def test_error_feedback_zero_matches_numpy_reference(ranks):
    """Every step's parameters and every rank's residual equal the numpy
    reference bit for bit over EF steps (the gradients are each rank's
    own, taken before each step; the reference predicts the parameters
    they were computed from)."""
    grads = np.stack([r["efref/grads"] for r in ranks], axis=1)
    params, residuals = _ef_reference(grads, ranks[0]["efref/params"][0])
    steps = grads.shape[0]
    assert steps >= 3
    for rank, r in enumerate(ranks):
        for k in range(steps):
            np.testing.assert_array_equal(r["efref/params"][k + 1],
                                          params[k], err_msg=f"step {k}")
            np.testing.assert_array_equal(r["efref/residual"][k],
                                          residuals[k][rank],
                                          err_msg=f"step {k}")
    # the rounding loses something every step, and the residual carries
    # it: the same gradients without feedback give other parameters
    assert all(np.abs(res[0]).max() > 0 for res in residuals)
    stateless, _ = _ef_reference(grads, ranks[0]["efref/params"][0],
                                 feedback=False)
    assert all(not np.array_equal(a, b) for a, b in
               zip(stateless[1:], params[1:]))


def test_error_feedback_refusals(ranks):
    for r in ranks:
        msgs = list(r["refusals"])
        assert len(msgs) == 3
        assert "overlap" in msgs[0]
        assert all("stateless" in m for m in msgs[1:])


def test_gpt_tiny_zero_hierarchical_against_flat(ranks):
    for r in ranks:
        assert _rel(r["tiny/zero_hier/losses"],
                    r["tiny/zero_flat/losses"]) <= LOSS_REL_TOL
        np.testing.assert_array_equal(r["tiny/zero_hier/losses"],
                                      ranks[0]["tiny/zero_hier/losses"])
        assert r["tiny/zero_hier/losses"][-1] < r["tiny/zero_hier/losses"][0]


def test_gpt_tiny_routed_step_against_flat(ranks):
    for r in ranks:
        # the flag routed it: calls over the slice's two ranks
        assert int(r["tiny/dp_hier/local_calls"]) > 0
        assert int(r["tiny/dp_flat/local_calls"]) == 0
        assert _rel(r["tiny/dp_hier/losses"],
                    r["tiny/dp_flat/losses"]) <= LOSS_REL_TOL
        np.testing.assert_array_equal(r["tiny/dp_hier"],
                                      ranks[0]["tiny/dp_hier"])


def test_overlapped_and_plain_hierarchical_steps_bit_identical(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["tiny/dp_hier_overlap/losses"],
                                      r["tiny/dp_hier/losses"])
        np.testing.assert_array_equal(r["tiny/dp_hier_overlap"],
                                      r["tiny/dp_hier"])
