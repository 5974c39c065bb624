"""The hook-driven DistributedOptimizer, the overlapped train step, the
bucket schedule, the autotuner and compression, against the JAX package.

* ``BucketSchedule``: the port's layout equals the JAX one on the same
  specs, permuted lists included (as ``tests/test_overlap.py`` holds the
  JAX one), and its launch order, packing and signature follow the same
  rules.
* The environment knobs and ``BucketAutotuner``: the cases of
  ``tests/test_overlap.py``'s ``TestEnvValidation`` and
  ``TestBucketAutotuner``, on the port's copies.
* World 1, in process: the hooked ``DistributedOptimizer`` with buckets
  forced small leaves the parameters bit-equal to the JAX package's own
  ``horovod_tpu.torch.DistributedOptimizer`` over the same torch model
  and steps; the overlapped train step on the port's flash transformer
  is bit-equal to the step without overlap and within
  ``test_torch_training``'s tolerances of the JAX step.
* World 2 and 4, one process per rank over gloo: a seeded fp32 MLP, each
  rank on its shard of a global batch.  The overlapped step's gradients
  (``data_parallel_train_step(overlap=True)``) and the hooked
  ``DistributedOptimizer``'s are bit-equal, every step, to the step
  without overlap (in its default layout, one fusion-threshold bucket),
  and to the plain reduction of the ranks' own
  gradients (each computed alone in the test process, added in rank
  order and divided by the world size: the oracle
  ``test_grads_bit_equal_and_match_plain_grad`` of ``test_overlap.py``
  holds to the same bits); against the single-process gradient of the
  whole batch they agree to 1e-6 of each tensor's largest |value|.
  Every bucket launches from a hook, in schedule order, the first with
  gradients still to come.  ``backward_passes_per_step=2`` and
  ``gradient_predivide_factor`` give the plain reduction's bits too;
  ``op=Adasum`` gives ``adasum_combine_rows`` over each bucket's fused
  gradients, bit for bit; ``Compression.fp16`` stays within 2^-9 of the
  largest |value| of the plain reduction.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.compression import Compression as JCompression
from horovod_tpu.ops.fusion import BucketSchedule as JBucketSchedule
from horovod_tpu_torch import training
from horovod_tpu_torch.metrics import instruments as _metrics
from horovod_tpu_torch.models import params_to_numpy_tree
from horovod_tpu_torch.ops.adasum import adasum_combine_rows
from horovod_tpu_torch.ops.fusion import BucketSchedule, FusionPlan
from horovod_tpu_torch.ops.overlap import BucketAutotuner, Candidate

from test_torch_collectives import spawn_ranks
from test_torch_training import (OPTS, STEPS, _assert_close, _flat,
                                 _jax_run, _port_model, _tokens)

GRAD_REL_TOL = 1e-6
#: fp16 on the wire: 11 significant bits for each addend and the sum
FP16_REL_TOL = 2 ** -9

SPECS = [((3, 4), "float32"), ((5,), "int32"), ((100,), "float32"),
         ((7, 7), "bfloat16"), ((16, 16), "float32")]


def _leaves(specs):
    return [torch.zeros(s, dtype=getattr(torch, d)) for s, d in specs]


# -- the bucket schedule ------------------------------------------------------


@pytest.mark.parametrize("threshold", [0, 64, 1024, 20 * 1024])
@pytest.mark.parametrize("perm", [None, (3, 0, 4, 1, 2)])
def test_bucket_schedule_layout_matches_jax(threshold, perm):
    order = list(range(len(SPECS)))[::-1]
    specs, prod = SPECS, order
    if perm is not None:
        specs = [SPECS[i] for i in perm]
        prod = [order[i] for i in perm]
    a = BucketSchedule.from_specs(specs, threshold, production_order=prod)
    b = JBucketSchedule.from_specs(specs, threshold, production_order=prod)
    assert a.layout() == b.layout()
    assert a.ready_at == b.ready_at
    assert a.bucket_nbytes == b.bucket_nbytes
    assert a.num_buckets == b.num_buckets
    # permuted-but-equal lists build the identical layout
    ref = BucketSchedule.from_specs(SPECS, threshold, production_order=order)
    assert a.layout() == ref.layout()
    assert a.ready_at == ref.ready_at


def test_bucket_schedule_rules():
    leaves = _leaves([((8, 8), "float32")] * 4)
    sched = BucketSchedule(leaves, 8 * 8 * 4)  # one leaf a bucket
    assert [idxs[0] for _, idxs in sched.buckets] == [3, 2, 1, 0]
    assert sched.ready_at == [0, 1, 2, 3]
    sched = BucketSchedule(_leaves([((8, 8), "float32")] * 6), 512)
    assert sched.num_buckets == 3
    assert all(n == 512 for n in sched.bucket_nbytes)
    for _, idxs in sched.buckets:  # members are produced consecutively
        prods = sorted(sched.production_order[i] for i in idxs)
        assert prods == list(range(prods[0], prods[0] + len(prods)))
    assert BucketSchedule(_leaves(SPECS), 0).num_buckets == len(SPECS)
    leaves = _leaves(SPECS)
    for cls in (FusionPlan, BucketSchedule):
        assert cls(leaves, 1 << 20).signature() != \
            cls(leaves, 1 << 10).signature()
        assert cls(leaves, 64).signature() == cls(leaves, 64).signature()
    assert BucketSchedule(leaves, 20 * 1024).layout() == \
        BucketSchedule.from_specs(SPECS, 20 * 1024).layout()


# -- environment knobs --------------------------------------------------------


@pytest.mark.parametrize("name,value,ok", [
    ("HVD_TPU_FUSION_THRESHOLD", "64MB", False),
    ("HVD_TPU_FUSION_THRESHOLD", "-1", False),
    ("HVD_TPU_FUSION_THRESHOLD", "0", True),
    ("HVD_TPU_OVERLAP_BUCKET_BYTES", "4MiB", False),
    ("HVD_TPU_OVERLAP_BUCKET_BYTES", "1048576", True),
    ("HOROVOD_OVERLAP_BUCKET_BYTES", "-5", False),
    ("HVD_TPU_OVERLAP_AUTOTUNE_TRIALS", "0", False),
    ("HVD_TPU_OVERLAP_AUTOTUNE_STEPS", "2", True),
])
def test_env_validation(monkeypatch, name, value, ok):
    from horovod_tpu_torch.ops.fusion import fusion_threshold
    from horovod_tpu_torch.utils.env_parser import Config

    monkeypatch.setenv(name, value)
    knob = name.split("_", 2)[-1] if name.startswith("HVD") else \
        name.split("_", 1)[-1]
    if not ok:
        with pytest.raises(ValueError, match=knob):
            Config.from_env()
        return
    cfg = Config.from_env()
    got = {"FUSION_THRESHOLD": cfg.fusion_threshold_bytes,
           "OVERLAP_BUCKET_BYTES": cfg.overlap_bucket_bytes,
           "OVERLAP_AUTOTUNE_STEPS": cfg.overlap_autotune_steps}[knob]
    assert got == int(value)
    if knob == "FUSION_THRESHOLD":
        assert fusion_threshold() == 0


# -- the autotuner ------------------------------------------------------------

CANDS = [Candidate(1 << 20), Candidate(4 << 20), Candidate(16 << 20)]


def _drive(tuner, time_of):
    while not tuner.converged:
        tuner.observe(time_of(tuner.propose()))
    return tuner


def test_autotuner_converges_to_argmin_within_budget():
    tuner = BucketAutotuner(candidates=CANDS, default=Candidate(8 << 20),
                            trial_budget=8, steps_per_trial=3)
    times = {1 << 20: 0.9, 4 << 20: 0.3, 8 << 20: 0.5, 16 << 20: 0.7}
    _drive(tuner, lambda c: times[c.bucket_bytes])
    assert tuner.pinned.bucket_bytes == 4 << 20
    assert len(tuner.scores) <= 8
    assert tuner.propose() == tuner.pinned
    tuner.observe(0.0001)
    assert tuner.pinned.bucket_bytes == 4 << 20


def test_autotuner_never_regresses_vs_default():
    tuner = BucketAutotuner(candidates=CANDS, default=Candidate(8 << 20),
                            trial_budget=8, steps_per_trial=2)
    times = {1 << 20: 0.9, 4 << 20: 0.8, 8 << 20: 0.1, 16 << 20: 0.7}
    _drive(tuner, lambda c: times[c.bucket_bytes])
    assert tuner.pinned.bucket_bytes == 8 << 20


def test_autotuner_budget_exhaustion_pins_best_so_far():
    tuner = BucketAutotuner(candidates=CANDS, default=Candidate(8 << 20),
                            trial_budget=2, steps_per_trial=1)
    times = {1 << 20: 0.2, 4 << 20: 0.05, 8 << 20: 0.5, 16 << 20: 0.7}
    _drive(tuner, lambda c: times[c.bucket_bytes])
    assert len(tuner.scores) == 2
    assert tuner.pinned.bucket_bytes == 1 << 20


def test_autotuner_metrics_and_first_step_discarded(monkeypatch):
    before = _metrics.OVERLAP_AUTOTUNE_TRIALS.get()
    tuner = _drive(BucketAutotuner(candidates=CANDS[:1],
                                   default=Candidate(8 << 20),
                                   trial_budget=4, steps_per_trial=1),
                   lambda c: 0.1)
    assert _metrics.OVERLAP_AUTOTUNE_TRIALS.get() == before + 2
    assert _metrics.OVERLAP_AUTOTUNE_PINNED_BYTES.get() == \
        tuner.pinned.bucket_bytes
    tuner = BucketAutotuner(candidates=[], default=Candidate(8 << 20),
                            trial_budget=1, steps_per_trial=3)
    for t in (9.0, 0.1, 0.1):  # the first step pays the set-up
        tuner.observe(t)
    assert tuner.converged and tuner.scores[0][1] == pytest.approx(0.1)
    # defaults come from the environment; run() drives the sweep
    monkeypatch.setenv("HVD_TPU_OVERLAP_BUCKET_BYTES", str(2 << 20))
    monkeypatch.setenv("HVD_TPU_OVERLAP_AUTOTUNE_STEPS", "2")
    tuner = BucketAutotuner(candidates=CANDS)
    assert tuner.default == Candidate(2 << 20) and tuner.steps_per_trial == 2
    built = []
    pinned = tuner.run(lambda c: built.append(c) or (lambda: None),
                       time_fn=lambda thunk: 1.0 / (1 + len(built)))
    assert pinned == built[-1] and tuner.converged


# -- compression --------------------------------------------------------------


@pytest.mark.parametrize("name", ["none", "fp16", "bf16"])
def test_compression_matches_jax(name):
    x = np.array([1e5, -7e4, 3.25, 1.0 / 3, -2e-3], np.float32)
    comp, jcomp = getattr(hvd.Compression, name), getattr(JCompression, name)
    wire, ctx = comp.compress(torch.from_numpy(x))
    jwire, jctx = jcomp.compress(jnp.asarray(x))
    assert str(wire.dtype).replace("torch.", "") == str(jwire.dtype)
    np.testing.assert_array_equal(wire.float().numpy(),
                                  np.asarray(jwire.astype(jnp.float32)))
    back = comp.decompress(wire, ctx)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jcomp.decompress(jwire, jctx)))
    ints = torch.arange(4, dtype=torch.int32)
    wire, ctx = comp.compress(ints)
    assert wire is ints and comp.decompress(wire, ctx) is ints


# -- world 1, in process ------------------------------------------------------


@pytest.fixture
def world_one(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _seq():
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 8),
                               torch.nn.Linear(8, 4))


def test_hooked_optimizer_bit_equal_to_reference_torch_adapter(
        world_one, monkeypatch):
    """Buckets forced small (64 bytes) on both sides, as
    ``test_overlap.py``'s torch-bridge case forces them."""
    from horovod_tpu.common import basics as jbasics
    from horovod_tpu.torch.optimizer import (
        DistributedOptimizer as JDistributedOptimizer)

    monkeypatch.setenv("HVD_TPU_OVERLAP_BUCKET_BYTES", "64")
    cfg = jbasics._require_init().config
    old = cfg.overlap_bucket_bytes
    cfg.overlap_bucket_bytes = 64
    torch.manual_seed(0)
    model, ref = _seq(), _seq()
    ref.load_state_dict(model.state_dict())
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    ref_opt = JDistributedOptimizer(
        torch.optim.SGD(ref.parameters(), lr=0.1, momentum=0.9),
        named_parameters=ref.named_parameters())
    xb = torch.randn(4, 8)
    try:
        for _ in range(3):
            for m, o in ((model, opt), (ref, ref_opt)):
                o.zero_grad()
                m(xb).pow(2).mean().backward()
                o.step()
        for p, q in zip(model.parameters(), ref.parameters()):
            assert torch.equal(p, q)
        launches = opt._reducer.last_launches
        assert opt._reducer.schedule.num_buckets >= 2
        assert [b for b, _, _ in launches] == list(
            range(opt._reducer.schedule.num_buckets))
        assert all(from_hook for _, _, from_hook in launches)
    finally:
        ref_opt.close()
        opt.close()
        cfg.overlap_bucket_bytes = old


def test_hooked_optimizer_edges(world_one):
    """An unused parameter keeps no gradient (its bucket launches at
    synchronize); a second backward past backward_passes_per_step
    raises; zero_grad between backward and step raises; step after a
    manual synchronize warns."""
    model = _seq()
    model.unused = torch.nn.Parameter(torch.ones(3))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    x = torch.ones(2, 8)
    model(x).sum().backward()
    with pytest.raises(AssertionError, match="zero_grad"):
        opt.zero_grad()
    with pytest.raises(RuntimeError, match="backward_passes_per_step"):
        model(x).sum().backward()
    opt.synchronize()
    assert model.unused.grad is None
    assert not opt._reducer.last_launches[0][2]  # waited for the unused
    with pytest.warns(UserWarning, match="skip_synchronize"):
        opt.step()
    opt.zero_grad()
    opt.close()
    model(x).sum().backward()  # no hooks: nothing launches
    assert not opt._reducer.pending


def test_overlapped_transformer_step_matches(world_one):
    """The port's flash transformer (gpt_tiny-sized, fp32): the
    overlapped step bit-equal to the step without overlap, both within
    ``test_torch_training``'s sgd tolerances of the JAX step."""
    init, want_losses, want_params = _jax_run(1, OPTS["sgd"][0]())
    runs = {}
    for overlap in (False, True):
        model = _port_model(init)
        opt = OPTS["sgd"][1](model.parameters())
        state = training.create_train_state(model, opt)
        step = training.data_parallel_train_step(
            model, opt, overlap=overlap, bucket_bytes=16 * 1024)
        toks = torch.from_numpy(_tokens()).long()
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, toks[:, :-1], toks[:, 1:])
            losses.append(float(loss))
        runs[overlap] = (losses, params_to_numpy_tree(model.state_dict()))
        launches = step.reducer.last_launches
        assert len(launches) == step.reducer.schedule.num_buckets > 2
        assert all(h for _, _, h in launches) == overlap
    assert runs[True][0] == runs[False][0]
    for key, v in _flat(runs[False][1]).items():
        np.testing.assert_array_equal(_flat(runs[True][1])[key], v)
    _assert_close("sgd", runs[True][0], runs[True][1], want_losses,
                  want_params)
    with pytest.raises(ValueError, match="Sum/Average"):
        training.data_parallel_train_step(model, opt, op=hvd.Max,
                                          overlap=True)


# -- world 2 and 4 ------------------------------------------------------------

HELPERS = r"""
import numpy as np
import torch

GLOBAL_B, MLP_STEPS, BUCKET = 8, 2, 256


def mlp():
    rs = np.random.RandomState(11)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 4))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                rs.randn(*p.shape).astype(np.float32) * 0.5))
    return model


def batch():
    rs = np.random.RandomState(12)
    return (torch.from_numpy(rs.randn(GLOBAL_B, 8).astype(np.float32)),
            torch.from_numpy(rs.randn(GLOBAL_B, 4).astype(np.float32)))


def loss_fn(out, y):
    return (out - y).pow(2).mean()
"""
exec(HELPERS)

WORKER = HELPERS + r"""
import sys
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
x, y = batch()
rows = GLOBAL_B // world
x, y = x[rank * rows:(rank + 1) * rows], y[rank * rows:(rank + 1) * rows]
res = {}


class Recording(torch.optim.SGD):
    # records the gradients the step sees
    def step(self, closure=None):
        for j, p in enumerate(self.param_groups[0]["params"]):
            res[f"{self.tag}/step{self.n}/g{j}"] = p.grad.numpy().copy()
        self.n += 1
        return super().step(closure)


def recording(model, tag):
    opt = Recording(model.parameters(), lr=0.1, momentum=0.9)
    opt.tag, opt.n = tag, 0
    return opt


for tag, overlap in (("plain_step", False), ("overlap_step", True)):
    model = mlp()
    opt = recording(model, tag)
    # without overlap: the default buckets (the fusion threshold, one
    # bucket here), so the bits must not depend on how buckets are cut
    step = training.data_parallel_train_step(
        model, opt, loss_fn=loss_fn, overlap=overlap,
        bucket_bytes=BUCKET if overlap else None)
    state = training.create_train_state(model, opt)
    for _ in range(MLP_STEPS):
        state, loss = step(state, x, y)
    launches = step.reducer.last_launches
    res[tag + "/launches"] = np.array(launches)
    res[tag + "/buckets"] = np.array(step.reducer.schedule.num_buckets)
    res[tag + "/nparams"] = np.array(len(step.reducer.params))
    for j, p in enumerate(model.parameters()):
        res[f"{tag}/param{j}"] = p.detach().numpy().copy()

import os
os.environ["HVD_TPU_OVERLAP_BUCKET_BYTES"] = str(BUCKET)
model = mlp()
opt = hvd.DistributedOptimizer(recording(model, "dist_opt"),
                               named_parameters=model.named_parameters())
for _ in range(MLP_STEPS):
    opt.zero_grad()
    loss_fn(model(x), y).backward()
    opt.step()
for j, p in enumerate(model.parameters()):
    res[f"dist_opt/param{j}"] = p.detach().numpy().copy()
opt.close()
# two backward passes a step over the two halves of the rank's rows
model = mlp()
opt = hvd.DistributedOptimizer(recording(model, "bpps2"),
                               backward_passes_per_step=2)
h = rows // 2
for sl in (slice(0, h), slice(h, rows)):
    loss_fn(model(x[sl]), y[sl]).backward()
opt.step()
opt.close()
# Sum with a predivide factor of 4: (g / 4 summed) * 4; Adasum; fp16
for tag, kw in (("predivide", dict(op=hvd.Sum,
                                   gradient_predivide_factor=4.0)),
                ("adasum", dict(op=hvd.Adasum)),
                ("fp16", dict(compression=hvd.Compression.fp16))):
    model = mlp()
    opt = hvd.DistributedOptimizer(recording(model, tag), **kw)
    loss_fn(model(x), y).backward()
    opt.step()
    opt.close()
np.savez(out, **res)
hvd.shutdown()
"""


def _local_grads(world, rank, rows=None):
    """Rank ``rank``'s own gradients at the initial weights, alone."""
    model = mlp()
    x, y = batch()
    n = GLOBAL_B // world
    x, y = x[rank * n:(rank + 1) * n], y[rank * n:(rank + 1) * n]
    if rows is None:
        loss_fn(model(x), y).backward()
    else:
        for sl in rows:
            loss_fn(model(x[sl]), y[sl]).backward()
    return [p.grad.clone() for p in model.parameters()]


def _rank_ordered(per_rank, divide=None):
    out = []
    for j in range(len(per_rank[0])):
        acc = per_rank[0][j].clone()
        for g in per_rank[1:]:
            acc += g[j]
        if divide is not None:
            acc = acc / torch.tensor(divide, dtype=acc.dtype)
        out.append(acc.numpy())
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_overlapped_grads_bit_equal(world, tmp_path):
    got = spawn_ranks(WORKER, world, tmp_path)
    nparam = 6
    for r in range(world):
        res = got[r]
        for tag in ("overlap_step", "dist_opt"):
            for s in range(MLP_STEPS):
                for j in range(nparam):
                    key = f"step{s}/g{j}"
                    np.testing.assert_array_equal(
                        res[f"{tag}/{key}"], res[f"plain_step/{key}"],
                        err_msg=f"{tag} {key} rank {r}")
            for j in range(nparam):
                np.testing.assert_array_equal(res[f"{tag}/param{j}"],
                                              res[f"plain_step/param{j}"])
                np.testing.assert_array_equal(res[f"{tag}/param{j}"],
                                              got[0][f"{tag}/param{j}"])
        # every bucket from a hook, in order, the first with gradients
        # still to come; without overlap, all after the backward
        nb = int(res["overlap_step/buckets"])
        assert nb >= 3
        launches = res["overlap_step/launches"]
        assert [int(b) for b in launches[:, 0]] == list(range(nb))
        assert launches[:, 2].all()
        assert launches[0, 1] < int(res["overlap_step/nparams"])
        assert not res["plain_step/launches"][:, 2].any()
        assert int(res["plain_step/buckets"]) == 1
    # the plain reduction of the ranks' own gradients: the same bits
    per_rank = [_local_grads(world, r) for r in range(world)]
    plain = _rank_ordered(per_rank, divide=world)
    whole = mlp()
    loss_fn(whole(batch()[0]), batch()[1]).backward()
    half = GLOBAL_B // world // 2
    bpps2 = _rank_ordered([[g / 2 for g in _local_grads(
        world, r, rows=(slice(0, half), slice(half, 2 * half)))]
        for r in range(world)], divide=world)
    summed = _rank_ordered(per_rank)
    # Adasum combines each bucket's fused gradient vector across ranks
    adasum = [None] * len(plain)
    sched = BucketSchedule(list(mlp().parameters()), BUCKET)
    for _, idxs in sched.buckets:
        rows = torch.stack([torch.cat([g[i].reshape(-1) for i in idxs])
                            for g in per_rank])
        vec, off = adasum_combine_rows(rows), 0
        for i in idxs:
            k = per_rank[0][i].numel()
            adasum[i] = vec[off:off + k].view(per_rank[0][i].shape).numpy()
            off += k
    for r in range(world):
        for j, p in enumerate(whole.parameters()):
            g = got[r][f"overlap_step/step0/g{j}"]
            np.testing.assert_array_equal(g, plain[j])
            ref = p.grad.numpy()
            assert np.abs(g - ref).max() <= \
                GRAD_REL_TOL * np.abs(ref).max(), j
            np.testing.assert_array_equal(got[r][f"bpps2/step0/g{j}"],
                                          bpps2[j])
            np.testing.assert_array_equal(got[r][f"predivide/step0/g{j}"],
                                          summed[j])
            np.testing.assert_array_equal(got[r][f"adasum/step0/g{j}"],
                                          adasum[j])
            fp16 = got[r][f"fp16/step0/g{j}"]
            assert fp16.dtype == np.float32
            assert np.abs(fp16 - plain[j]).max() <= \
                FP16_REL_TOL * np.abs(plain[j]).max(), j


def test_training_step_refusals(world_one):
    from horovod_tpu_torch.models.resnet import BatchNorm

    model = _seq()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(ValueError, match="Sum/Average"):
        training.data_parallel_train_step(model, opt, op=hvd.Adasum,
                                          overlap=True)
    bn = torch.nn.Sequential(torch.nn.Linear(3, 4),
                             BatchNorm(4, device="cpu"))
    with pytest.raises(ValueError, match="running statistics"):
        training.data_parallel_train_step(
            bn, torch.optim.SGD(bn.parameters(), lr=0.1), overlap=True)
    # a step's hooks act only inside its own backward
    step = training.data_parallel_train_step(model, opt, overlap=True,
                                             loss_fn=lambda o, y: o.sum())
    model(torch.ones(1, 8)).sum().backward()
    assert not step.reducer.pending
    opt.zero_grad()
    state = training.create_train_state(model, opt)
    state, _ = step(state, torch.ones(2, 8), None)
    assert len(step.reducer.last_launches) == step.reducer.schedule.num_buckets
