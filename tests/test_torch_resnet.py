"""The port's ResNet, its training step and sync BN against the JAX package.

Weights come from the JAX package: a flax ``ResNet`` is initialised
(every leaf then perturbed by seeded numpy noise, so that the zero-init
scales of each block's last norm do not zero whole gradient paths, and
the running statistics are not the trivial 0/1) and carried into the
port by ``resnet_params_from_flax``.  Everything runs in fp32 on the
CPU, the port through the fused op's plain versions.

Tolerances, each against what fp32 with sums in other orders (XLA's
convolutions and reductions against torch's) gives:

* train-mode and eval-mode logits and the updated running statistics:
  1e-5 absolute (observed ≤ 1e-6);
* parameter gradients: 1e-4 of each gradient's largest |entry|
  (observed ≤ 5e-6);
* SGD-momentum training, 3 steps (losses 1e-5 relative; parameters and
  running statistics 1e-5 of each tensor's largest |value|; observed
  ≤ 1e-7 and ≤ 4e-7): the gradients' rounding passes through lr 0.1
  unmagnified in 3 steps.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import Mesh

from horovod_tpu import training as jtraining
from horovod_tpu.models import resnet as jr
from horovod_tpu.models import simple as jsimple
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import (
    LeNet, MLP, ResNet, ResNet50, ResNetTiny, resnet_params_from_flax,
    resnet_params_to_flax,
)
from horovod_tpu_torch.models import resnet as tr
from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm, cross_replica

from test_torch_collectives import spawn_ranks


B, HW, STEPS = 4, 16, 3
CONFIGS = {
    "tiny": dict(stage_sizes=[1, 1], block="ResNetBlock", num_filters=8,
                 num_classes=10, stem="conv"),
    "bottleneck_conv": dict(stage_sizes=[1, 1], block="BottleneckBlock",
                            num_filters=8, num_classes=10, stem="conv"),
    "bottleneck_s2d": dict(stage_sizes=[1, 1], block="BottleneckBlock",
                           num_filters=8, num_classes=10,
                           stem="space_to_depth"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, HW, HW, 3).astype(np.float32),
            rs.randint(0, 10, B).astype(np.int32))


def _jax_model(name, **kw):
    c = dict(CONFIGS[name])
    return jr.ResNet(block_cls=getattr(jr, c.pop("block")),
                     dtype=jnp.float32, **c, **kw)


def _port_model(name, **kw):
    c = dict(CONFIGS[name])
    return ResNet(block_cls=getattr(tr, c.pop("block")), dtype=torch.float32,
                  device="cpu", **c, **kw)


def _flax_variables(model, x, seed=1):
    """Numpy (params, batch_stats) of a flax init, perturbed."""
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x[:2]))
    rs = np.random.RandomState(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rs.randn(
        *a.shape).astype(np.float32), v["params"])
    stats = _unflat({
        k: (a + 0.1 * rs.randn(*a.shape) if k.endswith("mean")
            else a + 0.1 * np.abs(rs.randn(*a.shape))).astype(np.float32)
        for k, a in _flat(v["batch_stats"]).items()})
    return params, stats


def _loaded(model, params, stats):
    model.load_state_dict(resnet_params_from_flax(params, stats, model))
    return model


@pytest.mark.parametrize("name", list(CONFIGS))
def test_model_matches_flax(name):
    """Train-mode logits, updated batch_stats and every parameter
    gradient, then eval-mode logits, on the same weights."""
    x, labels = _batch()
    jm = _jax_model(name)
    params, stats = _flax_variables(jm, x)

    @jax.jit
    def run(p):
        def loss_fn(p):
            out, upd = jm.apply({"params": p, "batch_stats": stats},
                                jnp.asarray(x), mutable=["batch_stats"])
            return jtraining.softmax_cross_entropy(out, labels), (out, upd)

        eval_out = jm.apply({"params": p, "batch_stats": stats},
                            jnp.asarray(x), train=False)
        return jax.value_and_grad(loss_fn, has_aux=True)(p), eval_out

    ((_, (logits, upd)), grads), eval_logits = run(params)

    model = _loaded(_port_model(name), params, stats)
    out = model(torch.from_numpy(x))
    training.softmax_cross_entropy(out, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(out.detach().numpy(), logits, atol=1e-5)
    got_p, got_s = resnet_params_to_flax(model)
    for key, want in _flat(upd["batch_stats"]).items():
        np.testing.assert_allclose(_flat(got_s)[key], want, atol=1e-5,
                                   err_msg=key)
    port_grads = {n: p.grad for n, p in model.named_parameters()}
    for key, want in _flat(grads).items():
        got = port_grads[key].numpy()
        if got.ndim == 4:
            got = got.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        tol = 1e-4 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=key)
    model = _loaded(_port_model(name), params, stats).eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(),
                                   eval_logits, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_space_to_depth_stem_equivalence(train):
    """The port's space-to-depth stem computes the classic 7x7/s2 stem's
    linear map when its 4x4x12 kernel carries the mapped 7x7x3 weights
    (``tests/test_models_and_ring.py::test_space_to_depth_stem_
    equivalence`` on the port's side; kernels here are OIHW)."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 32, 32, 3).astype(np.float32))
    kw = dict(stage_sizes=[1], block_cls=tr.ResNetBlock, num_filters=8,
              num_classes=4, dtype=torch.float32, device="cpu")
    classic = ResNet(stem="conv", **kw)
    s2d = ResNet(stem="space_to_depth", **kw,
                 generator=torch.Generator().manual_seed(1))
    assert tuple(s2d.conv_init.kernel.shape) == (8, 12, 4, 4)
    w7 = classic.conv_init.kernel.detach()
    w4 = torch.zeros(8, 12, 4, 4)
    for kp in range(4):
        for a in range(2):
            di = 2 * kp + a - 1
            for kq in range(4):
                for b in range(2):
                    dj = 2 * kq + b - 1
                    if 0 <= di < 7 and 0 <= dj < 7:
                        w4[:, a * 6 + b * 3:a * 6 + b * 3 + 3, kp, kq] = \
                            w7[:, :, di, dj]
    state = dict(classic.state_dict())
    state["conv_init.kernel"] = w4
    s2d.load_state_dict(state)
    classic.train(train)
    s2d.train(train)
    with torch.no_grad():
        np.testing.assert_allclose(s2d(x).numpy(), classic(x).numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_converter_round_trip_and_mismatch():
    x, _ = _batch()
    jm = _jax_model("bottleneck_s2d")
    params, stats = _flax_variables(jm, x)
    model = _loaded(_port_model("bottleneck_s2d"), params, stats)
    back_p, back_s = resnet_params_to_flax(model)
    for want, got in ((params, back_p), (stats, back_s)):
        assert set(_flat(want)) == set(_flat(got))
        for key, arr in _flat(want).items():
            np.testing.assert_array_equal(_flat(got)[key], arr)
    again = resnet_params_from_flax(back_p, back_s, model)
    for key, t in model.state_dict().items():
        assert torch.equal(again[key], t), key
    missing = _flat(params)
    del missing["head.bias"]
    with pytest.raises(ValueError, match="missing"):
        resnet_params_from_flax(_unflat(missing), stats, model)
    extra = dict(_flat(params), **{"head.extra": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        resnet_params_from_flax(_unflat(extra), stats, model)
    wrong = _flat(params)
    wrong["conv_init.kernel"] = np.zeros((4, 4, 12, 9), np.float32)
    with pytest.raises(ValueError, match="conv_init.kernel"):
        resnet_params_from_flax(_unflat(wrong), stats, model)
    with pytest.raises(ValueError, match="both"):
        resnet_params_from_flax(params, dict(stats, head=params["head"]),
                                model)


@pytest.mark.parametrize("stem", ["space_to_depth", "conv"])
def test_resnet50_bn_sites_are_what_the_forward_runs(stem, monkeypatch):
    """``bn_sites`` (the shapes the chip check holds the kernels at)
    equals the (M, C, relu, residual) of every fused-op call of a real
    ResNet-50 training forward: 53 sites."""
    seen = []
    op = tr.fused_batch_norm_act

    def record(x, gamma, beta, residual=None, **kw):
        seen.append((x.numel() // x.shape[-1], x.shape[-1], kw["relu"],
                     residual is not None))
        return op(x, gamma, beta, residual, **kw)

    monkeypatch.setattr(tr, "fused_batch_norm_act", record)
    model = ResNet50(num_classes=10, dtype=torch.float32, stem=stem,
                     device="cpu")
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3))
    assert len(seen) == 53
    assert seen == model.bn_sites(1, 64, 64)
    full = model.bn_sites(128, 224, 224)
    assert full[0] == (128 * 112 * 112, 64, True, False)
    assert len({s for s in full}) == 16


def test_unported_options_raise():
    """An unknown stem raises; ``remat=True`` is ported now: it builds,
    and its training forward gives remat=False's logits."""
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 16, 16, 3).astype(np.float32))
    outs = [ResNetTiny(dtype=torch.float32, device="cpu", remat=r)(x)
            for r in (False, True)]
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="stem"):
        ResNetTiny(dtype=torch.float32, device="cpu", stem="s2d")


@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_small_models_match_flax(name):
    rs = np.random.RandomState(0)
    x = rs.randn(3, 28, 28, 1).astype(np.float32)
    if name == "mlp":
        jm, pm = jsimple.MLP(), MLP(28 * 28, device="cpu")
    else:
        jm, pm = jsimple.LeNet(), LeNet((28, 28, 1), device="cpu")
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rs.randn(*a.shape).astype(
            np.float32),
        jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = jm.apply({"params": params}, jnp.asarray(x))
    pm.load_state_dict(resnet_params_from_flax(params, {}, pm))
    with torch.no_grad():
        np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(), want,
                                   atol=1e-5)

# -- training: the data-parallel step at world 1 and 2, and sync BN -----------

SGD = (lambda: optax.sgd(0.1, momentum=0.9),
       lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9))


def _jax_train(world, params, stats, bn_axis_name=None):
    """(per-step losses, final params, final batch_stats) of JAX's
    data-parallel step on ``world`` virtual devices."""
    model = jr.ResNetTiny(dtype=jnp.float32, bn_axis_name=bn_axis_name)
    opt = SGD[0]()
    mesh = Mesh(np.array(jax.devices()[:world]), ("hvd",))
    state = jtraining.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 opt_state=opt.init(params),
                                 batch_stats=stats)
    state = jtraining.replicate_state(state, mesh)
    step = jtraining.data_parallel_train_step(model, opt, mesh=mesh)
    x, labels = _batch()
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(labels))
        losses.append(float(loss))
    return (losses, jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.batch_stats))


def _assert_trained_close(losses, params, stats, want):
    want_losses, want_params, want_stats = want
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=0)
    for got, ref in ((params, want_params), (stats, want_stats)):
        got, ref = _flat(got), _flat(ref)
        assert set(got) == set(ref)
        for key, w in ref.items():
            np.testing.assert_allclose(
                got[key], w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
                err_msg=key)


@pytest.fixture(scope="module")
def tiny_weights():
    x, _ = _batch()
    return _flax_variables(jr.ResNetTiny(dtype=jnp.float32), x)


@pytest.fixture()
def world_one():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_world_one_training_matches_jax(tiny_weights, world_one):
    params, stats = tiny_weights
    want = _jax_train(1, params, stats)
    model = _loaded(ResNetTiny(dtype=torch.float32, device="cpu"), params,
                    stats)
    opt = SGD[1](model.parameters())
    state = training.replicate_state(training.create_train_state(model, opt))
    step = training.data_parallel_train_step(model, opt)
    x, labels = (torch.from_numpy(a) for a in _batch())
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, x, labels)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    _assert_trained_close(losses, *resnet_params_to_flax(model), want)


WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import (
    ResNetTiny, resnet_params_from_flax, resnet_params_to_flax)
from horovod_tpu_torch.models.resnet import WORLD, BatchNorm
from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm

rank, world, store, out, inp = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
data = np.load(inp)


def tree(prefix):
    t = {}
    for key in data.files:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split(".")
            node = t
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return t


def flat(t, prefix=""):
    o = {}
    for k, v in t.items():
        if isinstance(v, dict):
            o.update(flat(v, prefix + k + "."))
        else:
            o[prefix + k] = v
    return o

params, stats = tree("p/"), tree("s/")
rows = data["x"].shape[0] // world
mine = slice(rank * rows, (rank + 1) * rows)
bn_rows = data["bn_x"].shape[0] // world
bn_mine = slice(rank * bn_rows, (rank + 1) * bn_rows)
x = torch.from_numpy(data["x"][mine])
labels = torch.from_numpy(data["labels"][mine])
res = {}
for mode, group in (("local", None), ("sync", WORLD)):
    model = ResNetTiny(dtype=torch.float32, bn_group=group, device="cpu")
    loaded = resnet_params_from_flax(params, stats, model)
    # every rank but 0 starts from other weights and running statistics:
    # replicate_state must hand every rank rank 0's, buffers included
    model.load_state_dict({k: v + rank for k, v in loaded.items()})
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    state = training.replicate_state(training.create_train_state(model, opt))
    res[mode + "/replicated"] = np.array(all(
        torch.equal(t, loaded[k]) for k, t in model.state_dict().items()))
    step = training.data_parallel_train_step(model, opt)
    losses = []
    for _ in range(int(data["steps"])):
        state, loss = step(state, x, labels)
        losses.append(float(loss))
    res[mode + "/losses"] = np.array(losses)
    p, s = resnet_params_to_flax(model)
    res.update({f"{mode}/p/{k}": v for k, v in flat(p).items()})
    res.update({f"{mode}/s/{k}": v for k, v in flat(s).items()})

# one SyncBatchNorm (residual + relu) on this rank's rows of the batch
cl = torch.channels_last
bx = torch.from_numpy(data["bn_x"][bn_mine]).contiguous(memory_format=cl)
br = torch.from_numpy(data["bn_res"][bn_mine]).contiguous(memory_format=cl)
bx.requires_grad_()
br.requires_grad_()
bn = SyncBatchNorm(bx.shape[1], device="cpu")
with torch.no_grad():
    bn.scale.copy_(torch.from_numpy(data["bn_scale"]))
    bn.bias.copy_(torch.from_numpy(data["bn_bias"]))
y = bn(bx, residual=br, relu=True)
(y * torch.from_numpy(data["bn_dy"][bn_mine])).sum().backward()
res.update({"bn/y": y.detach().numpy(), "bn/dx": bx.grad.numpy(),
            "bn/dres": br.grad.numpy(), "bn/dscale": bn.scale.grad.numpy(),
            "bn/dbias": bn.bias.grad.numpy(), "bn/mean": bn.mean.numpy(),
            "bn/var": bn.var.numpy()})
np.savez(out, **res)
hvd.shutdown()
"""


@pytest.fixture(scope="module")
def world_two(tiny_weights, tmp_path_factory):
    """Both ranks' results: ResNetTiny trained with local BN and with
    sync BN, and one SyncBatchNorm layer's outputs and gradients."""
    tmp = tmp_path_factory.mktemp("resnet_world2")
    params, stats = tiny_weights
    x, labels = _batch()
    rs = np.random.RandomState(5)
    shape = (8, 6, 5, 5)
    bn = dict(bn_x=rs.randn(*shape) * 2 + 1, bn_res=rs.randn(*shape),
              bn_dy=rs.randn(*shape), bn_scale=rs.rand(6) + 0.5,
              bn_bias=rs.randn(6))
    inp = tmp / "inputs.npz"
    np.savez(inp, x=x, labels=labels, steps=STEPS,
             **{k: v.astype(np.float32) for k, v in bn.items()},
             **{"p/" + k: v for k, v in _flat(params).items()},
             **{"s/" + k: v for k, v in _flat(stats).items()})
    return spawn_ranks(WORKER, 2, tmp, inp), {
        k: v.astype(np.float32) for k, v in bn.items()}


def _rank_tree(r, prefix):
    return _unflat({k[len(prefix):]: v for k, v in r.items()
                    if k.startswith(prefix)})


@pytest.mark.parametrize("mode", ["local", "sync"])
def test_world_two_training_matches_jax(mode, tiny_weights, world_two):
    """Two ranks over gloo, each on half the batch, against JAX's step on
    a 2-device mesh (``bn_axis_name="hvd"`` for sync BN): losses,
    parameters and the averaged running statistics agree, and both
    ranks hold identical ones."""
    ranks, _ = world_two
    params, stats = tiny_weights
    want = _jax_train(2, params, stats,
                      bn_axis_name="hvd" if mode == "sync" else None)
    for r in ranks:
        assert bool(r[mode + "/replicated"])
    for key in ranks[0]:
        if key.startswith(mode + "/"):
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    _assert_trained_close(list(ranks[0][mode + "/losses"]),
                          _rank_tree(ranks[0], mode + "/p/"),
                          _rank_tree(ranks[0], mode + "/s/"), want)


def test_sync_batch_norm_equals_batch_norm_over_the_whole_batch(world_two):
    """SyncBatchNorm at world 2 equals one process's BatchNorm over the
    concatenated batch: each rank's outputs and input gradients are its
    rows of the whole batch's; the ranks' γ/β gradients sum to the whole
    batch's; the running statistics match on both ranks."""
    ranks, bn = world_two
    cl = torch.channels_last
    x = torch.from_numpy(bn["bn_x"]).contiguous(memory_format=cl)
    res = torch.from_numpy(bn["bn_res"]).contiguous(memory_format=cl)
    x.requires_grad_()
    res.requires_grad_()
    ref = tr.BatchNorm(6, device="cpu")
    with torch.no_grad():
        ref.scale.copy_(torch.from_numpy(bn["bn_scale"]))
        ref.bias.copy_(torch.from_numpy(bn["bn_bias"]))
    y = ref(x, residual=res, relu=True)
    (y * torch.from_numpy(bn["bn_dy"])).sum().backward()
    half = x.shape[0] // 2
    for r, rank in enumerate(ranks):
        rows = slice(r * half, (r + 1) * half)
        for key, want in (("y", y.detach()), ("dx", x.grad),
                          ("dres", res.grad)):
            np.testing.assert_allclose(rank["bn/" + key], want[rows].numpy(),
                                       atol=1e-5, err_msg=key)
        np.testing.assert_allclose(rank["bn/mean"], ref.mean.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(rank["bn/var"], ref.var.numpy(),
                                   atol=1e-6)
    for key, want in (("dscale", ref.scale.grad), ("dbias", ref.bias.grad)):
        np.testing.assert_allclose(ranks[0]["bn/" + key]
                                   + ranks[1]["bn/" + key], want.numpy(),
                                   atol=1e-4, err_msg=key)


def test_cross_replica_binds_the_group():
    """``cross_replica`` and ``SyncBatchNorm`` default to the world
    group (resolved when the norm runs); a plain BatchNorm has none."""
    norm = cross_replica()(4, device="cpu")
    assert norm.process_group == tr.WORLD
    assert SyncBatchNorm(4, device="cpu").process_group == tr.WORLD
    assert tr.BatchNorm(4, device="cpu").group() is None
    model = ResNetTiny(dtype=torch.float32, device="cpu", bn_group=tr.WORLD)
    assert all(m.process_group == tr.WORLD for m in model.modules()
               if isinstance(m, tr.BatchNorm))
    assert len(tr.running_stats(model)) == 2 * 6  # 6 norms


def test_running_stats_follow_flax_momentum():
    """ra = 0.9·ra + 0.1·batch_stat with the biased batch variance (not
    torch's momentum=0.1 convention or its unbiased variance)."""
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(4, 3, 5, 5).astype(np.float32) * 3 + 2
                         ).contiguous(memory_format=torch.channels_last)
    bn = tr.BatchNorm(3, device="cpu")
    bn(x)
    xf = x.permute(0, 2, 3, 1).reshape(-1, 3).numpy().astype(np.float64)
    np.testing.assert_allclose(bn.mean.numpy(), 0.1 * xf.mean(0), rtol=1e-5)
    np.testing.assert_allclose(bn.var.numpy(), 0.9 + 0.1 * xf.var(0),
                               rtol=1e-5)
