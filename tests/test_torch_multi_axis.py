"""The port's dp × sp × tp trainer against the JAX package's.

Mirrors ``tests/test_parallel_strategies.py``'s multi-axis cases and
holds the port to the TRUE gradient.  The JAX ``MultiAxisTransformer``
(vocab 32, d_model 16, 4 heads, seq_len 8) is initialised by its
``init_sharded`` on host devices; its global tree is carried to each
rank of the port's mesh by ``multi_axis_params_from_flax`` (every
tp-sharded leaf cut as ``shard_map`` cuts it, the fused ``qkv`` kernel
read per rank as (3, H/tp, d)).  One worker set per world size (gloo,
one process per rank, ``spawn_ranks``):

* world 2: the mesh (1, 1, 2), ``ulysses`` and ``ring_flash``; the
  remat policies; ``init_sharded``'s per-rank draws;
* world 4: (2, 1, 2) and (1, 2, 2), ``ulysses`` and ``ring_flash``.

For each: every rank's logits against the JAX ``shard_map`` forward's
(1e-5), the step's loss against the JAX loss (1e-5), and the step's
gradients — each rank's slices after the (dp, sp) mean — against
``jax.grad`` taken OUTSIDE the ``shard_map`` of the same sharded
forward (1e-4 of each leaf's max |grad|).  The JAX step takes its
gradient INSIDE the ``shard_map``: at tp = 2 that gives every
tp-sharded leaf exactly twice the true gradient (ROADMAP §C5), which
a test pins together with the port's not doing so.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu.parallel import sharded as jsh
from test_torch_collectives import spawn_ranks

SHAPE = dict(vocab=32, d_model=16, num_heads=4, num_layers=2, seq_len=8)
B = 4
MESHES = {2: [((1, 1, 2), "ulysses"), ((1, 1, 2), "ring_flash")],
          4: [((2, 1, 2), "ulysses"), ((2, 1, 2), "ring_flash"),
              ((1, 2, 2), "ulysses"), ((1, 2, 2), "ring_flash")]}
REMAT = ("none", "dots", "dots_no_batch", "full", ("none", "full"))
FWD_TOL = 1e-5
GRAD_TOL = 1e-4

WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.convert import multi_axis_params_from_flax
from horovod_tpu_torch.parallel import sharded as sh
from horovod_tpu_torch.training import create_train_state

rank, world, store, out, given = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
g = torch.load(given, weights_only=False)
res = {}


def build(dims, impl, remat=None):
    mesh = sh.multi_axis_mesh(*dims)
    model = sh.MultiAxisTransformer(**g["shape"], attention_impl=impl,
                                    remat_policy=remat, mesh=mesh,
                                    device="cpu")
    return mesh, model


def local(a, mesh):
    b, s = a.shape[0] // mesh.dp, a.shape[1] // mesh.sp
    return torch.from_numpy(np.ascontiguousarray(
        a[mesh.dp_idx * b:(mesh.dp_idx + 1) * b,
          mesh.sp_idx * s:(mesh.sp_idx + 1) * s])).long()


def train(model, mesh, steps=1, **kw):
    opt = torch.optim.SGD(model.parameters(), lr=0.3, momentum=0.9)
    state = create_train_state(model, opt)
    step = sh.make_sharded_train_step(model, opt, mesh, **kw)
    losses = []
    for _ in range(steps):
        state, loss = step(state, local(g["tokens"], mesh),
                           local(g["targets"], mesh))
        losses.append(float(loss))
    return losses


for dims, impl in g["meshes"]:
    tag = "x".join(map(str, dims)) + "/" + impl
    mesh, model = build(dims, impl)
    model.load_state_dict(multi_axis_params_from_flax(
        g["params"][dims], model))
    with torch.no_grad():
        res[tag + "/logits"] = model(local(g["tokens"], mesh)).numpy()
    res[tag + "/loss"] = np.asarray(train(model, mesh))
    for name, p in model.named_parameters():
        res[tag + "/grad/" + name] = p.grad.numpy()

if world == 4:
    # the hooked reduction (small buckets, launched from the backward)
    dims = (2, 1, 2)
    mesh, model = build(dims, "ulysses")
    model.load_state_dict(multi_axis_params_from_flax(
        g["params"][dims], model))
    res["overlap/loss"] = np.asarray(train(model, mesh, overlap=True,
                                           bucket_bytes=4096))
    for name, p in model.named_parameters():
        res["overlap/grad/" + name] = p.grad.numpy()
if world == 2:
    dims = (1, 1, 2)
    for policy in g["remat"]:
        mesh, model = build(dims, "ulysses", remat=policy)
        model.load_state_dict(multi_axis_params_from_flax(
            g["params"][dims], model))
        key = policy if isinstance(policy, str) else "+".join(policy)
        res["remat/" + key] = np.asarray(train(model, mesh, steps=2))
    mesh, model = build(dims, "ulysses")
    params, specs = sh.init_sharded(model, seed=0)
    for name in ("block_0.mlp.wi.kernel", "block_0.attn.qkv.kernel",
                 "embed", "block_0.ln1.scale", "pos_embed"):
        res["draw/" + name] = params[name].numpy()
np.savez(out, **res)
hvd.shutdown()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    rs = np.random.RandomState(0)
    return (rs.randint(0, SHAPE["vocab"], (B, SHAPE["seq_len"])),
            rs.randint(0, SHAPE["vocab"], (B, SHAPE["seq_len"])))


_JAX = {}


def _jax(dims, impl):
    """The JAX side at one mesh: (global params as numpy, their specs,
    global logits, loss, grads outside the shard_map, grads inside it
    as the JAX step takes them)."""
    key = (dims, impl)
    if key in _JAX:
        return _JAX[key]
    dp, sp, tp = dims
    mesh = jsh.multi_axis_mesh(dp, sp, tp,
                               devices=jax.devices()[:dp * sp * tp])
    model = jsh.MultiAxisTransformer(**SHAPE, attention_impl=impl)
    variables, specs = jsh.init_sharded(model, mesh, jax.random.PRNGKey(0),
                                        local_batch=B // dp)
    tok, tgt = (jnp.asarray(a) for a in _data())
    data = P("dp", "sp")

    def local_loss(p, t, y):
        logits = model.apply(p, t)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), y).mean()

    fwd = jax.shard_map(lambda p, t: model.apply(p, t), mesh=mesh,
                        in_specs=(specs, data), out_specs=data,
                        check_vma=False)
    loss_fn = jax.shard_map(
        lambda p, t, y: jax.lax.pmean(local_loss(p, t, y), ("dp", "sp")),
        mesh=mesh, in_specs=(specs, data, data), out_specs=P(),
        check_vma=False)

    def inside(p, t, y):
        grads = jax.grad(local_loss)(p, t, y)
        return jax.lax.pmean(grads, ("dp", "sp"))

    inside_fn = jax.shard_map(inside, mesh=mesh,
                              in_specs=(specs, data, data),
                              out_specs=specs, check_vma=False)
    logits = jax.jit(fwd)(variables, tok)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables, tok, tgt)
    g_in = jax.jit(inside_fn)(variables, tok, tgt)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    _JAX[key] = (to_np(variables["params"]), specs["params"],
                 np.asarray(logits), float(loss), _flat(to_np(grads)),
                 _flat(to_np(g_in)))
    return _JAX[key]


def _flat(tree):
    """A flax tree of ``{"params": ...}`` (or the params) as {"a.b": x}."""
    tree = tree.get("params", tree)
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                out[prefix + k] = v
    walk(tree, "")
    return out


def _spec_dim(spec):
    return list(spec).index("tp") if "tp" in tuple(spec) else None


def _slice(a, dim, r, n):
    if dim is None:
        return a
    w = a.shape[dim] // n
    return np.take(a, np.arange(r * w, (r + 1) * w), axis=dim)


def _rank_coords(r, dims):
    _dp, sp, tp = dims
    return r // (sp * tp), (r // tp) % sp, r % tp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    done = {}

    def get(n):
        if n not in done:
            tmp = tmp_path_factory.mktemp(f"multi{n}")
            tok, tgt = _data()
            params = {dims: _jax(dims, impl)[0] for dims, impl in MESHES[n]}
            torch.save(dict(shape=SHAPE, tokens=tok, targets=tgt,
                            params=params, meshes=MESHES[n],
                            remat=[p if isinstance(p, str) else list(p)
                                   for p in REMAT]),
                       tmp / "given.pt")
            done[n] = spawn_ranks(WORKER, n, tmp, tmp / "given.pt",
                                  timeout=240)
        return done[n]

    return get


CASES = [(n, dims, impl) for n in sorted(MESHES) for dims, impl in MESHES[n]]


def _tag(dims, impl):
    return "x".join(map(str, dims)) + "/" + impl


@pytest.mark.parametrize("n,dims,impl", CASES)
def test_forward_and_loss_match_jax(runs, n, dims, impl):
    res = runs(n)
    _p, _specs, logits, loss, _g, _gi = _jax(dims, impl)
    dp, sp, _tp = dims
    b, s = B // dp, SHAPE["seq_len"] // sp
    for r in range(n):
        d, si, _t = _rank_coords(r, dims)
        want = logits[d * b:(d + 1) * b, si * s:(si + 1) * s]
        np.testing.assert_allclose(res[r][_tag(dims, impl) + "/logits"],
                                   want, rtol=FWD_TOL, atol=FWD_TOL,
                                   err_msg=f"rank {r}")
        got = float(res[r][_tag(dims, impl) + "/loss"][0])
        np.testing.assert_allclose(got, loss, rtol=FWD_TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("n,dims,impl", CASES)
def test_step_gradients_match_jax_grad_outside(runs, n, dims, impl):
    """Every leaf on every rank: the port's reduced gradient (its tp
    slice) against ``jax.grad`` of the sharded forward's loss taken
    outside the ``shard_map``."""
    res = runs(n)
    _p, specs, _l, _loss, grads, _gi = _jax(dims, impl)
    spec_of = _flat(specs)
    tp = dims[2]
    for r in range(n):
        t = _rank_coords(r, dims)[2]
        for name, want in grads.items():
            want = _slice(want, _spec_dim(spec_of[name]), t, tp)
            got = res[r][_tag(dims, impl) + "/grad/" + name]
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(got - want).max())
            assert err <= GRAD_TOL * scale, \
                f"rank {r} {name}: {err} > {GRAD_TOL} x {scale}"


@pytest.mark.parametrize("impl", ["ulysses", "ring_flash"])
def test_tp_gradients_are_not_tp_times_the_true_ones(runs, impl):
    """The fault the port does not copy: at tp = 2 the JAX step's
    gradient (taken inside the ``shard_map``) of every tp-sharded leaf
    is exactly twice the true one; the port's equals the true one."""
    dims = (1, 1, 2)
    res = runs(2)
    _p, specs, _l, _loss, grads, inside = _jax(dims, impl)
    spec_of = _flat(specs)
    sharded = [k for k, s in spec_of.items() if "tp" in tuple(s)]
    assert sharded, "the model has tp-sharded leaves"
    for name in sharded:
        np.testing.assert_allclose(inside[name], 2.0 * grads[name],
                                   rtol=1e-4, atol=1e-7, err_msg=name)
        dim = _spec_dim(spec_of[name])
        for r in range(2):
            got = res[r][_tag(dims, impl) + "/grad/" + name]
            true = _slice(grads[name], dim, r, 2)
            twice = _slice(inside[name], dim, r, 2)
            assert np.abs(got - true).max() < 0.1 * np.abs(twice - true).max()
    # behind the last reduction the JAX step is right; upstream of a tp
    # layer the replicated leaves are off too
    for name in ("ln_f.scale", "block_1.mlp.wo.bias"):
        np.testing.assert_allclose(inside[name], grads[name], rtol=1e-4,
                                   atol=1e-7, err_msg=name)
    assert not np.allclose(inside["block_0.ln1.scale"],
                           grads["block_0.ln1.scale"], rtol=1e-3)


def test_overlapped_step_bit_equal_to_plain(runs):
    """``overlap=True`` (the buckets launched from the backward's hooks,
    4 KiB each) reduces the same gradients to the same bits as the plain
    step at (2, 1, 2), where the (dp, sp) mean is over two ranks."""
    res = runs(4)
    tag = _tag((2, 1, 2), "ulysses")
    for r in range(4):
        np.testing.assert_array_equal(res[r]["overlap/loss"],
                                      res[r][tag + "/loss"])
        names = [k[len(tag) + 6:] for k in res[r] if
                 k.startswith(tag + "/grad/")]
        assert names
        for name in names:
            np.testing.assert_array_equal(
                res[r]["overlap/grad/" + name], res[r][tag + "/grad/" + name],
                err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("dims", [(2, 1, 1), (1, 2, 1)])
def test_jax_step_gradient_is_right_without_tp(dims):
    """The fault is tp's: at tp = 1 the JAX step's gradient (inside the
    ``shard_map``) equals ``jax.grad`` outside it."""
    _p, _specs, _l, _loss, grads, inside = _jax(dims, "ulysses")
    for name, want in grads.items():
        np.testing.assert_allclose(inside[name], want, rtol=1e-4,
                                   atol=1e-7, err_msg=name)


def test_remat_policies_bit_identical_to_none(runs):
    res = runs(2)
    for r in range(2):
        none = res[r]["remat/none"]
        assert np.isfinite(none).all()
        for policy in REMAT[1:]:
            key = policy if isinstance(policy, str) else "+".join(policy)
            np.testing.assert_array_equal(res[r]["remat/" + key], none,
                                          err_msg=f"{key} rank {r}")


def test_init_sharded_tp_shards_differ(runs):
    """tp slices are DISTINCT draws; replicated leaves are identical on
    every rank."""
    res = runs(2)
    for name in ("block_0.mlp.wi.kernel", "block_0.attn.qkv.kernel"):
        assert not np.array_equal(res[0]["draw/" + name],
                                  res[1]["draw/" + name]), name
    for name in ("embed", "block_0.ln1.scale", "pos_embed"):
        np.testing.assert_array_equal(res[0]["draw/" + name],
                                      res[1]["draw/" + name], err_msg=name)
    std = float(res[0]["draw/embed"].std())
    assert 0.015 < std < 0.025


def test_param_specs_layout():
    """The port's ``param_specs`` names the JAX ``param_specs``'s layout
    for every leaf of the same model."""
    from horovod_tpu_torch.parallel import sharded as tsh

    _p, specs, _l, _loss, _g, _gi = _jax((1, 1, 2), "ulysses")
    want = {k: tuple(v) for k, v in _flat(specs).items()}
    got = tsh.param_specs(tsh.MultiAxisTransformer(**SHAPE, device="cpu"))
    assert got == want
    assert got["block_0.attn.qkv.kernel"] == (None, "tp")
    assert got["block_0.attn.proj.kernel"] == ("tp", None)
    assert got["block_0.mlp.wi.bias"] == ("tp",)
    assert got["embed"] == ()
    with pytest.raises(ValueError, match="attention_impl"):
        tsh.MultiAxisTransformer(**SHAPE, attention_impl="warp",
                                 device="cpu")
