"""The port's data-parallel training step against the JAX package's.

A gpt_tiny-sized fp32 model with ``attention_impl="flash"`` (4 heads over
2 kv heads, so the GQA backward is exercised) is initialised by the JAX
package; its params go through ``params_from_flax`` (fp32 masters) into
the port.  The same global batch then takes a few steps through JAX
``training.data_parallel_train_step`` on a mesh of 1 or 2 virtual CPU
devices (Pallas flash kernels in interpret mode) and through the port's
``data_parallel_train_step`` at world 1 (in process) or world 2 (two
processes over gloo, each feeding its half of the batch).

Tolerances, on the losses of every step and the parameters after them:

* sgd (lr 0.1, momentum 0.9): losses to 1e-6 relative, parameters to
  1e-6 of each tensor's largest |value| (both observed ≤ 2e-7).  The two
  sides agree to fp32 rounding of the gradients, which sgd passes on
  unmagnified.
* adamw (lr 1e-3, optax's defaults): parameters to 2e-5 absolute
  (observed 3e-7), losses to 1e-5 relative (observed 1e-6).  Adam
  divides by sqrt(v) + eps, so where |g| is near eps the gradients'
  rounding difference becomes a visible fraction of one lr-sized
  update.

``with_gradient_accumulation`` (k=2) is held against ``optax.MultiSteps``
the same way, and ``DistributedOptimizer`` (reduce in ``step()``) must
give bit-identical parameters to ``data_parallel_train_step``.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import Mesh

from horovod_tpu import training as jtraining
from horovod_tpu.models import transformer as jt
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import (
    Transformer, TransformerConfig, params_from_flax, params_to_numpy_tree,
)
from horovod_tpu_torch.optim import DistributedOptimizer

from test_torch_collectives import spawn_ranks

SHAPE = dict(vocab_size=97, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=8, max_seq_len=32)
B, S, STEPS = 4, 16, 3
OPTS = {
    "sgd": (lambda: optax.sgd(0.1, momentum=0.9),
            lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9)),
    "adamw": (lambda: optax.adamw(1e-3),
              lambda ps: torch.optim.AdamW(ps, lr=1e-3, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=1e-4)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world_one():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _tokens(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, SHAPE["vocab_size"], (B, S + 1)).astype(np.int32)


def _jax_run(world, optimizer, steps=STEPS):
    """(initial params as numpy, per-step losses, final params as numpy)
    from the JAX package's data-parallel step on ``world`` devices."""
    cfg = jt.TransformerConfig(dtype=jnp.float32, attention_impl="flash",
                               **SHAPE)
    model = jt.Transformer(cfg)
    mesh = Mesh(np.array(jax.devices()[:world]), ("hvd",))
    state = jtraining.create_train_state(
        model, optimizer, jax.random.PRNGKey(0), jnp.zeros((1, S), jnp.int32))
    init = jax.tree.map(np.asarray, state.params)
    state = jtraining.replicate_state(state, mesh)
    step = jtraining.data_parallel_train_step(model, optimizer, mesh=mesh)
    toks = jnp.asarray(_tokens())
    losses = []
    for _ in range(steps):
        state, loss = step(state, toks[:, :-1], toks[:, 1:])
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, state.params)


def _port_model(init_tree):
    cfg = TransformerConfig(dtype=torch.float32, attention_impl="flash",
                            **SHAPE)
    return Transformer(cfg, params=params_from_flax(
        init_tree, cfg, device="cpu", param_dtype=torch.float32))


def _port_run(init_tree, make_opt, steps=STEPS, wrap=None):
    model = _port_model(init_tree)
    opt = make_opt(model.parameters())
    if wrap is not None:
        opt = wrap(opt)
    state = training.replicate_state(training.create_train_state(model, opt))
    step = training.data_parallel_train_step(model, opt)
    toks = torch.from_numpy(_tokens()).long()
    losses = []
    for _ in range(steps):
        state, loss = step(state, toks[:, :-1], toks[:, 1:])
        losses.append(float(loss))
    assert state.step == steps
    return losses, params_to_numpy_tree(model.state_dict())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_close(opt_name, losses, params, want_losses, want_params):
    np.testing.assert_allclose(
        losses, want_losses, rtol=1e-5 if opt_name == "adamw" else 1e-6,
        atol=0)
    got, want = _flat(params), _flat(want_params)
    assert set(got) == set(want)
    for key, w in want.items():
        if opt_name == "adamw":
            tol = dict(rtol=0, atol=2e-5)
        else:
            tol = dict(rtol=0, atol=1e-6 * float(np.abs(w).max()))
        np.testing.assert_allclose(got[key], w, err_msg=key, **tol)


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_world_one_matches_jax(opt_name, world_one):
    jax_opt, torch_opt = OPTS[opt_name]
    init, want_losses, want_params = _jax_run(1, jax_opt())
    losses, params = _port_run(init, torch_opt)
    assert losses[-1] < losses[0]
    _assert_close(opt_name, losses, params, want_losses, want_params)


def test_gradient_accumulation_matches_multisteps(world_one):
    init, want_losses, want_params = _jax_run(
        1, optax.MultiSteps(optax.sgd(0.1, momentum=0.9), every_k_schedule=2),
        steps=4)
    losses, params = _port_run(
        init, OPTS["sgd"][1], steps=4,
        wrap=lambda opt: hvd.with_gradient_accumulation(opt, 2))
    assert losses[0] == losses[1] and losses[2] < losses[1]
    _assert_close("sgd", losses, params, want_losses, want_params)


def test_distributed_optimizer_bit_identical_to_train_step(world_one):
    """The same sgd steps through DistributedOptimizer (the reduction in
    step()) and through data_parallel_train_step: identical bits."""
    init, _, _ = _jax_run(1, optax.sgd(0.1), steps=0)
    _, want = _port_run(init, OPTS["sgd"][1])
    model = _port_model(init)
    opt = DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1,
                                               momentum=0.9))
    toks = torch.from_numpy(_tokens()).long()
    for _ in range(STEPS):
        opt.zero_grad()
        training.softmax_cross_entropy(model(toks[:, :-1]),
                                       toks[:, 1:]).backward()
        opt.step()
    got = _flat(params_to_numpy_tree(model.state_dict()))
    for key, w in _flat(want).items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_distributed_optimizer_accumulates_and_synchronizes(world_one):
    """backward_passes_per_step=2: two backward passes on one batch, a
    manual synchronize() (where clipping would go), then a step under
    skip_synchronize() — the same bits as one train step."""
    init, _, _ = _jax_run(1, optax.sgd(0.1), steps=0)
    _, want = _port_run(init, OPTS["sgd"][1], steps=1)
    model = _port_model(init)
    opt = DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1,
                                               momentum=0.9),
                               backward_passes_per_step=2)
    toks = torch.from_numpy(_tokens()).long()
    opt.zero_grad()
    for _ in range(2):
        training.softmax_cross_entropy(model(toks[:, :-1]),
                                       toks[:, 1:]).backward()
    opt.synchronize()
    with opt.skip_synchronize():
        opt.step()
    got = _flat(params_to_numpy_tree(model.state_dict()))
    for key, w in _flat(want).items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_softmax_cross_entropy_matches_optax():
    rs = np.random.RandomState(3)
    logits = (rs.randn(6, 11) * 4).astype(np.float32)
    labels = rs.randint(0, 11, (6,)).astype(np.int32)
    want = float(optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(labels)).mean())
    got = training.softmax_cross_entropy(torch.from_numpy(logits),
                                         torch.from_numpy(labels))
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    half = training.softmax_cross_entropy(
        torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    assert half.dtype == torch.bfloat16  # computed in the logits' dtype


def test_fit_epoch_records_train_step_spans(world_one):
    from horovod_tpu_torch import trace

    init, _, _ = _jax_run(1, optax.sgd(0.1), steps=0)
    model = _port_model(init)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = training.data_parallel_train_step(model, opt)
    state = training.create_train_state(model, opt)
    toks = torch.from_numpy(_tokens()).long()
    batches = [(toks[:, :-1], toks[:, 1:])] * 2
    since = trace.now()
    state, loss = training.fit_epoch(step, state, batches, epoch=0)
    state, loss = training.fit_epoch(step, state, batches, epoch=1)
    assert isinstance(loss, float) and state.step == 4
    spans = [r[3] for r in trace.snapshot(since) if r[0] == "train.step"]
    assert [a["step"] for a in spans] == [1, 2, 3, 4]
    assert [a["epoch"] for a in spans] == [0, 0, 1, 1]
    with pytest.raises(ValueError, match="does not carry"):
        step(training.create_train_state(_port_model(init), opt), *batches[0])


WORKER = r"""
import json, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import (
    Transformer, TransformerConfig, params_from_flax, params_to_numpy_tree)
from horovod_tpu_torch.optim import DistributedOptimizer

rank, world, store, out, inp, opt_name = sys.argv[1:7]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
data = np.load(inp)
shape = json.loads(str(data["shape"]))
cfg = TransformerConfig(dtype=torch.float32, attention_impl="flash", **shape)
tree = {}
for key in data.files:
    if key.startswith("p/"):
        *path, leaf = key[2:].split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = data[key]
toks = torch.from_numpy(data["tokens"]).long()
rows = toks.shape[0] // world
mine = toks[rank * rows:(rank + 1) * rows]


def build():
    # every rank starts from its own perturbed copy: replicate_state must
    # hand every rank rank 0's weights
    params = params_from_flax(tree, cfg, device="cpu",
                              param_dtype=torch.float32)
    if rank:
        params = {k: v + 1.0 for k, v in params.items()}
    return Transformer(cfg, params=params)


def make_opt(ps):
    if opt_name == "sgd":
        return torch.optim.SGD(ps, lr=0.1, momentum=0.9)
    return torch.optim.AdamW(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


model = build()
opt = make_opt(model.parameters())
state = training.replicate_state(training.create_train_state(model, opt))
step = training.data_parallel_train_step(model, opt)
losses = []
for _ in range(int(data["steps"])):
    state, loss = step(state, mine[:, :-1], mine[:, 1:])
    losses.append(float(loss))
res = {"losses": np.array(losses)}
for k, v in model.state_dict().items():
    res["p/" + k] = v.numpy()
# the same steps through DistributedOptimizer: bit-identical parameters
model2 = build()
opt2 = DistributedOptimizer(make_opt(model2.parameters()))
hvd.broadcast_parameters(model2)
for _ in range(int(data["steps"])):
    opt2.zero_grad()
    training.softmax_cross_entropy(model2(mine[:, :-1]),
                                   mine[:, 1:]).backward()
    opt2.step()
res["dist_opt_equal"] = np.array(all(
    torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                      model2.state_dict().values())))
np.savez(out, **res)
hvd.shutdown()
"""


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_world_two_matches_jax_mesh(opt_name, tmp_path):
    """Two ranks over gloo, each on its half of the global batch, against
    the JAX step on a 2-device mesh: losses and parameters agree, both
    ranks hold identical parameters, and DistributedOptimizer gives the
    same bits as the train step."""
    jax_opt, _ = OPTS[opt_name]
    init, want_losses, want_params = _jax_run(2, jax_opt())
    inp = tmp_path / "inputs.npz"
    np.savez(inp, tokens=_tokens(), steps=STEPS, shape=json.dumps(SHAPE),
             **{"p/" + k: v for k, v in _flat(init).items()})
    ranks = spawn_ranks(WORKER, 2, tmp_path, inp, opt_name)
    for r in ranks:
        assert bool(r["dist_opt_equal"])
    for key in ranks[0]:
        if key.startswith("p/"):
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    params = {k[2:]: v for k, v in ranks[0].items() if k.startswith("p/")}
    tree = {}
    for key, v in params.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    _assert_close(opt_name, list(ranks[0]["losses"]), tree, want_losses,
                  want_params)
