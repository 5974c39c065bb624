"""The port's ring attention across processes, and the models it trains.

One worker set per world size runs every case (gloo over a ``file://``
store, one process per rank, ``spawn_ranks``):

* ring attention, both impls, forward and backward, on the cases of
  ``tests/test_torch_ring_attention.py``: each rank's output and
  (dq, dk, dv) bit-equal to the in-process replay of the same rank (the
  same code in the same order; a hop moves bits), and within 1e-5 / 1e-4
  (fp32) of the JAX package's single-device attention over the whole
  sequence (its ``causal_dot_attention`` and ``jax.grad``), which the
  reference's own ring tests hold its ring to;
* world 4: the port's ``Transformer`` with ``attention_impl="ring"`` and
  ``"ring_flash"`` and ``seq_axis_name`` set (gpt_tiny, fp32, the JAX
  model's weights carried across by ``models/convert.py``), with the
  reference's global positions passed and with its global default
  positions, and a GQA config: every rank's logits, joined, against the
  JAX dense model's over the whole sequence, within 1e-4 absolute and
  relative (observed ≤ 3e-6: both fp32, the ring merges blocks in
  another order than one softmax);
* world 2: one ``data_parallel_train_step`` over a ``ring_flash`` model,
  each rank's batch its sequence shard: the same loss (1e-6 relative)
  and gradients (max |diff| ≤ 1e-4 of max |grad| per parameter) as the
  dense model over the whole sequence at world 1; and the remat
  policies over ``ring_flash``, whose losses over two steps are
  bit-identical to ``none``'s.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models.transformer import Transformer as JaxTransformer
from horovod_tpu.models.transformer import TransformerConfig as JaxConfig
from horovod_tpu.models.transformer import \
    causal_dot_attention as j_dot_attention
from horovod_tpu_torch import training
from horovod_tpu_torch.models import (
    Transformer, TransformerConfig, init_params, params_from_flax,
)
from horovod_tpu_torch.parallel.ring_attention import replay_ring_flash
from test_torch_collectives import spawn_ranks
from test_torch_ring_attention import (
    ATOL, CASES, HELPERS, RTOL, replay_ring_dense, ring_inputs, shards,
)

MODEL = dict(vocab_size=256, num_layers=2, num_heads=2, head_dim=16,
             max_seq_len=128)  # gpt_tiny
GQA = dict(MODEL, num_heads=4, num_kv_heads=2)
MODEL_S_LOCAL = 8
TRAIN_B = 2
REMAT = ("none", "dots", "dots_no_batch", "full", ("none", "full"))

WORKER = HELPERS + r"""
import sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.models import init_params
from horovod_tpu_torch.parallel.ring_attention import ring_attention

rank, world, store, out, weights = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
res = {}
cut = slice(rank * S_LOCAL, (rank + 1) * S_LOCAL)
for case, (h, h_kv, causal, window) in CASES.items():
    q, k, v, w = ring_inputs(case, world)
    for impl in ("flash", "dense"):
        xs = [torch.from_numpy(np.ascontiguousarray(x[:, cut]))
              .requires_grad_() for x in (q, k, v)]
        o = ring_attention(*xs, impl=impl, causal=causal, window=window)
        o.backward(torch.from_numpy(np.ascontiguousarray(w[:, cut])))
        for name, t in zip(("out", "dq", "dk", "dv"),
                           (o, *(x.grad for x in xs))):
            res[f"{case}/{impl}/{name}"] = t.detach().numpy()

saved = torch.load(weights, weights_only=True)
s_local = saved["s_local"]
mcut = slice(rank * s_local, (rank + 1) * s_local)
if world == 4:
    # logits of the JAX model's weights, the sequence sharded over ranks
    tokens = saved["tokens"][:, mcut]
    pos = torch.arange(rank * s_local, (rank + 1) * s_local)[None]
    for tag, shape, params in (("mha", saved["model"], saved["params"]),
                               ("gqa", saved["gqa"], saved["gqa_params"])):
        for impl in ("ring", "ring_flash"):
            cfg = TransformerConfig(dtype=torch.float32,
                                    attention_impl=impl,
                                    seq_axis_name="seq", **shape)
            model = Transformer(cfg, params=params)
            with torch.no_grad():
                res[f"logits/{tag}/{impl}/default"] = model(tokens).numpy()
                res[f"logits/{tag}/{impl}/positions"] = model(
                    tokens, positions=pos).numpy()
else:
    # one data-parallel step over the ring, each rank's batch its shard;
    # then the remat policies' losses over two steps
    toks = saved["train_tokens"]
    x, y = toks[:, :-1][:, mcut], toks[:, 1:][:, mcut]
    for policy in saved["remat"]:
        cfg = TransformerConfig(dtype=torch.float32,
                                attention_impl="ring_flash",
                                seq_axis_name="seq",
                                remat_policy=policy, **saved["model"])
        model = Transformer(cfg, params=init_params(
            cfg, torch.Generator().manual_seed(3), "cpu"))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        state = training.create_train_state(model, opt)
        step = training.data_parallel_train_step(model, opt)
        losses = []
        for i in range(2):
            state, loss = step(state, x, y)
            losses.append(float(loss))
            if i == 0 and policy == "none":
                for n, p in model.named_parameters():
                    res[f"grad/{n}"] = p.grad.numpy()
        key = policy if isinstance(policy, str) else "+".join(policy)
        res[f"losses/{key}"] = np.asarray(losses)
np.savez(out, **res)
hvd.shutdown()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(shape, seed):
    jc = JaxConfig(dtype=jnp.float32, **shape)
    model = JaxTransformer(jc)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    tc = TransformerConfig(dtype=torch.float32, **shape)
    return model, params, params_from_flax(
        jax.tree.map(np.asarray, params), tc, device="cpu")


def _policy_key(policy):
    return policy if isinstance(policy, str) else "+".join(policy)


def _spawn(n, tmp_path_factory):
    """One worker set of n ranks that runs every case: (per-rank
    results, the JAX models' logits, what the workers were given)."""
    tmp = tmp_path_factory.mktemp(f"ring{n}")
    rs = np.random.RandomState(41)
    s_global = n * MODEL_S_LOCAL
    tokens = rs.randint(0, MODEL["vocab_size"], size=(1, s_global))
    saved = dict(s_local=MODEL_S_LOCAL, model=MODEL, gqa=GQA,
                 tokens=torch.as_tensor(tokens),
                 train_tokens=torch.as_tensor(rs.randint(
                     0, MODEL["vocab_size"], size=(TRAIN_B, s_global + 1))),
                 remat=[p if isinstance(p, str) else list(p)
                        for p in REMAT])
    want = {}
    if n == 4:
        for tag, shape, key in (("mha", MODEL, "params"),
                                ("gqa", GQA, "gqa_params")):
            jmodel, jparams, sd = _jax_model(shape, {"mha": 5, "gqa": 0}[tag])
            saved[key] = sd
            want[tag] = np.asarray(jmodel.apply({"params": jparams},
                                                jnp.asarray(tokens)))
    torch.save(saved, tmp / "weights.pt")
    return spawn_ranks(WORKER, n, tmp, tmp / "weights.pt"), want, saved


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(n)``: the worker set of n ranks, spawned once a module."""
    done = {}

    def get(n):
        if n not in done:
            done[n] = _spawn(n, tmp_path_factory)
        return done[n]

    return get


def _jax_attention(case, n):
    """The JAX package's single-device attention over the whole
    sequence and its gradients: (out, dq, dk, dv) numpy."""
    _h, _hk, causal, window = CASES[case]
    q, k, v, w = (jnp.asarray(x) for x in ring_inputs(case, n))

    def f(q_, k_, v_):
        g = q_.shape[2] // k_.shape[2]
        return j_dot_attention(q_, jnp.repeat(k_, g, axis=2),
                               jnp.repeat(v_, g, axis=2), causal=causal,
                               window=window)

    grads = jax.grad(lambda *a: jnp.sum(f(*a) * w), argnums=(0, 1, 2))(
        q, k, v)
    return [np.asarray(x) for x in (f(q, k, v),) + grads]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("impl", ["flash", "dense"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_across_processes_bit_equal_to_replay(runs, n, case, impl):
    res = runs(n)[0]
    _h, _hk, causal, window = CASES[case]
    qs, ks, vs, ws = (shards(x, n) for x in ring_inputs(case, n))
    replay = replay_ring_flash if impl == "flash" else replay_ring_dense
    rep = replay(qs, ks, vs, ws, causal, window)
    jax_ref = _jax_attention(case, n)
    for j, name in enumerate(("out", "dq", "dk", "dv")):
        got = [res[r][f"{case}/{impl}/{name}"] for r in range(n)]
        for r in range(n):
            np.testing.assert_array_equal(
                got[r], rep[j][r].numpy(),
                err_msg=f"{name} of rank {r}: process vs replay")
        np.testing.assert_allclose(
            np.concatenate(got, axis=1), jax_ref[j], atol=ATOL, rtol=RTOL,
            err_msg=f"{name}: port ring vs JAX attention")


@pytest.mark.parametrize("tag", ["mha", "gqa"])
@pytest.mark.parametrize("impl", ["ring", "ring_flash"])
@pytest.mark.parametrize("positions", ["default", "positions"])
def test_ring_model_logits_match_jax(runs, tag, impl, positions):
    res, want, _saved = runs(4)
    got = np.concatenate([res[r][f"logits/{tag}/{impl}/{positions}"]
                          for r in range(4)], axis=1)
    np.testing.assert_allclose(got, want[tag], atol=1e-4, rtol=1e-4)


def test_ring_train_step_matches_dense_world_one(runs):
    res, _want, saved = runs(2)
    cfg = TransformerConfig(dtype=torch.float32, attention_impl="dot",
                            **MODEL)
    model = Transformer(cfg, params=init_params(
        cfg, torch.Generator().manual_seed(3), "cpu"))
    toks = saved["train_tokens"]
    loss = training.softmax_cross_entropy(model(toks[:, :-1]), toks[:, 1:])
    loss.backward()
    got = res[0]["losses/none"][0]
    assert all(r["losses/none"][0] == got for r in res)
    np.testing.assert_allclose(got, float(loss.detach()), rtol=1e-6, atol=0)
    for name, p in model.named_parameters():
        for r in range(2):
            g = res[r][f"grad/{name}"]
            err = np.abs(g - p.grad.numpy()).max() / \
                max(np.abs(p.grad.numpy()).max(), 1e-30)
            assert err <= 1e-4, (name, r, err)


def test_remat_policies_hold_over_ring_flash(runs):
    res = runs(2)[0]
    for r in range(2):
        none = res[r]["losses/none"]
        assert np.isfinite(none).all() and none[1] < none[0]
        for policy in REMAT[1:]:
            np.testing.assert_array_equal(
                res[r][f"losses/{_policy_key(policy)}"], none,
                err_msg=str(policy))
