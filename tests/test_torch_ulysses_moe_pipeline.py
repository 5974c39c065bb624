"""The port's Ulysses attention, expert-parallel MoE and GPipe schedule
against the JAX package's, across processes.

Mirrors ``tests/test_parallel_strategies.py``'s Ulysses, MoE and
pipeline cases.  One worker set per world size (2 and 4; gloo over a
``file://`` store, one process per rank, ``spawn_ranks``) runs every
case on the same seeded numpy inputs as the JAX side:

* ``ulysses_attention``, ``impl="dense"`` and ``"flash"`` (on the CPU
  the flash op runs its kernels' plain versions), causal, bidirectional
  and a window of 5, MHA and GQA: each rank's output against the JAX
  ``ulysses_attention`` under ``shard_map`` (the JAX tests' 1e-4), its
  (dq, dk, dv) against ``jax.grad`` of the JAX Ulysses taken outside
  the ``shard_map`` (1e-4 of max |grad|), and the output against the
  port's own ring attention over the same ranks;
* ``ExpertParallelMoe`` at ep = 1 (each rank the whole layer) and
  ep = world (the experts sliced): output and aux loss against the JAX
  single-chip layer on its own weights, and the gradients of
  ``mean(out**2) + 0.01·aux`` — each rank's replicated loss counted
  once (scaled by 1/ep, the replicated gate's gradient summed over the
  ranks, as ``shard_map``'s transpose does) — against its ``jax.grad``;
* ``pipeline_apply`` with one stage a rank: outputs and every stage's
  gradients (and the input's on the first stage) against the sequential
  stack (``test_pipeline_gradients_match_sequential``'s oracle).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.models.transformer import causal_dot_attention
from horovod_tpu.parallel.moe import ExpertParallelMoe as JMoe
from horovod_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from test_torch_collectives import spawn_ranks

WORLDS = (2, 4)
# name: (global S, H, H_kv, D, causal, window)
ATTN = {
    "causal": (16, 8, 8, 4, True, None),
    "bidirectional": (16, 8, 8, 4, False, None),
    "window": (16, 8, 8, 4, True, 5),
    "gqa": (16, 8, 4, 8, True, None),
}
B = 2
MOE = dict(experts=8, d=8, dff=16, cf=8.0)
PIPE = dict(m=5, mb=2, d=6)

WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import ExpertParallelMoe, ulysses_attention
from horovod_tpu_torch.parallel import ring_attention
from horovod_tpu_torch.parallel.pipeline import pipeline_apply

rank, world, store, out, given = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
g = torch.load(given, weights_only=False)
res = {}
for case, (q, k, v, w, causal, window) in g["attn"].items():
    s = q.shape[1] // world
    cut = slice(rank * s, (rank + 1) * s)
    for impl in ("dense", "flash"):
        xs = [torch.from_numpy(np.ascontiguousarray(x[:, cut]))
              .requires_grad_() for x in (q, k, v)]
        o = ulysses_attention(*xs, impl=impl, causal=causal, window=window)
        o.backward(torch.from_numpy(np.ascontiguousarray(w[:, cut])))
        res[f"{case}/{impl}/out"] = o.detach().numpy()
        for n_, x in zip(("dq", "dk", "dv"), xs):
            res[f"{case}/{impl}/{n_}"] = x.grad.numpy()
    xs = [torch.from_numpy(np.ascontiguousarray(x[:, cut])) for x in (q, k, v)]
    res[f"{case}/ring/out"] = ring_attention(
        *xs, causal=causal, window=window).numpy()

mo = g["moe"]
for ep in (1, world):
    e = mo["wi"].shape[0] // ep
    mod = ExpertParallelMoe(mo["experts"], mo["d"], mo["dff"],
                            process_set=None if ep == 1 else
                            hvd.global_process_set,
                            capacity_factor=mo["cf"], device="cpu")
    lo = 0 if ep == 1 else rank * e
    with torch.no_grad():
        mod.gate.copy_(torch.from_numpy(mo["gate"]))
        mod.wi.copy_(torch.from_numpy(mo["wi"][lo:lo + e]))
        mod.wo.copy_(torch.from_numpy(mo["wo"][lo:lo + e]))
    o, aux = mod(torch.from_numpy(mo["x"]))
    (((o ** 2).mean() + 0.01 * aux) / ep).backward()
    gate_g = mod.gate.grad
    if ep > 1:  # the replicated gate's gradient, summed over the ranks
        gate_g = hvd.allreduce(gate_g, op=hvd.Sum)
    res[f"moe/{ep}/out"] = o.detach().numpy()
    res[f"moe/{ep}/aux"] = np.asarray(float(aux))
    res[f"moe/{ep}/dgate"] = gate_g.numpy()
    res[f"moe/{ep}/dwi"] = mod.wi.grad.numpy()
    res[f"moe/{ep}/dwo"] = mod.wo.grad.numpy()

pp = g["pipe"]
w_r = torch.from_numpy(pp["ws"][rank]).requires_grad_()
x = torch.from_numpy(pp["x"]).requires_grad_()
y = pipeline_apply(lambda w, h: torch.tanh(h @ w), w_r, x,
                   num_microbatches=pp["x"].shape[0])
(y ** 2).mean().backward()
res["pipe/out"] = y.detach().numpy()
res["pipe/dw"] = w_r.grad.numpy()
res["pipe/dx"] = x.grad.numpy() if x.grad is not None else np.zeros(0)
np.savez(out, **res)
hvd.shutdown()
"""


def _attn_inputs(case):
    s, h, h_kv, d, causal, window = ATTN[case]
    rs = np.random.RandomState(sorted(ATTN).index(case) + 4)
    f = lambda hh: rs.randn(B, s, hh, d).astype(np.float32)  # noqa: E731
    return f(h), f(h_kv), f(h_kv), f(h), causal, window


def _moe_params():
    rs = np.random.RandomState(7)
    x = rs.randn(2, 8, MOE["d"]).astype(np.float32)
    mod = JMoe(num_experts=MOE["experts"], d_model=MOE["d"],
               d_ff=MOE["dff"], axis=None, capacity_factor=MOE["cf"])
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    return mod, x, jax.tree.map(np.asarray, params)


def _pipe_inputs(n):
    rs = np.random.RandomState(9)
    ws = (rs.randn(n, PIPE["d"], PIPE["d"]) * 0.3).astype(np.float32)
    x = rs.randn(PIPE["m"], PIPE["mb"], PIPE["d"]).astype(np.float32)
    return ws, x


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    done = {}

    def get(n):
        if n not in done:
            tmp = tmp_path_factory.mktemp(f"ump{n}")
            _mod, x, p = _moe_params()
            ws, px = _pipe_inputs(n)
            given = dict(
                attn={c: _attn_inputs(c) for c in ATTN},
                moe=dict(MOE, x=x, gate=p["gate"], wi=p["wi"], wo=p["wo"],
                         experts=MOE["experts"]),
                pipe=dict(ws=ws, x=px))
            torch.save(given, tmp / "given.pt")
            done[n] = spawn_ranks(WORKER, n, tmp, tmp / "given.pt")
        return done[n]

    return get


def _close(got, want, what, tol=1e-4):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _jax_ulysses(case, n):
    """(out, (dq, dk, dv)) of the JAX Ulysses (dense) over n host
    devices, the gradient of sum(out·w) taken outside the shard_map."""
    q, k, v, w, causal, window = (jnp.asarray(a) if isinstance(a, np.ndarray)
                                  else a for a in _attn_inputs(case))
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    seq = P(None, "sp")

    def attn(q_, k_, v_):
        g = q_.shape[2] // k_.shape[2]
        if g > 1:  # the reference's dense attention takes MHA K/V
            k_, v_ = jnp.repeat(k_, g, axis=2), jnp.repeat(v_, g, axis=2)
        return causal_dot_attention(q_, k_, v_, causal=causal, window=window)

    fwd = jax.shard_map(
        lambda a, b, c: j_ulysses(a, b, c, axis_name="sp", attn_fn=attn),
        mesh=mesh, in_specs=(seq, seq, seq), out_specs=seq, check_vma=False)
    out = jax.jit(fwd)(q, k, v)
    grads = jax.jit(jax.grad(lambda a, b, c: (fwd(a, b, c) * w).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", sorted(ATTN))
def test_ulysses_matches_jax_and_the_ring(runs, case, n):
    res = runs(n)
    out, grads = _jax_ulysses(case, n)
    s = out.shape[1] // n
    for r in range(n):
        cut = slice(r * s, (r + 1) * s)
        for impl in ("dense", "flash"):
            np.testing.assert_allclose(
                res[r][f"{case}/{impl}/out"], out[:, cut], rtol=1e-4,
                atol=1e-5, err_msg=f"{impl} rank {r}")
            for name, want in zip(("dq", "dk", "dv"), grads):
                _close(res[r][f"{case}/{impl}/{name}"], want[:, cut],
                       f"{impl} {name} rank {r}")
        np.testing.assert_allclose(res[r][f"{case}/dense/out"],
                                   res[r][f"{case}/ring/out"], rtol=1e-4,
                                   atol=1e-5, err_msg=f"vs ring, rank {r}")


@pytest.mark.parametrize("n", WORLDS)
def test_moe_matches_single_chip(runs, n):
    """ep = 1 and ep = world against the JAX single-chip layer: output,
    aux loss, and the gradients of the loss counted once."""
    res = runs(n)
    mod, x, p = _moe_params()
    jp = jax.tree.map(jnp.asarray, p)
    out, aux = mod.apply({"params": jp}, jnp.asarray(x))

    def loss(gate, wi, wo):
        o, a = mod.apply({"params": {"gate": gate, "wi": wi, "wo": wo}},
                         jnp.asarray(x))
        return (o ** 2).mean() + 0.01 * a

    grads = jax.grad(loss, argnums=(0, 1, 2))(jp["gate"], jp["wi"], jp["wo"])
    dgate, dwi, dwo = (np.asarray(g) for g in grads)
    for ep in (1, n):
        e = MOE["experts"] // ep
        for r in range(n):
            got = res[r]
            np.testing.assert_allclose(got[f"moe/{ep}/out"], np.asarray(out),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(float(got[f"moe/{ep}/aux"]),
                                       float(aux), rtol=1e-5)
            lo = 0 if ep == 1 else r * e
            _close(got[f"moe/{ep}/dgate"], dgate, f"ep {ep} dgate rank {r}")
            _close(got[f"moe/{ep}/dwi"], dwi[lo:lo + e],
                   f"ep {ep} dwi rank {r}")
            _close(got[f"moe/{ep}/dwo"], dwo[lo:lo + e],
                   f"ep {ep} dwo rank {r}")


@pytest.mark.parametrize("n", WORLDS)
def test_pipeline_matches_sequential(runs, n):
    """Outputs on every rank, each stage's gradient on its rank and the
    input's on the first, against the sequential stack's."""
    res = runs(n)
    ws, x = (jnp.asarray(a) for a in _pipe_inputs(n))

    def seq(w, x_):
        h = x_
        for i in range(n):
            h = jnp.tanh(h @ w[i])
        return h

    want = np.asarray(seq(ws, x))
    dws, dx = (np.asarray(g) for g in jax.grad(
        lambda w, x_: (seq(w, x_) ** 2).mean(), argnums=(0, 1))(ws, x))
    for r in range(n):
        np.testing.assert_allclose(res[r]["pipe/out"], want, rtol=1e-4,
                                   atol=1e-5, err_msg=f"rank {r}")
        _close(res[r]["pipe/dw"], dws[r], f"stage {r}")
    _close(res[0]["pipe/dx"], dx, "dx on the first stage")
