"""The port's ring attention against the JAX package's, in one process.

``horovod_tpu_torch.parallel.ring_attention`` computes each rank's
share of a sequence-sharded attention; here n ranks' schedule is
replayed in one process, in the ring's own order, through the package's
code: the flash ring through ``replay_ring_flash`` (its per-step
functions), the dense ring through ``_block_update`` with one autograd
node a hop, as the multi-process ring's rotation is.  Outputs and
(dq, dk, dv) go against ``horovod_tpu.parallel.ring_attention.
ring_attention`` under ``hvd.run_per_rank`` on n of the 8 virtual CPU
devices (its Pallas kernels in interpret mode): n = 4 and 8, the cases
of ``tests/test_models_and_ring.py`` (causal, bidirectional, causal
windows 3 — the rotation cut to 2 steps — and 6, a bidirectional
window, GQA under a window).

Tolerance: fp32, 1e-5 absolute and 1e-4 relative, the reference's own
ring tests' (both sides sum in different orders; observed ≤ 2e-6).
``tests/test_torch_ring_training.py`` runs the same rings across
processes over gloo and holds them bit-equal to these replays.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import horovod_tpu as jhvd
from horovod_tpu.parallel.ring_attention import ring_attention as jring
from horovod_tpu.parallel.ring_attention import \
    ring_window_steps as j_window_steps
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.common.exceptions import NotInitializedError
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.models import init_params
from horovod_tpu_torch.models.transformer import causal_dot_attention
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel.ring_attention import (
    _block_update, replay_ring_flash, ring_attention, ring_window_steps,
)
from horovod_tpu_torch.serving import ServeConfig, ServingEngine

ATOL, RTOL = 1e-5, 1e-4

#: the cases and their seeded inputs, shared with the multi-process
#: workers of tests/test_torch_ring_training.py (which must not import
#: this module: it imports JAX)
HELPERS = r'''
import numpy as np

B, S_LOCAL, D = 2, 4, 8
# (name, H, H_kv, causal, window)
CASES = {
    "causal": (2, 2, True, None),
    "bidirectional": (2, 2, False, None),
    "causal_window3": (2, 2, True, 3),
    "causal_window6": (2, 2, True, 6),
    "bidirectional_window6": (2, 2, False, 6),
    "gqa_causal_window6": (4, 2, True, 6),
}


def ring_inputs(case, n, seed=0):
    """Global (q, k, v, w) numpy fp32 arrays of one case: n shards of
    S_LOCAL tokens (w: the output's gradient)."""
    h, h_kv = CASES[case][:2]
    rs = np.random.RandomState(seed + 17 * n)
    return [rs.randn(B, n * S_LOCAL, hh, D).astype(np.float32)
            for hh in (h, h_kv, h_kv, h)]
'''
exec(HELPERS)
# (n, impl, case): every case through the flash ring at 8 ranks, the
# dense ring's and 4 ranks' a selection (each JAX ring costs ~10 s to
# trace and compile on the CPU)
GRID = ([(8, "flash", c) for c in CASES]
        + [(8, "dense", c) for c in ("causal", "bidirectional_window6",
                                     "gqa_causal_window6")]
        + [(4, "flash", c) for c in ("causal_window3", "bidirectional",
                                     "gqa_causal_window6")]
        + [(4, "dense", "causal_window3")])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shards(x, n):
    s = x.shape[1] // n
    return [torch.from_numpy(np.ascontiguousarray(x[:, i * s:(i + 1) * s]))
            for i in range(n)]


def jax_ring(case, n, impl):
    """The reference's ring on n virtual devices: per rank (out, dq, dk,
    dv) of ``sum(ring_attention(q, k, v) * w)``, each (n, B, S_LOCAL, .,
    D) numpy."""
    _h, _hk, causal, window = CASES[case]
    q, k, v, w = (jnp.asarray(x) for x in ring_inputs(case, n))
    ps = None if n == jhvd.size() else jhvd.add_process_set(list(range(n)))

    def per_rank(r):
        cut = lambda t: jax.lax.dynamic_slice_in_dim(  # noqa: E731
            t, r * S_LOCAL, S_LOCAL, axis=1)

        def f(q_, k_, v_):
            return jring(q_, k_, v_, impl=impl, causal=causal, window=window)

        grads = jax.grad(lambda *a: jnp.sum(f(*a) * cut(w)),
                         argnums=(0, 1, 2))(cut(q), cut(k), cut(v))
        return (f(cut(q), cut(k), cut(v)),) + grads

    try:
        return [np.asarray(x) for x in jhvd.run_per_rank(per_rank,
                                                         process_set=ps)]
    finally:
        if ps is not None:
            jhvd.remove_process_set(ps)


class _Hop(torch.autograd.Function):
    """One hop of a shard around the replayed ring: the same values, and
    one autograd node a hop whose gradient goes back unchanged, as the
    ring's rotation (``_Rotate``) sends it."""

    @staticmethod
    def forward(ctx, *tensors):
        return tuple(t.clone() for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return grads


def replay_ring_dense(qs, ks, vs, ws, causal, window):
    """The dense ring of ``len(qs)`` ranks in one process: each rank's
    loop of ``_block_update`` over the blocks in ring order, each shard's
    K/V passed on by one ``_Hop`` a step (the gradient of a block then
    sums, as on the ring, its use on this step's rank and what comes
    back from the next); autograd from every rank's output.  Returns
    (outs, dqs, dks, dvs) in rank order."""
    n, s = len(qs), qs[0].shape[1]
    steps = ring_window_steps(n, s, causal=causal, window=window)
    qs, ks, vs = ([x.clone().requires_grad_() for x in xs]
                  for xs in (qs, ks, vs))
    chains = [[(ks[i], vs[i])] for i in range(n)]
    for chain in chains:
        for _ in range(1, steps):
            chain.append(_Hop.apply(*chain[-1]))
    outs = []
    for idx in range(n):
        b, _, h, d = qs[idx].shape
        o = torch.zeros((b, h, s, d))
        l = torch.zeros((b, h, s))
        m = torch.full((b, h, s), -1e30)
        for t in range(steps):
            src = (idx - t) % n
            kk, vv = chains[src][t]
            o, l, m = _block_update(o, l, m, qs[idx], kk, vv, idx * s,
                                    src * s, causal=causal, window=window)
        outs.append((o / l[..., None]).transpose(1, 2).to(qs[idx].dtype))
    torch.autograd.backward(outs, list(ws))
    return ([o.detach() for o in outs], [q.grad for q in qs],
            [k.grad for k in ks], [v.grad for v in vs])


def port_replay(case, n, impl):
    """The port's ring of n ranks replayed in one process: per rank
    (out, dq, dk, dv) tensors."""
    _h, _hk, causal, window = CASES[case]
    qs, ks, vs, ws = (shards(x, n) for x in ring_inputs(case, n))
    replay = replay_ring_flash if impl == "flash" else replay_ring_dense
    return replay(qs, ks, vs, ws, causal, window)


@pytest.mark.parametrize("n,impl,case", GRID)
def test_replayed_ring_matches_jax_ring(n, impl, case):
    got = port_replay(case, n, impl)
    want = jax_ring(case, n, impl)
    for name, per_rank, ref in zip(("out", "dq", "dk", "dv"), got, want):
        for r in range(n):
            np.testing.assert_allclose(
                per_rank[r].numpy(), ref[r], atol=ATOL, rtol=RTOL,
                err_msg=f"{name} of rank {r}")


def test_ring_window_steps_matches_jax():
    for n in (1, 2, 3, 4, 8):
        for s_local in (1, 2, 4, 7):
            for causal in (True, False):
                for window in (None, 1, 2, 3, 5, 6, 9, 30):
                    assert ring_window_steps(n, s_local, causal, window) == \
                        j_window_steps(n, s_local, causal, window)


@pytest.fixture
def world_one():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.mark.parametrize("case", ["causal", "bidirectional_window6",
                                  "gqa_causal_window6"])
def test_world_of_one_falls_back(world_one, case):
    """A ring of one rank is the single-device attention, bit for bit:
    dense → causal_dot_attention, flash → flash_attention."""
    _h, _hk, causal, window = CASES[case]
    q, k, v, w = (torch.from_numpy(x) for x in ring_inputs(case, 2))
    for impl, single in (("dense", causal_dot_attention),
                         ("flash", flash_attention)):
        res = []
        for fn in (lambda *a: ring_attention(*a, impl=impl, causal=causal,
                                             window=window),
                   lambda *a: single(*a, causal=causal, window=window)):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            out = fn(*leaves)
            out.backward(w)
            res.append([out.detach()] + [x.grad for x in leaves])
        for a, b in zip(*res):
            assert torch.equal(a, b), impl


def test_ring_validates_arguments(world_one):
    q = torch.zeros((1, 4, 4, 8))
    k = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="window"):
        ring_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="impl"):
        ring_attention(q, k, k, impl="ulysses")
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ring_attention(q, k[:, :, :1].expand(1, 4, 3, 8),
                       k[:, :, :1].expand(1, 4, 3, 8), impl="flash")
    with pytest.raises(ValueError, match="do not match"):
        ring_attention(q, k[:, :2], k[:, :2], impl="flash")


def test_ring_needs_init():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(NotInitializedError):
        ring_attention(q, q, q, impl="flash")


def _tiny(**kw):
    return TransformerConfig(vocab_size=32, num_layers=1, num_heads=2,
                             head_dim=8, max_seq_len=16, dtype=torch.float32,
                             **kw)


def test_overlap_refuses_ring_models(world_one):
    """The overlapped step and ZeRO's overlap refuse a ring model (the
    reference's overlap_segments does) and name the plain step."""
    for impl in ("ring", "ring_flash"):
        cfg = _tiny(attention_impl=impl, seq_axis_name="seq")
        model = Transformer(cfg, params=init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        with pytest.raises(ValueError, match="overlap=False"):
            training.data_parallel_train_step(model, opt, overlap=True)
        with pytest.raises(ValueError, match="overlap=False"):
            training.zero_train_setup(model, opt, overlap=True)


def test_ring_config_world_of_one_and_serving_guard(world_one):
    """``attention_impl="ring"|"ring_flash"`` with ``seq_axis_name``
    builds and runs; at world 1 its logits are the dot / flash model's
    bit for bit (rank 0: global positions are the local ones).  Paged
    serving refuses the ring impls, as the reference's does."""
    params = init_params(_tiny(), torch.Generator().manual_seed(1), "cpu")
    tokens = torch.as_tensor(np.random.RandomState(2).randint(0, 32, (2, 16)))
    for ring_impl, single in (("ring", "dot"), ("ring_flash", "flash")):
        cfg = _tiny(attention_impl=ring_impl, seq_axis_name="seq")
        assert cfg.seq_axis_name == "seq"
        got = Transformer(cfg, params=params)(tokens)
        want = Transformer(_tiny(attention_impl=single), params=params)(tokens)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="serving requires"):
            ServingEngine(cfg, params, serve=ServeConfig(block_size=4),
                          device="cpu")
