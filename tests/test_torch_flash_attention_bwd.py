"""The port's differentiable flash attention against the JAX package's.

Same seeded numpy inputs through ``horovod_tpu.ops.flash_attention.
flash_attention`` under ``jax.vjp`` (its Pallas forward and backward
kernels in interpret mode on the CPU, as the JAX package's own tests run
them) and through ``horovod_tpu_torch.ops.flash_attention.
flash_attention`` with autograd (whose CPU path is the kernels' plain
PyTorch versions).  The grid covers causal and bidirectional attention,
windows None/24/120, GQA ratios 1/2/4 and S 64/200/256.

Tolerances: fp32 outputs and dq/dk/dv agree to 1e-5 absolute (the two
sides sum in different orders; observed ≤ 2e-6).  bf16 to 2e-2 absolute:
both sides round the same bf16 inputs, accumulate in fp32 and round each
output to bf16 once, so they differ by about one bf16 step (2⁻⁸
relative) at magnitudes ≤ 2.

The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``.
"""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is enough, and the suite runs
    several workers side by side on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": 1e-5, "bfloat16": 2e-2}
H = 4
# every S with every mask kind; the GQA ratio cycles so that each ratio
# meets each S
MASKS = [(True, None), (False, None), (True, 24), (False, 120),
         (True, 120), (False, 24)]
GRID = [(s, causal, window, (1, 2, 4)[(i + j) % 3])
        for i, s in enumerate((64, 200, 256))
        for j, (causal, window) in enumerate(MASKS)
        if (i + j) % 2 == 0 or j < 2]


def _inputs(seed, b, s, h, h_kv, d):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, s, h, d).astype(np.float32)
    k = rs.randn(b, s, h_kv, d).astype(np.float32)
    v = rs.randn(b, s, h_kv, d).astype(np.float32)
    g = rs.randn(b, s, h, d).astype(np.float32)
    return q, k, v, g


def _jax_fwd_bwd(q, k, v, g, causal, window, dtype):
    jd = getattr(jnp, dtype)
    fn = lambda q, k, v: jfa.flash_attention(  # noqa: E731
        q, k, v, causal=causal, window=window, interpret=True)
    out, vjp = jax.vjp(fn, *(jnp.asarray(x).astype(jd) for x in (q, k, v)))
    grads = vjp(jnp.asarray(g).astype(jd))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _torch_fwd_bwd(q, k, v, g, causal, window, dtype):
    td = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(x).to(td).requires_grad_()
                  for x in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal=causal, window=window)
    out.backward(torch.from_numpy(g).to(td))
    assert qt.grad.dtype == td and kt.grad.shape == kt.shape
    return [x.detach().float().numpy()
            for x in (out, qt.grad, kt.grad, vt.grad)]


def _compare(got, want, dtype, what):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = float(np.abs(a - b).max())
        assert err <= TOL[dtype], f"{what} {name}: max abs err {err}"


@pytest.mark.parametrize("s,causal,window,ratio", GRID)
def test_flash_attention_matches_jax_fp32(s, causal, window, ratio):
    h_kv = H // ratio
    q, k, v, g = _inputs(s + ratio, 2, s, H, h_kv, 16)
    _compare(_torch_fwd_bwd(q, k, v, g, causal, window, "float32"),
             _jax_fwd_bwd(q, k, v, g, causal, window, "float32"), "float32",
             (s, causal, window, ratio))


@pytest.mark.parametrize("s,causal,window,ratio",
                         [(200, True, 24, 2), (64, False, None, 4)])
def test_flash_attention_matches_jax_bf16(s, causal, window, ratio):
    q, k, v, g = _inputs(7, 2, s, H, H // ratio, 16)
    _compare(_torch_fwd_bwd(q, k, v, g, causal, window, "bfloat16"),
             _jax_fwd_bwd(q, k, v, g, causal, window, "bfloat16"),
             "bfloat16", (s, causal, window, ratio))


@pytest.mark.parametrize("causal,window", [(True, None), (False, 24)])
def test_bwd_plain_versions_match_jax_kernels(causal, window):
    """flash_bwd_dq_reference / flash_bwd_dkv_reference on their own,
    fed the same (q, k, v, dO, lse, δ) as the JAX backward kernels; the
    forward's log-sum-exp agrees too."""
    b, s, h, h_kv, d = 2, 200, 4, 2, 16
    q, k, v, g = _inputs(11, b, s, h, h_kv, d)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out_j, lse_j = jfa._forward_impl(jq, jk, jv, causal, 256, 256, True,
                                     with_lse=True, window=window)
    dq_j, dk_j, dv_j = jfa._backward_impl(jq, jk, jv, out_j, lse_j, jg,
                                          causal, 256, 256, True,
                                          window=window)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out_t, lse_t = tfa.flash_attention_reference(tq, tk, tv, causal, window)
    lse_j = np.asarray(lse_j)[:, :s, 0].reshape(b, h, s)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-5, rtol=0)
    delta = (tg * out_t).sum(-1).transpose(1, 2).contiguous()
    dq_t = tfa.flash_bwd_dq_reference(tq, tk, tv, tg, lse_t, delta, causal,
                                      window)
    dk_t, dv_t = tfa.flash_bwd_dkv_reference(tq, tk, tv, tg, lse_t, delta,
                                             causal, window)
    for a, want in ((dq_t, dq_j), (dk_t, dk_j), (dv_t, dv_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def _brute_q_blocks(k_off, block_k, block_q, n_qb, causal, window, kv_off):
    """Q blocks holding >= 1 (q, k) pair, k in this K block, that the
    causal/window terms leave visible."""
    blocks = set()
    for qb in range(n_qb):
        for qp in range(qb * block_q, (qb + 1) * block_q):
            rel = [qp - kp - kv_off for kp in range(k_off, k_off + block_k)]
            if any((not causal or r >= 0) and (
                    window is None or (r < window and (causal or r > -window)))
                   for r in rel):
                blocks.add(qb)
                break
    return blocks


def test_qb_range_bounds_property():
    """kv_off=0: [lo, hi) covers EXACTLY the Q blocks with work for the
    K block — none skipped, no empty one visited at either edge."""
    for block_k, block_q in ((16, 32), (32, 16), (64, 64)):
        for n_qb in (2, 3):
            for k_off in range(0, n_qb * block_q, block_k):
                for causal, window in itertools.product(
                        (True, False), (None, 1, 17, 100, 1000)):
                    want = _brute_q_blocks(k_off, block_k, block_q, n_qb,
                                           causal, window, 0)
                    lo, hi = tfa._qb_range(k_off, block_k, block_q, n_qb,
                                           causal, window)
                    assert set(range(lo, hi)) == want, (
                        block_k, block_q, n_qb, k_off, causal, window)


def test_qb_range_with_offset_mirrors_jax():
    """kv_off != 0: the bounds contain every Q block with work, and equal
    the JAX dkv kernel's own bounds (its inline _kb_range transpose)."""
    rng = np.random.RandomState(0)
    for _ in range(200):
        block_k, block_q = (int(x) for x in rng.choice([16, 32], 2))
        n_qb = int(rng.randint(1, 4))
        k_off = int(rng.randint(0, 3)) * block_k
        causal = bool(rng.randint(2))
        window = [None, 1, 9, 50][rng.randint(4)]
        kv_off = int(rng.randint(-3, 4)) * 16
        lo, hi = tfa._qb_range(k_off, block_k, block_q, n_qb, causal, window,
                               kv_off)
        want = _brute_q_blocks(k_off, block_k, block_q, n_qb, causal,
                               window, kv_off)
        assert want <= set(range(lo, hi))
        jlo, jhi = jfa._kb_range(k_off, block_k, block_q, n_qb, False,
                                 window, -kv_off)
        if causal:
            jlo = max(int(jlo), max(0, (k_off + kv_off) // block_q))
        assert (lo, hi) == (int(jlo), int(jhi))


def test_wrappers_validate_arguments():
    q = torch.zeros((2, 8, 4, 16))
    k = torch.zeros((2, 8, 2, 16))
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="k/v shapes differ"):
        tfa.flash_attention(q, k, k[:, :, :1])
    with pytest.raises(ValueError, match="length"):
        tfa.flash_attention(q, k[:, :4], k[:, :4])
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_attention(q, k[:, :, :1].expand(2, 8, 3, 16),
                            k[:, :, :1].expand(2, 8, 3, 16))
    # the kernel wrappers refuse CPU tensors (they never fall back)
    lse = torch.zeros((2, 4, 8))
    for fn in (tfa.flash_bwd_dq_cuda, tfa.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, k, q, lse, lse)
