"""The flash kernels' uniform ``kv_offset`` form (ring attention's
off-diagonal blocks) against the JAX package's kernels.

The port's plain versions — ``flash_block_forward`` on CPU tensors
(``flash_attention_reference`` at the offset), ``flash_bwd_dq_reference``
and ``flash_bwd_dkv_reference`` — take the same seeded numpy inputs as
``horovod_tpu.ops.flash_attention.flash_block_forward`` and
``_backward_folded(kv_offset=)``, whose Pallas kernels run in interpret
mode on the CPU as the JAX package's own tests run them.  The grid
covers offsets of either sign (whole shards away and inside one shard),
causal and bidirectional masks, windows 2 and 5, GQA 4/2 and a ragged S
(40: the JAX kernels pad it to their 128-row tiles).  Rows that see no
key come out as exact zeros with the −1e30 sentinel lse on both sides,
and their dq as exact zeros; keys no query sees get zero dK and dV.

Tolerance: fp32, 1e-5 absolute and 1e-4 relative (the reference's ring
tests' ``rtol=1e-4, atol=1e-5``): the two sides sum in different orders.
The CUDA kernels at these offsets are held against the same plain
versions on the card by ``chip_smoke.py`` (its B9 cases).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 1e-5, 1e-4
SENTINEL = np.float32(-1e30)
H = 4
# (S, kv_offset, causal, window, H_kv)
CASES = [
    (32, -32, True, None, 4),     # a past shard: every key visible
    (32, 32, True, None, 4),      # a future shard: nothing visible
    (40, -13, True, None, 2),     # the diagonal 13 keys back, ragged S
    (40, 13, True, None, 2),      # rows 0..12 see no key
    (32, -96, False, None, 2),    # three shards back, bidirectional
    (32, -32, True, 5, 2),        # causal window across the boundary
    (40, -40, False, 5, 4),       # bidirectional window, past shard
    (32, 32, False, 2, 4),        # bidirectional window, next shard
    (40, 3, False, 5, 2),         # bidirectional window inside a shard
    (32, 96, True, 2, 4),         # future shard under a window
]


def _inputs(seed, s, h_kv, b=2, d=16):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, hh, d).astype(np.float32)
            for hh in (H, h_kv, h_kv, H)]


def _visible(s, off, causal, window):
    """(S, S) bool: the reference's _tile_mask at ``off``."""
    q = np.arange(s)[:, None]
    k = np.arange(s)[None, :]
    return np.broadcast_to(np.asarray(
        jfa._tile_mask(q, k, causal, window, s, off)), (s, s))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                               err_msg=what)


@pytest.mark.parametrize("s,off,causal,window,h_kv", CASES)
def test_block_forward_matches_jax(s, off, causal, window, h_kv):
    q, k, v, _ = _inputs(s + off % 7, s, h_kv)
    out_j, lse_j = jfa.flash_block_forward(
        *(jnp.asarray(x) for x in (q, k, v)), causal, interpret=True,
        window=window, kv_offset=off)
    out_t, lse_t = tfa.flash_block_forward(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, window=window,
        kv_offset=off)
    assert lse_t.shape == (2, H, s) and lse_t.dtype == torch.float32
    lse_j = np.asarray(lse_j).transpose(0, 2, 1)  # (B, S, H) -> (B, H, S)
    live = _visible(s, off, causal, window).any(axis=1)
    _close(out_t.numpy(), np.asarray(out_j), "out")
    _close(lse_t.numpy()[..., live], lse_j[..., live], "lse")
    for got in (out_t.numpy(), np.asarray(out_j)):
        assert (got[:, ~live] == 0).all()
    for got in (lse_t.numpy(), lse_j):
        assert (got[..., ~live] == SENTINEL).all()


@pytest.mark.parametrize("s,off,causal,window,h_kv", CASES)
def test_block_backward_matches_jax(s, off, causal, window, h_kv):
    """dq/dkv plain versions against ``_backward_folded(kv_offset=)``,
    given the same finite lse (the block's own where a row sees a key,
    else the row's diagonal lse: what a ring's merged lse looks like)
    and δ."""
    q, k, v, g = _inputs(3 * s + off % 5, s, h_kv)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse_blk = tfa.flash_block_forward(tq, tk, tv, causal, window, off)
    lse = torch.where(lse_blk > -1e29, lse_blk,
                      tfa.flash_attention_reference(tq, tk, tv, True,
                                                    window)[1])
    delta = (tg * out).sum(-1).transpose(1, 2).contiguous()
    dq_t = tfa.flash_bwd_dq_reference(tq, tk, tv, tg, lse, delta, causal,
                                      window, off)
    dk_t, dv_t = tfa.flash_bwd_dkv_reference(tq, tk, tv, tg, lse, delta,
                                             causal, window, off)

    b, _, _, d = q.shape
    bq, bk = jfa._clamp_blocks(s, 256, 256)
    lse_col = jnp.asarray(lse.numpy()).reshape(b * H, s, 1)
    qf, gf, lse_f, delta_f = jfa._fold_bwd_invariants(
        jnp.asarray(q), jnp.asarray(out.numpy()), lse_col, jnp.asarray(g), bq)
    kf = jfa._fold(jfa._pad_to(jnp.asarray(k), bk, axis=1), b, h_kv, d)
    vf = jfa._fold(jfa._pad_to(jnp.asarray(v), bk, axis=1), b, h_kv, d)
    dq_j, dk_j, dv_j = jfa._backward_folded(
        qf, kf, vf, gf, lse_f, delta_f, orig_s=s, causal=causal,
        block_q=bq, block_k=bk, interpret=True, window=window,
        kv_offset=off)
    dq_j = jfa._unfold(dq_j, b, H, qf.shape[1], d)[:, :s]
    dk_j = jfa._unfold(dk_j, b, h_kv, kf.shape[1], d)[:, :s]
    dv_j = jfa._unfold(dv_j, b, h_kv, kf.shape[1], d)[:, :s]
    for name, got, want in (("dq", dq_t, dq_j), ("dk", dk_t, dk_j),
                            ("dv", dv_t, dv_j)):
        _close(got.numpy(), np.asarray(want), name)
    mask = _visible(s, off, causal, window)
    live_q, live_k = mask.any(axis=1), mask.any(axis=0)
    assert (dq_t.numpy()[:, ~live_q] == 0).all()
    assert (dk_t.numpy()[:, ~live_k] == 0).all()
    assert (dv_t.numpy()[:, ~live_k] == 0).all()


def test_offset_zero_is_self_attention():
    """kv_offset 0 (or None) is the self-attention launch: the same bits
    as flash_attention_reference and the training backward."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(5, 40, 2))
    for causal, window in ((True, None), (False, 5)):
        out0, lse0 = tfa.flash_attention_reference(q, k, v, causal, window)
        for off in (None, 0):
            out, lse = tfa.flash_block_forward(q, k, v, causal, window, off)
            assert torch.equal(out, out0) and torch.equal(lse, lse0)
        delta = (g * out0).sum(-1).transpose(1, 2).contiguous()
        assert torch.equal(
            tfa.flash_bwd_dq(q, k, v, g, lse0, delta, causal, window, 0),
            tfa.flash_bwd_dq_reference(q, k, v, g, lse0, delta, causal,
                                       window))


def test_block_wrappers_validate_and_refuse_cpu_launches():
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="window"):
        tfa.flash_block_forward(q, k, k, True, window=0, kv_offset=8)
    with pytest.raises(ValueError, match="length"):
        tfa.flash_block_forward(q, k[:, :4], k[:, :4], True, kv_offset=8)
    lse = torch.zeros((1, 4, 8))
    for fn in (tfa.flash_bwd_dq_cuda, tfa.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, k, q, lse, lse, kv_offset=-8)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_cuda(q, k, k, -8, causal=False)
