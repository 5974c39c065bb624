"""The port's paged flash attention against the JAX package's.

Same inputs (numpy, seeded) through ``horovod_tpu.ops.flash_attention``
(its Pallas kernel in interpret mode on the CPU, as the JAX package's own
tests run it) and through ``horovod_tpu_torch.ops.flash_attention``
(whose CPU path is the plain PyTorch version).  fp32 agrees to 1e-5;
bf16 to 2e-2 (both sides round the output to bf16, from fp32 sums taken
in different orders).  The mask helpers are mirrored exactly.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``.
"""

import itertools

import numpy as np
import pytest

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
HEADS = [(4, 4), (4, 2), (8, 2)]
CHUNKS = [1, 5, 32, 40]


def _inputs(seed, b, c, h, h_kv, d, s):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, c, h, d).astype(np.float32)
    k = rs.randn(b, s, h_kv, d).astype(np.float32)
    v = rs.randn(b, s, h_kv, d).astype(np.float32)
    return q, k, v


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _compare(out_t, out_j, dtype):
    a = out_t.float().numpy()
    b = np.asarray(jnp.asarray(out_j).astype(jnp.float32))
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    assert err <= TOL[dtype], f"max abs err {err} > {TOL[dtype]}"


@pytest.mark.parametrize("c,heads", list(itertools.product(CHUNKS, HEADS)))
@pytest.mark.parametrize("variant", ["plain_fp32", "window_kvstart_bf16"])
def test_chunk_attention_matches_jax(c, heads, variant):
    h, h_kv = heads
    d = 16 if (c + h) % 2 else 32
    b, s = 3, 64
    q, k, v = _inputs(c * 10 + h, b, c, h, h_kv, d, s)
    if variant == "plain_fp32":
        dtype, window, kv_start = "float32", None, None
        q_starts = np.array([0, 9, s - c], np.int32)
    else:
        # rows start mid-sequence; the gather of row 1 and 2 begins at a
        # page boundary past 0 (kv_start), as the windowed gather does
        dtype, window = "bfloat16", 7
        kv_start = np.array([0, 8, 16], np.int32)
        q_starts = np.array([0, 20, 16 + s - c], np.int32)
    out_j = jfa.flash_chunk_attention(
        _to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
        jnp.asarray(q_starts), window=window,
        kv_start=None if kv_start is None else jnp.asarray(kv_start),
        interpret=True)
    out_t = tfa.flash_chunk_attention(
        _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype),
        torch.from_numpy(q_starts), window=window,
        kv_start=None if kv_start is None else torch.from_numpy(kv_start))
    assert out_t.dtype == getattr(torch, dtype)
    _compare(out_t, out_j, dtype)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax_with_pad_rows(heads, dtype):
    """Decode over a partial batch: rows with kv_lens=0 are pad slots
    and must come back exactly zero on both sides."""
    h, h_kv = heads
    d, s = 16, 48
    kv_lens = np.array([5, 0, 48, 1, 0], np.int32)
    q, k, v = _inputs(h * 7 + h_kv, len(kv_lens), 1, h, h_kv, d, s)
    window = 7 if dtype == "bfloat16" else None
    out_j = jfa.flash_decode_attention(
        _to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
        jnp.asarray(kv_lens), window=window, interpret=True)
    out_t = tfa.flash_decode_attention(
        _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype),
        torch.from_numpy(kv_lens), window=window)
    _compare(out_t, out_j, dtype)
    pad = kv_lens == 0
    assert bool((out_t[torch.from_numpy(pad)] == 0).all())


def test_tile_mask_and_kb_range_mirror_jax_exactly():
    qp = np.arange(-3, 20)[:, None]
    kp = np.arange(-2, 30)[None, :]
    for causal, window, seq_len, off in itertools.product(
            (True, False), (None, 1, 4, 9), (0, 7, 30), (-5, 0, 3, 12)):
        mj = np.asarray(jfa._tile_mask(jnp.asarray(qp), jnp.asarray(kp),
                                       causal, window, seq_len, off))
        mt = tfa._tile_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                            causal, window, seq_len, off).numpy()
        np.testing.assert_array_equal(mt, mj)
    for q_off, bq, bk, pkb, causal, window, off in itertools.product(
            (0, 8, 40), (8, 32), (16, 128), (1, 4, 9), (True, False),
            (None, 1, 7, 100), (-300, -9, 0, 5, 77)):
        lo_j, hi_j = jfa._kb_range(q_off, bq, bk, pkb, causal, window, off)
        lo_t, hi_t = tfa._kb_range(q_off, bq, bk, pkb, causal, window, off)
        assert (lo_t, hi_t) == (int(lo_j), int(hi_j)), (
            q_off, bq, bk, pkb, causal, window, off)


def test_wrapper_validates_arguments():
    q = torch.zeros((2, 1, 4, 16))
    k = torch.zeros((2, 8, 3, 16))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_chunk_attention(q, k, k, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="window"):
        tfa.flash_chunk_attention(q, k[:, :, :2], k[:, :, :2],
                                  torch.zeros(2, dtype=torch.int32), window=0)
    with pytest.raises(ValueError, match="q_len=1"):
        tfa.flash_decode_attention(torch.zeros((2, 3, 4, 16)), k[:, :, :2],
                                   k[:, :, :2], torch.ones(2))
    # the kernel wrapper refuses CPU tensors (it never falls back)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_cuda(q, k[:, :, :2], k[:, :, :2],
                           torch.zeros(2, dtype=torch.int32))

