"""The sm90 flash forward's rules and numerics, on the CPU.

``csrc/flash_fwd_sm90.cu`` (wgmma + TMA) runs only on the card; here:

* the variant rule (``_fwd_variant``) that sends bf16 launches with head
  width 64 or 128 and more than four query rows to it, and everything
  else to the CUDA-core kernel, and the check of what its TMA (and the
  CUDA-core kernels' 16-byte loads) need of a tensor's layout
  (``_check_aligned``, pure: no device);
* its rounding, emulated in plain torch — bf16 q and k, fp32 scores
  times the scale, an online softmax over the kernel's key tiles, P
  rounded to bf16 before P·V, fp32 l — against the JAX package's
  ``flash_attention`` (its Pallas kernel in interpret mode) on the same
  bf16 inputs.  The tolerances are the ones ``chip_smoke.py`` holds the
  kernel to in bf16: 2e-2 absolute (``TOL``) and 1e-2 of each row's
  largest |output| (``ROW_TOL``): rounding P to bf16 moves an output by
  at most ~2^-8 of its row's largest value, one bf16 output rounding
  step is 2^-8 relative.

The kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

TOL, ROW_TOL = 2e-2, 1e-2  # chip_smoke.py's bf16 TOL / ROW_TOL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the variant rule and the alignment check ---------------------------


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("c", [5, 40, 256, 2048])
def test_bf16_chunks_at_d64_d128_take_sm90(d, c):
    assert tfa._fwd_variant(torch.bfloat16, d, c) == "sm90"


@pytest.mark.parametrize("dtype,d,c", [
    (torch.float32, 64, 256), (torch.float32, 128, 2048),
    (torch.bfloat16, 32, 256), (torch.bfloat16, 96, 256),
    (torch.bfloat16, 256, 256),
    (torch.bfloat16, 64, 1), (torch.bfloat16, 128, 4),
    (torch.bfloat16, 128, 1)])
def test_fp32_other_widths_and_decode_take_simt(dtype, d, c):
    assert tfa._fwd_variant(dtype, d, c) == "simt"


def _offset_view(shift):
    """A (2, 8, 4, 64) bf16 view whose base is ``shift`` elements past a
    16-byte aligned buffer start."""
    buf = torch.zeros(2 * 8 * 4 * 64 + 16, dtype=torch.bfloat16)
    start = (-buf.data_ptr() // 2) % 8  # elements to the first 16 B line
    return buf[start + shift:start + shift + 2 * 8 * 4 * 64].view(2, 8, 4, 64)


def test_alignment_check_refuses_a_base_off_16_bytes():
    t = _offset_view(1)
    assert tfa._fwd_variant(t.dtype, t.shape[3], t.shape[1]) == "sm90"
    assert t.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte aligned base"):
        tfa._check_aligned("q", t.data_ptr(), t.stride()[:3],
                           t.element_size())
    ok = _offset_view(0)
    tfa._check_aligned("q", ok.data_ptr(), ok.stride()[:3],
                       ok.element_size())


@pytest.mark.parametrize("strides", [(2048, 256, 68), (2052, 256, 64),
                                     (2 ** 40, 256, 64)])
def test_alignment_check_refuses_strides_off_16_bytes(strides):
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tfa._check_aligned("k", 0x1000, strides, 2)


def test_alignment_check_takes_a_strided_head_view():
    """A q sliced out of a fused (B, C, 3H, D) projection: strides of
    whole rows, still 16-byte multiples."""
    qkv = torch.zeros((2, 8, 12, 64), dtype=torch.bfloat16)
    q = qkv[:, :, :4]
    tfa._check_aligned("q", q.data_ptr(), q.stride()[:3], q.element_size())


# -- (b) the design's rounding against the JAX kernel ------------------------


def _sm90_emulation(q, k, v, causal, window):
    """The sm90 forward's arithmetic in plain torch: (B, S, H, D) bf16 in,
    bf16 out.  Key tiles of the kernel's BK (128 at D = 64, 64 at
    D = 128); per tile, fp32 scores of the bf16 q and k times the scale,
    the _tile_mask, a running max, P = exp(s - m) zeroed where masked,
    l += ΣP in fp32, O = O·corr + bf16(P)·V in fp32; O / l rounded to
    bf16."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    bk = 128 if d == 64 else 64
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    qf = q.float()
    pos = torch.arange(s)
    m = torch.full((b, h, s), -1e30)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, s, bk):
        kk = pos[k0:k0 + bk]
        mask = tfa._tile_mask(pos[:, None], kk[None, :], causal, window, s)
        sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + bk]) \
            * (1.0 / d ** 0.5)
        sc = torch.where(mask, sc, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.where(mask & (m_new[..., None] > -1e30),
                        torch.exp(sc - m_new[..., None]), torch.zeros(()))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.bfloat16().float(), vf[:, k0:k0 + bk])
        m = m_new
    out = acc / torch.where(l > 0, l, torch.ones(()))[..., None]
    return out.permute(0, 2, 1, 3).bfloat16()


CASES = [  # (S, H, H_kv, causal, window)
    (300, 8, 2, True, None),
    (300, 8, 2, False, None),
    (300, 8, 2, True, 33),
    (300, 8, 2, False, 33),
    (256, 4, 4, True, None),
]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,h,h_kv,causal,window", CASES)
def test_sm90_rounding_matches_jax_kernel(d, s, h, h_kv, causal, window):
    rs = np.random.RandomState(s + h + d + int(causal) + (window or 0))
    b = 2
    q, k, v = (rs.randn(b, s, n, d).astype(np.float32)
               for n in (h, h_kv, h_kv))
    qt, kt, vt = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = _sm90_emulation(qt, kt, vt, causal, window).float().numpy()
    want = np.asarray(jfa.flash_attention(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=causal, window=window, interpret=True).astype(jnp.float32))
    diff = np.abs(got - want)
    row_scale = np.maximum(np.abs(want).max(axis=-1), 1e-30)
    assert float(diff.max()) <= TOL
    assert float((diff.max(axis=-1) / row_scale).max()) <= ROW_TOL
    # the emulation against the plain version the kernel is held to on
    # the card (fp32 P): the same bound
    ref = tfa.flash_attention_reference(qt, kt, vt, causal, window)[0]
    diff = np.abs(got - ref.float().numpy())
    assert float(diff.max()) <= TOL
    assert float((diff.max(axis=-1) / row_scale).max()) <= ROW_TOL
