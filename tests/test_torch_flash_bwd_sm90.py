"""The sm90 flash backward's rules and numerics, on the CPU.

``csrc/flash_bwd_sm90.cu`` (wgmma + TMA: dQ, and dK/dV) runs only on the
card; here:

* the variant rule (``_bwd_variant``) that sends bf16 backward launches
  with head width 64 or 128 to it, and everything else to the CUDA-core
  kernels, and the layout check over every tensor its TMA tensor maps
  address, outputs included (``_check_layout``, pure: no device);
* its rounding, emulated in plain torch — bf16 operands, fp32 scores,
  P = exp(S·scale − lse) zeroed where masked, dS = P∘(dP − δ) in fp32
  (the dK/dV kernel at D = 128 forms it from P rounded to bf16), P and
  dS rounded to bf16 before their products, fp32 accumulation over the
  kernels' tile order (dQ over 64-key tiles; dK and dV over 64-query
  tiles, each for the group's query heads in turn) — against the JAX
  package's backward (``_forward_impl`` then ``_backward_impl``, its
  Pallas kernels in interpret mode) on the same bf16 inputs.  The
  tolerances are the ones ``chip_smoke.py`` holds the kernels to in
  bf16: absolute error within 2e-2 x max(1, largest |output|) (``TOL``),
  and 1e-2 of each row's largest |output|, a row's scale floored at 1e-2
  of the tensor's largest value (``TRAIN_ROW_TOL``): rounding P or dS to
  bf16 moves each term by at most 2^-9 of itself, one bf16 output
  rounding step is 2^-8 relative.

The kernels themselves are held against the plain versions on the card
by ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

TOL, ROW_TOL = 2e-2, 1e-2  # chip_smoke.py's bf16 TOL / TRAIN_ROW_TOL
TILE = 64  # the kernels' streamed tile (keys in dq, queries in dkv)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the variant rule ----------------------------------------------------


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_at_d64_d128_takes_sm90(d):
    assert tfa._bwd_variant(torch.bfloat16, d) == "sm90"


@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 64), (torch.float32, 128), (torch.bfloat16, 16),
    (torch.bfloat16, 32), (torch.bfloat16, 96), (torch.bfloat16, 256)])
def test_fp32_and_other_widths_take_simt(dtype, d):
    assert tfa._bwd_variant(dtype, d) == "simt"


# -- (b) the layout check over inputs and outputs ---------------------------


def _offset_view(shift, shape=(2, 8, 4, 64)):
    """A bf16 view of ``shape`` whose base is ``shift`` elements past a
    16-byte aligned buffer start."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 16, dtype=torch.bfloat16)
    start = (-buf.data_ptr() // 2) % 8  # elements to the first 16 B line
    return buf[start + shift:start + shift + n].view(*shape)


@pytest.mark.parametrize("name", ["dO", "dQ", "dK", "dV"])
def test_layout_check_refuses_a_misaligned_base(name):
    """A misaligned dO (an input) or gradient (an output) is refused, by
    name, before anything reaches the device."""
    bad = _offset_view(1)
    assert bad.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match=f"{name} needs a 16-byte aligned"):
        tfa._check_layout([("q", _offset_view(0)), (name, bad)])


def test_layout_check_refuses_misaligned_strides_and_strided_rows():
    buf = torch.zeros((2, 8, 4, 68), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dQ needs strides"):
        tfa._check_layout([("dQ", buf[..., :64])])  # rows 136 B apart
    full = torch.zeros((2, 8, 4, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dO needs a contiguous last dim"):
        tfa._check_layout([("dO", full[..., ::2])])


def test_layout_check_takes_aligned_views():
    qkv = torch.zeros((2, 8, 12, 64), dtype=torch.bfloat16)
    tfa._check_layout([("q", qkv[:, :, :4]), ("dO", _offset_view(0)),
                       ("dK", torch.empty((2, 8, 4, 128),
                                          dtype=torch.bfloat16))])


# -- (c) the design's rounding against the JAX kernels -----------------------


def _sm90_bwd_emulation(q, k, v, do, lse, delta, causal, window):
    """The sm90 backward's arithmetic in plain torch: q, dO (B, S, H, D)
    and k, v (B, S, H_kv, D) bf16, lse and δ (B, H, S) fp32; returns dQ,
    dK, dV in bf16.  Scores and dP in fp32 from the bf16 operands;
    P = exp(S·scale − lse) zeroed where the _tile_mask hides it;
    dS = P∘(dP − δ) (for dK at D = 128 with P rounded to bf16 first, as
    that kernel forms it); P and dS rounded to bf16; dQ summed in fp32 over
    64-key tiles in order, dK and dV over 64-query tiles in order and,
    per tile, the group's query heads in turn; dQ and dK times the
    scale, each output rounded to bf16 once."""
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    group = h // h_kv
    scale = 1.0 / d ** 0.5
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    kr = kf.repeat_interleave(group, dim=2)
    vr = vf.repeat_interleave(group, dim=2)
    pos = torch.arange(s)
    mask = tfa._tile_mask(pos[:, None], pos[None, :], causal, window, s)
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kr)
    p = torch.where(mask, torch.exp(sc * scale - lse[..., None]),
                    torch.zeros(()))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    pb = p.bfloat16().float()
    dsb = (p * (dp - delta[..., None])).bfloat16().float()
    # the dkv kernel at D = 128 forms dS from P's bf16 fragments
    dsb_kv = (pb * (dp - delta[..., None])).bfloat16().float() \
        if d == 128 else dsb
    dq = torch.zeros((b, h, s, d))
    for k0 in range(0, s, TILE):
        dq += torch.einsum("bhqk,bkhd->bhqd", dsb[..., k0:k0 + TILE],
                           kr[:, k0:k0 + TILE])
    dk = torch.zeros((b, h_kv, s, d))
    dv = torch.zeros((b, h_kv, s, d))
    for q0 in range(0, s, TILE):
        rows = slice(q0, q0 + TILE)
        for g in range(group):
            heads = torch.arange(h_kv) * group + g  # one per kv head
            dv += torch.einsum("bhqk,bqhd->bhkd", pb[:, heads, rows],
                               dof[:, rows][:, :, heads])
            dk += torch.einsum("bhqk,bqhd->bhkd", dsb_kv[:, heads, rows],
                               qf[:, rows][:, :, heads])
    out = lambda x: x.permute(0, 2, 1, 3).bfloat16()  # noqa: E731
    return out(dq * scale), out(dk * scale), out(dv)


def _check(got, want, what):
    """chip_smoke.py's training-kernel bounds (``_errors``): absolute
    error within TOL x max(1, largest |want|), per-row error within
    ROW_TOL of the row's largest |want|, floored at 1e-2 of the
    tensor's."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    top = float(want.abs().max())
    rows = want.abs().amax(dim=-1).clamp_min(max(1e-2 * top, 1e-30))
    err, row = float(diff.max()), float((diff.amax(dim=-1) / rows).max())
    assert err <= TOL * max(1.0, top), f"{what}: abs {err} (top {top})"
    assert row <= ROW_TOL, f"{what}: row {row}"


CASES = [  # (S, H, H_kv, causal, window): ragged S, GQA ratios 1 and 4
    (200, 4, 4, True, None),
    (200, 4, 1, False, None),
    (200, 4, 1, True, 40),
    (200, 4, 4, False, 40),
    (256, 4, 4, True, None),
]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,h,h_kv,causal,window", CASES)
def test_sm90_bwd_rounding_matches_jax_kernels(d, s, h, h_kv, causal,
                                               window):
    rs = np.random.RandomState(s + 10 * h_kv + d + int(causal)
                               + (window or 0))
    b = 1
    q, do = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, s, h_kv, d).astype(np.float32) for _ in range(2))
    jq, jk, jv, jg = (jnp.asarray(x).astype(jnp.bfloat16)
                      for x in (q, k, v, do))
    out_j, lse_j = jfa._forward_impl(jq, jk, jv, causal, 256, 256, True,
                                     with_lse=True, window=window)
    want = jfa._backward_impl(jq, jk, jv, out_j, lse_j, jg, causal, 256,
                              256, True, window=window)
    want = [torch.from_numpy(np.array(x.astype(jnp.float32)))
            for x in want]
    # the kernels' inputs as the port's backward forms them: the
    # forward's lse (B, H, S) and δ = rowsum(dO·O) in fp32
    qt, kt, vt, dot = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    out = torch.from_numpy(np.array(out_j.astype(jnp.float32))).bfloat16()
    lse = torch.from_numpy(
        np.asarray(lse_j)[:, :s, 0].reshape(b, h, s).copy())
    delta = (dot.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = _sm90_bwd_emulation(qt, kt, vt, dot, lse, delta, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        _check(g, w, f"{name} vs the JAX kernels")
    # the emulation against the plain versions the kernels are held to on
    # the card (fp32 P and dS): the same bounds
    plain = (tfa.flash_bwd_dq_reference(qt, kt, vt, dot, lse, delta, causal,
                                        window),
             *tfa.flash_bwd_dkv_reference(qt, kt, vt, dot, lse, delta,
                                          causal, window))
    for name, g, w in zip(("dq", "dk", "dv"), got, plain):
        _check(g, w, f"{name} vs the plain version")
