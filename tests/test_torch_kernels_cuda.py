"""The port's hand-written kernels on the card (marked ``cuda``).

These need a CUDA device and skip without one.  They import nothing of
JAX, so they run on a machine with the card and without JAX; the
repository's ``tests/conftest.py`` imports JAX, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py -q

``chip_smoke.py`` runs the full-size cases; these are small ones.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import TransformerConfig, init_params
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.serving import ServeConfig, ServingEngine

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("c", [1, 3, 40])
@pytest.mark.parametrize("window", [None, 33])
def test_kernel_matches_plain_version(dtype, tol, c, window):
    _need_card()
    g = torch.Generator("cuda").manual_seed(c)
    b, h, h_kv, d, s = 4, 8, 2, 64, 300
    q = torch.randn((b, c, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, s, h_kv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, s, h_kv, d), generator=g, device="cuda").to(dtype)
    starts = torch.tensor([0, 17, 100, s - c], dtype=torch.int32,
                          device="cuda")
    kv_start = torch.tensor([0, 0, 16, 32], dtype=torch.int32, device="cuda")
    before = tfa.flash_fwd_cuda.launches
    out = tfa.flash_chunk_attention(q, k, v, starts, window=window,
                                    kv_start=kv_start)
    ref = tfa.flash_chunk_attention_reference(q, k, v, starts,
                                              window=window,
                                              kv_start=kv_start)
    torch.cuda.synchronize()
    assert tfa.flash_fwd_cuda.launches == before + 1
    assert float((out.float() - ref.float()).abs().max()) <= tol


def test_kernel_lse_and_zero_rows():
    _need_card()
    g = torch.Generator("cuda").manual_seed(0)
    q = torch.randn((3, 1, 4, 32), generator=g, device="cuda")
    k = torch.randn((3, 64, 4, 32), generator=g, device="cuda")
    starts = torch.tensor([-1, 10, 63], dtype=torch.int32, device="cuda")
    out, lse = tfa.flash_fwd_cuda(q, k, k, -starts, with_lse=True)
    torch.cuda.synchronize()
    sentinel = float(np.float32(-1e30))  # the kernel's fp32 -1e30
    assert bool((out[0] == 0).all()) and float(lse[0].max()) == sentinel
    logits = torch.einsum("bchd,bshd->bhcs", q, k) / 32 ** 0.5
    want = torch.logsumexp(logits[1, :, 0, :11], dim=-1)
    assert float((lse[1, :, 0] - want).abs().max()) < 1e-4


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("pv", [False, True])
def test_sm90_wgmma_tile_product_matches_matmul(d, pv):
    """One 64-row tile product of the sm90 forward through its own TMA
    loads, swizzled descriptors and wgmma: S = Q·Kᵀ (both operands
    K-major) or O = P·V (P from registers, V MN-major), against
    torch.matmul in fp32 on the same bf16 inputs."""
    _need_card()
    bk = 128 if d == 64 else 64
    g = torch.Generator("cuda").manual_seed(d + pv)
    a = torch.randn((64, bk if pv else d), generator=g,
                    device="cuda").bfloat16()
    b = torch.randn((bk, d), generator=g, device="cuda").bfloat16()
    got = tfa.wgmma_tile_cuda(a, b, pv)
    want = a.float() @ (b.float() if pv else b.float().T)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    # fp32 sums of 64-128 exact bf16 products: rounding only
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def _row_errors(out, ref):
    diff = (out.float() - ref.float()).abs()
    scale = ref.float().abs().amax(dim=-1).clamp_min(1e-30)
    return float(diff.max()), float((diff.amax(dim=-1) / scale).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 33), (False, 33)])
def test_sm90_training_forward_matches_plain_version(seed, d, causal,
                                                     window):
    """The uniform-offset forward through the sm90 variant: GQA 8/2, a
    ragged S = 333; output and log-sum-exp against the plain version
    (bf16: 2e-2 absolute, 1e-2 of each row's largest |output|, as
    chip_smoke.py holds it).  Several seeds: a stage released early
    would fail only sometimes."""
    _need_card()
    g = torch.Generator("cuda").manual_seed(seed)
    b, s, h, h_kv = 2, 333, 8, 2
    mk = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device="cuda").bfloat16()
    q, k, v = mk(b, s, h, d), mk(b, s, h_kv, d), mk(b, s, h_kv, d)
    before = tfa.flash_fwd_cuda.sm90_launches
    out, lse = tfa.flash_forward(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert tfa.flash_fwd_cuda.sm90_launches == before + 1
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, causal, window)
    err, row = _row_errors(out, ref)
    assert err <= 2e-2 and row <= 1e-2
    assert float((lse - ref_lse).abs().max()) <= 1e-3


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window", [None, 33])
def test_sm90_chunk_matches_plain_version_with_offsets_and_empty_rows(
        d, window):
    """Per-row offsets (nonzero kv_start) through the sm90 variant; rows
    placed before their sequence's first key see nothing and come back
    as exact zeros with the -1e30 log-sum-exp sentinel."""
    _need_card()
    g = torch.Generator("cuda").manual_seed(d)
    b, c, h, h_kv, s = 4, 40, 8, 2, 300
    q = torch.randn((b, c, h, d), generator=g, device="cuda").bfloat16()
    k = torch.randn((b, s, h_kv, d), generator=g, device="cuda").bfloat16()
    v = torch.randn((b, s, h_kv, d), generator=g, device="cuda").bfloat16()
    starts = torch.tensor([-40, 17, 100, 30], dtype=torch.int32,
                          device="cuda")
    kv_start = torch.tensor([0, 0, 16, 50], dtype=torch.int32, device="cuda")
    before = tfa.flash_fwd_cuda.sm90_launches
    out = tfa.flash_chunk_attention(q, k, v, starts, window=window,
                                    kv_start=kv_start)
    ref = tfa.flash_chunk_attention_reference(q, k, v, starts,
                                              window=window,
                                              kv_start=kv_start)
    offs = (kv_start - starts).contiguous()
    _, lse = tfa.flash_fwd_cuda(q, k, v, offs, window=window, with_lse=True)
    torch.cuda.synchronize()
    assert tfa.flash_fwd_cuda.sm90_launches == before + 2
    err, row = _row_errors(out, ref)
    assert err <= 2e-2 and row <= 1e-2
    # row 0 sits at -40..-1, row 3's first 20 queries before kv_start 50
    empty = torch.zeros((b, c), dtype=torch.bool, device="cuda")
    empty[0] = True
    empty[3, :20] = True
    sentinel = float(np.float32(-1e30))
    assert bool((out[empty] == 0).all())
    assert bool((lse.transpose(1, 2)[empty] == sentinel).all())
    assert bool((lse.transpose(1, 2)[~empty] > -1e29).all())


def test_sm90_refuses_a_misaligned_view():
    """A bf16 view off 16 bytes raises before any launch; nothing falls
    back to the CUDA-core kernel."""
    _need_card()
    buf = torch.zeros(2 * 16 * 4 * 64 + 8, dtype=torch.bfloat16,
                      device="cuda")
    q = buf[1:1 + 2 * 16 * 4 * 64].view(2, 16, 4, 64)
    k = torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16, device="cuda")
    before = tfa.flash_fwd_cuda.launches
    with pytest.raises(ValueError):
        tfa.flash_forward(q, k, k)
    assert tfa.flash_fwd_cuda.launches == before


def test_engine_on_card_matches_engine_on_cpu():
    """The same fp32 weights and requests through the engine on the card
    (the kernels) and on the CPU (the plain versions): identical greedy
    streams, one attention kernel launch per layer per step (the forward
    on mixed steps, the paged decode on decode steps)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(vocab_size=211, num_layers=2, num_heads=4,
                            num_kv_heads=2, head_dim=16, max_seq_len=96,
                            dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, 211, size=n).astype(np.int32)
               for n in (3, 17, 40, 9)]
    outs = []
    for device in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params, device=device, serve=ServeConfig(
            block_size=8, decode_tiers=(1, 2, 4), prefill_chunk=16))
        before = tfa.flash_fwd_cuda.launches
        paged = tfa.flash_decode_paged.launches
        ids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        res = eng.run()
        outs.append([res[i].tolist() for i in ids])
        if device == "cuda":
            paged = tfa.flash_decode_paged.launches - paged
            assert paged > 0
            assert tfa.flash_fwd_cuda.launches - before + paged == \
                cfg.num_layers * eng.steps
    assert outs[0] == outs[1]


def _paged_inputs(seed, h, h_kv, d, bs, kv_lens, dtype):
    """q, two layers of pools holding twice the live pages, and block
    tables whose page ids are a seeded shuffle (on the card)."""
    g = torch.Generator().manual_seed(seed)
    need = [-(-max(n, 0) // bs) for n in kv_lens]
    n_blocks = 1 + 2 * sum(need)
    kp, vp = (torch.randn((2, n_blocks, bs, h_kv, d), generator=g)
              for _ in range(2))
    ids = torch.randperm(n_blocks - 1, generator=g) + 1
    tables = torch.zeros((len(kv_lens), max(need) + 2), dtype=torch.long)
    used = 0
    for i, n in enumerate(need):
        tables[i, :n] = ids[used:used + n]
        used += n
    q = torch.randn((len(kv_lens), 1, h, d), generator=g)
    return (q.to("cuda", dtype), kp.to("cuda", dtype), vp.to("cuda", dtype),
            tables.cuda(), torch.tensor(kv_lens, dtype=torch.int32,
                                        device="cuda"))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,h_kv,d,bs,window", [
    (8, 2, 64, 16, None), (4, 4, 128, 8, None), (9, 3, 72, 5, None),
    (24, 2, 256, 16, None), (12, 2, 8, 1, None), (8, 2, 64, 16, 3),
    (8, 2, 64, 16, 40), (32, 8, 128, 16, 256)])
def test_paged_decode_matches_plain_version(dtype, tol, h, h_kv, d, bs,
                                            window):
    """The paged decode kernel against its plain version (the gather
    then the dense reference): GQA groups of 1 to 12 (rows per block 1,
    4 and 8, and two blocks for a group of 12), head widths 8 to 256,
    pages of 1 to 16 tokens, windows inside one page and over many; pad
    rows exactly zero; the same bits on a second call."""
    _need_card()
    kv_lens = [0, 1, 3 * bs, 37, 300, 1000]
    q, kp, vp, tables, kv = _paged_inputs(h + d + bs, h, h_kv, d, bs,
                                          kv_lens, dtype)
    kw = dict(layer=1, window=window, max_pages=tables.shape[1] - 1)
    before = tfa.flash_decode_paged.launches
    out = tfa.flash_decode_paged(q, kp, vp, tables, kv, **kw)
    again = tfa.flash_decode_paged(q, kp, vp, tables, kv, **kw)
    ref = tfa.flash_decode_paged_reference(q, kp, vp, tables, kv, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_decode_paged.launches == before + 2
    assert torch.equal(out, again)
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert bool((out[kv <= 0] == 0).all())


def test_paged_decode_refuses_what_the_kernel_does_not_take():
    """Misaligned pools, int32 tables or an fp16 query raise before any
    launch; nothing falls back to the gathered path."""
    _need_card()
    q, kp, vp, tables, kv = _paged_inputs(0, 8, 2, 64, 16, [5, 40],
                                          torch.bfloat16)
    flat = torch.zeros(kp.numel() + 8, dtype=kp.dtype, device="cuda")
    odd = flat[1:1 + kp.numel()].view(kp.shape)
    before = tfa.flash_decode_paged.launches
    for args in ((q, odd, odd, tables, kv), (q, kp, vp, tables.int(), kv),
                 (q.half(), kp.half(), vp.half(), tables, kv)):
        with pytest.raises((ValueError, TypeError)):
            tfa.flash_decode_paged(*args, layer=0)
    assert tfa.flash_decode_paged.launches == before


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 40), (False, 40)])
def test_flash_attention_backward_matches_plain_versions(dtype, tol, causal,
                                                         window):
    """flash_attention on the card (the forward, dq and dkv kernels, one
    launch each) against the plain versions on the same card: output
    and gradients; a ragged S and GQA 8/2."""
    _need_card()
    g = torch.Generator("cuda").manual_seed(7)
    b, s, h, h_kv, d = 2, 333, 8, 2, 64
    mk = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device="cuda").to(dtype)
    q, k, v, do = mk(b, s, h, d), mk(b, s, h_kv, d), mk(b, s, h_kv, d), \
        mk(b, s, h, d)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    before = (tfa.flash_fwd_cuda.launches, tfa.flash_bwd_dq_cuda.launches,
              tfa.flash_bwd_dkv_cuda.launches)
    out = tfa.flash_attention(qr, kr, vr, causal=causal, window=window)
    out.backward(do)
    torch.cuda.synchronize()
    after = (tfa.flash_fwd_cuda.launches, tfa.flash_bwd_dq_cuda.launches,
             tfa.flash_bwd_dkv_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    ref, lse = tfa.flash_attention_reference(q, k, v, causal, window)
    delta = (do.float() * out.detach().float()).sum(-1).transpose(
        1, 2).contiguous()
    dq = tfa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, window)
    dk, dv = tfa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                         window)
    for got, want in ((out, ref), (qr.grad, dq), (kr.grad, dk),
                      (vr.grad, dv)):
        assert got.shape == want.shape and got.dtype == want.dtype
        scale = max(1.0, float(want.float().abs().max()))
        assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rs", [False, True])
def test_sm90_bwd_wgmma_tile_product_matches_matmul(d, rs):
    """One 64-row tile product of the sm90 backward through its own TMA
    loads, swizzled descriptors and wgmma: a (64, D) · b (64, D)ᵀ (S, dP,
    Sᵀ, dPᵀ: both operands K-major) or a (64, 64) · b (64, D) (dS·K,
    Pᵀ·dO, dSᵀ·Q: a from registers, b MN-major), against torch.matmul in
    fp32 on the same bf16 inputs."""
    _need_card()
    g = torch.Generator("cuda").manual_seed(10 * d + rs)
    a = torch.randn((64, 64 if rs else d), generator=g,
                    device="cuda").bfloat16()
    b = torch.randn((64, d), generator=g, device="cuda").bfloat16()
    got = tfa.wgmma_bwd_tile_cuda(a, b, rs)
    want = a.float() @ (b.float() if rs else b.float().T)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def _train_errors(out, ref):
    """chip_smoke.py's training-kernel measures (``_errors``): the
    largest absolute error over max(1, largest |ref|), and the largest
    per-row error relative to the row's largest |ref|, floored at 1e-2
    of the tensor's."""
    diff = (out.float() - ref.float()).abs()
    refa = ref.float().abs()
    top = float(refa.max())
    rows = refa.amax(dim=-1).clamp_min(max(1e-2 * top, 1e-30))
    return (float(diff.max()) / max(1.0, top),
            float((diff.amax(dim=-1) / rows).max()))


def _bwd_inputs(seed, b, s, h, h_kv, d, causal, window):
    g = torch.Generator("cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device="cuda").bfloat16()
    q, k, v, do = mk(b, s, h, d), mk(b, s, h_kv, d), mk(b, s, h_kv, d), \
        mk(b, s, h, d)
    out, lse = tfa.flash_forward(q, k, v, causal, window)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,window,h_kv", [
    (True, None, 8), (False, None, 2), (True, 100, 2), (False, 100, 8)])
def test_sm90_bwd_matches_plain_versions(seed, d, causal, window, h_kv):
    """dq and dkv through the sm90 variant on a ragged S = 333 (the
    tiles past S masked, lse/δ reads bounded), GQA 8/8 and 8/2, causal,
    bidirectional and windows, against the plain versions (bf16: 2e-2 of
    max(1, largest |output|), 1e-2 per row, as chip_smoke.py holds
    them).  Several seeds: a stage released early would fail only
    sometimes."""
    _need_card()
    q, k, v, do, lse, delta = _bwd_inputs(seed, 2, 333, 8, h_kv, d, causal,
                                          window)
    before = (tfa.flash_bwd_dq_cuda.sm90_launches,
              tfa.flash_bwd_dkv_cuda.sm90_launches)
    kw = dict(causal=causal, window=window)
    dq = tfa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_dq_cuda.sm90_launches,
            tfa.flash_bwd_dkv_cuda.sm90_launches) == (before[0] + 1,
                                                      before[1] + 1)
    ref_dq = tfa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                        window)
    ref_dk, ref_dv = tfa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, window)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.shape == want.shape and got.dtype == want.dtype
        err, row = _train_errors(got, want)
        assert err <= 2e-2 and row <= 1e-2, (err, row)


@pytest.mark.parametrize("d", [64, 128])
def test_sm90_bwd_is_bitwise_deterministic(d):
    """One writer per output, no atomics: two calls give the same bits."""
    _need_card()
    q, k, v, do, lse, delta = _bwd_inputs(3, 2, 700, 8, 2, d, True, None)
    first = (tfa.flash_bwd_dq_cuda(q, k, v, do, lse, delta),
             *tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta))
    second = (tfa.flash_bwd_dq_cuda(q, k, v, do, lse, delta),
              *tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_sm90_bwd_refuses_a_misaligned_dout():
    _need_card()
    q, k, v, do, lse, delta = _bwd_inputs(4, 1, 128, 4, 4, 64, True, None)
    buf = torch.empty(do.numel() + 8, dtype=do.dtype, device="cuda")
    bad = buf[1:1 + do.numel()].view(do.shape)
    bad.copy_(do)
    with pytest.raises(ValueError, match="dO needs a 16-byte aligned"):
        tfa.flash_bwd_dq_cuda(q, k, v, bad, lse, delta)


def test_transformer_grads_on_card_match_cpu():
    """The same fp32 weights and batch through the flash transformer on
    the card (the kernels) and on the CPU (the plain versions): every
    parameter's gradient agrees."""
    _need_card()
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import Transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(vocab_size=211, num_layers=2, num_heads=4,
                            num_kv_heads=2, head_dim=16, max_seq_len=96,
                            dtype=torch.float32, attention_impl="flash")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(
        np.random.RandomState(0).randint(0, 211, (3, 65))).long()
    grads = []
    for device in ("cpu", "cuda"):
        model = Transformer(cfg, params={k: v.to(device)
                                         for k, v in params.items()})
        t = toks.to(device)
        training.softmax_cross_entropy(model(t[:, :-1]), t[:, 1:]).backward()
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    for name, want in grads[0].items():
        err = float((grads[1][name] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,c,relu,res", [(4096, 64, True, False),
                                          (1000, 96, True, True),
                                          (777, 30, False, True),
                                          (3000, 2048, False, False),
                                          (16, 2048, True, True),
                                          (64, 512, True, False),
                                          (3, 8, True, True)])
def test_fused_norm_matches_plain_version(dtype, tol, m, c, relu, res):
    """fused_batch_norm_act on the card (the four kernels, one launch
    each) against the plain versions on the same card: y, the batch
    statistics and the gradients of x, γ, β and the residual (C = 30
    takes the scalar path; M = 16 and 64 are the small ResNet-50 oracle's
    last-stage sites)."""
    _need_card()
    from horovod_tpu_torch.ops import fused_norm as fn

    g = torch.Generator("cuda").manual_seed(m + c)
    mk = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device="cuda")
    x = (2 * mk(m, c) + mk(c)).to(dtype)
    gamma, beta = mk(c).abs() + 0.5, mk(c)
    r = mk(m, c).to(dtype) if res else None
    dy = mk(m, c).to(dtype)
    wrappers = (fn.bn_stats_cuda, fn.bn_apply_cuda, fn.bn_bwd_reduce_cuda,
                fn.bn_dx_cuda)
    outs = []
    for impl in (None, "reference"):
        leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)
                  + ((r,) if res else ())]
        before = [w.launches for w in wrappers]
        y, mean, var = fn.fused_batch_norm_act(
            *leaves[:3], leaves[3] if res else None, relu=relu, impl=impl)
        y.backward(dy)
        torch.cuda.synchronize()
        launched = [w.launches - b for w, b in zip(wrappers, before)]
        assert launched == ([1, 1, 1, 1] if impl is None else [0] * 4)
        outs.append([y, mean, var] + [t.grad for t in leaves])
    for got, want in zip(*outs):
        assert got.shape == want.shape and got.dtype == want.dtype
        scale = max(1.0, float(want.float().abs().max()))
        assert float((got.float() - want.float()).abs().max()) <= tol * scale


def _bn_stats_inputs(m, c, dtype, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    x = (2 * torch.randn((m, c), generator=g, device="cuda")
         + torch.randn((c,), generator=g, device="cuda")).to(dtype)
    return (x, torch.rand((c,), generator=g, device="cuda") + 0.5,
            torch.randn((c,), generator=g, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,c", [(1, 1), (1, 64), (7, 3), (777, 30),
                                 (4096, 64), (3000, 2048), (20_000, 256)])
def test_bn_stats_is_one_launch_and_deterministic(dtype, m, c):
    """The stats kernel (one launch, its last blocks finish) against the
    plain version, with the same bits on a second call; mean and var
    within chip_smoke's BN_STAT_TOL of their terms' scale."""
    _need_card()
    from horovod_tpu_torch.ops import fused_norm as fn

    x, gamma, beta = _bn_stats_inputs(m, c, dtype, m + c)
    before = fn.bn_stats_cuda.launches
    stats = fn.bn_stats_cuda(x, gamma, beta, 1e-5)
    again = fn.bn_stats_cuda(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    assert fn.bn_stats_cuda.launches - before == 2
    assert torch.equal(stats, again)
    mean, var, _ = fn.bn_stats_reference(x, 1e-5)
    ex2 = (x.float() ** 2).mean(0)
    assert bool(((stats[0] - mean).abs() <= 1e-4 * ex2.sqrt() + 1e-30).all())
    assert bool(((stats[1] - var).abs() <= 2e-4 * ex2 + 1e-30).all())


def test_bn_stats_counters_reset_between_launches():
    """Launches back to back over shapes of 1 to 32 column tiles, each
    bit-equal to its shape's first call: the last block of every launch
    leaves its tiles' counters at 0 for the next one."""
    _need_card()
    from horovod_tpu_torch.ops import fused_norm as fn

    cases = [_bn_stats_inputs(m, c, dtype, i) for i, (m, c, dtype) in
             enumerate([(4096, 64, torch.bfloat16),
                        (3000, 2048, torch.bfloat16),
                        (999, 100, torch.float32), (5, 1, torch.float32)])]
    first = [fn.bn_stats_cuda(*a, 1e-5) for a in cases]
    outs = [fn.bn_stats_cuda(*cases[i % 4], 1e-5) for i in range(24)]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        assert torch.equal(out, first[i % 4]), i


def test_fused_norm_raises_on_what_the_kernels_do_not_take():
    """A CUDA tensor the kernels cannot take raises; nothing falls back."""
    _need_card()
    from horovod_tpu_torch.ops import fused_norm as fn

    g, b = torch.ones(8, device="cuda"), torch.zeros(8, device="cuda")
    x = torch.randn(4, 8, 3, 3, device="cuda").permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fn.fused_batch_norm_act(x, g, b)
    with pytest.raises(TypeError, match="not supported"):
        fn.fused_batch_norm_act(torch.randn(4, 8, device="cuda").half(), g, b)
    with pytest.raises(ValueError, match="CUDA"):
        fn.bn_apply_cuda(torch.randn(4, 8), torch.zeros(5, 8))


def test_resnet_grads_and_running_stats_on_card_match_cpu():
    """ResNetTiny in fp32 (TF32 off) on the card (the fused kernels) and
    on the CPU (the plain versions): logits and the updated running
    statistics agree closely, every parameter gradient within 1e-1 in
    relative L2 (a ReLU or max-pool decision on a value within rounding
    of its threshold flips between the two sides and moves one entry of
    a gradient by O(1); a wrong kernel moves all of them)."""
    _need_card()
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import ResNetTiny

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = ResNetTiny(dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    card = ResNetTiny(dtype=torch.float32, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(4, 32, 32, 3).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, 10, (4,))).long()
    logits = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        out = model(x.to(dev))
        training.softmax_cross_entropy(out, labels.to(dev)).backward()
        logits.append(out.detach().cpu())
    assert float((logits[0] - logits[1]).abs().max()) <= 1e-4
    grads = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        want = grads[name].grad
        err = float((p.grad.cpu() - want).norm())
        assert err <= 1e-1 * float(want.norm()), name
    bufs = dict(cpu.named_buffers())
    for name, t in card.named_buffers():
        assert float((t.cpu() - bufs[name]).abs().max()) <= 1e-4, name


def _train_on_card(make_opt, *, zero=False, steps=3, **kw):
    """A small bf16 flash transformer over fp32 masters trained at world
    1 over NCCL on the card: (losses, parameters, step)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import Transformer

    cfg = TransformerConfig(vocab_size=211, num_layers=2, num_heads=4,
                            num_kv_heads=2, head_dim=64, max_seq_len=128,
                            dtype=torch.bfloat16, attention_impl="flash")
    hvd.init()
    try:
        model = Transformer(cfg, params=init_params(
            cfg, torch.Generator("cuda").manual_seed(0), "cuda",
            param_dtype=torch.float32))
        if zero:
            state, step = training.zero_train_setup(
                model, make_opt(model.parameters()), **kw)
        else:
            opt = make_opt(model.parameters())
            state = training.create_train_state(model, opt)
            step = training.data_parallel_train_step(model, opt, **kw)
        toks = torch.from_numpy(np.random.RandomState(0).randint(
            0, 211, (4, 129))).long().cuda()
        losses = []
        for _ in range(steps):
            state, loss = step(state, toks[:, :-1], toks[:, 1:])
            losses.append(float(loss))
        return losses, [p.detach().clone() for p in model.parameters()], step
    finally:
        hvd.shutdown()


def _sgd(ps):
    return torch.optim.SGD(ps, lr=0.1, momentum=0.9)


def test_overlapped_step_on_card_is_bit_equal_and_hooked():
    """The hooked step (each bucket's NCCL allreduce launched from the
    backward's hooks) gives the same bits as the step without overlap,
    with every bucket launched from a hook, in order."""
    _need_card()
    base, base_params, _ = _train_on_card(_sgd, bucket_bytes=256 * 1024)
    fwd = tfa.flash_fwd_cuda.sm90_launches
    got, params, step = _train_on_card(_sgd, overlap=True,
                                       bucket_bytes=256 * 1024)
    assert tfa.flash_fwd_cuda.sm90_launches == fwd + 2 * 3
    assert got == base
    assert all(torch.equal(a, b) for a, b in zip(params, base_params))
    launches = step.reducer.last_launches
    assert [b for b, _, _ in launches] == list(
        range(step.reducer.schedule.num_buckets))
    assert step.reducer.schedule.num_buckets > 2
    assert all(h for _, _, h in launches)
    assert launches[0][1] < len(step.reducer.params)


def test_zero_step_on_card_matches_replicated():
    """ZeRO at world 1 on the card: SGD bit-equal to the replicated
    step, AdamW losses within 1e-5 relative (chip_smoke's bound)."""
    _need_card()
    base, base_params, _ = _train_on_card(_sgd)
    got, params, _ = _train_on_card(_sgd, zero=True)
    assert got == base
    assert all(torch.equal(a, b) for a, b in zip(params, base_params))

    def adamw(ps):
        return torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4)

    base, _, _ = _train_on_card(adamw)
    for kw in ({}, dict(overlap=True, bucket_bytes=256 * 1024)):
        got, _, _ = _train_on_card(adamw, zero=True, **kw)
        assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got, base))


WORLD4 = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.ops.adasum import adasum_allreduce

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
hvd.init(rank=rank, size=world, init_method="file://" + store)  # NCCL
dev = hvd.device()
res = {}
rs = np.random.RandomState(50 + rank)
v = torch.from_numpy(rs.randn(100003).astype(np.float32)).to(dev)
whole = hvd.allreduce_gradients(v, op=hvd.Sum)
for cut in (3, 1000, 50001):
    parts = hvd.allreduce_gradients([v[:cut], v[cut:]], op=hvd.Sum)
    res[f"layout{cut}"] = np.array(torch.equal(torch.cat(parts), whole))
res["sum"] = whole.cpu().numpy()
sp = [(rank + j) % 3 for j in range(world)]
rows = torch.arange(sum(sp) * 2, dtype=torch.float32, device=dev).view(
    -1, 2) + 1000 * rank
recv, splits = hvd.alltoall(rows, splits=sp)
res["a2a"], res["a2a_splits"] = recv.cpu().numpy(), splits.numpy()
pm = torch.from_numpy((rs.choice([-1.0, 1.0], 16) * 2.0 ** -(rank % 3))
                      .astype(np.float32)).to(dev)
res["adasum_in"] = pm.cpu().numpy()
res["adasum"] = adasum_allreduce(pm).cpu().numpy()

g = np.random.RandomState(7)
x = torch.from_numpy(g.randn(16, 32).astype(np.float32))[rank * 4:][:4].to(dev)
y = torch.from_numpy(g.randn(16, 8).astype(np.float32))[rank * 4:][:4].to(dev)


def mlp():
    w = np.random.RandomState(8)
    m = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.Tanh(),
                            torch.nn.Linear(64, 64), torch.nn.Tanh(),
                            torch.nn.Linear(64, 8)).to(dev)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(w.randn(*p.shape).astype(np.float32)
                                     * 0.3))
    return m


def loss_fn(o, t):
    return (o - t).pow(2).mean()


m = mlp()
loss_fn(m(x), y).backward()
for j, p in enumerate(m.parameters()):
    res[f"local/g{j}"] = p.grad.cpu().numpy()
for tag in ("plain", "overlap", "zero", "zero_overlap"):
    m = mlp()
    opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
    if tag.startswith("zero"):
        state, step = training.zero_train_setup(
            m, opt, loss_fn=loss_fn, overlap=tag == "zero_overlap",
            bucket_bytes=4096)
    else:
        state = training.create_train_state(m, opt)
        step = training.data_parallel_train_step(
            m, opt, loss_fn=loss_fn, overlap=tag == "overlap",
            bucket_bytes=4096 if tag == "overlap" else None)
    for i in range(3):
        state, loss = step(state, x, y)
        if i == 0 and not tag.startswith("zero"):
            for j, p in enumerate(m.parameters()):
                res[f"{tag}/g{j}"] = p.grad.cpu().numpy()
    for j, p in enumerate(m.parameters()):
        res[f"{tag}/p{j}"] = p.detach().cpu().numpy()
np.savez(out, **res)
hvd.shutdown()
"""


def test_world4_nccl_rank_ordered_sums_and_training():
    """Four cards over NCCL: the gradient reductions' floating sums give
    the same bits however the buffer is cut; the overlapped, plain and ZeRO steps give the
    same bits, and the reduced gradients equal the ranks' own gradients
    added in rank order; uneven alltoall and Adasum."""
    import os
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    _need_card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from horovod_tpu_torch.ops.adasum import adasum_combine_rows

    world, root = 4, Path(__file__).resolve().parents[1]
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"rank{r}.npz" for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORLD4, str(r), str(world),
             str(Path(tmp) / "store"), str(outs[r])], cwd=str(root),
            env=dict(os.environ, PYTHONPATH=str(root)))
            for r in range(world)]
        try:
            rcs = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        assert rcs == [0] * world
        got = [dict(np.load(o)) for o in outs]
    n = 6
    for r in range(world):
        res = got[r]
        assert all(bool(res[f"layout{c}"]) for c in (3, 1000, 50001))
        np.testing.assert_array_equal(res["sum"], got[0]["sum"])
        for j in range(n):
            want = got[0][f"local/g{j}"].copy()
            for s in range(1, world):
                want += got[s][f"local/g{j}"]
            want = want / np.float32(world)
            for tag in ("plain", "overlap"):
                np.testing.assert_array_equal(res[f"{tag}/g{j}"], want)
            for tag in ("overlap", "zero", "zero_overlap"):
                np.testing.assert_array_equal(res[f"{tag}/p{j}"],
                                              res[f"plain/p{j}"])
        sends = {s: np.split(np.arange(sum((s + k) % 3 for k in range(
            world)) * 2, dtype=np.float32).reshape(-1, 2) + 1000 * s,
            np.cumsum([(s + k) % 3 for k in range(world)])[:-1])
            for s in range(world)}
        np.testing.assert_array_equal(res["a2a"], np.concatenate(
            [sends[s][r] for s in range(world)]))
        rows = torch.from_numpy(np.stack([got[s]["adasum_in"]
                                          for s in range(world)]))
        np.testing.assert_array_equal(res["adasum"],
                                      adasum_combine_rows(rows).numpy())


# -- the training loop (remat, the prefetcher) on the card ---------------------


def _remat_loss_grads(policy):
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import Transformer

    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=4,
                            num_kv_heads=2, head_dim=64, max_seq_len=256,
                            dtype=torch.bfloat16, attention_impl="flash",
                            remat_policy=policy)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda", param_dtype=torch.float32)
    model = Transformer(cfg, params=params)
    toks = torch.randint(0, 128, (2, 129), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    before = tfa.flash_fwd_cuda.sm90_launches
    loss = training.softmax_cross_entropy(model(toks[:, :-1]), toks[:, 1:])
    loss.backward()
    torch.cuda.synchronize()
    return (loss.detach(), [p.grad for p in model.parameters()],
            tfa.flash_fwd_cuda.sm90_launches - before)


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch", "full"])
def test_transformer_remat_on_card_recomputes_the_kernel(policy):
    """bf16 through the sm90 kernels: the remat backward runs the flash
    forward again (two launches a layer) and gives the loss and every
    gradient of the plain run bit for bit."""
    _need_card()
    loss0, grads0, fwd0 = _remat_loss_grads("none")
    loss, grads, fwd = _remat_loss_grads(policy)
    assert (fwd0, fwd) == (2, 4)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


def test_resnet_remat_on_card_is_bit_equal_and_moves_stats_once():
    """ResNet depths [1, 1, 1, 1] in bf16 on the card: remat gives the
    plain run's loss, gradients and running statistics bit for bit; the
    stats and apply kernels run once more for each norm of a block."""
    _need_card()
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.models import resnet as tr
    from horovod_tpu_torch.ops import fused_norm as fn

    g = torch.Generator("cuda").manual_seed(2)
    x = torch.randn((4, 64, 64, 3), generator=g, device="cuda")
    y = torch.randint(0, 10, (4,), generator=g, device="cuda")
    out = []
    for remat in (False, True):
        model = ResNet(stage_sizes=[1, 1, 1, 1], block_cls=tr.BottleneckBlock,
                       num_filters=16, num_classes=10, dtype=torch.bfloat16,
                       stem="space_to_depth", remat=remat, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(0))
        before = (fn.bn_stats_cuda.launches, fn.bn_dx_cuda.launches)
        loss = training.softmax_cross_entropy(model(x), y)
        loss.backward()
        torch.cuda.synchronize()
        out.append((loss.detach(), [p.grad for p in model.parameters()],
                    tr.running_stats(model),
                    (fn.bn_stats_cuda.launches - before[0],
                     fn.bn_dx_cuda.launches - before[1])))
    (l0, g0, s0, n0), (l1, g1, s1, n1) = out
    sites = 1 + 4 * 4  # the stem, and four norms in each block
    assert n0 == (sites, sites) and n1 == (2 * sites - 1, sites)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


def test_prefetcher_on_card_orders_copies_before_the_step():
    """Batches staged on the side stream arrive on the card intact while
    the consumer's stream is kept busy (a spin before each read), over
    more batches than the queue holds, so the allocator reuses staged
    memory: every batch equals its host batch, read on the consumer's
    stream."""
    _need_card()
    from horovod_tpu_torch import data

    rs = np.random.RandomState(0)
    host = [(rs.randint(0, 255, (64, 56, 56, 3)).astype(np.float32),
             np.arange(64, dtype=np.int32) + i) for i in range(12)]
    pf = data.DevicePrefetcher(iter(host), depth=2, device="cuda",
                               cast="bfloat16")
    n = 0
    for (x, y), (a, b) in zip(pf, host, strict=True):
        assert x.device.type == "cuda" and x.dtype == torch.bfloat16
        assert y.dtype == torch.int32
        torch.cuda._sleep(2_000_000)  # the step's stream lags the copies
        want = torch.from_numpy(a).to(torch.bfloat16).cuda()
        assert torch.equal(x, want) and torch.equal(y.cpu(),
                                                    torch.from_numpy(b))
        n += 1
    assert n == pf.stats()["batches"] == 12
