#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``horovod_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``horovod_tpu_torch/csrc`` (into
``build/horovod_tpu_torch/``), then runs these phases and exits non-zero
if any fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the kernel build time and the compiler's register/shared
   memory report;
3. kernels (kernel vs plain): every kernel against its plain PyTorch
   version on the card, each case with its absolute and per-row relative
   error against their tolerances, its time, the plain version's, SDPA's
   (timed only, never called by the port) and the card's bound:
   - the paged forward (serving): decode and chunk cases (llama3_8b
     heads 32/8 at D=128, an MHA case at D=64, a windowed case with
     nonzero ``kv_start``, pad rows that must come back exactly zero;
     bf16 and fp32);
   - the training kernels — the uniform-offset forward (out and lse),
     dQ, and dK/dV: gpt_small's shape (B=8, S=2048, 12 heads of 64; the
     main path's), llama3_8b's attention (32/8 heads, D=128, S=4096,
     the GQA group sum), bidirectional, a causal and a bidirectional
     window of 256, a ragged S=1000; bf16 and fp32;
4. serving: ``ServingEngine`` over llama3_8b at full width (32 layers,
   bf16, random weights from a seeded generator on the card) serves two
   waves of requests; every request must complete, the kernel must have
   launched exactly 32 times per engine step, the second wave must hit
   the prefix cache, and each first token's logits must match a dense
   cache-free forward;
5. oracle: llama3_8b width, 2 layers, fp32 — greedy streams through the
   engine must equal one-at-a-time plain decode (tie-aware);
6. training: gpt_small at full width and depth (B=8, S=2048, bf16
   compute over fp32 masters, AdamW 1e-3 at optax's defaults) through
   ``init()`` (world 1 over NCCL), ``replicate_state`` and
   ``data_parallel_train_step``, 10 steps on one fixed batch: every loss
   finite and the last below the first, exactly 12 launches of each
   training kernel per step; tokens/s, MFU, peak memory, then the
   device busy share and time by kernel class over 2 profiled steps;
7. training_oracle: gpt_small width, 2 layers, fp32 — the gradient of
   every parameter through the kernels ("flash") against the plain dense
   path ("dot") on the same weights and batch.

Each main path (serving, training) is driven with the kernels' launch
counts set to 0 just before it and read just after.  The card's
``nvidia-smi`` line comes next, then the ``kernels`` JSON on the line
before the last (one entry per kernel source and C entry: ``launches``
from the main paths' runs, the other numbers from the kernel phase at
the main path's shape; null where ``--phases`` left that phase out);
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout, it exits 1 and prints no result.
``--phases`` runs a subset (e.g. ``--phases kernels,training``); the
default runs all.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # fp32 outside the tensor cores
# kernel vs plain version, on the outputs: the largest absolute error,
# and the largest per-row error relative to that row's largest |output|
# (a row = one (batch, query, head); rows that must be zero are checked
# for exact zeros).  bf16 outputs round to 8 significant bits, so an
# element may differ by one rounding step (<= 2**-7 of its magnitude,
# hence of its row's largest value) where the two fp32 accumulations
# straddle a rounding boundary; they agree far closer than one step.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
ROW_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
SEED = 1234


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 3: the kernel against its plain version ---------------------------


def make_case(name, *, b, c, h, h_kv, d, s, dtype, q_starts, kv_start=None,
              window=None, decode=False, kv_lens=None):
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((b, c, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, s, h_kv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, s, h_kv, d), generator=g, device="cuda").to(dtype)
    as_i32 = lambda x: None if x is None else torch.tensor(  # noqa: E731
        x, dtype=torch.int32, device="cuda")
    return dict(name=name, q=q, k=k, v=v, q_starts=as_i32(q_starts),
                kv_start=as_i32(kv_start), window=window, decode=decode,
                kv_lens=as_i32(kv_lens))


def visible_mask(case):
    """(B, C, S) bool: the keys each query may attend (the kernel's own
    mask, on global positions)."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    q, k = case["q"], case["k"]
    b, c, s = q.shape[0], q.shape[1], k.shape[1]
    offs = fa._row_offsets(case["q_starts"], case["kv_start"], b, q.device)
    return fa._tile_mask(
        torch.arange(c, device=q.device)[None, :, None],
        torch.arange(s, device=q.device)[None, None, :], True,
        case["window"], s, offs.long()[:, None, None])


def bound_ms(case, mask):
    """Least time on the card: max(bytes / HBM rate, FLOPs / peak).
    Bytes: Q and O once, and each K/V row some query of its batch row
    can see once (per kv head).  FLOPs: 4*D per visible (query head,
    query, key) pair (QK^T and PV)."""
    q, k = case["q"], case["k"]
    b, c, h, d = q.shape
    h_kv, el = k.shape[2], q.element_size()
    keys = int(mask.any(dim=1).sum())             # visible K/V rows
    pairs = int(mask.sum())                       # visible (q, k) pairs
    nbytes = 2 * b * c * h * d * el + 2 * keys * h_kv * d * el
    flops = 4 * d * h * pairs
    peak = PEAK_FLOPS[str(q.dtype).split(".")[-1]]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def run_case(case):
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa

    q, k, v = case["q"], case["k"], case["v"]
    b, c, h, d = q.shape
    kw = dict(window=case["window"], kv_start=case["kv_start"])
    if case["decode"]:
        call = lambda: fa.flash_decode_attention(  # noqa: E731
            q, k, v, case["kv_lens"], **kw)
    else:
        call = lambda: fa.flash_chunk_attention(  # noqa: E731
            q, k, v, case["q_starts"], **kw)
    plain = lambda: fa.flash_chunk_attention_reference(  # noqa: E731
        q, k, v, case["q_starts"], **kw)
    out = call()
    torch.cuda.synchronize()
    ref = plain()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    scale = ref.float().abs().amax(dim=-1).clamp_min(1e-30)
    row_err = float((diff.amax(dim=-1) / scale).max())
    dtype = str(q.dtype).split(".")[-1]
    ok = (math.isfinite(err) and err <= TOL[dtype]
          and math.isfinite(row_err) and row_err <= ROW_TOL[dtype])
    if case["decode"] and case["kv_lens"] is not None:
        pad = case["kv_lens"] <= 0
        if bool(pad.any()):
            zero = bool((out[pad] == 0).all())
            ok = ok and zero
            log(f"  {case['name']}: pad rows exactly zero: {zero}")
    mask = visible_mask(case)
    bnd, by = bound_ms(case, mask)
    # SDPA on the same function, timed only (never used by the port)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    am = mask[:, None]
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=am, enable_gqa=True)
    try:
        lib_ms = cuda_ms(library)
    except Exception as e:  # an SDPA without enable_gqa: no yardstick
        log(f"  {case['name']}: library call unavailable ({e!r})")
        lib_ms = None
    rec = dict(case=case["name"], shape=[b, c, h, k.shape[2], d, k.shape[1]],
               dtype=dtype, max_abs_err=err, tol=TOL[dtype],
               max_row_rel_err=row_err, row_tol=ROW_TOL[dtype], ok=ok,
               kernel_ms=cuda_ms(call), plain_ms=cuda_ms(plain, reps=3),
               library_ms=lib_ms, bound_ms=bnd, bound_by=by)
    log("  " + json.dumps(rec))
    return rec


def phase_kernels():
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    ctx = [1, 9, 100, 700, 1500, 2500, 3333, 4096]
    starts = [0, 256, 512, 1000, 1792, 2500, 3000, 3840]
    cases = []
    for dt in (bf, f32):
        tag = "bf16" if dt is bf else "fp32"
        cases.append(make_case(
            f"decode_gqa_{tag}", b=8, c=1, h=32, h_kv=8, d=128, s=4096,
            dtype=dt, q_starts=[x - 1 for x in ctx], decode=True,
            kv_lens=ctx))
        cases.append(make_case(
            f"chunk_gqa_{tag}", b=8, c=256, h=32, h_kv=8, d=128, s=4096,
            dtype=dt, q_starts=starts))
    for dt in (bf, f32):
        tag = "bf16" if dt is bf else "fp32"
        cases.append(make_case(
            f"decode_mha_d64_{tag}", b=8, c=1, h=32, h_kv=32, d=64, s=2048,
            dtype=dt, q_starts=[min(x, 2048) - 1 for x in ctx], decode=True,
            kv_lens=[min(x, 2048) for x in ctx]))
        cases.append(make_case(
            f"chunk_mha_d64_{tag}", b=8, c=128, h=32, h_kv=32, d=64, s=2048,
            dtype=dt, q_starts=[0, 100, 300, 640, 1000, 1500, 1800, 1920]))
    # windowed: the gather starts at page `first` (kv_start = first*16)
    # and spans window + C - 1 positions plus slack (as PagedKVState does)
    win, cw = 256, 64
    lens = [0, 10, 300, 900, 1200, 2000, 3000, 4000]
    first = [max(0, (n + 1 - win) // 16) for n in lens]
    for dt in (bf, f32):
        tag = "bf16" if dt is bf else "fp32"
        cases.append(make_case(
            f"chunk_window_{tag}", b=8, c=cw, h=32, h_kv=8, d=128,
            s=((win + cw - 1) // 16 + 2) * 16, dtype=dt, q_starts=lens,
            kv_start=[f * 16 for f in first], window=win))
    pad_lens = [0, 5, 0, 300, 0, 1, 0, 4096]
    cases.append(make_case(
        "decode_pad_rows_bf16", b=8, c=1, h=32, h_kv=8, d=128, s=4096,
        dtype=bf, q_starts=[x - 1 for x in pad_lens], decode=True,
        kv_lens=pad_lens))
    recs = []
    for case in cases:
        recs.append(run_case(case))
        del case
        torch.cuda.empty_cache()
    bad = [r["case"] for r in recs if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return recs


# -- phase 3b: the training kernels (B1 uniform offset, B2, B3) --------------

# (name, B, S, H, H_kv, D, causal, window, dtype); the first is the main
# path's shape (gpt_small at B=8, S=2048)
TRAIN_CASES = [
    ("gpt_small_causal", 8, 2048, 12, 12, 64, True, None, "bfloat16"),
    ("gpt_small_causal", 8, 2048, 12, 12, 64, True, None, "float32"),
    ("llama3_8b_gqa_causal", 1, 4096, 32, 8, 128, True, None, "bfloat16"),
    ("llama3_8b_gqa_causal", 1, 4096, 32, 8, 128, True, None, "float32"),
    ("bidirectional", 4, 2048, 12, 12, 64, False, None, "bfloat16"),
    ("causal_window256", 4, 2048, 12, 12, 64, True, 256, "bfloat16"),
    ("bidirectional_window256", 4, 2048, 12, 12, 64, False, 256,
     "bfloat16"),
    ("ragged_s1000_gqa", 2, 1000, 12, 4, 64, True, None, "bfloat16"),
    ("ragged_s1000_gqa", 2, 1000, 12, 4, 64, True, None, "float32"),
    ("ragged_s1000_bidirectional_window", 2, 1000, 12, 4, 64, False, 100,
     "float32"),
]
# kernel vs plain on the training kernels' outputs (O, lse, dQ, dK, dV):
# absolute error within TOL x max(1, largest |plain output|) (gradients
# are not bounded by 1 as attention outputs are), and per-row error
# relative to the row's largest |output|, where rows whose largest value
# is below 1e-2 of the tensor's are held against 1e-2 of the tensor's
# largest instead (a causal dQ's first row is 0 up to rounding).  The
# fp32 row tolerance is 3e-4: the first rows of a causal dQ sum few
# terms of dS = P∘(dO·Vᵀ − δ), whose difference cancels, so fp32
# rounding that is 1e-6 of the tensor shows as up to ~1e-4 of such a
# row (7.4e-5 observed, llama3_8b GQA dQ on an H100); a dropped or
# misplaced tile is off by O(1).
TRAIN_ROW_TOL = {"bfloat16": 1e-2, "float32": 3e-4}


def _errors(out, ref):
    diff = (out.float() - ref.float()).abs()
    refa = ref.float().abs()
    top = float(refa.max())
    rows = refa.amax(dim=-1).clamp_min(max(1e-2 * top, 1e-30))
    return (float(diff.max()), float((diff.amax(dim=-1) / rows).max()),
            max(1.0, top))


def _train_bounds(b, s, h, h_kv, d, causal, window, el, dtype):
    """Least time on the card for each kernel: max(bytes / HBM rate,
    FLOPs / peak).  Triples = visible (head, query, key) entries of this
    run's mask.  FLOPs per triple: 4·D forward (QKᵀ, PV), 6·D dq (QKᵀ,
    dO·Vᵀ, dS·K), 8·D dkv (QKᵀ, Pᵀ·dO, dO·Vᵀ, dSᵀ·Q).  Bytes: each input
    read once and each output written once (q-side (B,S,H,D) tensors,
    kv-side (B,S,H_kv,D) ones, fp32 (B,H,S) statistics)."""
    from horovod_tpu_torch.ops import flash_attention as fa

    mask = fa._self_mask(s, causal, window, "cuda")
    triples = int(mask.sum()) * b * h
    qs, kvs, st = b * s * h * d * el, b * s * h_kv * d * el, b * h * s * 4
    peak = PEAK_FLOPS[dtype]
    out = {}
    for name, nbytes, flops in (
            ("fwd", 2 * qs + 2 * kvs + st, 4 * d * triples),
            ("dq", 3 * qs + 2 * kvs + 2 * st, 6 * d * triples),
            ("dkv", 2 * qs + 4 * kvs + 2 * st, 8 * d * triples)):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
        out[name] = (max(t_b, t_o) * 1e3,
                     "bytes" if t_b >= t_o else "operations")
    del mask
    return out, triples


def run_train_case(name, b, s, h, h_kv, d, causal, window, dtype_name):
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    mk = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device="cuda").to(dtype)
    q, k, v, do = mk(b, s, h, d), mk(b, s, h_kv, d), mk(b, s, h_kv, d), \
        mk(b, s, h, d)
    kw = dict(causal=causal, window=window)
    fwd = lambda: fa.flash_forward(q, k, v, causal, window)  # noqa: E731
    out, lse = fwd()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq_k = lambda: fa.flash_bwd_dq_cuda(  # noqa: E731
        q, k, v, do, lse, delta, **kw)
    dkv_k = lambda: fa.flash_bwd_dkv_cuda(  # noqa: E731
        q, k, v, do, lse, delta, **kw)
    dq = dq_k()
    dk, dv = dkv_k()
    torch.cuda.synchronize()
    plain_f = lambda: fa.flash_attention_reference(  # noqa: E731
        q, k, v, causal, window)
    plain_dq = lambda: fa.flash_bwd_dq_reference(  # noqa: E731
        q, k, v, do, lse, delta, causal, window)
    plain_dkv = lambda: fa.flash_bwd_dkv_reference(  # noqa: E731
        q, k, v, do, lse, delta, causal, window)
    errs = {}
    r_out, r_lse = plain_f()
    errs["o"] = _errors(out, r_out)
    errs["lse"] = _errors(lse[..., None], r_lse[..., None])
    del r_out, r_lse
    errs["dq"] = _errors(dq, plain_dq())
    r_dk, r_dv = plain_dkv()
    errs["dk"], errs["dv"] = _errors(dk, r_dk), _errors(dv, r_dv)
    del r_dk, r_dv
    ok = all(math.isfinite(a) and a <= TOL[dtype_name] * top
             and math.isfinite(r) and r <= TRAIN_ROW_TOL[dtype_name]
             for a, r, top in errs.values())
    bounds, triples = _train_bounds(b, s, h, h_kv, d, causal, window,
                                    q.element_size(), dtype_name)
    rec = dict(case=name, shape=[b, s, h, h_kv, d], causal=causal,
               window=window, dtype=dtype_name, ok=ok, triples=triples,
               tol=TOL[dtype_name], row_tol=TRAIN_ROW_TOL[dtype_name],
               errors={key: dict(abs=a, row=r, abs_bound=TOL[dtype_name]
                                 * top) for key, (a, r, top) in errs.items()})
    for key, kern, plain in (("fwd", fwd, plain_f), ("dq", dq_k, plain_dq),
                             ("dkv", dkv_k, plain_dkv)):
        rec[key] = dict(kernel_ms=cuda_ms(kern, reps=5),
                        plain_ms=cuda_ms(plain, reps=2, warmup=1),
                        bound_ms=bounds[key][0], bound_by=bounds[key][1])
        torch.cuda.empty_cache()
    # SDPA on the same function, timed only (never used by the port): its
    # forward beside B1, its whole backward (dQ, dK, dV) beside B2 + B3
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    if window is None:
        sd_kw = dict(is_causal=causal)
    else:
        sd_kw = dict(attn_mask=fa._self_mask(s, causal, window, "cuda"))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, enable_gqa=True, **sd_kw)
    try:
        rec["fwd"]["library_ms"] = cuda_ms(sdpa, reps=5)
        o_sd = sdpa()
        g_sd = do.transpose(1, 2).contiguous()
        bwd = lambda: torch.autograd.grad(  # noqa: E731
            o_sd, (qt, kt, vt), g_sd, retain_graph=True)
        rec["sdpa_bwd_ms"] = cuda_ms(bwd, reps=5)
        del o_sd
    except Exception as e:  # an SDPA without enable_gqa: no yardstick
        log(f"  {name}: library call unavailable ({e!r})")
        rec["fwd"]["library_ms"] = rec["sdpa_bwd_ms"] = None
    rec["dq"]["library_ms"] = rec["dkv"]["library_ms"] = rec["sdpa_bwd_ms"]
    log("  " + json.dumps(rec))
    return rec


def phase_train_kernels():
    import torch

    recs = []
    for case in TRAIN_CASES:
        recs.append(run_train_case(*case))
        torch.cuda.empty_cache()
    bad = [f"{r['case']}/{r['dtype']}" for r in recs if not r["ok"]]
    if bad:
        raise AssertionError(
            f"training kernels disagree with their plain versions: {bad}")
    return recs


# -- phase 4: serving at full width ------------------------------------------


def phase_serving():
    import numpy as np
    import torch
    from horovod_tpu_torch import trace
    from horovod_tpu_torch.models import init_params, llama3_8b
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serving import ServeConfig, ServingEngine

    cfg = llama3_8b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"  weights: {sum(p.numel() for p in params.values()):,} params "
        f"in {time.perf_counter() - t0:.1f}s")
    eng = ServingEngine(cfg, params, serve=ServeConfig(
        block_size=16, decode_tiers=(1, 2, 4, 8), prefill_chunk=256),
        device="cuda")
    del params
    t0 = time.perf_counter()
    eng.warmup()
    log(f"  warmup {time.perf_counter() - t0:.2f}s, pool "
        f"{eng.pool_bytes / 1e9:.2f} GB ({eng.num_blocks} blocks)")
    eng.first_logits = {}
    eng.token_log = []
    rs = np.random.RandomState(SEED)
    vocab = cfg.vocab_size
    shared = rs.randint(1, vocab, size=256).astype(np.int32)
    tail = lambda n: rs.randint(1, vocab, size=n).astype(np.int32)  # noqa
    wave1 = [tail(16), tail(100), np.concatenate([shared, tail(44)]),
             tail(480), np.concatenate([shared, tail(444)]), tail(64)]
    wave2 = [np.concatenate([shared, tail(30)]),
             np.concatenate([shared, tail(200)])]
    prompts = {}
    torch.cuda.reset_peak_memory_stats()
    since = trace.now()
    fa.flash_fwd_cuda.launches = 0
    steps0 = eng.steps
    t_run = time.perf_counter()
    for p in wave1:
        prompts[eng.submit(p, max_new_tokens=32)] = p
    eng.run()
    for p in wave2:
        prompts[eng.submit(p, max_new_tokens=32)] = p
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = fa.flash_fwd_cuda.launches
    steps = eng.steps - steps0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert sorted(out) == sorted(prompts), "not every request completed"
    assert all(len(out[r]) == 32 for r in prompts), "short stream"
    assert launches == cfg.num_layers * steps, (
        f"kernel launches {launches} != {cfg.num_layers} x {steps} steps")
    hits = eng.scheduler.prefix_hit_blocks
    assert hits > 0, "the second wave hit no cached prefix block"
    # first-token logits against a dense, cache-free forward (bf16)
    worst = 0.0
    with torch.inference_mode():
        for rid, p in prompts.items():
            toks = torch.as_tensor(p, dtype=torch.long, device="cuda")[None]
            dense = eng.model(toks)[0, -1].float().cpu()
            got = eng.first_logits[rid]
            rel = float((got - dense).abs().max() / dense.abs().max())
            worst = max(worst, rel)
    logit_tol = 5e-2
    log(f"  first-token logits vs dense forward: max |diff|/max|logit| = "
        f"{worst:.4g} (tol {logit_tol})")
    assert worst <= logit_tol, "first-token logits disagree"
    ttft = sorted(s - a for s, a in _first_tokens(eng))
    gen = sum(len(v) for v in out.values())
    # decode throughput: tokens emitted by decode steps over their time
    dec = [(args["batch"], dur) for site, _t, dur, args, _tid
           in trace.snapshot(since)
           if site == "serve.step" and args and args["kind"] == "decode"]
    rec = dict(requests=len(out), steps=steps, launches=launches,
               prefix_hit_blocks=hits, evictions=eng.scheduler.evictions,
               prefill_tokens_computed=eng.prefill_tokens_computed,
               ttft_p50_s=ttft[len(ttft) // 2], tokens=gen, wall_s=wall,
               tokens_per_s=gen / wall,
               decode_steps=len(dec),
               decode_tokens_per_s=(sum(b for b, _ in dec)
                                    / sum(d for _, d in dec)),
               pool_gb=eng.pool_bytes / 1e9, peak_mem_gb=peak_gb)
    log("  serving: " + json.dumps(rec))
    profile_wave(eng, list(prompts.values()))
    del eng
    torch.cuda.empty_cache()
    return rec


def _kernel_class(name):
    n = name.lower()
    if "flash_fwd" in n:
        return "attention_fwd_kernel"
    if "flash_bwd" in n:
        return "attention_bwd_kernels"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "sm90", "nvjet")):
        return "gemm"
    if "index" in n or "gather" in n or "scatter" in n:
        return "cache_copy"
    return "other"


def _device_breakdown(prof, wall, steps):
    """Device time by kernel class and by kernel name, the device busy
    share (union of kernel intervals over the wall) and kernels per step
    from a torch.profiler capture."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_class, by_name, spans = {}, {}, []
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        cls = _kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + ms
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    if not kernels:
        log("  profile: the profiler recorded no device kernels "
            "(device time not measured)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        steps=steps, wall_s=wall,
        device_ms_by_class={k: round(v, 3) for k, v in by_class.items()},
        device_busy_share=(busy_us / 1e6 / wall) if kernels else None,
        top_kernels_ms={k: round(v, 3) for k, v in top},
        kernels_per_step=len(kernels) / max(1, steps))


def profile_wave(eng, prompts):
    """Where the time goes: resubmit ``prompts`` (their full blocks are
    cached by now) under torch.profiler; device time by kernel class,
    device busy share (union of kernel intervals over the wall), and the
    mean wall time per step kind from the engine's trace spans."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch import trace

    torch.cuda.synchronize()
    since = trace.now()
    steps0 = eng.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p, max_new_tokens=32)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = _device_breakdown(prof, wall, eng.steps - steps0)
    host = sorted(((a.key, a.self_cpu_time_total / 1e3, a.count)
                   for a in prof.key_averages()
                   if a.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])[:10]
    kinds = {}
    for site, _t0, dur, args, _tid in trace.snapshot(since):
        if site == "serve.step" and args:
            kinds.setdefault(args["kind"], []).append(dur * 1e3)
    rec.update(
        step_ms_mean={k: sum(v) / len(v) for k, v in kinds.items()},
        step_count={k: len(v) for k, v in kinds.items()},
        top_host_self_ms_calls={k: [round(ms, 3), n] for k, ms, n in host})
    log("  profile: " + json.dumps(rec))
    return rec


def _first_tokens(eng):
    """(first-token time, arrival) per request, from the token log."""
    seen = {}
    for rid, t, arrival in eng.token_log:
        seen.setdefault(rid, (t, arrival))
    return list(seen.values())


# -- phase 5: the fp32 oracle ------------------------------------------------


def phase_oracle():
    import numpy as np
    import torch
    from horovod_tpu_torch.models import init_params, llama3_8b
    from horovod_tpu_torch.serving import ServeConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_8b(num_layers=2, dtype=torch.float32)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED + 1),
                         device="cuda")
    eng = ServingEngine(cfg, params, serve=ServeConfig(
        block_size=16, decode_tiers=(1, 2, 4), prefill_chunk=32),
        device="cuda")
    rs = np.random.RandomState(SEED + 1)
    prompts = [rs.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 23, 40, 61)]
    n_new = 12
    ids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    out = eng.run()
    compared = 0
    with torch.inference_mode():
        for rid, p in zip(ids, prompts):
            toks = list(p)
            for i in range(n_new):
                x = torch.as_tensor(toks, dtype=torch.long,
                                    device="cuda")[None]
                logits = eng.model(x)[0, -1].float()
                top2 = torch.topk(logits, 2).values
                if float(top2[0] - top2[1]) < 1e-4:
                    break  # a near-tie: the rest of the stream may fork
                t = int(torch.argmax(logits))
                assert int(out[rid][i]) == t, (
                    f"request {rid} token {i}: engine {int(out[rid][i])} "
                    f"!= reference {t}")
                compared += 1
                toks.append(t)
    log(f"  oracle: {compared}/{len(ids) * n_new} tokens compared, all equal")
    assert compared >= len(ids) * n_new // 2, "too few tokens compared"
    del eng
    torch.cuda.empty_cache()
    return compared


# -- phase 6: data-parallel training of gpt_small at full width --------------

TRAIN_B, TRAIN_S, TRAIN_STEPS, PROFILE_STEPS = 8, 2048, 10, 2


def _reset_train_counts():
    from horovod_tpu_torch.ops import flash_attention as fa

    for fn in (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda):
        fn.launches = 0


def _train_counts():
    from horovod_tpu_torch.ops import flash_attention as fa

    return (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
            fa.flash_bwd_dkv_cuda.launches)


def phase_training():
    """gpt_small (12 layers, 12 heads of 64, vocab 32000) at full width
    and depth, B=8 x S=2048, bf16 compute over fp32 master weights,
    AdamW(1e-3) at optax's defaults, through the public training path:
    init() (world 1 over NCCL) -> replicate_state -> data_parallel_
    train_step, TRAIN_STEPS steps on one fixed batch."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import Transformer, gpt_small, init_params

    hvd.init()
    assert hvd.size() == 1 and hvd.device().type == "cuda"
    cfg = gpt_small(dtype=torch.bfloat16, attention_impl="flash")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda", param_dtype=torch.float32)
    model = Transformer(cfg, params=params)
    del params
    n_params = sum(p.numel() for p in model.parameters())
    # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    state = training.replicate_state(training.create_train_state(model, opt))
    step = training.data_parallel_train_step(model, opt)
    rs = np.random.RandomState(SEED)
    toks = torch.as_tensor(
        rs.randint(0, cfg.vocab_size, size=(TRAIN_B, TRAIN_S + 1)),
        dtype=torch.long, device="cuda")
    inputs, labels = toks[:, :-1], toks[:, 1:]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    losses, per_step, times = [], [], []
    for _ in range(TRAIN_STEPS):
        before = _train_counts()
        t0 = time.perf_counter()
        state, loss = step(state, inputs, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        per_step.append(tuple(a - b for a, b in zip(_train_counts(),
                                                    before)))
    launches = _train_counts()
    losses = [float(x) for x in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert all(math.isfinite(x) for x in losses), f"loss not finite: {losses}"
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    want = (cfg.num_layers,) * 3
    assert all(c == want for c in per_step), (
        f"kernel launches per step {per_step} != {want} (fwd, dq, dkv)")
    assert state.step == TRAIN_STEPS
    tokens = TRAIN_B * TRAIN_S
    steady = times[1:]  # the first step pays one-time set-up
    step_s = sum(steady) / len(steady)
    # model FLOPs: 6·N per token (attention's S² term not counted); the
    # attention-inclusive figure adds 6·L·S·d per token (causal half of
    # 12·L·S·d)
    mfu = 6 * n_params * tokens / step_s / PEAK_FLOPS["bfloat16"]
    attn = 6 * cfg.num_layers * TRAIN_S * cfg.d_model * tokens
    rec = dict(params=n_params, batch=[TRAIN_B, TRAIN_S],
               steps=TRAIN_STEPS, losses=losses, step_s=times,
               step_s_mean_steady=step_s, tokens_per_s=tokens / step_s,
               mfu_6n=mfu, mfu_6n_plus_attention=mfu + attn / step_s
               / PEAK_FLOPS["bfloat16"],
               launches=dict(zip(("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"), launches)),
               launches_per_step=list(per_step[0]), peak_mem_gb=peak_gb)
    log("  training: " + json.dumps(rec))
    rec["profile"] = profile_train(step, state, inputs, labels)
    hvd.shutdown()
    del state, step, model, opt
    torch.cuda.empty_cache()
    return rec


def profile_train(step, state, inputs, labels):
    """Device busy share and device time by kernel class over
    PROFILE_STEPS more steps under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            state, loss = step(state, inputs, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = _device_breakdown(prof, wall, PROFILE_STEPS)
    log("  training profile: " + json.dumps(rec))
    return rec


def phase_training_oracle():
    """gpt_small width, 2 layers, fp32: the gradient of every parameter
    through the kernels ("flash") against the plain dense path ("dot"),
    on the same weights and batch."""
    import dataclasses

    import numpy as np
    import torch

    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import Transformer, gpt_small, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt_small(num_layers=2, dtype=torch.float32,
                    attention_impl="flash")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED + 2),
                         device="cuda")
    rs = np.random.RandomState(SEED + 2)
    toks = torch.as_tensor(rs.randint(0, cfg.vocab_size, size=(2, 513)),
                           dtype=torch.long, device="cuda")
    grads = {}
    for impl in ("flash", "dot"):
        model = Transformer(dataclasses.replace(cfg, attention_impl=impl),
                            params={k: v.clone() for k, v in params.items()})
        loss = training.softmax_cross_entropy(model(toks[:, :-1]),
                                              toks[:, 1:])
        loss.backward()
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
    # fp32 on both sides; the kernels sum in another order than the dense
    # einsums, so each gradient agrees to rounding, far inside 1e-4 of
    # its largest entry
    tol = 1e-4
    worst = max(float((grads["flash"][n] - g).abs().max()
                      / g.abs().max().clamp_min(1e-30))
                for n, g in grads["dot"].items())
    log(f"  training oracle: {len(grads['dot'])} parameter gradients, flash "
        f"vs dot: max |diff|/max|grad| = {worst:.3g} (tol {tol})")
    assert worst <= tol, "gradients through the kernels disagree"
    torch.cuda.empty_cache()
    return worst


PHASES = ("kernels", "serving", "oracle", "training", "training_oracle")


def kernel_entries(kern, train_kern, serving, train):
    """The ``kernels`` JSON line: one entry per kernel source and C
    entry.  ``launches`` come from the main paths' runs (flash_fwd: the
    serving run's plus the training run's), the other numbers from the
    kernel phase at the main path's shape (flash_fwd: the training
    forward, gpt_small bf16); a phase left out by ``--phases`` leaves its
    numbers null."""
    main = train_kern[0] if train_kern else None
    fwd_launches = None
    if serving or train:
        fwd_launches = ((serving["launches"] if serving else 0)
                        + (train["launches"]["flash_fwd"] if train else 0))
    entries = []
    for name, key, src, line in (
            ("flash_fwd", "fwd", "flash_fwd.cu", 104),
            ("flash_bwd_dq", "dq", "flash_bwd.cu", 301),
            ("flash_bwd_dkv", "dkv", "flash_bwd.cu", 342)):
        e = dict(name=name, route="cuda",
                 source=f"horovod_tpu_torch/csrc/{src}",
                 replaces=f"horovod_tpu/ops/flash_attention.py:{line}",
                 launches=(fwd_launches if key == "fwd" else
                           train["launches"][name] if train else None),
                 max_abs_err=None, ms=None, plain_ms=None, bound_ms=None,
                 bound_by=None, library_ms=None)
        if main:
            outs = {"fwd": ("o", "lse"), "dq": ("dq",),
                    "dkv": ("dk", "dv")}[key]
            errs = [r["errors"][o]["abs"] for r in train_kern for o in outs]
            if key == "fwd":
                errs += [r["max_abs_err"] for r in kern]
            e.update(max_abs_err=max(errs), ms=main[key]["kernel_ms"],
                     plain_ms=main[key]["plain_ms"],
                     bound_ms=main[key]["bound_ms"],
                     bound_by=main[key]["bound_by"],
                     library_ms=main[key]["library_ms"])
        entries.append(e)
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from horovod_tpu_torch.ops import _build
        from horovod_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"
    log(f"device: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_build.build_seconds:.1f}s)")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    kern = train_kern = serving = train = None
    if "kernels" in phases:
        log("phase kernels:")
        kern = phase_kernels()
        train_kern = phase_train_kernels()
    if "serving" in phases:
        log("phase serving:")
        serving = phase_serving()
    if "oracle" in phases:
        log("phase oracle:")
        phase_oracle()
    if "training" in phases:
        log("phase training:")
        train = phase_training()
    if "training_oracle" in phases:
        log("phase training_oracle:")
        phase_training_oracle()
    entries = kernel_entries(kern, train_kern, serving, train)
    log(card)
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
