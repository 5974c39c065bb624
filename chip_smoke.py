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
3. kernel vs plain: the paged flash-attention kernel against its plain
   PyTorch version on the card, over decode and chunk cases (llama3_8b
   heads 32/8 at D=128, an MHA case at D=64, a windowed case with
   nonzero ``kv_start``, pad rows that must come back exactly zero; bf16
   and fp32), each with its absolute and per-row relative error against
   their tolerances, its time, the plain version's, SDPA's (timed only)
   and the card's bound;
4. serving: ``ServingEngine`` over llama3_8b at full width (32 layers,
   bf16, random weights from a seeded generator on the card) serves two
   waves of requests; every request must complete, the kernel must have
   launched exactly 32 times per engine step, the second wave must hit
   the prefix cache, and each first token's logits must match a dense
   cache-free forward;
5. oracle: llama3_8b width, 2 layers, fp32 — greedy streams through the
   engine must equal one-at-a-time plain decode (tie-aware).

The card's ``nvidia-smi`` line comes next, then the ``kernels`` JSON on
the line before the last (``launches`` from the serving run, the other
numbers from the kernel phase; null where ``--phases`` left that phase
out); the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, it exits 1 and prints no result.  ``--phases`` runs a subset
(e.g. ``--phases kernels``); the default runs all.
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
        return "attention_kernel"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "sm90", "nvjet")):
        return "gemm"
    if "index" in n or "gather" in n or "scatter" in n:
        return "cache_copy"
    return "other"


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
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_class, by_name = {}, {}
    spans = []
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        cls = _kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + ms
        spans.append((e.time_range.start, e.time_range.end))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    host = sorted(((a.key, a.self_cpu_time_total / 1e3, a.count)
                   for a in prof.key_averages()
                   if a.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])[:10]
    busy_us, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    kinds = {}
    for site, _t0, dur, args, _tid in trace.snapshot(since):
        if site == "serve.step" and args:
            kinds.setdefault(args["kind"], []).append(dur * 1e3)
    rec = dict(
        steps=eng.steps - steps0, wall_s=wall,
        device_ms_by_class={k: round(v, 3) for k, v in by_class.items()},
        device_busy_share=(busy_us / 1e6 / wall) if kernels else None,
        step_ms_mean={k: sum(v) / len(v) for k, v in kinds.items()},
        step_count={k: len(v) for k, v in kinds.items()},
        top_kernels_ms={k: round(v, 3) for k, v in top},
        kernels_per_step=len(kernels) / max(1, eng.steps - steps0),
        top_host_self_ms_calls={k: [round(ms, 3), n] for k, ms, n in host})
    if not kernels:
        log("  profile: the profiler recorded no device kernels "
            "(device time not measured)")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="kernels,serving,oracle")
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
    kern = serving = None
    if "kernels" in phases:
        log("phase kernels:")
        kern = phase_kernels()
    if "serving" in phases:
        log("phase serving:")
        serving = phase_serving()
    if "oracle" in phases:
        log("phase oracle:")
        phase_oracle()
    # a phase left out by --phases leaves its numbers null: launches
    # come only from the serving run, the rest from the kernel phase
    entry = dict(name="flash_fwd", route="cuda",
                 source="horovod_tpu_torch/csrc/flash_fwd.cu",
                 replaces="horovod_tpu/ops/flash_attention.py:104",
                 launches=serving["launches"] if serving else None,
                 max_abs_err=None, ms=None, plain_ms=None, bound_ms=None,
                 bound_by=None, library_ms=None)
    if kern:
        main_case = next(r for r in kern if r["case"] == "decode_gqa_bf16")
        entry.update(max_abs_err=max(r["max_abs_err"] for r in kern),
                     ms=main_case["kernel_ms"],
                     plain_ms=main_case["plain_ms"],
                     bound_ms=main_case["bound_ms"],
                     bound_by=main_case["bound_by"],
                     library_ms=main_case["library_ms"])
    log(card)
    log(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
