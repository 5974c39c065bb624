#!/usr/bin/env python3
"""A/B variants of the paged decode kernel on one card, in one process.

Each variant is ``horovod_tpu_torch/csrc/flash_decode.cu`` with ``sed``
edits applied, compiled by its own ``nvcc`` (all at once, the package's
flags) into its own library; ``base`` is the source as it stands.  Each
``--plan BLOCKS_PER_SM,MIN_SPLIT_KEYS`` sets the host split plan's two
constants (``ops/flash_attention.py``); the first plan is the package's.
On seeded decode inputs read through shuffled block tables (16-token
pages, pools twice the live size), every (variant, plan) is timed in
turns (forward order, then reverse: device time over 20 calls, as
``chip_smoke.py``'s ``device_ms``) and its largest error against the
plain version printed.  Beside them, per shape: SDPA on the
already-gathered K/V (device time) and one ``torch.sum`` over a
contiguous tensor of the same K/V bytes (a plain streaming read of them).

Run from the root of a checkout on a machine with the card:

    python3 tools/flash_decode_ab.py --variant \\
        'st3=s/^constexpr int kStages = 2;/constexpr int kStages = 3;/' \\
        --plan 4,256 --plan 8,256

Shapes: llama3_8b's decode at chip_smoke's context lengths (32/8 heads
of 128; bf16 and fp32), a serving-like batch (contexts 290-780), and an
MHA case at D = 64.
"""

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

CTX = [1, 9, 100, 700, 1500, 2500, 3333, 4096]
SHAPES = {  # B, H, H_kv, D, block size, kv_lens, dtype
    "gqa_bf16": (8, 32, 8, 128, 16, CTX, "bfloat16"),
    "gqa_fp32": (8, 32, 8, 128, 16, CTX, "float32"),
    "serve_bf16": (8, 32, 8, 128, 16,
                   [290, 340, 420, 510, 530, 610, 700, 780], "bfloat16"),
    "mha_d64_bf16": (8, 32, 32, 64, 16, [min(x, 2048) for x in CTX],
                     "bfloat16"),
}


def inputs(b, h, h_kv, d, bs, kv_lens, dtype):
    import chip_smoke as cs
    import torch

    return cs.make_paged_case("ab", b=b, h=h, h_kv=h_kv, d=d, bs=bs,
                              dtype=getattr(torch, dtype), kv_lens=kv_lens)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=SED", help="a variant: a sed edit of the "
                    "source (repeat the flag with one NAME for several)")
    ap.add_argument("--plan", action="append", default=[],
                    metavar="BLOCKS_PER_SM,MIN_SPLIT_KEYS")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from flash_bwd_sm90_ab import build
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    variants = {"base": []}
    for v in args.variant:
        name, edit = v.split("=", 1)
        variants.setdefault(name, []).append(edit)
    plans = [(fa._BLOCKS_PER_SM, fa._MIN_SPLIT_KEYS)] + [
        tuple(int(x) for x in p.split(",")) for p in args.plan]
    bound = _build.bound
    with tempfile.TemporaryDirectory() as work:
        libs = build(variants, work, "flash_decode.cu", fa._DECODE_ARGS)
        combos = [(v, p) for v in libs for p in plans]
        for shape_name, shape in SHAPES.items():
            case = inputs(*shape)
            q, kp, vp, tables, kv = (case[k] for k in (
                "q", "k_pool", "v_pool", "tables", "kv_lens"))
            kw = dict(layer=case["layer"], max_pages=case["max_pages"])
            ref = fa.flash_decode_paged_reference(q, kp, vp, tables, kv, **kw)
            times = {c: [] for c in combos}
            errs = {}
            for c in combos + combos[::-1]:
                _build.bound = lambda n, e, lib=libs[c[0]]: (  # noqa: E731
                    lib if n == "flash_decode.cu" else bound(n, e))
                fa._BLOCKS_PER_SM, fa._MIN_SPLIT_KEYS = c[1]
                call = lambda: fa.flash_decode_paged(  # noqa: E731
                    q, kp, vp, tables, kv, **kw)
                times[c].append(cs.device_ms(call, reps=20, warmup=3))
                errs[c] = float((call().float() - ref.float()).abs().max())
            _build.bound = bound
            fa._BLOCKS_PER_SM, fa._MIN_SPLIT_KEYS = plans[0]
            gk, gv, _ = fa.gather_pages(kp[1], vp[1], tables, kv - 1,
                                        max_pages=case["max_pages"])
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, gk, gv))
            mask = (torch.arange(kt.shape[2], device="cuda")[None]
                    < kv[:, None])[:, None, None]
            sdpa_ms = cs.device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), reps=20)
            n_kv = 2 * sum(kv.tolist()) * kp.shape[3] * kp.shape[4]
            flat = torch.ones(n_kv, dtype=q.dtype, device="cuda")
            sum_ms = cs.device_ms(lambda: flat.sum(), reps=20)
            bnd, _ = cs.paged_bound_ms(case)
            print(f"{shape_name}: bound {bnd:.4f} ms, SDPA (gathered) "
                  f"{sdpa_ms:.4f} ms, torch.sum over the same "
                  f"{n_kv * q.element_size() / 1e6:.1f} MB {sum_ms:.4f} ms")
            for c in combos:
                print(f"  {c[0]:10s} plan {c[1]}: "
                      f"{[round(t, 4) for t in times[c]]} ms, "
                      f"max abs err {errs[c]:.3g}")
            del case, q, kp, vp, tables, kv, ref, gk, gv, qt, kt, vt, flat
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
