#!/usr/bin/env python3
"""A/B variants of the fused-norm stats kernel on one card, in one process.

Each variant is ``horovod_tpu_torch/csrc/fused_norm.cu`` with ``sed``
edits applied, compiled by its own ``nvcc`` (all at once, the package's
flags) into its own library; ``base`` is the source as it stands.  Each
``--plan BLOCKS_PER_SM,TILE_VECS,FINISH_KB`` sets the host plan's blocks
an SM, vectors a column tile and partial bytes a finishing block reads
(``ops/fused_norm.py`` ``_STATS_BLOCKS_PER_SM``, ``_STATS_TILE_VECS``,
``_STATS_FINISH_BYTES``); the first plan is the package's.  Over the 16
distinct site shapes of ResNet-50 at batch 128 (bf16), every (variant,
plan) is timed in turns (forward order, then reverse: device time over
20 calls, as ``chip_smoke.py``'s ``device_ms``; the faster turn counts
in the totals), its outputs compared bit for bit with base's, and its
largest mean error against the plain version printed.  Beside them, per
shape: the byte bound, ``torch.var_mean`` (the function in one PyTorch
call) and one ``x.sum()`` (a plain streaming read of the same bytes);
then each combination's total over the 53 sites of a step.

Named variants (``--variant NAME``) besides ``NAME=SED`` edits:

- ``loads4``: 4 loads of x in flight a thread (``kLoads``), not 8;
- ``acc2``, ``acc8``: 2 or 8 accumulator pairs a thread (``kAcc``; 8:
  each of the 8 loads into its own pair, variant (a) in full);
- ``l4a4``: 4 loads, each into its own pair;
- ``ring``: variant (b), ``tools/bn_stats_ring.cuh``: a ring of 1-D bulk
  copies (``cp.async.bulk``) into shared memory on mbarriers, reduced
  from shared memory;
- ``lb4``: ``__launch_bounds__`` for 4 resident blocks an SM (pair it
  with ``--plan 4,8,150``); ``lb4l4``: the same with 4 loads.

Run from the root of a checkout on a machine with the card:

    python3 tools/bn_stats_ab.py --variant ring --variant loads4 \
        --plan 1,8,150 --plan 2,4,150
"""

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RING = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "bn_stats_ring.cuh")
NAMED = {
    "loads4": [r"s/^constexpr int kLoads = 8;/constexpr int kLoads = 4;/"],
    "acc2": [r"s/^constexpr int kAcc = 1;/constexpr int kAcc = 2;/"],
    "acc8": [r"s/^constexpr int kAcc = 1;/constexpr int kAcc = 8;/"],
    "ring": [rf"/^\/\/ -* launches --$/r {RING}",
             r"s/bn_stats<T, V><<</(V > 1 ? bn_stats_ring<T, V> : "
             r"bn_stats<T, V>)<<</"],
    "lb4": [r"s/^constexpr int kStatsBlocksPerSM = 2;/"
            r"constexpr int kStatsBlocksPerSM = 4;/"],
}
NAMED["l4a4"] = NAMED["loads4"] + [
    r"s/^constexpr int kAcc = 1;/constexpr int kAcc = 4;/"]
NAMED["lb4l4"] = NAMED["lb4"] + NAMED["loads4"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME[=SED]", help="a named variant, or a sed "
                    "edit of the source (repeat one NAME for several)")
    ap.add_argument("--plan", action="append", default=[],
                    metavar="BLOCKS_PER_SM,TILE_VECS,FINISH_KB")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from flash_bwd_sm90_ab import build
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import fused_norm as fn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    variants = {"base": []}
    for v in args.variant:
        name, _, edit = v.partition("=")
        variants.setdefault(name, []).extend([edit] if edit else NAMED[name])
    knobs = ("_STATS_BLOCKS_PER_SM", "_STATS_TILE_VECS",
             "_STATS_FINISH_BYTES")
    plans = [(fn._STATS_BLOCKS_PER_SM, fn._STATS_TILE_VECS,
              fn._STATS_FINISH_BYTES // 1024)] + [
        tuple(int(v) for v in p.split(",")) for p in args.plan]

    def set_plan(plan):
        for knob, v in zip(knobs, plan):
            setattr(fn, knob, v * 1024 if knob.endswith("BYTES") else v)

    bound = _build.bound
    sites = cs.resnet50_sites()
    shapes = {}
    for (m, c, _, _), n in sites.items():
        shapes[(m, c)] = shapes.get((m, c), 0) + n
    with tempfile.TemporaryDirectory() as work:
        libs = build(variants, work, "fused_norm.cu", fn._ARGS)
        combos = [(v, p) for v in libs for p in plans]
        totals = {c: 0.0 for c in combos}
        sum_total = var_mean_total = bound_total = 0.0
        g = torch.Generator(device="cuda").manual_seed(cs.SEED)
        for (m, c), n in sorted(shapes.items(), key=lambda kv: -kv[0][0]):
            x = (2 * torch.randn((m, c), generator=g, device="cuda")
                 + 3 * torch.randn((c,), generator=g, device="cuda")
                 ).to(torch.bfloat16)
            gamma = torch.rand((c,), generator=g, device="cuda") + 0.5
            beta = torch.randn((c,), generator=g, device="cuda")
            mean, _, _ = fn.bn_stats_reference(x, cs.EPS)
            times = {k: [] for k in combos}
            outs = {}
            for k in combos + combos[::-1]:
                _build.bound = lambda nm, e, lib=libs[k[0]]: (  # noqa: E731
                    lib if nm == "fused_norm.cu" else bound(nm, e))
                set_plan(k[1])
                call = lambda: fn.bn_stats_cuda(  # noqa: E731
                    x, gamma, beta, cs.EPS)
                times[k].append(cs.device_ms(call, reps=20, warmup=3))
                outs[k] = call()
            _build.bound = bound
            set_plan(plans[0])
            sum_ms = cs.device_ms(lambda: x.sum(), reps=20)
            var_mean_ms = cs.device_ms(
                lambda: torch.var_mean(x, dim=0, correction=0), reps=20)
            bnd = cs._bn_bounds(m, c, 2, 0, 0)["stats"][0]
            sum_total += n * sum_ms
            var_mean_total += n * var_mean_ms
            bound_total += n * bnd
            print(f"m{m}_c{c} x{n}: bound {bnd:.4f} ms, x.sum() "
                  f"{sum_ms:.4f} ms, var_mean {var_mean_ms:.4f} ms")
            base = outs[combos[0]]
            for k in combos:
                best = min(times[k])
                totals[k] += n * best
                err = float((outs[k][0] - mean).abs().max())
                print(f"  {k[0]:8s} plan {k[1]}: "
                      f"{[round(t, 4) for t in times[k]]} ms "
                      f"({bnd / best:.0%} of bound), "
                      f"same bits as base: {torch.equal(outs[k], base)}, "
                      f"max |mean err| {err:.3g}")
            del x, outs, mean
            torch.cuda.empty_cache()
    print(f"per step (53 sites): bound {bound_total:.4f} ms, x.sum() "
          f"{sum_total:.4f} ms, var_mean {var_mean_total:.4f} ms")
    for k, t in totals.items():
        print(f"  {k[0]:8s} plan {k[1]}: {t:.4f} ms "
              f"({bound_total / t:.0%} of bound)")


if __name__ == "__main__":
    main()
