#!/usr/bin/env python3
"""A/B variants of the sm90 flash backward on one card, in one process.

Each variant is ``horovod_tpu_torch/csrc/flash_bwd_sm90.cu`` with ``sed``
edits applied, compiled by its own ``nvcc`` (all at once, the package's
flags) into its own library; ``base`` is the source as it stands.  On the
same seeded bf16 inputs, causal, the dq and dkv entries of every variant
are timed in turns (base, v1, ..., v1, base: CUDA events over 10 launches
each), their outputs compared bit for bit with base's, and each held
against the plain versions with ``chip_smoke.py``'s bf16 measures.  The
compiler's spill and serialization remarks are printed per variant.

Run from the root of a checkout on a machine with the card:

    python3 tools/flash_bwd_sm90_ab.py --variant \\
        'st2=s/constexpr int kStages = 3;/constexpr int kStages = 2;/'

Shapes: gpt_small's attention (B=8, S=2048, 12 heads of 64) and
llama3_8b's (B=1, S=4096, 32/8 heads of 128).
"""

import argparse
import ctypes
import math
import os
import subprocess
import sys
import tempfile

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

SHAPES = {"gpt_small": (8, 2048, 12, 12, 64),
          "llama3_8b": (1, 4096, 32, 8, 128)}


def build(variants, work, source="flash_bwd_sm90.cu", entries=None):
    """Compile each variant of ``csrc/<source>`` (``{name: [sed edit,
    ...]}``) into its own library under ``work``; returns ``{name:
    CDLL}`` with ``entries``' signatures set (default: the sm90
    backward's)."""
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    entries = entries or fa._BWD_SM90_ARGS
    src = os.path.join(_build.CSRC, source)
    procs = {}
    for name, edits in variants.items():
        d = os.path.join(work, name)
        os.makedirs(d)
        subprocess.run(f"cp {_build.CSRC}/*.cuh {d}/", shell=True, check=True)
        path = os.path.join(d, "k.cu")
        subprocess.run(["cp", src, path], check=True)
        for e in edits:
            subprocess.run(["sed", "-i", e, path], check=True)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", f"{d}/k.so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for line in log.splitlines():
            if ("spill" in line and " 0 bytes spill" not in line) \
                    or "C75" in line:
                print(f"  {name}: {line.strip()[:160]}")
        lib = ctypes.CDLL(os.path.join(work, name, "k.so"))
        for entry, args in entries.items():
            getattr(lib, entry).argtypes = args
            getattr(lib, entry).restype = ctypes.c_int
        lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def inputs(b, s, h, h_kv, d):
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(0)
    mk = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device="cuda").bfloat16()
    q, k, v, do = mk(b, s, h, d), mk(b, s, h_kv, d), mk(b, s, h_kv, d), \
        mk(b, s, h, d)
    out, lse = fa.flash_forward(q, k, v, True, None)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def launch(lib, dkv, args, outs):
    import torch

    q, k, v, do, lse, delta = args
    b, s, h, d = q.shape
    strides = [x for t in [q, k, v, do] + outs for x in t.stride()[:3]]
    arr = (ctypes.c_longlong * len(strides))(*strides)
    entry = "hvd_flash_bwd_dkv_sm90" if dkv else "hvd_flash_bwd_dq_sm90"
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
        b, s, h, k.shape[2], d, ctypes.addressof(arr), 1, 0,
        1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=SED", help="a variant: a sed edit of the "
                    "source (repeat the flag with one NAME for several)")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from horovod_tpu_torch.ops import flash_attention as fa

    variants = {"base": []}
    for v in args.variant:
        name, edit = v.split("=", 1)
        variants.setdefault(name, []).append(edit)
    with tempfile.TemporaryDirectory() as work:
        libs = build(variants, work)
        names = list(libs)
        for shape_name, shape in SHAPES.items():
            t = inputs(*shape)
            q, k = t[0], t[1]
            outs = {n: ([torch.empty_like(q)],
                        [torch.empty_like(k), torch.empty_like(k)])
                    for n in names}
            times = {n: {"dq": [], "dkv": []} for n in names}
            for n in names + names[::-1]:
                for key, dkv in (("dq", 0), ("dkv", 1)):
                    o = outs[n][dkv]
                    times[n][key].append(cs.cuda_ms(
                        lambda: launch(libs[n], dkv, t, o), reps=10,
                        warmup=1))
            ref = fa.flash_bwd_dq_reference(*t, True, None), \
                *fa.flash_bwd_dkv_reference(*t, True, None)
            base = outs["base"][0] + outs["base"][1]
            for n in names:
                got = outs[n][0] + outs[n][1]
                print(shape_name, n, {k_: [round(x, 4) for x in v_]
                                      for k_, v_ in times[n].items()},
                      "bits equal to base:",
                      all(torch.equal(a, b) for a, b in zip(got, base)),
                      "errors (abs, row):",
                      [tuple(round(x, 5) for x in cs._errors(a, r)[:2])
                       for a, r in zip(got, ref)])
            del t, outs, ref
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
