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


def test_engine_on_card_matches_engine_on_cpu():
    """The same fp32 weights and requests through the engine on the card
    (the kernel) and on the CPU (the plain version): identical greedy
    streams, one kernel launch per layer per step."""
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
        ids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        res = eng.run()
        outs.append([res[i].tolist() for i in ids])
        if device == "cuda":
            assert tfa.flash_fwd_cuda.launches - before == \
                cfg.num_layers * eng.steps
    assert outs[0] == outs[1]
