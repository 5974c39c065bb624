"""The fused-norm stats kernel's host plan and summation order, on the CPU.

``horovod_tpu_torch/csrc/fused_norm.cu``'s ``bn_stats`` follows the plan
``ops/fused_norm.py::_stats_plan`` gives it (column tiles, contiguous row
ranges, scratch sizes); these tests check that plan covers every row and
channel of a site once within CUDA's limits, and keeps every sequential
chain of fp32 additions at or under ``_STATS_CHAIN`` (500), the length
``chip_smoke.py``'s ``BN_STAT_TOL`` comment rests on.  Cases: the 16
distinct ResNet-50 site shapes at batch 128 (bf16: 8 elements a vector;
fp32: 4), the ragged and scalar-path cases of ``chip_smoke.py``'s
fused-norm phase, M = 1 and C = 1, on cards of several SM counts.

Then a vectorised fp32 emulation of the kernel's summation order (each
thread's rows in row order into its accumulator pairs, the fused
multiply-add of x², the block's row threads in a pairwise tree, the
partials in strided slices, the slices in a pairwise tree, the finalize's
roundings) is held, at ``BN_STAT_TOL`` (|Δmean| ≤ 1e-4·sqrt(E[x²]),
|Δvar| ≤ 2e-4·E[x²] per channel), against the JAX package's
``fused_batch_norm_act`` (its Pallas stats kernel in interpret mode, as
``tests/test_torch_fused_norm.py`` runs it) at small shapes, and against
float64 sums at a ResNet-50 shape (M = 25,088, C = 256).  The emulation
rounds x² + q once through float64 (the card's fma rounds once; the two
differ at most by a double rounding, far inside the tolerance).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from horovod_tpu.ops.fused_norm import fused_batch_norm_act as jax_op
from horovod_tpu_torch.ops import fused_norm as fn

# chip_smoke.py's tolerance of the stats kernel against its plain version
BN_STAT_TOL = {"mean": 1e-4, "var": 2e-4}
EPS = 1e-5
SOURCE = Path(fn.__file__).resolve().parents[1] / "csrc" / "fused_norm.cu"

# ResNet-50's 53 norm sites at batch 128, 224x224 (ResNet.bn_sites):
# the 12 distinct (M, C) of its 16 (M, C, relu, residual) shapes
RESNET_MC = [(1_605_632, 64), (401_408, 64), (401_408, 128), (401_408, 256),
             (100_352, 128), (100_352, 256), (100_352, 512), (25_088, 256),
             (25_088, 512), (25_088, 1024), (6_272, 512), (6_272, 2048)]
# chip_smoke.py's ragged and scalar-path cases, M = 1, C = 1
OTHER = [(1000, 96, 8), (4099, 100, 1), (4099, 30, 1), (4096, 64, 1),
         (1, 64, 8), (1, 1, 1), (5, 1, 1), (7, 3, 1), (1, 2048, 4)]
CASES = ([(m, c, 8) for m, c in RESNET_MC] + [(m, c, 4) for m, c in RESNET_MC]
         + OTHER)


def test_resnet_site_shapes_are_the_models():
    """RESNET_MC is the set of ResNet-50's site shapes at batch 128."""
    import torch
    from horovod_tpu_torch.models import ResNet50

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     stem="space_to_depth", device="cpu")
    sites = model.bn_sites(128, 224, 224)
    assert len(sites) == 53 and len(set(sites)) == 16
    assert sorted({(m, c) for m, c, _, _ in sites}) == sorted(RESNET_MC)


def test_constants_mirror_the_kernel_source():
    """The plan's copies of the kernel's compile-time constants."""
    src = SOURCE.read_text()
    const = {name: int(re.search(rf"^constexpr int {name} = (\d+);", src,
                                 re.M).group(1))
             for name in ("kLoads", "kAcc", "kStatsBlocksPerSM")}
    assert const["kLoads"] == fn._STATS_LOADS
    assert const["kAcc"] == fn._STATS_ACC
    # the plan's wave is resident at once under the kernel's budget
    assert 1 <= fn._STATS_BLOCKS_PER_SM <= const["kStatsBlocksPerSM"]


def _chains(plan, vec):
    """The longest sequential chain of each sum: a thread's rows into
    one accumulator pair, the pairs, the block tree's depth, a finishing
    slice's partials, the slice tree's depth."""
    slices = 256 // (2 * plan.tx)
    per_thread = plan.rows // plan.ty
    return dict(rows=-(-per_thread // fn._STATS_ACC), pairs=fn._STATS_ACC,
                block_tree=int(math.log2(plan.ty)),
                partials=-(-plan.gy // slices),
                slice_tree=int(math.log2(slices)))


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("m,c,vec", CASES)
def test_plan_covers_every_row_and_channel_once(m, c, vec, sms):
    plan = fn._stats_plan(m, c, vec, sms)
    cv = c // vec
    assert plan.tx in (1, 2, 4, 8, 16, 32) and plan.ty * plan.tx == 256
    # column tiles: channel vectors [bx·tx, (bx+1)·tx) ∩ [0, cv), each
    # vector of vec channels, cover the c channels once
    assert plan.gx * plan.tx >= cv > (plan.gx - 1) * plan.tx
    assert cv * vec == c
    # row blocks: [y·rows, min(m, (y+1)·rows)), none empty, cover m once
    assert plan.rows % plan.ty == 0
    assert plan.gy * plan.rows >= m > (plan.gy - 1) * plan.rows
    # CUDA's grid limits; the scratch the wrapper allocates
    assert 1 <= plan.gy <= 65535 and 1 <= plan.gx < 2 ** 31
    assert plan.partials == plan.gy * 2 * c and plan.counters == plan.gx
    # a finishing block reads at most _STATS_FINISH_BYTES of partials
    assert plan.gy * 2 * plan.tx * vec * 4 <= fn._STATS_FINISH_BYTES
    # one wave of _STATS_BLOCKS_PER_SM blocks on every SM, unless the
    # chain limit needs more row blocks (a small card, a tall site)
    tall = -(-m // (plan.ty * fn._STATS_ACC * fn._STATS_CHAIN))
    assert plan.gy <= max(sms * fn._STATS_BLOCKS_PER_SM // plan.gx, tall, 1)
    assert all(n <= fn._STATS_CHAIN for n in _chains(plan, vec).values())


@pytest.mark.parametrize("m,c,vec", [(1000, 96, 8), (4099, 30, 1),
                                     (777, 40, 4), (1, 1, 1), (300, 2048, 8)])
def test_plan_blocks_tile_the_site_exactly(m, c, vec):
    """Every (row, channel) of a small site belongs to one block."""
    plan = fn._stats_plan(m, c, vec, 132)
    hits = np.zeros((m, c), np.int32)
    width = plan.tx * vec
    for bx in range(plan.gx):
        for by in range(plan.gy):
            hits[by * plan.rows:min(m, (by + 1) * plan.rows),
                 bx * width:min(c, (bx + 1) * width)] += 1
    assert (hits == 1).all()


def test_small_sites_fill_the_card():
    """Every ResNet-50 site, the smallest too, runs one wave of a block
    on (nearly) every SM: the tiles share the SMs evenly, so a few SMs
    may stay idle where the tile count does not divide 132."""
    for m, c in RESNET_MC:
        plan = fn._stats_plan(m, c, 8, 132)
        assert 0.95 * 132 <= plan.gx * plan.gy <= 132, (m, c)


def _pairwise(a, axis):
    """The kernel's slice tree: slice s += slice s + n/2, ... (n a power
    of two) along ``axis``."""
    a = np.moveaxis(a, axis, 0)
    while a.shape[0] > 1:
        h = a.shape[0] // 2
        a = (a[:h] + a[h:]).astype(np.float32)
    return a[0]


def emulate_stats(x, vec, sms=132, eps=EPS):
    """(sums (2, C), mean, var) of an (M, C) fp32 array as bn_stats sums
    them under ``_stats_plan(M, C, vec, sms)``."""
    m, c = x.shape
    plan = fn._stats_plan(m, c, vec, sms)
    acc, ty, gy = fn._STATS_ACC, plan.ty, plan.gy
    xp = np.zeros((gy * plan.rows, c), np.float32)
    xp[:m] = x  # the rows past M add exact zeros
    # (block, row n of the thread, thread ty, channel)
    xb = xp.reshape(gy, plan.rows // ty, ty, c)
    s = np.zeros((acc, gy, ty, c), np.float32)
    q = np.zeros((acc, gy, ty, c), np.float32)
    for n in range(xb.shape[1]):
        v = xb[:, n]
        s[n % acc] = s[n % acc] + v
        q[n % acc] = (v.astype(np.float64) ** 2
                      + q[n % acc]).astype(np.float32)
    for a in range(1, acc):
        s[0] = s[0] + s[a]
        q[0] = q[0] + q[a]
    partials = np.stack([_pairwise(s[0], 1), _pairwise(q[0], 1)])  # 2,gy,c
    slices = 256 // (2 * plan.tx)
    pp = np.zeros((2, -(-gy // slices) * slices, c), np.float32)
    pp[:, :gy] = partials
    pp = pp.reshape(2, -1, slices, c)
    tot = np.zeros((2, slices, c), np.float32)
    for j in range(pp.shape[1]):
        tot = tot + pp[:, j]
    sums = _pairwise(tot, 1)
    count = np.float32(m)
    mean = sums[0] / count
    var = np.maximum(sums[1] / count - mean * mean, np.float32(0))
    return sums, mean, var


def _within_tol(mean, var, ref_mean, ref_var, x):
    ex2 = (x.astype(np.float64) ** 2).mean(0)
    dm = np.abs(mean.astype(np.float64) - ref_mean) / np.sqrt(ex2)
    dv = np.abs(var.astype(np.float64) - ref_var) / ex2
    assert dm.max() <= BN_STAT_TOL["mean"], dm.max()
    assert dv.max() <= BN_STAT_TOL["var"], dv.max()


@pytest.mark.parametrize("shape,vec", [((16, 8, 8, 64), 4),
                                       ((4, 8, 8, 256), 4),
                                       ((8, 8, 8, 128), 8)])
def test_emulated_order_matches_jax_interpret(shape, vec):
    """The kernel's order against the JAX op's mean and var (its Pallas
    stats kernel in interpret mode), on seeded inputs with per-channel
    offsets (E[x²] well above var, so var's cancellation shows)."""
    rng = np.random.RandomState(7)
    c = shape[-1]
    x = (2 * rng.randn(*shape) + 3 * rng.randn(c)).astype(np.float32)
    _, mean, var = emulate_stats(x.reshape(-1, c), vec, sms=16)
    _, m0, v0 = jax_op(jnp.asarray(x), jnp.ones(c), jnp.zeros(c),
                       impl="interpret")
    _within_tol(mean, var, np.asarray(m0, np.float64),
                np.asarray(v0, np.float64), x.reshape(-1, c))


@pytest.mark.parametrize("m,c,vec", [(25_088, 256, 8), (1000, 96, 8),
                                     (4099, 30, 1), (1, 64, 8)])
def test_emulated_order_against_float64(m, c, vec):
    """The kernel's order against float64 sums, at a ResNet-50 shape
    (bf16 values, 66 row blocks in 4 column tiles) and the ragged,
    scalar-path and M = 1 cases."""
    rng = np.random.RandomState(m + c)
    x = (2 * rng.randn(m, c) + 3 * rng.randn(c)).astype(np.float32)
    if vec == 8:  # bf16 values: keep the top 16 bits
        x = (x.view(np.uint32) & 0xFFFF0000).view(np.float32)
    sums, mean, var = emulate_stats(x, vec)
    x64 = x.astype(np.float64)
    ref_mean = x64.mean(0)
    ref_var = np.maximum((x64 ** 2).mean(0) - ref_mean ** 2, 0)
    _within_tol(mean, var, ref_mean, ref_var, x)
    np.testing.assert_allclose(sums[0], x64.sum(0),
                               atol=1e-5 * np.abs(x64).sum(0).max())
