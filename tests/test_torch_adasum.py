"""Adasum against the JAX package's ``adasum_combine_rows``.

One process per rank over gloo (``spawn_ranks``) at world 2, 3 and 4:
each rank Adasum-allreduces its vector (``allreduce(op=Adasum)`` and
``adasum_allreduce`` on a dict of two leaves), and the JAX side combines
the stacked rows with ``horovod_tpu.ops.adasum.adasum_combine_rows``.
Adasum is not associative, so this holds the pairing too (the ranks past
the largest power of two fold first, then the XOR hypercube).

* ±1 vectors of 16 entries (times a power of two): every norm is a
  power of two, so the first round's coefficients (the fold's at world
  3) are dyadic, and at up to four ranks every dot product the pairing
  takes is exact in fp32 whatever the order of its sum.  The two sides
  must then agree bit for bit.
* seeded normal fp32 vectors of 1000 entries: dot products may round
  differently (XLA's sum against torch's), so the result must agree to
  1e-6 of the largest |value| (observed: 0, the sums happened to round
  alike on this data).

Every rank must hold the same result.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from horovod_tpu.ops.adasum import adasum_combine_rows as jax_combine
from horovod_tpu_torch.ops.adasum import adasum_combine_rows

from test_torch_collectives import spawn_ranks

REL_TOL = 1e-6

HELPERS = r"""
import numpy as np


def exact_vec(rank):
    rs = np.random.RandomState(500 + rank)
    return (rs.choice([-1.0, 1.0], 16) * 2.0 ** -(rank % 3)).astype(
        np.float32)


def normal_vec(rank):
    return np.random.RandomState(600 + rank).randn(1000).astype(np.float32)
"""
exec(HELPERS)

WORKER = HELPERS + r"""
import sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops.adasum import adasum_allreduce

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
res = {}
for name, make in (("exact", exact_vec), ("normal", normal_vec)):
    v = torch.from_numpy(make(rank))
    res[name] = hvd.allreduce(v, op=hvd.Adasum).numpy()
    tree = adasum_allreduce({"a": v[:5].view(1, 5), "b": v[5:]})
    res[name + "_tree"] = torch.cat([tree["a"].reshape(-1),
                                     tree["b"]]).numpy()
np.savez(out, **res)
hvd.shutdown()
"""


@pytest.mark.parametrize("world", [2, 3, 4])
def test_adasum_matches_jax_combine_rows(world, tmp_path):
    got = spawn_ranks(WORKER, world, tmp_path)
    for name, make in (("exact", exact_vec), ("normal", normal_vec)):
        want = np.asarray(jax_combine(jnp.stack(
            [jnp.asarray(make(r)) for r in range(world)])))
        for r in range(world):
            for key in (name, name + "_tree"):
                a = got[r][key]
                assert a.dtype == np.float32 and a.shape == want.shape
                np.testing.assert_array_equal(a, got[0][key])
                if name == "exact":
                    np.testing.assert_array_equal(a, want, err_msg=key)
                else:
                    err = np.abs(a - want).max() / np.abs(want).max()
                    assert err <= REL_TOL, (key, err)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_combine_rows_matches_jax(n):
    """The port's in-process combination against the JAX one: bit-equal
    on the ±1 rows up to 4 (their dot products are exact up to the last
    round, and 4 rows take two), within the fp32 tolerance past that and
    on normal rows."""
    rows = np.stack([exact_vec(r) for r in range(n)])
    got = adasum_combine_rows(torch.from_numpy(rows)).numpy()
    want = np.asarray(jax_combine(jnp.asarray(rows)))
    if n <= 4:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()
    rows = np.stack([normal_vec(r) for r in range(n)])
    got = adasum_combine_rows(torch.from_numpy(rows)).numpy()
    want = np.asarray(jax_combine(jnp.asarray(rows)))
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()
    # bf16 gradients: fp32 dot products, bf16 coefficients and combine
    half = torch.from_numpy(rows).bfloat16()
    got = adasum_combine_rows(half)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_combine(jnp.asarray(half.float().numpy(),
                                              jnp.bfloat16))
                      .astype(jnp.float32))
    assert np.abs(got.float().numpy() - want).max() <= \
        2 ** -7 * np.abs(want).max()
