"""The port's fused BatchNorm(+residual)+ReLU op against the JAX package's.

The same seeded numpy inputs go through ``horovod_tpu.ops.fused_norm.
fused_batch_norm_act`` (its Pallas kernels in interpret mode, as
``tests/test_fused_norm.py`` runs them, and its XLA reference) and
through ``horovod_tpu_torch.ops.fused_norm.fused_batch_norm_act`` on the
CPU (the kernels' plain versions).  Outputs y, mean and var, and the
gradients of x, γ, β and the residual under ``sum(y·dy)``, are compared
at ``test_fused_norm.py``'s tolerances: y 2e-5, mean/var 1e-5 absolute,
gradients 3e-4 absolute + 2e-5 relative — fp32 on both sides, the sums
taken in different orders.  A shape the TPU path cannot tile (C = 24
does not divide its 128 lanes, M = 105) is held against the JAX
reference alone.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from horovod_tpu.ops.fused_norm import fused_batch_norm_act as jax_op
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import fused_norm as fn

CASES = [
    ((4, 8, 8, 256), True, False, ("interpret", "reference")),
    ((4, 8, 8, 256), True, True, ("interpret", "reference")),
    ((4, 8, 8, 256), False, False, ("interpret", "reference")),
    ((8, 4, 4, 64), True, True, ("interpret", "reference")),
    ((3, 5, 7, 24), True, True, ("reference",)),  # untileable on the TPU
]


def _inputs(shape, with_res, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    res = rng.randn(*shape).astype(np.float32) if with_res else None
    dy = rng.randn(*shape).astype(np.float32)
    return x, gamma, beta, res, dy


def _jax_run(impl, x, gamma, beta, res, dy, relu):
    def f(x, gamma, beta, res):
        y, mean, var = jax_op(x, gamma, beta, res, relu=relu, impl=impl)
        return (y * dy).sum(), (y, mean, var)

    argnums = (0, 1, 2) + ((3,) if res is not None else ())
    (_, aux), grads = jax.value_and_grad(f, argnums=argnums, has_aux=True)(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
        None if res is None else jnp.asarray(res))
    return [np.asarray(a) for a in aux], [np.asarray(g) for g in grads]


def _port_run(x, gamma, beta, res, dy, relu, **kw):
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (x, gamma, beta) + ((res,) if res is not None else ())]
    xt, gt, bt = leaves[:3]
    rt = leaves[3] if res is not None else None
    y, mean, var = fn.fused_batch_norm_act(xt, gt, bt, rt, relu=relu, **kw)
    (y * torch.from_numpy(dy)).sum().backward()
    return ([t.detach().numpy() for t in (y, mean, var)],
            [t.grad.numpy() for t in leaves])


@pytest.mark.parametrize("shape,relu,with_res,impls", CASES)
def test_op_matches_jax(shape, relu, with_res, impls):
    args = _inputs(shape, with_res)
    (y, mean, var), grads = _port_run(*args, relu=relu)
    assert y.dtype == np.float32 and y.shape == shape
    for impl in impls:
        (y0, m0, v0), g0 = _jax_run(impl, *args, relu)
        np.testing.assert_allclose(y, y0, atol=2e-5, err_msg=impl)
        np.testing.assert_allclose(mean, m0, atol=1e-5, err_msg=impl)
        np.testing.assert_allclose(var, v0, atol=1e-5, err_msg=impl)
        assert len(grads) == len(g0)
        for a, b in zip(grads, g0):
            np.testing.assert_allclose(a, b, atol=3e-4, rtol=2e-5,
                                       err_msg=impl)


def test_batch_stats_are_biased_and_cotangents_ignored():
    """(mean, var) are the biased batch statistics (the running-stats
    contract), and gradients through them are ignored, as JAX's
    ``_fused_bwd`` ignores their cotangents."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 4, 4, 128).astype(np.float32))
    gamma, beta = torch.ones(128), torch.zeros(128)
    y, mean, var = fn.fused_batch_norm_act(x, gamma, beta, impl="reference")
    xf = x.numpy().reshape(-1, 128)
    np.testing.assert_allclose(mean.numpy(), xf.mean(0), atol=1e-5)
    np.testing.assert_allclose(var.numpy(), xf.var(0), atol=1e-5)
    assert not mean.requires_grad and not var.requires_grad
    xg = x.clone().requires_grad_()
    y, mean, var = fn.fused_batch_norm_act(xg, gamma, beta, relu=False)
    y.sum().backward()
    # sum(y) does not depend on x: its gradient through the batch
    # statistics cancels exactly up to rounding
    assert float(xg.grad.abs().max()) < 1e-5


def test_plain_versions_compose_to_the_op():
    """The four plain versions, called one after another, give the
    op's forward and backward (the chip check compares each kernel with
    the plain version of its own step)."""
    x, gamma, beta, res, dy = _inputs((2, 3, 5, 40), True, seed=2)
    (y, mean, var), grads = _port_run(x, gamma, beta, res, dy, relu=True)
    x2d = torch.from_numpy(x).reshape(-1, 40)
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    m, v, rstd = fn.bn_stats_reference(x2d, 1e-5)
    y2d = fn.bn_apply_reference(x2d, g, b, m, rstd,
                                torch.from_numpy(res).reshape(-1, 40))
    np.testing.assert_array_equal(y2d.numpy().reshape(y.shape), y)
    np.testing.assert_array_equal(m.numpy(), mean)
    np.testing.assert_array_equal(v.numpy(), var)
    dy2d = torch.from_numpy(dy).reshape(-1, 40)
    dbeta, dgamma = fn.bn_bwd_reduce_reference(x2d, dy2d, y2d, m, rstd)
    dx, dres = fn.bn_dx_reference(x2d, dy2d, y2d, g, m, rstd, dbeta, dgamma,
                                  x2d.shape[0], has_residual=True)
    for got, want in ((dx, grads[0]), (dgamma, grads[1]), (dbeta, grads[2]),
                      (dres, grads[3])):
        np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)


@pytest.fixture()
def world_one():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_process_group_at_world_one_is_the_local_op(world_one):
    """The sync-BN seam at world 1 (all-reduces over one rank) gives the
    local op's bits, forward and backward."""
    args = _inputs((4, 3, 3, 16), True, seed=3)
    local = _port_run(*args, relu=True)
    synced = _port_run(*args, relu=True, process_group=dist.group.WORLD)
    for a, b in zip(local[0] + local[1], synced[0] + synced[1]):
        np.testing.assert_array_equal(a, b)


def test_bad_arguments_raise():
    x = torch.zeros(2, 3, 3, 8)
    g, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="impl"):
        fn.fused_batch_norm_act(x, g, b, impl="interpret")
    with pytest.raises(ValueError, match="residual"):
        fn.fused_batch_norm_act(x, g, b, torch.zeros(2, 3, 3, 4))


@pytest.mark.parametrize("m,c,vec", [
    (1_605_632, 64, 8), (401_408, 256, 8), (6_272, 2048, 8),
    (6_272, 2048, 4), (1000, 96, 8), (1000, 30, 1), (7, 3, 1), (1, 1, 1),
])
def test_kernel_layout_covers_every_element(m, c, vec):
    """The launch layout the wrappers hand the kernels: TX a power of
    two up to 32 dividing the block, the column blocks covering every
    channel vector, the row grid within CUDA's limit, and the reduction
    kernels' partials at most one block per 64 rows (and at least one)."""
    tx, gx, gy_stream, gy_reduce = fn._layout(m, c, vec)
    assert tx in (1, 2, 4, 8, 16, 32) and 256 % tx == 0
    cv = c // vec
    assert gx * tx >= cv > (gx - 1) * tx
    ty = 256 // tx
    assert 1 <= gy_stream <= min(65535, -(-m // ty))
    assert 1 <= gy_reduce <= gy_stream
    assert gy_reduce <= max(1, m // 64)
