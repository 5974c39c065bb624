"""The port's Megatron layers against the JAX package's, across processes.

Mirrors ``tests/test_parallel_strategies.py``'s tensor-parallel cases.
The same seeded numpy inputs and weights go through the JAX layers under
``shard_map`` on 2 and 4 of the host devices and through the port's
layers on as many ranks (one process each, gloo over a ``file://``
store, ``spawn_ranks``; one worker set per world size for the module),
each rank holding its slice of the weights:

* ``ColumnParallelDense``, ``RowParallelDense``, ``TensorParallelMlp``
  and ``TensorParallelAttention``: each rank's output against the JAX
  output (its column slice, or the replicated whole), within the JAX
  tests' ``rtol=1e-4``;
* their gradients — the input's, the kernels' slices and the biases' —
  of ``sum(out**2)`` over the global output, against ``jax.grad`` taken
  OUTSIDE the ``shard_map`` (the gradient of the loss counted once),
  within 1e-4 of each leaf's max |grad|.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.parallel.tensor_parallel import (
    ColumnParallelDense as JColumn, RowParallelDense as JRow,
    TensorParallelAttention as JAttention, TensorParallelMlp as JMlp,
)
from test_torch_collectives import spawn_ranks

WORLDS = (2, 4)
RTOL = 1e-4
GRAD_TOL = 1e-4

WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.process_sets import global_process_set as ws
from horovod_tpu_torch.parallel import (
    ColumnParallelDense, RowParallelDense, TensorParallelAttention,
    TensorParallelMlp)
from horovod_tpu_torch.parallel.tensor_parallel import shard_slice

rank, world, store, out, given = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
g = torch.load(given, weights_only=False)
res = {}


def t(a, dim=None):
    return torch.from_numpy(np.ascontiguousarray(
        shard_slice(a, dim, rank, world))).requires_grad_()


def run(name, mod, x, assign):
    with torch.no_grad():
        for key, (arr, dim) in assign.items():
            getattr_path(mod, key).copy_(t(arr, dim))
    y = mod(x)
    (y ** 2).sum().backward()
    res[name + "/out"] = y.detach().numpy()
    res[name + "/dx"] = x.grad.numpy()
    for key in assign:
        res[name + "/d" + key] = getattr_path(mod, key).grad.numpy()


def getattr_path(mod, key):
    for part in key.split("."):
        mod = getattr(mod, part)
    return mod


c = g["column"]
run("column", ColumnParallelDense(6, 16, ws, device="cpu"), t(c["x"]),
    {"kernel": (c["kernel"], 1), "bias": (c["bias"], 0)})
r = g["row"]
run("row", RowParallelDense(16, 6, ws, device="cpu"), t(r["x"], 1),
    {"kernel": (r["kernel"], 0), "bias": (r["bias"], None)})
m = g["mlp"]
run("mlp", TensorParallelMlp(8, 32, ws, device="cpu"), t(m["x"]),
    {"wi.kernel": (m["wi"], 1), "wi.bias": (m["bi"], 0),
     "wo.kernel": (m["wo"], 0), "wo.bias": (m["bo"], None)})
a = g["attn"]
run("attn", TensorParallelAttention(8, 4, 32, ws, device="cpu"), t(a["x"]),
    {"qkv.kernel": (a["qkv"], 1), "proj.kernel": (a["proj"], 0)})
np.savez(out, **res)
hvd.shutdown()
"""


def _inputs():
    rs = np.random.RandomState(0)
    f = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)  # noqa
    return dict(
        column=dict(x=f(4, 6), kernel=f(6, 16), bias=f(16)),
        row=dict(x=f(4, 16), kernel=f(16, 6), bias=f(6)),
        mlp=dict(x=f(2, 5, 8), wi=f(8, 32, scale=0.3), bi=f(32, scale=0.1),
                 wo=f(32, 8, scale=0.3), bo=f(8, scale=0.1)),
        attn=dict(x=f(2, 6, 32), qkv=f(32, 96, scale=0.2),
                  proj=f(32, 32, scale=0.2)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    done = {}

    def get(n):
        if n not in done:
            tmp = tmp_path_factory.mktemp(f"tp{n}")
            torch.save(_inputs(), tmp / "given.pt")
            done[n] = spawn_ranks(WORKER, n, tmp, tmp / "given.pt")
        return done[n]

    return get


def _jax_case(name, n):
    """(output, grads by name) of the JAX layer on n host devices, the
    gradient of sum(out**2) taken outside the shard_map."""
    g = _inputs()[name]
    mesh = Mesh(np.array(jax.devices()[:n]), ("tp",))
    if name == "column":
        mod, specs, out_spec = JColumn(features=16, axis="tp"), (
            P(), {"kernel": P(None, "tp"), "bias": P("tp")}), P(None, "tp")
        params = {"kernel": g["kernel"], "bias": g["bias"]}
    elif name == "row":
        mod, specs, out_spec = JRow(features=6, axis="tp"), (
            P(None, "tp"), {"kernel": P("tp", None), "bias": P()}), P()
        params = {"kernel": g["kernel"], "bias": g["bias"]}
    elif name == "mlp":
        mod, out_spec = JMlp(d_model=8, d_ff=32, axis="tp"), P()
        specs = (P(), {"wi": {"kernel": P(None, "tp"), "bias": P("tp")},
                       "wo": {"kernel": P("tp", None), "bias": P()}})
        params = {"wi": {"kernel": g["wi"], "bias": g["bi"]},
                  "wo": {"kernel": g["wo"], "bias": g["bo"]}}
    else:
        mod, out_spec = JAttention(num_heads=8, head_dim=4, axis="tp"), P()
        specs = (P(), {"qkv": {"kernel": P(None, "tp")},
                       "proj": {"kernel": P("tp", None)}})
        params = {"qkv": {"kernel": g["qkv"]}, "proj": {"kernel": g["proj"]}}
    fwd = jax.shard_map(lambda x, p: mod.apply({"params": p}, x), mesh=mesh,
                        in_specs=specs, out_specs=out_spec, check_vma=False)
    x = jnp.asarray(g["x"])
    params = jax.tree.map(jnp.asarray, params)
    out = jax.jit(fwd)(x, params)
    dx, dp = jax.jit(jax.grad(lambda x, p: (fwd(x, p) ** 2).sum(),
                              argnums=(0, 1)))(x, params)
    return np.asarray(out), np.asarray(dx), jax.tree.map(np.asarray, dp)


_LEAVES = {
    "column": {"kernel": (("kernel",), 1), "bias": (("bias",), 0)},
    "row": {"kernel": (("kernel",), 0), "bias": (("bias",), None)},
    "mlp": {"wi.kernel": (("wi", "kernel"), 1), "wi.bias": (("wi", "bias"), 0),
            "wo.kernel": (("wo", "kernel"), 0),
            "wo.bias": (("wo", "bias"), None)},
    "attn": {"qkv.kernel": (("qkv", "kernel"), 1),
             "proj.kernel": (("proj", "kernel"), 0)},
}


def _slice(a, dim, r, n):
    if dim is None:
        return a
    w = a.shape[dim] // n
    return np.take(a, np.arange(r * w, (r + 1) * w), axis=dim)


def _close_grad(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= GRAD_TOL * scale, f"{what}: {err} > {GRAD_TOL} x {scale}"


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", ["column", "row", "mlp", "attn"])
def test_tp_layer_matches_jax(runs, name, n):
    """Each rank's output is its slice of the JAX output (column) or the
    whole replicated output, within the JAX tests' rtol."""
    res = runs(n)
    out, _dx, _dp = _jax_case(name, n)
    for r in range(n):
        want = _slice(out, 1, r, n) if name == "column" else out
        np.testing.assert_allclose(res[r][f"{name}/out"], want, rtol=RTOL,
                                   atol=1e-5, err_msg=f"rank {r}")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", ["column", "row", "mlp", "attn"])
def test_tp_layer_gradients_match_jax_grad_outside(runs, name, n):
    """The port's f/g gradients equal ``jax.grad`` taken outside the
    ``shard_map``: each rank's kernel and bias slices, the replicated
    leaves whole on every rank, the input's gradient (summed over the
    set for a replicated input, the rank's slice for a sharded one)."""
    res = runs(n)
    _out, dx, dp = _jax_case(name, n)
    for r in range(n):
        _close_grad(res[r][f"{name}/dx"],
                    _slice(dx, 1, r, n) if name == "row" else dx,
                    f"{name} dx rank {r}")
        for key, (path, dim) in _LEAVES[name].items():
            want = dp
            for p in path:
                want = want[p]
            _close_grad(res[r][f"{name}/d{key}"], _slice(want, dim, r, n),
                        f"{name} d{key} rank {r}")
