"""The port's activation remat against the JAX package's.

* ``resolve_remat_policies``, the config's validation and
  ``block_remat_policies``, and ``modeled_activation_bytes`` equal the
  reference's on a grid of configs (dtypes, GQA, per-block tuples; the
  same errors for invalid names and lengths).
* Transparency: under every policy the port's fp32 loss and every
  gradient are bit-identical to its ``none`` run (the recompute repeats
  the forward's arithmetic), and within the transformer bound of the JAX
  model under the same policy: loss to 1e-5 relative, each gradient to
  1e-4 of its largest |entry| (PERF.md §2).
* What a block keeps for its backward, per policy: tensors autograd
  saves (``torch.autograd.graph.saved_tensors_hooks``) plus, for a
  checkpointed block, whose saved tensors the checkpoint holds itself,
  the tensors still alive after the forward; unique storages, the
  parameters, the block input and its output excluded.  Held against
  JAX's ``saved_residuals`` of the same block (arguments and constants
  excluded) with the dense attention both sides' remat papers over
  (``attention_impl="dot"``): ``full`` keeps 0 bytes in both,
  ``dots`` and ``dots_no_batch`` within 25 % of JAX's, and the order
  none > dots > dots_no_batch > full holds.  With ``"flash"``, ``full``
  keeps 0 bytes too: the flash op's ``ctx.save_for_backward`` tensors
  are not held outside the checkpoint.
* ResNet ``remat=True`` against ``remat=False`` (depths [1, 1, 1, 1],
  batch 4 of 64x64, fp32): bit-identical loss, gradients and running
  statistics, every BatchNorm's running statistics moved by exactly one
  forward a step; also at world 2 with sync BN over gloo.
"""

import gc
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax._src.ad_checkpoint import saved_residuals

from horovod_tpu.models import transformer as jt
from horovod_tpu_torch import training
from horovod_tpu_torch.models import (
    ResNet, Transformer, TransformerConfig, params_from_flax,
)
from horovod_tpu_torch.models import resnet as tr
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models import _remat
from horovod_tpu_torch.models._remat import remat_call

from test_torch_collectives import spawn_ranks

POLICIES = ("none", "dots", "dots_no_batch", "full")
MIXED = ("none", "full")
SHAPE = dict(vocab_size=97, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=8, max_seq_len=32)
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(fn):
    """``("ok", value)`` or ``("error", type, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # the two packages must raise alike
        return ("error", type(e).__name__, str(e))


# -- policy names, validation, modeled bytes ----------------------------------

RESOLVE_CASES = [
    (None, 3, "none"), (None, 3, "dots_no_batch"), ("none", 3, "none"),
    ("dots", 2, "none"), ("dots_no_batch", 4, "none"), ("full", 1, "none"),
    (("none", "full", "dots"), 3, "none"), (["full", "dots_no_batch"], 2,
                                            "none"),
    ("everything", 2, "none"), (("none",), 2, "none"),
    (("none", "bogus"), 2, "none"), (None, 2, "bogus"),
]


@pytest.mark.parametrize("policy,layers,default", RESOLVE_CASES)
def test_resolve_remat_policies_matches_reference(policy, layers, default):
    want = _outcome(lambda: jt.resolve_remat_policies(policy, layers,
                                                      default))
    got = _outcome(lambda: tt.resolve_remat_policies(policy, layers,
                                                     default))
    assert got == want
    assert set(tt.REMAT_POLICIES) == set(jt.REMAT_POLICIES)


CONFIG_CASES = [
    dict(), dict(remat=True), dict(remat_policy="dots"),
    dict(remat=True, remat_policy="full"),
    dict(remat_policy=["none", "dots_no_batch"]),
    dict(remat_policy=("full",) * 3), dict(remat_policy="nope"),
]


@pytest.mark.parametrize("kw", CONFIG_CASES)
def test_config_validates_and_resolves_like_reference(kw):
    def ref():
        cfg = jt.TransformerConfig(num_layers=2, **kw)
        return cfg.remat_policy, cfg.block_remat_policies()

    def port():
        cfg = TransformerConfig(num_layers=2, **kw)
        return cfg.remat_policy, cfg.block_remat_policies()

    assert _outcome(port) == _outcome(ref)


DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
          (jnp.float16, torch.float16)]
BYTES_CASES = [
    dict(kv=None, policy=None, remat=False, batch=8, seq=None),
    dict(kv=4, policy="dots", remat=False, batch=3, seq=100),
    dict(kv=1, policy=None, remat=True, batch=2, seq=64),
    dict(kv=2, policy=("none", "dots", "dots_no_batch", "full"),
         remat=False, batch=5, seq=None),
    dict(kv=None, policy="full", remat=False, batch=1, seq=7),
]


@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: str(d[1]))
@pytest.mark.parametrize("case", BYTES_CASES)
def test_modeled_activation_bytes_match_reference(dtypes, case):
    jdt, tdt = dtypes
    common = dict(num_layers=4, num_heads=8, num_kv_heads=case["kv"],
                  head_dim=16, max_seq_len=128, remat=case["remat"],
                  remat_policy=case["policy"])
    want = jt.modeled_activation_bytes(
        jt.TransformerConfig(dtype=jdt, **common), case["batch"], case["seq"])
    got = tt.modeled_activation_bytes(
        TransformerConfig(dtype=tdt, **common), case["batch"], case["seq"])
    assert got == want


# -- numerical transparency ---------------------------------------------------


def _tokens():
    return np.random.RandomState(0).randint(
        0, SHAPE["vocab_size"], (B, S + 1)).astype(np.int32)


def _jax_loss_grads(policy, impl):
    cfg = jt.TransformerConfig(dtype=jnp.float32, attention_impl=impl,
                               remat_policy=policy, **SHAPE)
    model = jt.Transformer(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, S), jnp.int32),
                        train=False)["params"]
    toks = jnp.asarray(_tokens())

    def loss_fn(p):
        logits = model.apply({"params": p}, toks[:, :-1], train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, toks[:, 1:]).mean()

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return (jax.tree.map(np.asarray, params), float(loss),
            jax.tree.map(np.asarray, grads))


def _port_loss_grads(init_tree, policy, impl):
    cfg = TransformerConfig(dtype=torch.float32, attention_impl=impl,
                            remat_policy=policy, **SHAPE)
    model = Transformer(cfg, params=params_from_flax(
        init_tree, cfg, device="cpu", param_dtype=torch.float32))
    toks = torch.from_numpy(_tokens()).long()
    loss = training.softmax_cross_entropy(model(toks[:, :-1]), toks[:, 1:])
    loss.backward()
    return cfg, loss.detach(), {k: p.grad.clone()
                                for k, p in model.named_parameters()}


@pytest.mark.parametrize("impl", ["dot", "flash"])
@pytest.mark.parametrize("policy", ["dots", "dots_no_batch", "full", MIXED])
def test_transformer_remat_is_transparent(policy, impl):
    init, jloss, jgrads = _jax_loss_grads(policy, impl)
    _, loss0, grads0 = _port_loss_grads(init, "none", impl)
    cfg, loss, grads = _port_loss_grads(init, policy, impl)
    assert torch.equal(loss, loss0)
    for k, g in grads.items():
        assert torch.equal(g, grads0[k]), k
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5, atol=0)
    want = params_from_flax(jgrads, cfg, device="cpu",
                            param_dtype=torch.float32)
    for k, g in grads.items():
        ref = want[k].numpy()
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (k, err)


def test_remat_applies_only_in_training_with_grad(monkeypatch):
    """Eval mode and no-grad forwards run the blocks plainly (the JAX
    model remats only with ``train=True``, never on the paged path)."""
    cfg = TransformerConfig(dtype=torch.float32, remat_policy="full",
                            **SHAPE)
    init, *_ = _jax_loss_grads("none", "dot")
    model = Transformer(cfg, params=params_from_flax(
        init, cfg, device="cpu", param_dtype=torch.float32))
    toks = torch.from_numpy(_tokens()[:, :-1]).long()
    calls = []
    real = _remat.checkpoint

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(_remat, "checkpoint", spy)
    with torch.no_grad():
        model(toks)
    model.eval()
    model(toks)
    assert calls == []
    model.train()
    model(toks)
    assert len(calls) == SHAPE["num_layers"]


# -- what a block keeps for its backward --------------------------------------


def _python_storages():
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for o in gc.get_objects():
            if isinstance(o, torch.Tensor):
                st = o.untyped_storage()
                out[st.data_ptr()] = st.nbytes()
    return out


def _port_saved_bytes(block, x, pos, policy):
    skip = set(_python_storages())
    skip |= {p.untyped_storage().data_ptr() for p in block.parameters()}
    skip.add(x.untyped_storage().data_ptr())
    saved = {}

    def pack(t):
        saved[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = remat_call(block, policy, x, pos)
    saved.update(_python_storages())
    saved.pop(out.untyped_storage().data_ptr(), None)
    return sum(n for ptr, n in saved.items() if ptr not in skip)


def _jax_saved_bytes(impl):
    """JAX's saved-residual bytes of ``layer_0`` of a model inited from
    PRNGKey(0), per policy, with the block's params and inputs."""
    cfg = jt.TransformerConfig(dtype=jnp.float32, attention_impl=impl,
                               **SHAPE)
    params = jt.Transformer(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, S), jnp.int32),
        train=False)["params"]
    block = jt.Block(cfg)
    x = jnp.asarray(np.random.RandomState(1).randn(
        B, S, cfg.d_model).astype(np.float32))
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    variables = {"params": params["layer_0"]}

    def f(v, x):
        return block.apply(v, x, pos).sum()

    out = {}
    for policy in POLICIES:
        g = f if policy == "none" else jax.checkpoint(
            f, policy=jt._checkpoint_policy(policy))
        out[policy] = sum(
            aval.size * aval.dtype.itemsize
            for aval, why in saved_residuals(g, variables, x)
            if "argument" not in why and "constant" not in why)
    return jax.tree.map(np.asarray, params), x, pos, out


def test_saved_bytes_per_policy_match_jax():
    params, x, pos, want = _jax_saved_bytes("dot")
    cfg = TransformerConfig(dtype=torch.float32, attention_impl="dot",
                            **SHAPE)
    block = Transformer(cfg, params=params_from_flax(
        params, cfg, device="cpu", param_dtype=torch.float32)).layer_0
    xt = torch.tensor(np.asarray(x), requires_grad=True)
    post = torch.from_numpy(np.asarray(pos)).long()
    got = {p: _port_saved_bytes(block, xt, post, p) for p in POLICIES}
    msg = f"port {got} vs JAX {want}"
    assert got["full"] == want["full"] == 0, msg
    for p in ("dots", "dots_no_batch"):
        assert abs(got[p] - want[p]) <= 0.25 * want[p], msg
    assert got["none"] > got["dots"] > got["dots_no_batch"] > got["full"], msg
    assert want["none"] > want["dots"] > want["dots_no_batch"], msg


def test_flash_block_under_full_keeps_nothing():
    cfg = TransformerConfig(dtype=torch.float32, attention_impl="flash",
                            **SHAPE)
    init, *_ = _jax_loss_grads("none", "dot")
    block = Transformer(cfg, params=params_from_flax(
        init, cfg, device="cpu", param_dtype=torch.float32)).layer_0
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(
        3), requires_grad=True)
    pos = torch.arange(S).expand(B, S)
    got = {p: _port_saved_bytes(block, x, pos, p) for p in POLICIES}
    assert got["full"] == 0, got
    assert got["none"] > got["dots_no_batch"] > 0, got


# -- ResNet --------------------------------------------------------------------


def _resnet(remat, bn_group=None):
    return ResNet(stage_sizes=[1, 1, 1, 1], block_cls=tr.BottleneckBlock,
                  num_filters=8, num_classes=10, dtype=torch.float32,
                  stem="space_to_depth", remat=remat, bn_group=bn_group,
                  device="cpu", generator=torch.Generator().manual_seed(0))


def _resnet_batch(seed=1, n=4):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(n, 64, 64, 3).astype(np.float32)),
            torch.from_numpy(rs.randint(0, 10, (n,))).long())


def _resnet_step(model, images, labels):
    """One forward and backward; (loss, gradients, running statistics,
    per-norm forwards that moved / left alone the running statistics)."""
    moved, kept = [], []

    def hook(m, _inputs):
        (kept if m.recomputing else moved).append(m)

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, tr.BatchNorm)]
    try:
        loss = training.softmax_cross_entropy(model(images), labels)
        loss.backward()
    finally:
        for h in handles:
            h.remove()
    return (loss.detach(), [p.grad.clone() for p in model.parameters()],
            [t.clone() for t in tr.running_stats(model)], moved, kept)


def test_resnet_remat_is_transparent_and_moves_stats_once():
    images, labels = _resnet_batch()
    plain = _resnet(False)
    remat = _resnet(True)
    a = _resnet_step(plain, images, labels)
    b = _resnet_step(remat, images, labels)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    norms = [m for m in remat.modules() if isinstance(m, tr.BatchNorm)]
    in_blocks = [m for name in remat.block_names
                 for m in getattr(remat, name).modules()
                 if isinstance(m, tr.BatchNorm)]
    # every norm moved its statistics exactly once; each block's norms
    # ran once more in the backward, leaving them alone; the stem's not
    assert sorted(map(id, b[3])) == sorted(map(id, norms))
    assert sorted(map(id, b[4])) == sorted(map(id, in_blocks))
    assert len(in_blocks) == len(norms) - 1 and a[4] == []
    assert not any(m.recomputing for m in norms)


SYNC_WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import ResNet
from horovod_tpu_torch.models import resnet as tr

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
rs = np.random.RandomState(10 + rank)
images = torch.from_numpy(rs.randn(2, 64, 64, 3).astype(np.float32))
labels = torch.from_numpy(rs.randint(0, 10, (2,))).long()
res = {}
for remat in (False, True):
    model = ResNet(stage_sizes=[1, 1, 1, 1], block_cls=tr.BottleneckBlock,
                   num_filters=8, num_classes=10, dtype=torch.float32,
                   stem="space_to_depth", remat=remat, bn_group=tr.WORLD,
                   device="cpu", generator=torch.Generator().manual_seed(0))
    loss = training.softmax_cross_entropy(model(images), labels)
    loss.backward()
    res[f"loss_{remat}"] = loss.detach().numpy()
    for i, p in enumerate(model.parameters()):
        res[f"grad{i}_{remat}"] = p.grad.numpy()
    for i, t in enumerate(tr.running_stats(model)):
        res[f"stat{i}_{remat}"] = t.numpy()
hvd.shutdown()
np.savez(out, **res)
"""


def test_resnet_remat_sync_bn_world2(tmp_path):
    """Sync BN over gloo at world 2: the recompute repeats the statistics
    all-reduce on both ranks in one order; loss, gradients and running
    statistics bit-identical with and without remat on every rank."""
    for res in spawn_ranks(SYNC_WORKER, 2, tmp_path):
        keys = sorted(k[:-len("_False")] for k in res if k.endswith("_False"))
        assert len(keys) > 3
        for k in keys:
            np.testing.assert_array_equal(res[f"{k}_True"], res[f"{k}_False"],
                                          err_msg=k)
