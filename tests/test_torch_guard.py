"""The port's integrity guard (``horovod_tpu_torch.guard``) against the
JAX package's (``horovod_tpu.guard``).

* Digests: the port's ``host_digest`` equals the reference's bit for
  bit on fp32, fp16, bf16 (``ml_dtypes``), int8, uint8, bool, int32,
  int64/fp64 (the 32-bit cast rule), words near 0xFFFFFFFF, leaves
  longer than 2^16 elements and nested dict/list trees; the port's
  ``device_digest`` over torch tensors equals both (and the reference's
  jax ``device_digest``).
* Exchange, agreement, attribution, rollback and the loop fuse: each
  test of ``tests/test_guard.py`` on the port's guard, plus mixed
  ``FileBoardExchange`` boards where ranks of both packages share one
  directory and reach the all-reference verdict.
* The training steps: the guarded data-parallel and ZeRO steps (the
  ``MLP`` of ``models/simple.py`` and gpt_tiny) are bit-identical to
  the unguarded ones with the same number of ``torch.distributed``
  calls, at world 1 here and at world 2 over gloo in spawned ranks
  (``test_torch_guard_world2``-style cases below); the diag digest is
  the host digest of the post-reduction gradients.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import ml_dtypes

from horovod_tpu import guard as jguard
from horovod_tpu_torch import checkpoint as tckpt
from horovod_tpu_torch import guard, training
from horovod_tpu_torch.elastic import ObjectState

ROOT = Path(__file__).resolve().parents[1]


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A tensor holding ``a``'s bits (bf16 through its 16-bit words,
    uint32 through int32)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(np.ascontiguousarray(a).copy())


_RS = np.random.RandomState(7)
DIGEST_CASES = {
    "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
    "i32": np.arange(5, dtype=np.int32),
    "f16": np.ones((3,), np.float16),
    "bool": np.array([True, False, True]),
    "f64": np.arange(4, dtype=np.float64),
    "f32_random": _RS.randn(7, 5).astype(np.float32),
    "bf16": _RS.randn(9).astype(ml_dtypes.bfloat16),
    "i8": _RS.randint(-128, 128, (13,)).astype(np.int8),
    "u8": _RS.randint(0, 256, (13,)).astype(np.uint8),
    "i64": _RS.randint(-2 ** 40, 2 ** 40, (17,)).astype(np.int64),
    "f64_random": _RS.randn(6),
    "near_max_words": _RS.randint(0xFFFF0000, 0xFFFFFFFF, (4099,),
                                  dtype=np.uint64).astype(np.uint32),
    "long_leaf": _RS.randn(70001).astype(np.float32),
    "long_near_max": np.full((1 << 17) + 3, 0xFFFFFFFF, np.uint32),
}


@pytest.mark.parametrize("name", sorted(DIGEST_CASES))
def test_host_digest_equals_device_digest(name):
    """Reference ``host_digest`` == port ``host_digest`` (numpy and
    tensor inputs) == port ``device_digest`` == reference jax
    ``device_digest``."""
    a = DIGEST_CASES[name]
    want = jguard.host_digest([a])
    np.testing.assert_array_equal(guard.host_digest([a]), want)
    np.testing.assert_array_equal(guard.host_digest([_tensor(a)]), want)
    dev = guard.device_digest([_tensor(a)])
    assert dev.dtype == torch.int64 and dev.shape == (2,)
    np.testing.assert_array_equal(dev.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(np.asarray(jguard.device_digest([a])),
                                  want)


def test_digest_bf16_and_nested_tree():
    tree = {"b": {"c": DIGEST_CASES["i8"], "a": DIGEST_CASES["f32"]},
            "a": [DIGEST_CASES["bf16"], None, DIGEST_CASES["bool"]],
            "z": (DIGEST_CASES["i64"],)}
    ttree = {"b": {"c": _tensor(DIGEST_CASES["i8"]),
                   "a": _tensor(DIGEST_CASES["f32"])},
             "a": [_tensor(DIGEST_CASES["bf16"]), None,
                   _tensor(DIGEST_CASES["bool"])],
             "z": (_tensor(DIGEST_CASES["i64"]),)}
    want = jguard.host_digest(tree)
    np.testing.assert_array_equal(guard.host_digest(tree), want)
    np.testing.assert_array_equal(
        guard.device_digest(ttree).numpy().astype(np.uint32), want)


def test_device_digest_packs_and_chunks(monkeypatch):
    """Leaves of one dtype pack into one row-aligned buffer (ints and
    floats interleaved, a scalar, a non-contiguous leaf), the fold
    reads it in chunks of rows, and a second call reuses the packing
    with new contents: the lanes stay the reference's."""
    leaves = [_RS.randn(1000, 37).astype(np.float32) for _ in range(5)]
    leaves += [_RS.randn(3).astype(np.float32), np.arange(5000, dtype=np.int8),
               np.float32(2.5), _RS.randn(40, 30).astype(np.float32).T]
    monkeypatch.setattr(guard, "_CHUNK_ROWS", 4)
    for scale in (1, 3):
        xs = [x * scale if x.dtype != np.int8 else x for x in leaves]
        got = guard.device_digest([torch.from_numpy(np.asarray(x))
                                   for x in xs])
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      jguard.host_digest(xs))
    assert guard.grad_diag([torch.ones(3), torch.tensor([1.0, np.nan])])[1] \
        .item() is False


def test_digest_catches_any_single_bit_flip():
    """Lane 0's odd multipliers make a single flipped bit PROVABLY
    visible — host and device folds alike."""
    base = np.ones((64,), np.float32)
    d0 = guard.host_digest([base])
    t0 = guard.device_digest([torch.from_numpy(base)])
    for word, bit in [(0, 0), (17, 3), (31, 22), (63, 31), (40, 15)]:
        mutant = base.copy()
        mutant.view(np.uint32)[word] ^= np.uint32(1 << bit)
        assert (guard.host_digest([mutant]) != d0).any(), (word, bit)
        assert (guard.device_digest([torch.from_numpy(mutant)])
                != t0).any(), (word, bit)


def test_digest_is_content_deterministic_and_order_sensitive():
    a = np.arange(8, dtype=np.float32)
    np.testing.assert_array_equal(guard.host_digest([a]),
                                  guard.host_digest([a.copy()]))
    # leaf order participates (the fold salts by leaf index)
    assert (guard.host_digest([a, a * 2]) !=
            guard.host_digest([a * 2, a])).any()
    t = torch.from_numpy(a)
    assert (guard.device_digest([t, t * 2]) !=
            guard.device_digest([t * 2, t])).any()


def test_allfinite_sentinel():
    assert bool(guard.device_allfinite(
        {"a": torch.ones(3), "b": torch.arange(3)}))
    assert not bool(guard.device_allfinite(
        {"a": torch.tensor([1.0, float("nan")])}))
    assert not bool(guard.device_allfinite([torch.tensor([float("inf")])]))
    assert not bool(guard.device_allfinite(
        (torch.tensor(1.0), [torch.ones(4, dtype=torch.bfloat16),
                             torch.tensor([-float("inf")])])))
    # int-only trees are vacuously finite
    assert bool(guard.device_allfinite([torch.arange(4)]))
    assert bool(guard.device_allfinite([]))


# -- exchange + agreement ----------------------------------------------------


def _run_ranks(board, world, fn, packages=None):
    """Drive one guard per rank on threads; ``packages[r]`` picks rank
    r's guard module (the port's by default).  Returns {rank: result}."""
    results = {}
    mods = packages or [guard] * world

    def _one(rank):
        mod = mods[rank]
        ex = mod.FileBoardExchange(str(board), timeout=20)
        g = mod.IntegrityGuard(
            cadence=4, world=world, rank=rank, exchange=ex,
            exit_fn=lambda code: results.setdefault(("exit", rank), code))
        results[rank] = fn(g, rank)

    ts = [threading.Thread(target=_one, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts), "a guard rank hung"
    return results


CLEAN = guard.host_digest([np.ones((), np.float32)])


@pytest.fixture(autouse=True)
def _clean_guard_env():
    """Rollback arms cross-execv env markers; tests must not leak them
    into each other (the fuse counter would accumulate)."""
    markers = (guard.ENV_ROLLBACK_T0, guard.ENV_GEN,
               guard.ENV_ROLLBACK_COUNT, guard.ENV_ROLLBACK_STEP,
               guard.ENV_VERIFIED)
    for k in markers:
        os.environ.pop(k, None)
    yield
    for k in markers:
        os.environ.pop(k, None)


def _bad_digest():
    x = np.ones((), np.float32)
    x.reshape(-1).view(np.uint32)[0] ^= np.uint32(1 << 22)
    return guard.host_digest([x])


def test_agreement_verified_advances_watermark(tmp_path):
    def fn(g, rank):
        g.observe_grads(3, CLEAN)
        g.observe_grads(4, torch.from_numpy(CLEAN.astype(np.int64)))
        v = g.check(4, loss=1.0)
        return v, g.last_verified_step

    out = _run_ranks(tmp_path, 2, fn)
    for rank in (0, 1):
        v, watermark = out[rank]
        assert v.ok and v.kind == "verified"
        assert watermark == 4


def test_pairwise_mismatch_recompute_vote_attributes_the_liar(tmp_path):
    """Two ranks disagree — no majority.  The redundant-recompute vote:
    the corrupt rank's own recompute contradicts what it published, so
    it attributes ITSELF, and the verdict round tells the survivor."""
    def fn(g, rank):
        for s in (1, 2, 3, 4):
            g.observe_grads(
                s, _bad_digest() if (rank == 1 and s == 2) else CLEAN)
        return g.check(4, loss=4.0, recompute=lambda s: CLEAN)

    out = _run_ranks(tmp_path, 2, fn)
    for rank in (0, 1):
        v = out[rank]
        assert not v.ok and v.kind == "mismatch"
        assert v.attributed == [1]
        assert v.divergent_step == 2
        assert v.self_attributed == (rank == 1)


def test_majority_vote_attributes_without_recompute(tmp_path):
    def fn(g, rank):
        for s in (1, 2, 3, 4):
            g.observe_grads(
                s, _bad_digest() if (rank == 2 and s == 3) else CLEAN)
        return g.check(4, loss=4.0)  # no recompute hook at all

    out = _run_ranks(tmp_path, 3, fn)
    for rank in range(3):
        assert out[rank].attributed == [2], out[rank]
        assert out[rank].self_attributed == (rank == 2)


def test_param_only_divergence_without_recompute_is_unattributed(tmp_path):
    """Identical windows but diverged param fingerprints and no
    majority: nobody is named — rollback-for-everyone."""
    def fn(g, rank):
        g.observe_grads(4, CLEAN)
        pd = _bad_digest() if rank == 1 else CLEAN
        return g.check(4, loss=4.0, param_digest=pd)

    out = _run_ranks(tmp_path, 2, fn)
    for rank in (0, 1):
        v = out[rank]
        assert not v.ok and v.kind == "mismatch"
        assert v.attributed == [] and not v.self_attributed
        assert v.divergent_step is None


def test_board_generation_hides_stale_entries(tmp_path):
    """Entries from before a rollback must read as ABSENT, not fresh."""
    ex0 = guard.FileBoardExchange(str(tmp_path), timeout=5, generation=0)
    ex0.gather("chk-4", b"stale", world=1, rank=0)  # publishes rank0 file
    ex1 = guard.FileBoardExchange(str(tmp_path), timeout=0.3, generation=1)
    out = ex1.gather("chk-4", b"fresh", world=2, rank=1)
    assert out[1] == b"fresh"
    assert out[0] is None  # gen-0 entry treated as not-yet-posted
    # same generation DOES read — across packages too
    ex1b = jguard.FileBoardExchange(str(tmp_path), timeout=5, generation=1)
    out = ex1b.gather("chk-4", b"peer", world=2, rank=0)
    assert out[1] == b"fresh"


def test_missing_peer_times_out_to_partial_not_failure(tmp_path):
    ex = guard.FileBoardExchange(str(tmp_path), timeout=0.3)
    g = guard.IntegrityGuard(cadence=4, world=2, rank=0, exchange=ex)
    g.observe_grads(4, CLEAN)
    v = g.check(4, loss=1.0)
    assert v.ok and v.kind == "partial"
    # an unverified window must NOT advance the rollback watermark
    assert g.last_verified_step == 0


MIXES = {
    "ref_port_ref_liar1": ((jguard, guard, jguard), 1),
    "port_ref_port_liar2": ((guard, jguard, guard), 2),
    "port_port_ref_liar0": ((guard, guard, jguard), 0),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_mixed_package_board_attributes_like_the_reference(tmp_path, mix):
    """Three ranks on one board, some running the reference's guard and
    some the port's, one publishing a wrong digest at step 3: every
    rank's verdict and attribution equal those of an all-reference
    board."""
    packages, liar = MIXES[mix]

    def fn(g, rank):
        for s in (1, 2, 3, 4):
            g.observe_grads(
                s, _bad_digest() if (rank == liar and s == 3) else CLEAN)
        v = g.check(4, loss=4.0, param_digest=CLEAN)
        return (v.ok, v.kind, list(v.attributed), v.self_attributed,
                v.divergent_step)

    mixed = _run_ranks(tmp_path / "mixed", 3, fn, packages)
    want = _run_ranks(tmp_path / "ref", 3, fn, (jguard,) * 3)
    assert mixed == want
    assert want[0][2] == [liar]


# -- local detectors ---------------------------------------------------------


def test_nan_verdict_and_respond_raises_integrity_error(tmp_path):
    g = guard.IntegrityGuard(cadence=1, world=1,
                             ckpt_dir=str(tmp_path / "ck"))
    v = g.check(1, loss=float("nan"))
    assert not v.ok and v.kind == "nan"
    with pytest.raises(guard.IntegrityError):
        g.respond(v)


def test_finite_flag_false_trips_without_loss(tmp_path):
    g = guard.IntegrityGuard(cadence=1, world=1)
    v = g.check(1, finite=False)
    assert not v.ok and v.kind == "nan"


def test_loss_spike_is_advisory():
    g = guard.IntegrityGuard(cadence=1, world=1, spike=5.0)
    for i in range(1, 5):
        v = g.check(i, loss=1.0)
        assert v.ok and not v.spike
    v = g.check(5, loss=100.0)
    assert v.ok and v.spike  # flagged, never failing by itself
    # spike=0 disables the detector
    g2 = guard.IntegrityGuard(cadence=1, world=1, spike=0.0)
    for i in range(1, 6):
        assert not g2.check(i, loss=10.0 ** i).spike


# -- rollback ----------------------------------------------------------------


def test_rollback_discards_poisoned_window_and_raises(tmp_path):
    ckpt = str(tmp_path / "ring")
    state = ObjectState(step=0, weight=torch.zeros(()))
    for step in range(1, 7):
        state.step = step
        tckpt.save_state_checkpoint(ckpt, state, step, keep=10)
    g = guard.IntegrityGuard(cadence=4, world=1, ckpt_dir=ckpt)
    g.last_verified_step = 4
    with pytest.raises(guard.IntegrityError):
        g.rollback(reason="test", step=6)
    step, _snap = tckpt.peek_state_checkpoint(ckpt)
    assert step == 4  # 5 and 6 were inside the poisoned window
    # the restart markers were armed for the (not-taken) exec path
    assert os.environ.pop(guard.ENV_GEN) == "1"
    t0 = os.environ.pop(guard.ENV_ROLLBACK_T0)
    assert float(t0) > 0
    # a fresh guard books the rollback wall time from the marker
    os.environ[guard.ENV_ROLLBACK_T0] = t0
    g2 = guard.IntegrityGuard(cadence=4, world=1)
    assert g2.last_rollback_s is not None and g2.last_rollback_s >= 0
    assert guard.ENV_ROLLBACK_T0 not in os.environ


def test_rollback_loop_fuse_refuses_deterministic_reproduction():
    """The same step tripping repeatedly must NOT restart forever: past
    HVD_TPU_GUARD_MAX_ROLLBACKS the guard refuses with a clear error —
    and a verified check PAST the tripping step disarms the fuse."""
    g = guard.IntegrityGuard(cadence=4, world=1)
    g.max_rollbacks = 2
    for _ in range(2):
        with pytest.raises(guard.IntegrityError, match="rolled the"):
            g.rollback(reason="nan", step=8)  # the normal rollback
    with pytest.raises(guard.IntegrityError,
                       match="refusing another restart"):
        g.rollback(reason="nan", step=8)  # fuse blown
    # the env markers survive an execv: a fresh guard inherits the fuse
    g2 = guard.IntegrityGuard(cadence=4, world=1)
    assert g2._rollback_count == 2 and g2._rollback_barrier == 8
    # a verified check at a step BEYOND the barrier disarms it
    g2.check(12, loss=1.0)
    assert g2._rollback_count == 0 and g2._rollback_barrier == -1
    assert guard.ENV_ROLLBACK_COUNT not in os.environ
    # ...and rolling back again afterwards starts a fresh count
    with pytest.raises(guard.IntegrityError, match="rolled the"):
        g2.rollback(reason="nan", step=16)


def test_respond_quarantines_self_attributed(tmp_path):
    codes = []
    g = guard.IntegrityGuard(cadence=1, world=1,
                             exit_fn=lambda c: codes.append(c))
    v = guard.Verdict(step=4, ok=False, kind="mismatch", attributed=[0],
                      self_attributed=True)
    g.respond(v)
    assert codes == [guard.QUARANTINE_EXIT] == [jguard.QUARANTINE_EXIT]


def test_discard_newer_than_is_concurrency_tolerant(tmp_path):
    ckpt = str(tmp_path)
    state = ObjectState(step=0)
    for step in (1, 2, 3):
        tckpt.save_state_checkpoint(ckpt, state, step, keep=10)
    removed = tckpt.discard_newer_than(ckpt, 1)
    assert sorted(os.path.basename(p) for p in removed) == \
        ["ckpt-2", "ckpt-3"]
    assert tckpt.discard_newer_than(ckpt, 1) == []


def test_nan_rank_still_joins_the_exchange(tmp_path):
    """A NaN-tripped rank must NOT bail before the exchange: the nan
    flag rides the payload — both ranks verdict 'nan' in the same
    number of rounds, nobody hangs."""
    def fn(g, rank):
        g.observe_grads(4, CLEAN)
        return g.check(4, loss=float("nan") if rank == 1 else 1.0)

    out = _run_ranks(tmp_path, 2, fn)
    for rank in (0, 1):
        v = out[rank]
        assert not v.ok and v.kind == "nan", (rank, v)
        assert not v.self_attributed  # nan names a value, not a rank
    assert "rank(s) [1]" in out[0].detail


def test_verified_watermark_survives_the_rollback_restart():
    g = guard.IntegrityGuard(cadence=4, world=1)
    g.check(32, loss=1.0)  # verified: watermark 32, env armed
    assert os.environ[guard.ENV_VERIFIED] == "32"
    g2 = guard.IntegrityGuard(cadence=4, world=1)
    assert g2.last_verified_step == 32


def test_majority_vote_never_attributes_an_absent_vote(tmp_path):
    """A rank whose window lacks the divergent step casts NO vote."""
    def fn(g, rank):
        for s in (1, 2, 3, 4):
            if rank == 3 and s <= 2:
                continue  # rank 3 joined mid-window: no entry at s=2
            g.observe_grads(
                s, _bad_digest() if (rank == 2 and s == 2) else CLEAN)
        return g.check(4, loss=4.0)

    out = _run_ranks(tmp_path, 4, fn)
    for rank in range(4):
        assert out[rank].attributed == [2], (rank, out[rank])
        assert out[rank].self_attributed == (rank == 2)


def test_absent_param_fingerprint_is_abstention_not_mismatch(tmp_path):
    def fn(g, rank):
        g.observe_grads(4, CLEAN)
        pd = CLEAN if rank == 0 else None
        v = g.check(4, loss=1.0, param_digest=pd)
        return v, g.last_verified_step

    out = _run_ranks(tmp_path, 2, fn)
    for rank in (0, 1):
        v, watermark = out[rank]
        assert v.ok and v.kind == "verified", (rank, v)
        assert watermark == 4


def test_from_env_knobs(monkeypatch, tmp_path):
    """The HVD_TPU_GUARD_* knobs, and the board exchange for a world
    of more than one."""
    monkeypatch.setenv("HVD_TPU_GUARD", "1")
    monkeypatch.setenv("HVD_TPU_GUARD_CADENCE", "5")
    monkeypatch.setenv("HVD_TPU_GUARD_SPIKE", "3.5")
    monkeypatch.setenv("HVD_TPU_GUARD_BOARD", str(tmp_path))
    g = guard.IntegrityGuard.from_env(world=2, rank=1)
    assert g.enabled and g.cadence == 5 and g.spike == 3.5
    assert isinstance(g.exchange, guard.FileBoardExchange)
    monkeypatch.delenv("HVD_TPU_GUARD_BOARD")
    assert isinstance(guard.IntegrityGuard.from_env(world=2, rank=0)
                      .exchange, guard.CollectiveExchange)
    assert guard.IntegrityGuard.from_env(world=1, rank=0).exchange is None


# -- training-step threading -------------------------------------------------

#: counts every torch.distributed call a step makes (shared with the
#: world-2 worker below)
COUNTER = r'''
import torch.distributed as _dist
from horovod_tpu_torch.ops import collective_ops as _co

CALLS = []
_NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor",
          "all_gather_single", "reduce_scatter_tensor",
          "reduce_scatter_single", "all_to_all_single", "all_to_all",
          "broadcast", "barrier", "all_gather_object",
          "broadcast_object_list", "batch_isend_irecv", "send", "recv",
          "isend", "irecv", "gather", "scatter", "reduce")


def _wrap(name, fn):
    def counted(*a, **k):
        CALLS.append(name)
        return fn(*a, **k)
    return counted


def install_counter():
    for n in _NAMES:
        if hasattr(_dist, n):
            setattr(_dist, n, _wrap(n, getattr(_dist, n)))
    _co._all_gather_flat = _wrap("all_gather_flat", _co._all_gather_flat)
    _co._reduce_scatter_flat_op = _wrap("reduce_scatter_flat",
                                        _co._reduce_scatter_flat_op)
'''

#: the models and steps both worlds run
HELPERS = r'''
import numpy as np
import torch
from horovod_tpu_torch import guard, training
from horovod_tpu_torch.models import MLP, Transformer, gpt_tiny, init_params


def build(model_name, seed=0):
    g = torch.Generator().manual_seed(seed)
    if model_name == "mlp":
        return MLP(8, features=(16,), num_classes=10, device="cpu",
                   generator=g)
    cfg = gpt_tiny(dtype=torch.float32)
    return Transformer(cfg, params=init_params(cfg, g, "cpu"))


def batch(model_name, rank, step):
    rs = np.random.RandomState(1000 * rank + step)
    if model_name == "mlp":
        return (torch.from_numpy(rs.rand(4, 8).astype(np.float32)),
                torch.from_numpy(rs.randint(0, 10, (4,))))
    toks = torch.from_numpy(rs.randint(0, 256, (2, 9)))
    return toks[:, :-1], toks[:, 1:]


def run(model_name, kind, guarded, rank, steps=3):
    """(losses, params, diags, grad digests) of ``steps`` steps."""
    model = build(model_name)
    if kind == "dp":
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        state = training.create_train_state(model, opt)
        step = training.data_parallel_train_step(model, opt, guard=guarded)
    else:
        state, step = training.zero_train_setup(
            model, torch.optim.SGD(model.parameters(), lr=0.1,
                                   momentum=0.9), guard=guarded)
    losses, diags, host = [], [], []
    for i in range(steps):
        out = step(state, *batch(model_name, rank, i))
        state, loss = out[0], out[1]
        losses.append(loss.item())
        if guarded:
            diags.append((bool(out[2]["finite"]),
                          out[2]["digest"].numpy().astype(np.uint32)))
            if kind == "dp":
                host.append(guard.host_digest(
                    [p.grad for p in model.parameters()]))
    params = [p.detach().clone() for p in model.parameters()]
    return losses, params, diags, host
'''

exec(COUNTER)
exec(HELPERS)


@pytest.fixture(scope="module")
def world_one():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _counted(fn):
    """Run ``fn`` with every torch.distributed call counted."""
    import torch.distributed as dist
    from horovod_tpu_torch.ops import collective_ops as co

    saved = {n: getattr(dist, n) for n in _NAMES if hasattr(dist, n)}
    saved_co = (co._all_gather_flat, co._reduce_scatter_flat_op)
    del CALLS[:]
    install_counter()
    try:
        out = fn()
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
        co._all_gather_flat, co._reduce_scatter_flat_op = saved_co
    return out, list(CALLS)


CASES = [(m, k) for m in ("mlp", "gpt_tiny") for k in ("dp", "zero")]


@pytest.mark.parametrize("model_name,kind", CASES)
def test_guarded_step_bit_identical_and_diag_shape(world_one, model_name,
                                                   kind):
    """World 1: the guarded step's losses and parameters equal the
    unguarded step's bit for bit, with the same torch.distributed calls
    (no collective added); the diag is finite and (2,), and for the
    data-parallel step it is the host digest of the post-reduction
    gradients."""
    (pl, pp, _, _), plain_calls = _counted(
        lambda: run(model_name, kind, False, 0))
    (gl, gp, diags, host), guarded_calls = _counted(
        lambda: run(model_name, kind, True, 0))
    assert pl == gl
    for a, b in zip(pp, gp):
        assert torch.equal(a, b)
    assert guarded_calls == plain_calls and plain_calls
    assert all(finite for finite, _ in diags)
    assert all(d.shape == (2,) for _, d in diags)
    for (_, d), h in zip(diags, host):
        np.testing.assert_array_equal(d, h)
    # the state moves, so do the digests
    assert (diags[0][1] != diags[-1][1]).any()


def test_guard_env_default(world_one, monkeypatch):
    model = build("mlp")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    state = training.create_train_state(model, opt)
    x, y = batch("mlp", 0, 0)
    monkeypatch.setenv("HVD_TPU_GUARD", "1")
    step = training.data_parallel_train_step(model, opt)  # guard=None
    assert len(step(state, x, y)) == 3
    monkeypatch.setenv("HVD_TPU_GUARD", "0")
    step = training.data_parallel_train_step(model, opt)
    assert len(step(state, x, y)) == 2
    monkeypatch.setenv("HVD_TPU_GUARD", "1")
    zmodel = build("mlp")
    zstate, zstep = training.zero_train_setup(
        zmodel, torch.optim.SGD(zmodel.parameters(), lr=0.1))
    assert len(zstep(zstate, x, y)) == 3


def test_zero_guard_digests_the_update_deltas(world_one):
    """ZeRO's diag digests the post-allgather update deltas: new minus
    old parameters."""
    model = build("mlp")
    before = [p.detach().clone() for p in model.parameters()]
    state, step = training.zero_train_setup(
        model, torch.optim.SGD(model.parameters(), lr=0.1), guard=True)
    _, _, diag = step(state, *batch("mlp", 0, 0))
    deltas = [p.detach() - b for p, b in zip(model.parameters(), before)]
    np.testing.assert_array_equal(
        diag["digest"].numpy().astype(np.uint32), guard.host_digest(deltas))
    assert bool(diag["finite"])


def test_fit_epoch_drives_the_guard(world_one, tmp_path):
    """fit_epoch feeds per-step diagnostics and runs the cadence check
    (world=1: the local detectors + watermark advance); an armed guard
    sizes the checkpoint ring to 2·cadence."""
    model = build("mlp")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = training.data_parallel_train_step(model, opt, guard=True)
    g = guard.IntegrityGuard(cadence=2, world=1)
    loader = [batch("mlp", 0, i) for i in range(6)]
    out_state, loss = training.fit_epoch(
        step, training.create_train_state(model, opt), loader, guard=g,
        checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert loss is not None and np.isfinite(loss)
    assert g.last_verified_step == 6  # checks ran at steps 2, 4 and 6
    assert out_state.step == 6
    assert len(os.listdir(tmp_path)) == 4  # max(3, 2 * cadence)


def test_fit_epoch_guard_trips_on_nonfinite_and_rolls_back(world_one,
                                                           tmp_path):
    """A parameter set to inf makes the next step's gradients
    non-finite: the cadence check trips, the ring loses every checkpoint
    newer than the last verified step, and IntegrityError reaches the
    (non-elastic) caller."""
    model = build("mlp")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = training.data_parallel_train_step(model, opt, guard=True)
    g = guard.IntegrityGuard(cadence=2, world=1, ckpt_dir=str(tmp_path))
    state = training.create_train_state(model, opt)
    state, _ = training.fit_epoch(
        step, state, [batch("mlp", 0, i) for i in range(2)], guard=g,
        checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert g.last_verified_step == 2
    with torch.no_grad():
        model.Dense_0.kernel[0, 0] = float("inf")
    with pytest.raises(guard.IntegrityError):
        training.fit_epoch(
            step, state, [batch("mlp", 0, i) for i in range(2, 4)],
            guard=g, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert sorted(os.listdir(tmp_path)) == ["ckpt-1", "ckpt-2"]


def test_step_diag_composes_manually():
    loss = torch.tensor(1.5)
    grads = {"w": torch.ones(4), "b": torch.arange(3, dtype=torch.float32)}
    diag = guard.step_diag(loss, grads)
    assert bool(diag["finite"])
    np.testing.assert_array_equal(
        diag["digest"].numpy().astype(np.uint32), guard.host_digest(grads))
    np.testing.assert_array_equal(
        diag["digest"].numpy().astype(np.uint32),
        jguard.host_digest({k: v.numpy() for k, v in grads.items()}))


# -- world 2 over gloo --------------------------------------------------------

WORKER = COUNTER + HELPERS + r'''
import sys
import horovod_tpu_torch as hvd

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
hvd.init(device="cpu", rank=rank, size=world, init_method=f"file://{store}")
install_counter()
res = {}
for model_name in ("mlp", "gpt_tiny"):
    for kind in ("dp", "zero"):
        tag = f"{model_name}_{kind}"
        del CALLS[:]
        pl, pp, _, _ = run(model_name, kind, False, rank)
        plain_calls = list(CALLS)
        del CALLS[:]
        gl, gp, diags, host = run(model_name, kind, True, rank)
        res[tag + "_losses"] = np.array([pl, gl])
        res[tag + "_same_params"] = np.array(
            all(torch.equal(a, b) for a, b in zip(pp, gp)))
        res[tag + "_calls"] = np.array([len(plain_calls), len(CALLS)])
        res[tag + "_same_calls"] = np.array(plain_calls == CALLS)
        res[tag + "_finite"] = np.array([f for f, _ in diags])
        res[tag + "_digests"] = np.stack([d for _, d in diags])
        if host:
            res[tag + "_host"] = np.stack(host)
# the guard's default exchange at world 2: the framework's allgather
model = build("mlp")
opt = torch.optim.SGD(model.parameters(), lr=0.1)
step = training.data_parallel_train_step(model, opt, guard=True)
g = guard.IntegrityGuard.from_env(enabled=True, cadence=2)
training.fit_epoch(step, training.create_train_state(model, opt),
                   [batch("mlp", rank, i) for i in range(4)], guard=g)
res["fit_verified"] = np.array(g.last_verified_step)
res["fit_exchange"] = np.array(type(g.exchange).__name__)
hvd.shutdown()
np.savez(out, **res)
'''


@pytest.fixture(scope="module")
def world_two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("guard_world2")
    store = tmp / "store"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    outs = [tmp / f"rank{r}.npz" for r in range(2)]
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "2", str(store), str(outs[r])],
        cwd=str(ROOT), env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(2)]
    deadline = time.monotonic() + 120
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp / f"rank{r}.log").read_text()
    return [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("model_name,kind", CASES)
def test_guarded_step_world_two_gloo(world_two, model_name, kind):
    """World 2 over gloo: on each rank the guarded step's losses and
    parameters equal the unguarded step's, with the same
    torch.distributed calls; both ranks' digests agree (the
    post-reduction gradients, or ZeRO's update deltas, are replicated),
    and the data-parallel digest is the host digest of the gradients."""
    tag = f"{model_name}_{kind}"
    for res in world_two:
        plain, guarded = res[tag + "_losses"]
        assert list(plain) == list(guarded)
        assert bool(res[tag + "_same_params"])
        assert bool(res[tag + "_same_calls"])
        assert res[tag + "_calls"][0] > 0
        assert res[tag + "_finite"].all()
        if kind == "dp":
            np.testing.assert_array_equal(res[tag + "_digests"],
                                          res[tag + "_host"])
    np.testing.assert_array_equal(world_two[0][tag + "_digests"],
                                  world_two[1][tag + "_digests"])
    np.testing.assert_array_equal(world_two[0][tag + "_losses"],
                                  world_two[1][tag + "_losses"])


def test_collective_exchange_verifies_at_world_two(world_two):
    for res in world_two:
        assert str(res["fit_exchange"]) == "CollectiveExchange"
        assert int(res["fit_verified"]) == 4
