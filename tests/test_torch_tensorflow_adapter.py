"""The port's TensorFlow adapter (``horovod_tpu_torch.tensorflow``)
against the JAX package's (``horovod_tpu.tensorflow``).

* World 1, in this process: the same numpy-seeded tensors go through
  both adapters' collectives (allreduce with Average, Sum, pre/postscale
  and an int dtype; grouped ops; broadcast, allgather, alltoall,
  reducescatter), eager, inside ``tf.function`` and, where XLA can
  compile them, inside ``tf.function(jit_compile=True)`` — each package
  through its own XLA custom-call bridge (the port's built from its own
  ``tensorflow/src/xla_bridge.cc`` into ``build/horovod_tpu_torch/``).
  ``DistributedGradientTape`` gradients (dense, fp16 compression,
  ``num_groups``, ``IndexedSlices``, ``tf.function``, ``jit_compile``),
  ``SyncBatchNormalization`` outputs and gradients,
  ``LocalGradientAggregationHelper`` and ``TensorFlowKerasState`` round
  trips agree: fp32 within 1e-6 absolute, integers exactly.
* World 2, two gloo ranks (one process each): each rank's results —
  the collectives, the tape's gradients eager and under ``jit_compile``,
  ``SyncBatchNormalization``'s outputs and input gradients, and the
  keras adapter's ``DistributedOptimizer`` step with its broadcast and
  metric-average callbacks — are held against numpy arithmetic over
  both ranks' inputs.  The JAX adapter reaches world > 1 only under its
  launcher, so it is not in this half.
* Under ``jit_compile`` a bridge that cannot be built raises with the
  build's error instead of falling through to ``py_function``.
"""

import os

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
keras = pytest.importorskip("keras")

import horovod_tpu.tensorflow as J  # noqa: E402
import horovod_tpu_torch as T  # noqa: E402
import horovod_tpu_torch.tensorflow as P  # noqa: E402
from horovod_tpu_torch.tensorflow import xla_ops  # noqa: E402

from test_torch_collectives import spawn_ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def world_one():
    T.init(device="cpu")
    yield
    T.shutdown()


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def same(got, want, exact=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact or not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


MODES = ("eager", "graph", "jit")


def in_mode(mode, fn):
    """``fn`` called eagerly, traced by ``tf.function``, or compiled by
    ``tf.function(jit_compile=True)``."""
    if mode == "eager":
        return fn
    return tf.function(fn, jit_compile=mode == "jit")


def numpy_of(x):
    if isinstance(x, (list, tuple)):
        return [numpy_of(v) for v in x]
    return x.numpy()


ALLREDUCE_CASES = {
    "average": (lambda h, x: h.allreduce(x), "float32"),
    "sum": (lambda h, x: h.allreduce(x, op=h.Sum), "float32"),
    "scaled": (lambda h, x: h.allreduce(x, op=h.Sum, prescale_factor=0.5,
                                        postscale_factor=3.0), "float32"),
    "average_flag": (lambda h, x: h.allreduce(x, average=False), "float32"),
    "int32": (lambda h, x: h.allreduce(x, op=h.Sum), "int32"),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(ALLREDUCE_CASES))
def test_allreduce_matches_jax(case, mode):
    fn, dtype = ALLREDUCE_CASES[case]
    x = tf.constant((rand(3, 5) * 100).astype(dtype))
    got = in_mode(mode, lambda t: fn(P, t))(x)
    want = in_mode(mode, lambda t: fn(J, t))(x)
    assert got.dtype == x.dtype
    same(got.numpy(), want.numpy())


@pytest.mark.parametrize("mode", MODES)
def test_grouped_allreduce_and_broadcast_match_jax(mode):
    xs = [tf.constant(rand(4, seed=1)), tf.constant(rand(2, 3, seed=2))]

    def run(h):
        return in_mode(mode, lambda a, b: (
            h.grouped_allreduce([a, b], op=h.Sum, postscale_factor=2.0)
            + [h.broadcast(b, root_rank=0)]))(*xs)

    for g, w in zip(numpy_of(run(P)), numpy_of(run(J))):
        same(g, w)


SHAPE_DYNAMIC = {
    "allgather": lambda h, x: [h.allgather(x)],
    "alltoall": lambda h, x: list(h.alltoall(x, splits=[x.shape[0]])),
    "reducescatter": lambda h, x: [h.reducescatter(x, op=h.Sum)],
    "grouped_allgather": lambda h, x: h.grouped_allgather([x, x[:1]]),
    "grouped_reducescatter": lambda h, x: h.grouped_reducescatter(
        [x, 2.0 * x]),
}


@pytest.mark.parametrize("mode", ("eager", "graph"))
@pytest.mark.parametrize("op", sorted(SHAPE_DYNAMIC))
def test_shape_dynamic_collectives_match_jax(op, mode):
    x = tf.constant(rand(4, 3, seed=3))
    got = numpy_of(in_mode(mode, lambda t: SHAPE_DYNAMIC[op](P, t))(x))
    want = numpy_of(in_mode(mode, lambda t: SHAPE_DYNAMIC[op](J, t))(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        same(g, w)


@pytest.mark.parametrize("op", sorted(SHAPE_DYNAMIC))
def test_shape_dynamic_collectives_refuse_jit_as_jax_does(op):
    x = tf.constant(rand(4, 3, seed=3))
    for h in (P, J):
        with pytest.raises(NotImplementedError, match="jit_compile"):
            tf.function(lambda t: SHAPE_DYNAMIC[op](h, t),
                        jit_compile=True)(x)


def test_the_port_jit_path_runs_its_own_bridge():
    """The jit tests above went through the port's library, built from
    its own source under build/horovod_tpu_torch/ and registered under a
    target of its own."""
    x = tf.constant(rand(3, seed=4))
    tf.function(lambda t: P.allreduce(t), jit_compile=True)(x)
    assert xla_ops._lib is not None
    path = os.path.realpath(xla_ops.lib_path())
    assert path.startswith(os.path.join(ROOT, "build", "horovod_tpu_torch")
                           + os.sep)
    assert xla_ops._SRC == os.path.join(
        ROOT, "horovod_tpu_torch", "tensorflow", "src", "xla_bridge.cc")
    from horovod_tpu.tensorflow import xla_ops as jax_xla_ops

    assert xla_ops._TARGET == "hvd_tpu_torch_tf_collective"
    assert jax_xla_ops._TARGET != xla_ops._TARGET


def test_jit_without_a_bridge_raises_the_build_error(monkeypatch):
    monkeypatch.setattr(xla_ops, "_lib", None)
    monkeypatch.setattr(xla_ops, "_load_attempted", True)
    monkeypatch.setattr(xla_ops, "_build_error",
                        "RuntimeError: g++ exited 1: no such header")
    x = tf.constant(rand(3, seed=5))
    with pytest.raises(RuntimeError, match="no such header"):
        tf.function(lambda t: P.allreduce(t), jit_compile=True)(x)
    # a plain graph still takes py_function
    same(tf.function(lambda t: P.allreduce(t))(x).numpy(), x.numpy())


# -- DistributedGradientTape -------------------------------------------------


def _tape_grads(h, mode, **kw):
    """Gradients of a tiny dense + embedding model's loss through
    ``h.DistributedGradientTape`` (same weights and batch for both
    packages)."""
    w = tf.Variable(rand(4, 3, seed=6))
    b = tf.Variable(rand(3, seed=7))
    emb = tf.Variable(rand(10, 4, seed=8))
    ids = tf.constant([1, 3, 3, 7])
    x = tf.constant(rand(4, 4, seed=9))
    sparse = kw.pop("sparse", False)

    def step():
        with tf.GradientTape() as tape:
            inp = tf.gather(emb, ids) + x if sparse else x
            loss = tf.reduce_sum(tf.tanh(inp @ w + b) ** 2)
        tape = h.DistributedGradientTape(tape, **kw)
        return tape.gradient(loss, [w, b, emb] if sparse else [w, b])

    grads = in_mode(mode, step)()
    return [tf.convert_to_tensor(g).numpy() for g in grads]


TAPE_CASES = {
    "dense": ("eager", {}),
    "fp16": ("eager", {"compression": "fp16"}),
    "num_groups": ("eager", {"num_groups": 2, "op": "Sum"}),
    "predivide": ("eager", {"gradient_predivide_factor": 2.0}),
    "indexed_slices": ("eager", {"sparse": True}),
    "tf_function": ("graph", {}),
    "jit_compile": ("jit", {"num_groups": 1}),
}


@pytest.mark.parametrize("case", sorted(TAPE_CASES))
def test_distributed_gradient_tape_matches_jax(case):
    mode, kw = TAPE_CASES[case]

    def args(h):
        out = dict(kw)
        if out.get("compression") == "fp16":
            out["compression"] = h.Compression.fp16
        if out.get("op") == "Sum":
            out["op"] = h.Sum
        return out

    got = _tape_grads(P, mode, **args(P))
    want = _tape_grads(J, mode, **args(J))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        same(g, w)


# -- SyncBatchNormalization, aggregation, elastic state -----------------------


def _sync_bn(h):
    layer = h.SyncBatchNormalization(axis=-1, momentum=0.9)
    x = tf.constant(rand(6, 5, seed=10) * 3 + 1)
    with tf.GradientTape() as tape:
        tape.watch(x)
        y = layer(x, training=True)
        loss = tf.reduce_sum(y * tf.constant(rand(6, 5, seed=11)))
    grads = tape.gradient(loss, [x] + layer.trainable_variables)
    return [y.numpy()] + [g.numpy() for g in grads] + [
        v.numpy() for v in layer.non_trainable_variables]


def test_sync_batch_norm_outputs_and_gradients_match_jax():
    for g, w in zip(_sync_bn(P), _sync_bn(J)):
        same(g, w)


def _aggregated(h):
    agg = h.LocalGradientAggregationHelper(
        backward_passes_per_step=3,
        allreduce_func=lambda gs: [h.allreduce(g, op=h.Average)
                                   for g in gs])

    @tf.function
    def step(g0, g1):
        return agg.compute_gradients([g0, g1])

    out = []
    for p in range(6):
        res = step(tf.constant(rand(3, seed=20 + p)),
                   tf.constant(rand(2, 2, seed=40 + p)))
        out += [r.numpy() for r in res]
    return out


def test_local_gradient_aggregation_matches_jax():
    got, want = _aggregated(P), _aggregated(J)
    for g, w in zip(got, want):
        same(g, w)
    # the flush passes carry the average of three passes
    want_flush = np.mean([rand(3, seed=20 + p) for p in range(3)], axis=0)
    np.testing.assert_allclose(got[4], want_flush, rtol=0, atol=ATOL)


def _state_roundtrip(h):
    keras.utils.set_random_seed(0)
    model = keras.Sequential([keras.Input(shape=(4,)),
                              keras.layers.Dense(3)])
    opt = keras.optimizers.Adam(0.01)
    model.compile(optimizer=opt, loss="mse")
    model.fit(rand(8, 4, seed=12), rand(8, 3, seed=13), epochs=1,
              verbose=0)
    state = h.elastic.TensorFlowKerasState(model=model, optimizer=opt,
                                           epoch=3)
    saved = [np.array(w) for w in model.get_weights()]
    saved_opt = [np.array(v) for v in opt.variables]
    model.fit(rand(8, 4, seed=14), rand(8, 3, seed=15), epochs=1,
              verbose=0)
    state.epoch = 9
    moved = [np.array(w) for w in model.get_weights()]
    state.restore()
    restored = [np.array(w) for w in model.get_weights()]
    restored_opt = [np.array(v) for v in opt.variables]
    state.sync()
    return saved, saved_opt, moved, restored, restored_opt, state.epoch


def test_tensorflow_keras_state_round_trips_as_jax():
    got, want = _state_roundtrip(P), _state_roundtrip(J)
    saved, saved_opt, moved, restored, restored_opt, epoch = got
    assert epoch == want[5] == 3
    assert any(not np.array_equal(a, b) for a, b in zip(saved, moved))
    for a, b in zip(restored + restored_opt, saved + saved_opt):
        same(a, b, exact=True)
    for part_g, part_w in zip(got[:5], want[:5]):
        for g, w in zip(part_g, part_w):
            same(g, w)


def test_variables_objects_join_and_barrier_match_jax():
    for h in (P, J):
        v = tf.Variable(rand(2, 2, seed=16))
        h.broadcast_variables([v], root_rank=0)
        same(v.numpy(), rand(2, 2, seed=16))
        assert h.broadcast_object({"k": [1, 2]}) == {"k": [1, 2]}
        assert h.broadcast_object_fn()({"k": 3}) == {"k": 3}
        assert h.allgather_object("x") == ["x"]
        assert h.join() == 0
        h.barrier()
        with pytest.raises(RuntimeError, match="broadcast_variables"):
            h.broadcast_global_variables(0)
    assert P.keras.__name__ == "horovod_tpu_torch.tensorflow.keras"


# -- world 2 ------------------------------------------------------------------


WORKER = r"""
import os, sys
os.environ["TF_CPP_MIN_LOG_LEVEL"] = "3"
import numpy as np
import tensorflow as tf
import horovod_tpu_torch as T
import horovod_tpu_torch.tensorflow as hvd

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
T.init(device="cpu", rank=rank, size=world, init_method="file://" + store)


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


res = {}
x = tf.constant(rand(3, 4, seed=rank))
ints = tf.constant(np.arange(6, dtype=np.int32) * (rank + 1))
res["avg"] = hvd.allreduce(x).numpy()
res["sum"] = hvd.allreduce(x, op=hvd.Sum, prescale_factor=0.5).numpy()
res["int"] = hvd.allreduce(ints, op=hvd.Sum).numpy()
res["graph"] = tf.function(lambda t: hvd.allreduce(t, op=hvd.Sum))(x).numpy()
res["jit"] = tf.function(lambda t: hvd.grouped_allreduce(
    [t, 2.0 * t], op=hvd.Sum), jit_compile=True)(x)[1].numpy()
res["bcast"] = hvd.broadcast(x, root_rank=1).numpy()
res["bcast_jit"] = tf.function(lambda t: hvd.broadcast(t, root_rank=1),
                               jit_compile=True)(x).numpy()
res["gather"] = hvd.allgather(x[:rank + 1]).numpy()
recv, splits = hvd.alltoall(tf.constant(rand(3, 2, seed=10 + rank)),
                            splits=[1, 2] if rank == 0 else [2, 1])
res["a2a"], res["a2a_splits"] = recv.numpy(), splits.numpy()
res["rs"] = hvd.reducescatter(tf.constant(rand(4, 3, seed=60 + rank)),
                              op=hvd.Sum).numpy()
res["gag"] = hvd.grouped_allgather([x[:rank + 1], ints])[0].numpy()
res["obj"] = np.array(hvd.allgather_object(rank * 10))
w = tf.Variable(rand(4, 2, seed=20))
data = tf.constant(rand(5, 4, seed=30 + rank))


def tape_grad(jit):
    def step():
        with tf.GradientTape() as tape:
            loss = tf.reduce_sum(tf.tanh(data @ w) ** 2)
        return hvd.DistributedGradientTape(tape).gradient(loss, [w])[0]
    return tf.function(step, jit_compile=jit)().numpy()


res["tape"], res["tape_jit"] = tape_grad(False), tape_grad(True)
bn = hvd.SyncBatchNormalization(axis=-1)
bx = tf.constant(rand(2 + rank, 3, seed=40 + rank))
with tf.GradientTape() as tape:
    tape.watch(bx)
    by = bn(bx, training=True)
    bl = tf.reduce_sum(by * tf.constant(rand(2 + rank, 3, seed=50 + rank)))
res["bn_y"] = by.numpy()
res["bn_dx"] = tape.gradient(bl, bx).numpy()

# the keras adapter: one DistributedOptimizer step, the broadcast and
# metric-average callbacks
import keras
import horovod_tpu_torch.keras as khvd

keras.utils.set_random_seed(rank)  # each rank starts elsewhere
model = keras.Sequential([keras.Input(shape=(3,)), keras.layers.Dense(2)])
model.compile(optimizer=khvd.DistributedOptimizer(keras.optimizers.SGD(0.1)),
              loss="mse")
res["k_init"] = np.concatenate([w.ravel() for w in model.get_weights()])
rng = np.random.RandomState(100 + rank)
kx, ky = rng.randn(4, 3).astype(np.float32), rng.randn(4, 2).astype(
    np.float32)


class Logs(keras.callbacks.Callback):
    def on_epoch_end(self, epoch, logs=None):
        res["k_logged_loss"] = np.array(logs["loss"])


model.fit(kx, ky, batch_size=4, epochs=1, shuffle=False, verbose=0,
          callbacks=[khvd.callbacks.BroadcastGlobalVariablesCallback(0),
                     khvd.callbacks.MetricAverageCallback(), Logs()])
res["k_after"] = np.concatenate([w.ravel() for w in model.get_weights()])
np.savez(out, **res)
T.shutdown()
"""


@pytest.fixture(scope="module")
def world_two(tmp_path_factory):
    return spawn_ranks(WORKER, 2, tmp_path_factory.mktemp("tf2"),
                       timeout=300)


def test_world_two_collectives_against_numpy(world_two):
    xs = [rand(3, 4, seed=r) for r in range(2)]
    ints = [np.arange(6, dtype=np.int32) * (r + 1) for r in range(2)]
    for r, got in enumerate(world_two):
        same(got["avg"], (xs[0] + xs[1]) / np.float32(2))
        same(got["sum"], xs[0] * np.float32(0.5) + xs[1] * np.float32(0.5))
        same(got["int"], ints[0] + ints[1])
        same(got["graph"], xs[0] + xs[1])
        same(got["jit"], 2 * xs[0] + 2 * xs[1])
        same(got["bcast"], xs[1], exact=True)
        same(got["bcast_jit"], xs[1], exact=True)
        same(got["gather"], np.concatenate([xs[0][:1], xs[1][:2]]),
             exact=True)
        sends = [rand(3, 2, seed=10 + q) for q in range(2)]
        cuts = [[1, 2], [2, 1]]
        mine = [sends[q][sum(cuts[q][:r]):sum(cuts[q][:r + 1])]
                for q in range(2)]
        same(got["a2a"], np.concatenate(mine), exact=True)
        np.testing.assert_array_equal(got["a2a_splits"],
                                      [cuts[0][r], cuts[1][r]])
        total = rand(4, 3, seed=60) + rand(4, 3, seed=61)
        same(got["rs"], total[2 * r:2 * r + 2])
        same(got["gag"], np.concatenate([xs[0][:1], xs[1][:2]]),
             exact=True)
        np.testing.assert_array_equal(got["obj"], [0, 10])


def test_world_two_gradients_and_sync_bn_against_numpy(world_two):
    w = rand(4, 2, seed=20)

    def grad(data):
        h = np.tanh(data @ w)
        return data.T @ (2 * h * (1 - h * h))

    want = (grad(rand(5, 4, seed=30)) + grad(rand(5, 4, seed=31))) / 2
    xs = [rand(2 + r, 3, seed=40 + r) for r in range(2)]
    cot = [rand(2 + r, 3, seed=50 + r) for r in range(2)]
    allx = np.concatenate(xs).astype(np.float64)
    mean, var = allx.mean(0), allx.var(0)
    inv = 1 / np.sqrt(var + 1e-3)  # keras's default epsilon
    dy = np.concatenate(cot).astype(np.float64)
    xhat = (allx - mean) * inv
    dx = inv * (dy - dy.mean(0) - xhat * (dy * xhat).mean(0))
    rows = [slice(0, 2), slice(2, 5)]
    for r, got in enumerate(world_two):
        np.testing.assert_allclose(got["tape"], want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["tape_jit"], want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["bn_y"], xhat[rows[r]], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["bn_dx"], dx[rows[r]], rtol=0,
                                   atol=1e-5)


def test_world_two_keras_step_and_callbacks_against_numpy(world_two):
    """The keras adapter at world 2: the broadcast callback fires after
    the FIRST batch (the reference's point), so that batch's update
    starts from each rank's own weights, w_r' = w_r - lr *
    mean_q(grad_q(w_q)), and then every rank takes rank 0's; the logged
    loss is the ranks' mean (MetricAverageCallback)."""
    inits = [r["k_init"] for r in world_two]
    grads, losses = [], []
    for q in range(2):
        rng = np.random.RandomState(100 + q)
        x = rng.randn(4, 3).astype(np.float32).astype(np.float64)
        y = rng.randn(4, 2).astype(np.float32).astype(np.float64)
        k, b = inits[q][:6].reshape(3, 2), inits[q][6:]
        err = x @ k + b - y
        losses.append((err ** 2).mean())
        gk, gb = 2 * x.T @ err / err.size, 2 * err.sum(0) / err.size
        grads.append(np.concatenate([gk.ravel(), gb]))
    want = inits[0] - 0.1 * (grads[0] + grads[1]) / 2
    for r in world_two:
        np.testing.assert_allclose(r["k_after"], want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["k_logged_loss"], np.mean(losses),
                                   rtol=1e-5, atol=1e-6)
