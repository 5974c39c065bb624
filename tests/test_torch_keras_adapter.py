"""The port's Keras 3 adapter (``horovod_tpu_torch.keras``) against the
JAX package's (``horovod_tpu.keras``).

* World 1, tensorflow backend, in this process: ``model.fit`` under
  ``DistributedOptimizer`` (plain, fp16 compression, gradient
  predivision, two backward passes a step) gives the same losses and
  weights as the JAX adapter's from the same weights and batches (fp32
  within 1e-6 absolute); the warmup and schedule callbacks set the same
  learning rates batch by batch, exactly; ``KerasState`` round trips
  as the JAX one does; ``TelemetryCallback`` books
  ``hvd_tpu_keras_epoch_metric`` in the port's registry.
* The torch backend (a subprocess: the backend is fixed at import): the
  wrapped optimizer hands torch gradients to the collectives and fits
  to the JAX adapter's losses, with two backward passes a step too,
  whose sum stays a torch tensor on the gradients' device.  A JAX-backend gradient raises
  ``TypeError``: the port imports no jax.

The adapter at world 2 (a ``DistributedOptimizer`` step, the broadcast
and metric-average callbacks) is held against numpy in
``test_torch_tensorflow_adapter.py``, whose two gloo ranks run it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

keras = pytest.importorskip("keras")
pytest.importorskip("tensorflow")

import horovod_tpu.keras as J  # noqa: E402
import horovod_tpu_torch as T  # noqa: E402
import horovod_tpu_torch.keras as P  # noqa: E402
from horovod_tpu_torch.metrics import instruments as TI  # noqa: E402
from horovod_tpu_torch.tensorflow import optimizer as topt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def world_one():
    T.init(device="cpu")
    yield
    T.shutdown()


def _data(n=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = (x @ rng.randn(4, 1)).astype(np.float32)
    return x, y


def _model():
    keras.utils.set_random_seed(0)
    return keras.Sequential([keras.Input(shape=(4,)),
                             keras.layers.Dense(8, activation="tanh"),
                             keras.layers.Dense(1)])


FIT_CASES = {
    "plain": ({}, {}),
    "fp16": ({"compression": "fp16"}, {}),
    "predivide": ({"gradient_predivide_factor": 2.0}, {}),
    "two_passes": ({"backward_passes_per_step": 2}, {"run_eagerly": True}),
}


def _fit(h, case, callbacks=()):
    kw, compile_kw = FIT_CASES[case]
    kw = dict(kw)
    if kw.get("compression") == "fp16":
        kw["compression"] = h.Compression.fp16
    model = _model()
    opt = h.DistributedOptimizer(keras.optimizers.SGD(0.05), **kw)
    model.compile(optimizer=opt, loss="mse", **compile_kw)
    x, y = _data()
    hist = model.fit(x, y, batch_size=8, epochs=3, shuffle=False,
                     verbose=0, callbacks=list(callbacks))
    return hist.history["loss"], model.get_weights()


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_under_distributed_optimizer_matches_jax(case):
    got_loss, got_w = _fit(P, case)
    want_loss, want_w = _fit(J, case)
    np.testing.assert_allclose(got_loss, want_loss, rtol=0, atol=ATOL)
    for g, w in zip(got_w, want_w):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    assert got_loss[-1] < got_loss[0]


class _LrLog(keras.callbacks.Callback):
    """Each batch's learning rate, read after the callbacks before it
    set it."""

    def __init__(self):
        super().__init__()
        self.lrs = []

    def on_train_batch_begin(self, batch, logs=None):
        self.lrs.append(float(np.asarray(
            self.model.optimizer.learning_rate)))


def _lrs(h, make):
    log = _LrLog()
    _fit(h, "plain", callbacks=[make(h), log])
    return log.lrs


LR_CASES = {
    "warmup": lambda h: h.callbacks.LearningRateWarmupCallback(
        0.2, warmup_epochs=2, steps_per_epoch=4),
    "warmup_epochwise": lambda h: h.callbacks.LearningRateWarmupCallback(
        0.2, warmup_epochs=2),
    "schedule_staircase": lambda h: h.callbacks.LearningRateScheduleCallback(
        0.1, multiplier=lambda e: 0.5 ** e, start_epoch=1),
    "schedule_smooth": lambda h: h.callbacks.LearningRateScheduleCallback(
        0.1, multiplier=lambda e: 1.0 / (1.0 + e), staircase=False,
        steps_per_epoch=4, end_epoch=2),
}


@pytest.mark.parametrize("case", sorted(LR_CASES))
def test_lr_callbacks_set_the_jax_rates(case):
    got, want = _lrs(P, LR_CASES[case]), _lrs(J, LR_CASES[case])
    assert len(got) == 12
    assert got == want


def _keras_state(h):
    model = _model()
    opt = keras.optimizers.Adam(0.01)
    model.compile(optimizer=opt, loss="mse")
    x, y = _data()
    model.fit(x, y, batch_size=8, epochs=1, shuffle=False, verbose=0)
    state = h.elastic.KerasState(model, batch=2, epoch=1)
    cb = h.elastic.CommitStateCallback(state, batches_per_commit=2)
    ub = h.elastic.UpdateBatchStateCallback(state)
    ue = h.elastic.UpdateEpochStateCallback(state)
    saved = [np.array(w) for w in model.get_weights()]
    saved_opt = [np.array(v) for v in opt.variables]
    model.fit(x, y, batch_size=8, epochs=1, shuffle=False, verbose=0,
              callbacks=[ub, ue])
    state.restore()
    restored = [np.array(w) for w in model.get_weights()] + [
        np.array(v) for v in opt.variables]
    model.fit(x, y, batch_size=8, epochs=1, shuffle=False, verbose=0,
              callbacks=[cb, ub, ue])
    state.sync()
    return (saved + saved_opt, restored,
            [np.array(w) for w in model.get_weights()],
            (state.batch, state.epoch))


def test_keras_state_round_trips_as_jax():
    got, want = _keras_state(P), _keras_state(J)
    saved, restored, after, counters = got
    for a, b in zip(restored, saved):
        np.testing.assert_array_equal(a, b)
    assert counters == want[3] == (0, 1)
    for part_g, part_w in zip(got[:3], want[:3]):
        for g, w in zip(part_g, part_w):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_telemetry_and_world_one_callbacks_book_the_port_registry():
    gauge = TI.KERAS_EPOCH_METRIC
    assert gauge.name == "hvd_tpu_keras_epoch_metric"
    steps = TI.STEP_DURATION.labels("keras")
    before = steps.get()["count"]
    losses, _ = _fit(P, "plain", callbacks=[
        P.callbacks.TelemetryCallback(),
        P.callbacks.BroadcastGlobalVariablesCallback(0),
        P.callbacks.MetricAverageCallback()])
    assert gauge.labels("loss").get() == np.float32(losses[-1])
    assert steps.get()["count"] - before == 12
    with pytest.raises(ValueError, match="models="):
        P.broadcast_global_variables(0)
    with pytest.raises(ValueError, match="already"):
        opt = P.DistributedOptimizer(keras.optimizers.SGD(0.1))
        P.DistributedOptimizer(opt)


def test_a_jax_backend_gradient_raises_type_error():
    jax_like = type("ArrayImpl", (), {"__module__": "jaxlib._jax"})()
    tracer = type("DynamicJaxprTracer", (),
                  {"__module__": "jax._src.interpreters.partial_eval"})()
    assert topt._grad_kind(jax_like) == topt._grad_kind(tracer) == "jax"
    opt = P.DistributedOptimizer(keras.optimizers.SGD(0.1))
    with pytest.raises(TypeError, match="imports no jax"):
        opt.apply([tracer])


TORCH_BACKEND = r"""
import os
import numpy as np
import keras
import horovod_tpu.keras as J
import horovod_tpu_torch as T
import horovod_tpu_torch.keras as P
assert keras.backend.backend() == "torch"
J.init()
T.init(device="cpu")


def fit(h, **kw):
    keras.utils.set_random_seed(0)
    model = keras.Sequential([keras.Input(shape=(4,)),
                              keras.layers.Dense(8, activation="tanh"),
                              keras.layers.Dense(1)])
    model.compile(optimizer=h.DistributedOptimizer(
        keras.optimizers.SGD(0.05), **kw), loss="mse")
    rng = np.random.RandomState(0)
    x = rng.randn(32, 4).astype(np.float32)
    y = (x @ rng.randn(4, 1)).astype(np.float32)
    return model.fit(x, y, batch_size=8, epochs=3, shuffle=False,
                     verbose=0).history["loss"]


got, want = fit(P), fit(J)
np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
assert got[-1] < got[0]
got = fit(P, compression=P.Compression.fp16)
want = fit(J, compression=J.Compression.fp16)
np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
got = fit(P, backward_passes_per_step=2)
want = fit(J, backward_passes_per_step=2)
np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

# two backward passes a step: the sum stays a torch tensor on the
# gradients' device, never crosses numpy, and reaches the wrapped
# optimizer's apply on that device
import torch

seen = []
base_apply = keras.optimizers.SGD.apply


def spy(self, grads, trainable_variables=None):
    seen.append([(type(g), g.device) for g in grads])
    return base_apply(self, grads, trainable_variables)


def no_hop(*a, **k):
    raise AssertionError("a torch gradient crossed numpy")


keras.optimizers.SGD.apply = spy
v = keras.Variable(np.zeros(3, np.float32))
opt = P.DistributedOptimizer(keras.optimizers.SGD(0.5),
                             backward_passes_per_step=2)
opt.build([v])
dev = v.value.device
g1 = torch.tensor([1.0, 2.0, 3.0], device=dev)
g2 = torch.tensor([3.0, 2.0, 5.0], device=dev)
real = torch.Tensor.numpy, torch.from_numpy
torch.Tensor.numpy = torch.from_numpy = no_hop
try:
    opt.apply([g1], [v])
    assert seen == []  # the first pass only aggregates
    opt.apply([g2], [v])
finally:
    torch.Tensor.numpy, torch.from_numpy = real
    keras.optimizers.SGD.apply = base_apply
assert seen == [[(torch.Tensor, dev)]], seen
np.testing.assert_array_equal(keras.ops.convert_to_numpy(v),
                              [-1.0, -1.0, -2.0])
assert g1.tolist() == [1.0, 2.0, 3.0]  # the aggregate is a copy
print("TORCH-BACKEND-OK")
"""


def test_torch_backend_fits_as_jax():
    env = dict(os.environ, KERAS_BACKEND="torch", JAX_PLATFORMS="cpu",
               TF_CPP_MIN_LOG_LEVEL="3",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", TORCH_BACKEND], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "TORCH-BACKEND-OK" in res.stdout
