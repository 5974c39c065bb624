"""horovod_tpu_torch.callbacks against horovod_tpu.callbacks.

The port's learning rate lives in a torch optimizer's ``param_groups``;
the reference's in an optax ``inject_hyperparams`` state, where it is
stored as fp32.  The same callbacks driven through the same epochs and
batches give, at every batch, the reference's rate: the port's Python
float rounded to fp32 equals the reference's fp32 value bit for bit.
``warmup_schedule`` equals ``optax.linear_schedule`` exactly at every
step (the reference's ``warmup_schedule`` returns that schedule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import callbacks as jcb
from horovod_tpu_torch import callbacks as cb
from horovod_tpu_torch import training
from horovod_tpu_torch.metrics import instruments as instr


def _jax_state(lr):
    import flax.struct

    class S(flax.struct.PyTreeNode):
        step: jax.Array
        params: dict
        opt_state: object

    opt = optax.inject_hyperparams(optax.sgd)(learning_rate=lr)
    params = {"w": jnp.ones((3,))}
    return S(step=jnp.zeros((), jnp.int32), params=params,
             opt_state=opt.init(params))


def _torch_state(lr, groups=1):
    model = torch.nn.Linear(3, 2)
    params = list(model.parameters())
    opt = torch.optim.SGD([{"params": params[i::groups]}
                           for i in range(groups)], lr=lr, momentum=0.9)
    return training.create_train_state(model, opt)


def test_get_set_lr_roundtrip():
    state = _torch_state(0.25, groups=2)
    assert cb.get_lr(state.optimizer) == 0.25
    assert cb.set_lr(state.optimizer, 0.5) is state.optimizer
    assert [g["lr"] for g in state.optimizer.param_groups] == [0.5, 0.5]
    # the rate drives the update
    w = state.model.weight
    before = w.detach().clone()
    w.grad = torch.ones_like(w)
    state.model.bias.grad = torch.zeros_like(state.model.bias)
    state.optimizer.step()
    torch.testing.assert_close(w.detach(), before - 0.5, rtol=0, atol=1e-7)


def test_set_lr_requires_param_groups():
    with pytest.raises(ValueError, match="learning rate"):
        cb.set_lr(object(), 0.5)
    with pytest.raises(ValueError, match="learning rate"):
        cb.get_lr(type("O", (), {"param_groups": [{"params": []}]})())


def _drive(loop, epochs, batches):
    """The rate after each on_batch_begin, then after each epoch end."""
    lrs = []
    for epoch in range(epochs):
        loop.on_epoch_begin(epoch)
        for batch in range(batches):
            loop.on_batch_begin(batch)
            lrs.append(loop.lr)
            loop.on_batch_end(batch, {"loss": 1.0})
        loop.on_epoch_end(epoch)
        lrs.append(loop.lr)
    return lrs


SCHEDULES = {
    "warmup": lambda m: [m.LearningRateWarmupCallback(
        target_lr=0.8, warmup_epochs=4, steps_per_epoch=10,
        initial_lr=0.0)],
    "warmup_goyal": lambda m: [m.LearningRateWarmupCallback(
        target_lr=0.4, warmup_epochs=3, steps_per_epoch=7,
        initial_lr=0.4 / 8)],
    "warmup_fractional": lambda m: [m.LearningRateWarmupCallback(
        target_lr=0.8, warmup_epochs=2.5, initial_lr=0.1)],
    "staircase": lambda m: [m.LearningRateScheduleCallback(
        initial_lr=1.0, multiplier=lambda e: 0.1 ** (e // 2))],
    "smooth": lambda m: [m.LearningRateScheduleCallback(
        initial_lr=0.3, multiplier=lambda e: 0.5 ** e, staircase=False,
        steps_per_epoch=10, start_epoch=1, end_epoch=4)],
    "smooth_no_steps": lambda m: [m.LearningRateScheduleCallback(
        initial_lr=1.0, multiplier=lambda e: 0.5 ** e, staircase=False)],
    "warmup_then_decay": lambda m: [
        m.LearningRateWarmupCallback(target_lr=0.2, warmup_epochs=2,
                                     steps_per_epoch=10, initial_lr=0.05),
        m.LearningRateScheduleCallback(initial_lr=0.2, multiplier=0.1,
                                       start_epoch=4)],
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_at_every_step_equals_reference(name):
    got = _drive(cb.TrainLoop(_torch_state(0.01), SCHEDULES[name](cb)), 6,
                 10)
    want = _drive(jcb.TrainLoop(_jax_state(0.01), SCHEDULES[name](jcb)), 6,
                  10)
    assert len(got) == len(want) == 66
    np.testing.assert_array_equal(np.float32(got), np.float32(want))


def test_warmup_default_initial_is_target_over_size():
    loop = cb.TrainLoop(_torch_state(0.0), [cb.LearningRateWarmupCallback(
        target_lr=0.8, warmup_epochs=1, steps_per_epoch=4)])
    loop.on_epoch_begin(0)
    loop.on_batch_begin(0)
    assert loop.lr == 0.8  # world 1 (not initialized): target / 1


@pytest.mark.parametrize("init,target,steps", [
    (0.0, 0.8, 8), (0.1 / 3, 0.1, 7), (0.0125, 0.4, 100), (0.3, 0.1, 5),
    (1e-3, 3e-3, 0), (0.05, 0.05, 3)])
def test_warmup_schedule_equals_optax(init, target, steps):
    got = cb.warmup_schedule(target, steps, initial_lr=init)
    want = jcb.warmup_schedule(target, steps, initial_lr=init)
    ref = optax.linear_schedule(init, target, steps)
    for s in range(-2, steps + 4):
        assert got(s) == float(want(s)) == float(ref(s)), s
    lam = torch.optim.lr_scheduler.LambdaLR(
        torch.optim.SGD(torch.nn.Linear(1, 1).parameters(), lr=1.0), got)
    assert lam.get_last_lr() == [got(0)]


def test_train_loop_books_step_duration():
    before = instr.STEP_DURATION.labels("torch").get()["count"]
    loop = cb.TrainLoop(_torch_state(0.1), [])
    loop.on_epoch_begin(0)
    loop.on_batch_begin(0)
    loop.on_batch_end(0)
    assert instr.STEP_DURATION.labels("torch").get()["count"] == before + 1


def test_metric_average_and_broadcast_callbacks_world1():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        state = _torch_state(0.1)
        w = state.model.weight.detach().clone()
        loop = cb.TrainLoop(state, [cb.BroadcastGlobalVariablesCallback(0),
                                    cb.MetricAverageCallback()])
        loop.on_epoch_begin(0)  # triggers on_train_begin
        torch.testing.assert_close(loop.state.model.weight.detach(), w)
        logs = loop.on_epoch_end(0, {"loss": 2.5, "acc": np.float32(0.75),
                                     "t": torch.tensor(1.5), "name": "x"})
    finally:
        hvd.shutdown()
    assert logs == {"loss": 2.5, "acc": 0.75, "t": 1.5, "name": "x"}
