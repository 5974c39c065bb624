"""horovod_tpu_torch.chaos against horovod_tpu.chaos.

The same ``HVD_TPU_CHAOS`` specs parse to the same rules (and the same
errors), and the same seed, rank and call sequence fire the same
injections in the same order in both engines; the sites this slice calls
(``data.batch``, ``data.prefetch``, ``checkpoint.payload``,
``training.step``) inject there.
"""


import numpy as np
import pytest
import torch

from horovod_tpu import chaos as jchaos
from horovod_tpu.chaos import spec as jspec
from horovod_tpu_torch import chaos, data, training
from horovod_tpu_torch.chaos import spec


@pytest.fixture(autouse=True)
def _disarmed():
    chaos.clear()
    jchaos.clear()
    yield
    chaos.clear()
    jchaos.clear()


SPECS = [
    "",
    "data.batch:delay,prob=0.5,delay=0.0",
    "training.step:raise,at=3",
    "checkpoint.payload:corrupt,after=2,times=2;data.prefetch:drop,prob=0.25",
    "elastic.commit:kill,at=8,rank=1;transport.frame.send:corrupt,at=400,"
    "rank=1,fuse=/tmp/f1",
    "guard.grad:flipbit,prob=0.3 ; guard.param:scale,factor=8,times=4",
    " data.batch : hang , after = 5 ",
    "fleet.preempt:kill,code=-15",
    "nosep", "x:explode", "data.batch:drop,prob=2", "data.batch:drop,at=q",
    "data.batch:drop,color=red", "data.batch:drop,prob", ":drop",
]


def _parsed(mod, text):
    try:
        return ("ok", [vars(r) for r in mod.parse_spec(text)])
    except Exception as e:
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("text", SPECS)
def test_specs_parse_to_the_same_rules(text):
    assert _parsed(spec, text) == _parsed(jspec, text)


def test_names_match_reference():
    assert chaos.SITES == jchaos.SITES
    assert spec.ACTIONS == jspec.ACTIONS
    assert (chaos.ENV_SPEC, chaos.ENV_SEED, chaos.ENV_LOG) == (
        jchaos.ENV_SPEC, jchaos.ENV_SEED, jchaos.ENV_LOG)
    for site in ("data.batch", "data.prefetch", "checkpoint.payload",
                 "training.step"):
        assert site in chaos.SITES


PLANS = [
    ("data.batch:delay,prob=0.3,delay=0.0;training.step:drop,prob=0.5", 7, 0),
    ("data.batch:delay,prob=0.3,delay=0.0;training.step:drop,prob=0.5", 7, 1),
    ("data.batch:drop,prob=0.1;data.batch:delay,prob=0.6,delay=0.0,times=5",
     123, 0),
    ("checkpoint.payload:corrupt,at=4;data.prefetch:drop,after=3,prob=0.5",
     0, 2),
    ("training.step:drop,prob=0.5,rank=1", 42, 0),
]
CALLS = ["data.batch", "training.step", "data.batch", "checkpoint.payload",
         "data.prefetch", "data.batch"] * 12


@pytest.mark.parametrize("plan,seed,rank", PLANS)
def test_same_seed_fires_the_same_injections_in_order(plan, seed, rank):
    def run(mod):
        mod.configure(plan, seed=seed, rank=rank)
        out = []
        for site in CALLS:
            got = mod.point(site, b"abcdef" if "payload" in site else None)
            out.append("drop" if got is mod.DROP else
                       (got if isinstance(got, bytes) else None))
        return out, mod.injection_trace()

    assert run(chaos) == run(jchaos)


def test_payload_actions_mangle_like_reference():
    cases = [("corrupt", b"0123456789"), ("corrupt", 5), ("flipbit", 7),
             ("flipbit", 1.5), ("flipbit", b"abc"), ("scale", 3.0),
             ("flipbit", np.arange(6, dtype=np.float32)),
             ("scale", np.ones(3, np.float32))]
    for action, payload in cases:
        chaos.configure(f"s.x:{action},factor=4")
        jchaos.configure(f"s.x:{action},factor=4")
        got, want = chaos.point("s.x", payload), jchaos.point("s.x", payload)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want, action
    chaos.configure("s.x:flipbit")
    with pytest.raises(chaos.ChaosInjected, match="no numeric payload"):
        chaos.point("s.x", None)


def test_raise_point_turns_drop_into_failure_and_raise_raises():
    chaos.configure("a:drop;b:raise")
    with pytest.raises(chaos.ChaosInjected, match="drop at a"):
        chaos.raise_point("a")
    with pytest.raises(chaos.ChaosInjected, match="injected failure at b"):
        chaos.point("b")


def test_fuse_fires_once_across_configures(tmp_path):
    def run(mod, fuse):
        fired = []
        for _ in range(2):  # a second configure stands in for a restart
            mod.configure(f"x:drop,fuse={fuse}")
            fired += [mod.point("x") is mod.DROP for _ in range(3)]
        return fired

    got = run(chaos, str(tmp_path / "a"))
    assert got == run(jchaos, str(tmp_path / "b"))
    assert got == [True] + [False] * 5


def test_install_from_env_and_log(monkeypatch, tmp_path):
    log = tmp_path / "chaos.jsonl"
    monkeypatch.setenv("HVD_TPU_CHAOS", "training.step:drop,at=1")
    monkeypatch.setenv("HVD_TPU_CHAOS_SEED", "5")
    monkeypatch.setenv("HVD_TPU_CHAOS_LOG", str(log))
    assert chaos.install_from_env(rank=0)
    assert chaos.point("training.step") is None
    assert chaos.point("training.step") is chaos.DROP
    assert log.read_text().count("training.step") == 1
    monkeypatch.setenv("HVD_TPU_CHAOS", "")
    assert not chaos.install_from_env(rank=0) and not chaos.active


def test_native_core_export_not_ported():
    chaos.configure("transport.frame.send:corrupt,at=1")
    with pytest.raises(NotImplementedError, match="A13"):
        chaos.configure_native_lib(object())


def test_training_step_site_stops_fit_epoch():
    """``training.step:raise,at=2`` fails the third step of fit_epoch
    before it runs."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import MLP

    rng = np.random.RandomState(0)
    src = data.ArraySource(rng.randn(32, 6).astype(np.float32),
                           rng.randint(0, 3, (32,)).astype(np.int32))
    hvd.init(device="cpu")
    try:
        model = MLP(6, features=(8,), num_classes=3, device="cpu")
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        state = training.create_train_state(model, opt)
        step = training.data_parallel_train_step(model, opt)
        loader = data.DataLoader(src, batch_size=4, device="cpu",
                                 num_workers=0, prefetch_depth=0)
        chaos.configure("training.step:raise,at=2")
        with pytest.raises(chaos.ChaosInjected, match="training.step"):
            training.fit_epoch(step, state, loader, epoch=0)
        assert state.step == 0  # fit_epoch returns new states; ours stayed
        assert chaos.injection_trace()[0]["eval"] == 2
    finally:
        hvd.shutdown()


def test_data_prefetch_site_reraises_on_consumer():
    chaos.configure("data.prefetch:raise,at=1")
    pf = data.DevicePrefetcher(iter([(np.ones(1),)] * 4), depth=2,
                               device_put=False)
    next(pf)
    with pytest.raises(chaos.ChaosInjected, match="data.prefetch"):
        next(pf)
    pf.close()


def test_fit_epoch_guard_not_ported():
    """fit_epoch takes a guard now (it used to raise): a step's
    diagnostics feed it, numbered by the global step, and an armed
    guard sizes the checkpoint ring to max(3, 2·cadence)."""
    from horovod_tpu_torch.guard import IntegrityGuard

    class _State:
        step = 0
        model = torch.nn.Linear(2, 2)

    def step(s, x, y):
        s.step += 1
        return s, torch.tensor(1.0), {"finite": torch.tensor(True),
                                      "digest": torch.zeros(2,
                                                            dtype=torch.int64)}

    g = IntegrityGuard(cadence=2, world=1)
    state, loss = training.fit_epoch(step, _State(), [(None, None)] * 4,
                                     guard=g)
    assert loss == 1.0 and state.step == 4
    assert g.last_verified_step == 4
