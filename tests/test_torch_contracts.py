"""The port's registries against the JAX package's: collective names and
counters, the chaos kill's crash bundle, and the knobs read from the
environment.

* Flat ZeRO at world 2 over gloo (one process per rank): one step of
  ``ZeroDistributedOptimizer``, sharded and unsharded
  (``min_total_bytes`` above the model's size), submits its collectives
  under the reference's names (``zero.grads``, ``zero.updates``, on the
  Chrome timeline too) and books the same deltas of
  ``hvd_tpu_collectives_total`` by (op, path) and of
  ``hvd_tpu_collective_bytes_total`` by op as one step of the JAX
  package's ``ZeroDistributedOptimizer``.  The JAX side runs in this
  process, on its Python dispatch path (its native controller off, as
  ``HVD_TPU_DISABLE_NATIVE=1`` has it), with a two-member stand-in for
  its engine: the JAX package's engine spans processes, and its tests
  run one.  The counters are booked at the API, before the engine, so
  the stand-in gives them world-2 shapes and nothing else.  The sharded
  and unsharded steps leave the same parameters, bit for bit, on both
  ranks.
* A chaos ``kill`` with ``HVD_TPU_TRACE_BUNDLE_DIR`` set leaves a
  ``chaos_kill`` crash bundle holding the site and the ``chaos.inject``
  event, as the JAX package's does (``tests/test_trace.py``).
* ``utils/env_parser.Config`` holds the JAX fields that the port reads;
  its ``from_env()`` equals the JAX one on those fields, or raises the
  same ``ValueError``, under seeded environments of set, unset and
  garbled knobs (the JAX package's other knobs among them); every ``HVD_TPU_SERVE_*`` variable
  reaches ``ServeConfig.from_env()`` as it reaches the JAX one;
  ``HVD_TPU_BOOT_TIMEOUT`` reaches ``init_process_group``'s timeout.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import optax

import horovod_tpu as jhvd
from horovod_tpu.common import basics as jbasics
from horovod_tpu.metrics import instruments as JI
from horovod_tpu.ops import collective_ops as jco
from horovod_tpu.serving.engine import ServeConfig as JServeConfig
from horovod_tpu.utils import env_parser as jenv
from horovod_tpu_torch.common import basics as tbasics
from horovod_tpu_torch.serving import ServeConfig
from horovod_tpu_torch.utils import env_parser as tenv

from test_torch_collectives import spawn_ranks

ROOT = Path(__file__).resolve().parents[1]

#: the model's leaves (two Linear layers, the second without a bias):
#: 25 floats, padded to 26 at world 2, so the padding is live
SHAPES = [(5, 3), (5,), (1, 5)]

ZERO_WORKER = r"""
import json
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.metrics import instruments as I
from horovod_tpu_torch.ops import collective_ops as co

rank, world, store, out, tmp = int(sys.argv[1]), int(sys.argv[2]), \
    sys.argv[3], sys.argv[4], sys.argv[5]
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
calls = []
submit = co._submit


def recording(name, opname, tree, start):
    calls.append([name or opname, opname])
    return submit(name, opname, tree, start)


co._submit = recording


def samples():
    return (dict(I.COLLECTIVES.samples()), dict(I.COLLECTIVE_BYTES.samples()))


def delta(after, before):
    return {"|".join(k): v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


rs = np.random.RandomState(7 + rank)
x = torch.from_numpy(rs.randn(4, 3).astype(np.float32))
y = torch.from_numpy(rs.randn(4, 1).astype(np.float32))
res = {}
for tag, min_bytes in (("sharded", 0), ("unsharded", 1 << 30)):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 5), torch.nn.Tanh(),
                                torch.nn.Linear(5, 1, bias=False))
    opt = hvd.ZeroDistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        min_total_bytes=min_bytes)
    (model(x) - y).pow(2).mean().backward()
    timeline = f"{tmp}/{tag}{rank}.json"
    hvd.start_timeline(timeline, mark_cycles=False)
    calls.clear()
    before = samples()
    opt.step()
    after = samples()
    hvd.stop_timeline()
    res[tag + "/sharded"] = np.array(opt.sharded)
    res[tag + "/calls"] = np.array(json.dumps(calls))
    res[tag + "/counts"] = np.array(json.dumps(delta(after[0], before[0])))
    res[tag + "/bytes"] = np.array(json.dumps(delta(after[1], before[1])))
    res[tag + "/timeline"] = np.array(open(timeline).read())
    for j, p in enumerate(model.parameters()):
        res[f"{tag}/param{j}"] = p.detach().numpy().copy()
np.savez(out, **res)
hvd.shutdown()
"""


@pytest.fixture(scope="module")
def zero_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero_names")
    return spawn_ranks(ZERO_WORKER, 2, tmp, str(tmp), timeout=180)


def _samples():
    return dict(JI.COLLECTIVES.samples()), dict(JI.COLLECTIVE_BYTES.samples())


def _delta(after, before):
    return {"|".join(k): v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _jax_step(monkeypatch, min_bytes):
    """One step of the JAX package's ZeroDistributedOptimizer as rank 0
    of two: (the (name, op) of each collective it submits, its counter
    deltas, its byte deltas)."""
    eng = jbasics._require_init().engine
    monkeypatch.setattr(jco, "_native", lambda tensor=None: None)
    monkeypatch.setattr(eng, "member_info", lambda process_set=None: (2, 0))
    monkeypatch.setattr(eng, "reducescatter_multi",
                        lambda xs, op=None, process_set=None: None)
    # every member contributes this rank's tensor
    monkeypatch.setattr(eng, "reducescatter",
                        lambda x, op=None, process_set=None:
                        2 * x[:x.shape[0] // 2])
    monkeypatch.setattr(eng, "allgather", lambda x, process_set=None:
                        jnp.concatenate([x, x]))
    monkeypatch.setattr(eng, "allreduce", lambda x, *a, **k: x)
    calls = []
    span = jco._span

    @contextlib.contextmanager
    def recording(name, opname, tree=None):
        calls.append([name or opname, opname])
        with span(name, opname, tree):
            yield

    monkeypatch.setattr(jco, "_span", recording)
    rs = np.random.RandomState(3)
    params = [jnp.asarray(rs.randn(*s).astype(np.float32)) for s in SHAPES]
    grads = [jnp.asarray(rs.randn(*s).astype(np.float32)) for s in SHAPES]
    zopt = jhvd.ZeroDistributedOptimizer(optax.sgd(0.1),
                                         min_total_bytes=min_bytes)
    state = zopt.init(params)
    before = _samples()
    zopt.update(grads, state, params)
    after = _samples()
    return calls, _delta(after[0], before[0]), _delta(after[1], before[1])


@pytest.mark.parametrize("tag,min_bytes", [("sharded", 0),
                                           ("unsharded", 1 << 30)])
def test_flat_zero_books_the_reference_collectives(tag, min_bytes,
                                                   zero_ranks, monkeypatch):
    calls, counts, nbytes = _jax_step(monkeypatch, min_bytes)
    want = ([["zero.grads", "reducescatter"], ["zero.updates", "allgather"]]
            if tag == "sharded" else [["zero.grads", "allreduce"]])
    assert calls == want
    padded = 26 * 4  # the padded fp32 bucket
    assert sum(nbytes.values()) == (padded + padded // 2 if tag == "sharded"
                                    else padded)
    for r in zero_ranks:
        assert bool(r[tag + "/sharded"]) == (tag == "sharded")
        assert json.loads(str(r[tag + "/calls"])) == want
        assert json.loads(str(r[tag + "/counts"])) == counts
        assert json.loads(str(r[tag + "/bytes"])) == nbytes
        timeline = str(r[tag + "/timeline"])
        for name, _ in want:
            assert f'"{name}"' in timeline, name


def test_flat_zero_sharded_and_unsharded_steps_agree(zero_ranks):
    for j in range(len(SHAPES)):
        for r in zero_ranks:
            np.testing.assert_array_equal(r[f"sharded/param{j}"],
                                          r[f"unsharded/param{j}"])
        np.testing.assert_array_equal(zero_ranks[0][f"sharded/param{j}"],
                                      zero_ranks[1][f"sharded/param{j}"])


# -- the chaos kill's crash bundle -------------------------------------------

KILL = r"""
from horovod_tpu_torch import chaos, trace
from horovod_tpu_torch.trace import flight

flight.note_metrics_baseline()
chaos.configure("elastic.commit:kill,at=0,code=7")
with trace.span("train.step", step=3):
    chaos.point("elastic.commit")
print("survived")
"""


def test_chaos_kill_leaves_a_crash_bundle(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               HVD_TPU_TRACE_BUNDLE_DIR=str(tmp_path / "bundles"))
    proc = subprocess.run([sys.executable, "-c", KILL], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 7, proc.stderr
    assert "survived" not in proc.stdout
    from horovod_tpu_torch.trace import flight

    paths = sorted((tmp_path / "bundles").iterdir())
    assert len(paths) == 1
    bundle = flight.read_bundle(str(paths[0]))
    assert bundle["reason"] == "chaos_kill"
    assert bundle["extra"] == {"site": "elastic.commit"}
    assert any(e["name"] == "chaos.inject"
               and e.get("args", {}).get("site") == "elastic.commit"
               for e in bundle["trace"]["traceEvents"])


# -- the knobs ----------------------------------------------------------------

KNOBS = ("FUSION_THRESHOLD", "CYCLE_TIME", "CACHE_CAPACITY", "TIMELINE",
         "TIMELINE_MARK_CYCLES", "STALL_CHECK_DISABLE",
         "STALL_CHECK_TIME_SECONDS", "STALL_SHUTDOWN_TIME_SECONDS",
         "AUTOTUNE", "AUTOTUNE_LOG", "OVERLAP_BUCKET_BYTES",
         "OVERLAP_AUTOTUNE", "OVERLAP_AUTOTUNE_TRIALS",
         "OVERLAP_AUTOTUNE_STEPS", "HIERARCHICAL_ALLREDUCE",
         "DCN_WIRE_DTYPE", "ELASTIC", "LOG_LEVEL", "TPU_OPERATIONS")
VALUES = ("0", "1", "7", "-3", "1.5", "64MB", "true", "off", "Bf16", "xla",
          "", "4096")


def _from_env(cls):
    try:
        return ("ok", dataclasses.asdict(cls.from_env()))
    except ValueError as e:
        return ("error", str(e))


#: the port's Config fields: the JAX package's that the port reads
FIELDS = [f.name for f in dataclasses.fields(tenv.Config)]


def _shared(outcome):
    """A JAX ``_from_env`` outcome cut to the port's fields."""
    kind, value = outcome
    return (kind, {k: value[k] for k in FIELDS} if kind == "ok" else value)


def test_config_fields_are_the_reference_fields():
    """The port's fields are JAX fields, in the JAX order, with the JAX
    defaults, and each one has a reader in the port outside
    env_parser.py: a field nothing reads would silence the env pass's
    stale-row check."""
    jfields = [f.name for f in dataclasses.fields(jenv.Config)]
    assert FIELDS == [n for n in jfields if n in FIELDS]
    assert dataclasses.asdict(tenv.Config()) == \
        _shared(("ok", dataclasses.asdict(jenv.Config())))[1]
    pkg = ROOT / "horovod_tpu_torch"
    sources = "\n".join(
        p.read_text() for p in pkg.rglob("*.py")
        if p != pkg / "utils" / "env_parser.py" and "analysis" not in p.parts)
    unread = [n for n in FIELDS if f".{n}" not in sources]
    assert not unread, f"Config fields nothing reads: {unread}"


SEEDS = range(16)


#: the knobs that raise on a garbled value
STRICT = ("FUSION_THRESHOLD", "OVERLAP_BUCKET_BYTES",
          "OVERLAP_AUTOTUNE_TRIALS", "OVERLAP_AUTOTUNE_STEPS")


def _seeded_env(seed, monkeypatch):
    """Each knob's two spellings unset, or set to a pick of VALUES; the
    strict knobs get only valid picks except for every fourth seed, so
    most seeds parse."""
    rs = np.random.RandomState(seed)
    for name in KNOBS:
        pool = (VALUES if name not in STRICT or seed % 4 == 0
                else ("1", "7", "4096"))
        for prefix in ("HVD_TPU_", "HOROVOD_"):
            monkeypatch.delenv(prefix + name, raising=False)
            if rs.rand() < 0.35:
                monkeypatch.setenv(prefix + name,
                                   pool[rs.randint(len(pool))])


@pytest.mark.parametrize("seed", SEEDS)
def test_config_from_env_matches_jax(seed, monkeypatch):
    _seeded_env(seed, monkeypatch)
    assert _from_env(tenv.Config) == _shared(_from_env(jenv.Config))


def test_config_seeds_parse_and_raise(monkeypatch):
    outcomes = []
    for seed in SEEDS:
        _seeded_env(seed, monkeypatch)
        outcomes.append(_from_env(tenv.Config)[0])
    assert outcomes.count("ok") >= 10 and "error" in outcomes


SERVE = [
    ("BLOCK_SIZE", "8", "block_size", 8),
    ("NUM_BLOCKS", "123", "num_blocks", 123),
    ("TOKEN_BUDGET", "512", "token_budget", 512),
    ("WATERMARK", "7", "watermark", 7),
    ("PREFILL_TIERS", "16,32", "prefill_tiers", (16, 32)),
    ("DECODE_TIERS", "1,2", "decode_tiers", (1, 2)),
    ("SHARDS", "2", "shards", 2),
    ("PREFILL_CHUNK", "16", "prefill_chunk", 16),
    ("PREFIX_CACHE", "0", "prefix_cache", False),
    ("DEADLINE", "1.5", "deadline_s", 1.5),
    ("SPEC", "1", "spec", True),
    ("SPEC_K", "3", "spec_k", 3),
    ("SPEC_DRAFTER", "ngram", "spec_drafter", "ngram"),
]


@pytest.mark.parametrize("env,value,field,want", SERVE,
                         ids=[s[0] for s in SERVE])
def test_serve_knob_reaches_serve_config(env, value, field, want,
                                         monkeypatch):
    for other, *_ in SERVE:
        monkeypatch.delenv("HVD_TPU_SERVE_" + other, raising=False)
    default = getattr(ServeConfig.from_env(), field)
    assert default != want
    monkeypatch.setenv("HVD_TPU_SERVE_" + env, value)
    assert getattr(ServeConfig.from_env(), field) == want
    assert getattr(JServeConfig.from_env(), field) == want
    # an explicit override wins over the environment
    assert getattr(ServeConfig.from_env(**{field: default}),
                   field) == default


BOOT = r"""
import os
import torch.distributed as dist
import horovod_tpu_torch as hvd

seen = []
real = dist.init_process_group


def spy(*args, **kwargs):
    seen.append(kwargs["timeout"].total_seconds())
    return real(*args, **kwargs)


dist.init_process_group = spy
for value in ("1234.5", None, "0"):
    if value is None:
        os.environ.pop("HVD_TPU_BOOT_TIMEOUT", None)
    else:
        os.environ["HVD_TPU_BOOT_TIMEOUT"] = value
    hvd.init(device="cpu")
    hvd.shutdown()
print(seen)
"""


def test_boot_timeout_reaches_init_process_group():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", BOOT], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[-2] == "[1234.5, 600.0, 600.0]"


def test_boot_timeout_garbled_keeps_the_default(monkeypatch):
    monkeypatch.setenv("HVD_TPU_BOOT_TIMEOUT", "soon")
    assert tbasics._timeout().total_seconds() == tbasics._TIMEOUT_S
    monkeypatch.setenv("HVD_TPU_BOOT_TIMEOUT", "90")
    assert tbasics._timeout().total_seconds() == 90.0
