"""The port's observability layer against the JAX package's.

* ``utils/timeline.py``: the same ``start`` / ``end`` / ``instant``
  calls on the JAX package's ``Timeline`` and on the port's give the
  same events (``name``, ``ph``, ``pid``, ``cat``, ``args``; ``ts``
  left out, ``tid`` compared as a consistent mapping of row names).
* Collective spans: world-1 ``allreduce`` / ``allgather`` /
  ``broadcast`` with ``HVD_TPU_TIMELINE`` set write one ``COMM``
  begin/end pair per call, labelled as the JAX package labels the same
  calls on its Python path (its ``XLA_COMM`` is the port's ``COMM``);
  a 16 MB allreduce's span covers a real share of its wall time (the
  counterpart of ``test_native_core.py``'s
  ``test_native_timeline_comm_span_covers_execution``); an async op's
  span ends at its ``wait``; the optimizer's buckets get one ``COMM``
  row each (``bucket.<b>``) and, with ``HVD_TPU_TIMELINE_MARK_CYCLES``,
  one ``CYCLE`` instant per gradient flush.
* ``start_timeline`` / ``stop_timeline`` at runtime, and their errors
  (a second start, a file that cannot be opened: ``ValueError``).
* Counters: ``hvd_tpu_collectives_total`` (summed over its ``path``
  label: the JAX package may book ``native``) and
  ``hvd_tpu_collective_bytes_total`` move by the JAX package's amounts
  for the same public calls on the same numpy inputs; ``barrier``,
  which the JAX package does not count, counts once with no bytes.
* The profiler bridge: ``torch.profiler`` on the CPU records
  ``hvd_tpu::bridge_probe::ENQUEUE`` and ``::COMM`` (the counterpart of
  ``test_eager_ops.py``'s ``test_profiler_bridge_spans_in_xplane_capture``),
  and ``HVD_TPU_PROFILER_BRIDGE=0`` keeps them out.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.common import basics as jbasics
from horovod_tpu.metrics import instruments as jmetrics
from horovod_tpu.utils.timeline import Timeline as JTimeline
from horovod_tpu_torch import trace
from horovod_tpu_torch.metrics import instruments as tmetrics
from horovod_tpu_torch.utils.timeline import Timeline

ROOT = Path(__file__).resolve().parents[1]#: each test's time limit, seconds (the whole file takes ~25 s)
LIMIT_S = 60


@pytest.fixture(autouse=True)
def _time_limit():
    """Fail a test that runs past LIMIT_S instead of hanging the suite."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def port_world(monkeypatch):
    """A fresh world-1 port on the CPU (the env is read at init)."""
    hvd.shutdown()
    yield monkeypatch
    hvd.shutdown()


@pytest.fixture
def jax_python_path(monkeypatch):
    """The JAX package's collectives on its Python path (its timeline is
    then the Python writer's, as the port's is)."""
    ctrl = jbasics._state.controller
    if ctrl is not None:
        monkeypatch.setattr(type(ctrl), "is_native", False)
    yield
    monkeypatch.undo()


def _events(path):
    with open(path) as f:
        return json.load(f)


def _rows(events, comm="COMM"):
    """(name, ph, pid, cat, args, row) per event, ``comm`` read as
    ``COMM``; ``row`` numbers the distinct ``tid`` values in order of
    first appearance (None for events without one)."""
    out, rows = [], {}
    for e in events:
        name = "COMM" if e["name"] == comm else e["name"]
        row = rows.setdefault(e["tid"], len(rows)) if "tid" in e else None
        out.append((name, e["ph"], e["pid"], e.get("cat"), e.get("args"),
                    row))
    return out


def test_timeline_writer_matches_jax(tmp_path):
    calls = [("start", "a", "COMM"), ("start", "b", "COMM"),
             ("end", "a", "COMM"), ("instant", "CYCLE"),
             ("end", "b", "COMM"), ("start", "a", "COMM"),
             ("end", "a", "COMM"), ("instant", "CYCLE")]
    files = []
    for cls, name in ((JTimeline, "jax.json"), (Timeline, "port.json")):
        path = tmp_path / name
        tl = cls(str(path), rank=3)
        for c in calls:
            getattr(tl, c[0])(*c[1:])
        tl.close()
        tl.close()  # a second close is a no-op
        tl.start("late", "COMM")  # dropped after close
        files.append(_events(path))
    jrows, trows = (_rows(e) for e in files)
    assert trows == jrows
    assert trows[0] == ("process_name", "M", 3, None,
                        {"name": "hvd_tpu rank 3"}, None)
    assert [r[5] for r in trows if r[5] is not None] == [0, 1, 0, 1, 0, 0]
    ts = [e["ts"] for e in files[1] if "ts" in e]
    assert ts == sorted(ts)


def _port_calls(x):
    hvd.allreduce(torch.as_tensor(x), name="obs_ar")
    hvd.allgather(torch.as_tensor(x))
    hvd.broadcast(torch.as_tensor(x), 0, name="obs_bc")


def _jax_calls(x):
    jhvd.allreduce(jnp.asarray(x), name="obs_ar")
    jhvd.allgather(jnp.asarray(x))
    jhvd.broadcast(jnp.asarray(x), 0, name="obs_bc")


def test_collective_spans_match_jax(tmp_path, port_world, jax_python_path):
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    port_world.setenv("HVD_TPU_TIMELINE", str(tmp_path / "port.json"))
    hvd.init(device="cpu")
    _port_calls(x)
    hvd.shutdown()
    jpath = tmp_path / "jax.json"
    jhvd.start_timeline(str(jpath))
    try:
        _jax_calls(x)
    finally:
        jhvd.stop_timeline()
    trows = _rows(_events(tmp_path / "port.json"))
    jrows = _rows(_events(jpath), comm="XLA_COMM")
    assert trows[1:] == jrows[1:]
    labels = [r[4]["tensor"] for r in trows if r[1] == "B"]
    assert labels == ["obs_ar", "allgather", "obs_bc"]
    assert [r[:2] for r in trows[1:]] == [("COMM", "B"), ("COMM", "E")] * 3


def test_comm_span_covers_execution(tmp_path, port_world):
    """COMM ends when the result is ready: a 16 MB allreduce's span is a
    real share of its wall time (not a dispatch-only sliver)."""
    port_world.setenv("HVD_TPU_TIMELINE", str(tmp_path / "t.json"))
    hvd.init(device="cpu")
    big = torch.ones(4 << 20)
    t0 = time.perf_counter()
    hvd.allreduce(big, name="comm_span_probe", op=hvd.Sum)
    wall = time.perf_counter() - t0
    hvd.shutdown()
    spans = {e["ph"]: e["ts"] for e in _events(tmp_path / "t.json")
             if e.get("name") == "COMM"}
    assert set(spans) == {"B", "E"}
    assert (spans["E"] - spans["B"]) / 1e6 >= 0.05 * wall


def test_async_span_ends_at_wait(tmp_path, port_world):
    hvd.init(device="cpu")
    hvd.start_timeline(str(tmp_path / "t.json"))
    h = hvd.allreduce_async(torch.ones(16), name="late_wait")
    time.sleep(0.05)
    h.wait()
    h.wait()  # a second wait ends nothing again
    hvd.stop_timeline()
    ev = [e for e in _events(tmp_path / "t.json") if e["name"] == "COMM"]
    assert [e["ph"] for e in ev] == ["B", "E"]
    assert ev[1]["ts"] - ev[0]["ts"] >= 0.04e6


def test_bucket_rows_and_cycle_marks(tmp_path, port_world):
    """The hooked optimizer's buckets are timeline rows of their own
    (``bucket.<b>``, one COMM pair a bucket a step), and with
    HVD_TPU_TIMELINE_MARK_CYCLES one CYCLE instant marks each flush."""
    port_world.setenv("HVD_TPU_TIMELINE", str(tmp_path / "t.json"))
    port_world.setenv("HVD_TPU_TIMELINE_MARK_CYCLES", "1")
    hvd.init(device="cpu")
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 2))
    port_world.setenv("HVD_TPU_OVERLAP_BUCKET_BYTES", str(8 * 8 * 4))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    n_buckets = opt._reducer.schedule.num_buckets
    assert n_buckets > 1
    c0 = sum(v for _, v in tmetrics.COLLECTIVES.samples())
    for _ in range(2):
        opt.zero_grad()
        model(torch.randn(4, 8)).square().mean().backward()
        opt.step()
    c1 = sum(v for _, v in tmetrics.COLLECTIVES.samples())
    opt.close()
    hvd.shutdown()
    ev = _events(tmp_path / "t.json")
    begins = [e["args"]["tensor"] for e in ev if e["ph"] == "B"]
    assert begins == [f"bucket.{b}" for b in range(n_buckets)] * 2
    assert sum(e["ph"] == "E" for e in ev) == len(begins) == c1 - c0
    assert [e["name"] for e in ev if e["ph"] == "i"] == ["CYCLE", "CYCLE"]


def test_runtime_start_stop_timeline(tmp_path, port_world):
    hvd.init(device="cpu")
    path = tmp_path / "runtime.json"
    hvd.allreduce(torch.ones(8), name="before_timeline")  # not traced
    hvd.start_timeline(str(path))
    try:
        with pytest.raises(ValueError):
            hvd.start_timeline(str(tmp_path / "other.json"))  # already on
        hvd.allreduce(torch.ones(32), name="runtime_traced")
    finally:
        hvd.stop_timeline()
    hvd.stop_timeline()  # no timeline: nothing to close
    hvd.allreduce(torch.ones(8), name="after_timeline")  # not traced
    tensors = {e.get("args", {}).get("tensor") for e in _events(path)
               if e["ph"] in ("B", "E")}
    assert tensors == {"runtime_traced", None}
    assert not (tmp_path / "other.json").exists()
    # a second round writes a fresh file
    path2 = tmp_path / "runtime2.json"
    hvd.start_timeline(str(path2))
    hvd.allreduce(torch.ones(16), name="second_round")
    hvd.stop_timeline()
    assert [e["args"]["tensor"] for e in _events(path2)
            if e["ph"] == "B"] == ["second_round"]
    with pytest.raises(ValueError, match="cannot open"):
        hvd.start_timeline(str(tmp_path / "no" / "such" / "dir.json"))
    with pytest.raises(ValueError, match="cannot open"):
        missing = tmp_path / "missing_dir" / "x.json"
        hvd.shutdown()
        port_world.setenv("HVD_TPU_TIMELINE", str(missing))
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def _counts(samples):
    """{op: value} summed over every other label."""
    out = {}
    for labels, v in samples:
        out[labels[0]] = out.get(labels[0], 0.0) + v
    return out


def _delta(metric, before):
    after = _counts(metric.samples())
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0)}


def test_counters_match_jax(port_world):
    rs = np.random.RandomState(1)
    a = rs.randn(8, 3).astype(np.float32)
    b = rs.randint(-5, 5, (8,)).astype(np.int32)
    c = rs.randn(16).astype(np.float32)
    hvd.init(device="cpu")

    def run(mod, conv):
        mod.allreduce({"a": conv(a), "b": conv(b)}, name="ctr_ar")
        mod.grouped_allreduce([conv(a), conv(c)])
        mod.allgather(conv(a))
        mod.broadcast(conv(c), 0)
        mod.alltoall(conv(a))
        mod.reducescatter(conv(c), op=mod.Sum)
        mod.grouped_reducescatter([conv(a), conv(c)], op=mod.Sum)

    deltas = []
    for mod, conv, metrics in ((hvd, torch.as_tensor, tmetrics),
                               (jhvd, jnp.asarray, jmetrics)):
        before = [_counts(m.samples()) for m in (metrics.COLLECTIVES,
                                                 metrics.COLLECTIVE_BYTES)]
        run(mod, conv)
        deltas.append((_delta(metrics.COLLECTIVES, before[0]),
                       _delta(metrics.COLLECTIVE_BYTES, before[1])))
    assert deltas[0] == deltas[1]
    assert deltas[0][0] == {"allreduce": 2, "allgather": 1, "broadcast": 1,
                            "alltoall": 1, "reducescatter": 2}
    assert deltas[0][1]["allreduce"] == a.nbytes + b.nbytes + a.nbytes \
        + c.nbytes
    # every submission went down the eager path, and each got a latency
    paths = {labels[1] for labels, _ in tmetrics.COLLECTIVES.samples()}
    assert paths == {"eager"}
    lat = {labels[0]: s["count"]
           for labels, s in tmetrics.OP_LATENCY.samples()}
    assert lat["alltoall"] >= 1 and lat["reducescatter"] >= 2
    # barrier: counted once, no bytes (the JAX package books none)
    before = [_counts(m.samples()) for m in (tmetrics.COLLECTIVES,
                                             tmetrics.COLLECTIVE_BYTES)]
    hvd.barrier()
    assert _delta(tmetrics.COLLECTIVES, before[0]) == {"barrier": 1}
    assert _delta(tmetrics.COLLECTIVE_BYTES, before[1]) == {}
    info = {labels: v for labels, v in tmetrics.PROCESS_INFO.samples()}
    assert info[("0", "0", "1", "1")] == 1


def test_profiler_bridge_records_spans(port_world):
    from torch.profiler import ProfilerActivity, profile

    hvd.init(device="cpu")
    x = torch.arange(1024, dtype=torch.float32)
    hvd.allreduce(x, name="bridge_warm")
    since = trace.now()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hvd.allreduce(x, name="bridge_probe", op=hvd.Sum)
    names = {e.name for e in prof.events()}
    assert "hvd_tpu::bridge_probe::ENQUEUE" in names, sorted(
        n for n in names if "hvd" in n)
    assert "hvd_tpu::bridge_probe::COMM" in names
    # the trace ring holds the catalogued sites with the collective's name
    sites = [(r[0], (r[3] or {}).get("name")) for r in trace.snapshot(since)
             if r[0].startswith("collective.")]
    assert ("collective.enqueue", "bridge_probe") in sites
    assert ("collective.exec", "bridge_probe") in sites


def test_profiler_bridge_off_keeps_the_ring():
    code = (
        "import torch\n"
        "from torch.profiler import profile, ProfilerActivity\n"
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch import trace\n"
        "hvd.init(device='cpu')\n"
        "with profile(activities=[ProfilerActivity.CPU]) as prof:\n"
        "    hvd.allreduce(torch.ones(4), name='quiet')\n"
        "assert not any('hvd_tpu::quiet' in e.name for e in prof.events())\n"
        "assert any(r[0] == 'collective.exec' for r in trace.snapshot())\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), HVD_TPU_PROFILER_BRIDGE="0")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
