"""Job-wide metric snapshots (``metrics/aggregate.py``) against the JAX
package's.

* ``snapshot`` and ``merge_snapshots`` of identically filled registries
  give the JAX functions' output, as JSON (pure Python on both sides),
  for one rank and for ranks whose histograms disagree on their bounds.
* ``cluster_snapshot`` at world 2, one process per rank over gloo: every
  rank's merged view equals ``horovod_tpu.metrics.aggregate
  .merge_snapshots`` of the two ranks' own snapshots, and carries them
  under ``per_rank``; counters sum, gauges get the ``rank`` label,
  histograms with the same bounds add bucket by bucket, and mismatched
  bounds keep only sum and count.  At world 1 it round-trips the
  default registry.
"""

import json

import pytest

import horovod_tpu_torch as hvd
from horovod_tpu.metrics import aggregate as jagg
from horovod_tpu.metrics import registry as jreg
from horovod_tpu_torch.metrics import aggregate as tagg
from horovod_tpu_torch.metrics import registry as treg

from test_torch_collectives import spawn_ranks

#: one rank's registry contents, shared by the tests and the workers
FILL = r'''
def fill(mod, rank):
    reg = mod.MetricsRegistry()
    c = mod.counter("t_requests_total", "Requests by kind", ["kind"],
                    registry=reg)
    c.labels("a").inc(1 + rank)
    c.labels("b").inc(2.5)
    if rank:
        c.labels("only_rank1").inc()
    g = mod.gauge("t_step_seconds", "Step time", ["phase"], registry=reg)
    g.labels("fwd").set(0.125 * (rank + 1))
    h = mod.histogram("t_latency_seconds", "Latency", ["op"],
                      buckets=(0.1, 1.0), registry=reg)
    for v in (0.05, 0.5, 2.0 + rank):
        h.labels("x").observe(v)
    hb = mod.histogram("t_bounds_seconds", "Bounds differ across ranks",
                       buckets=(0.1, 1.0) if rank == 0 else (0.5,),
                       registry=reg)
    hb.observe(0.25 * (rank + 1))
    return reg
'''
exec(FILL)

WORKER = r"""
import json, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.metrics import aggregate, registry

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
""" + FILL + r"""
reg = fill(registry, rank)
local = aggregate.snapshot(reg)
merged = aggregate.cluster_snapshot(reg)
as_bytes = lambda d: np.frombuffer(json.dumps(d, sort_keys=True).encode(),
                                   np.uint8)
np.savez(out, local=as_bytes(local), merged=as_bytes(merged))
hvd.shutdown()
"""


def _json(d):
    return json.loads(json.dumps(d, sort_keys=True))


@pytest.mark.parametrize("ranks", [1, 2])
def test_snapshot_and_merge_match_jax(ranks):
    tsnaps = [tagg.snapshot(fill(treg, r)) for r in range(ranks)]
    jsnaps = [jagg.snapshot(fill(jreg, r)) for r in range(ranks)]
    assert _json(tsnaps) == _json(jsnaps)
    assert _json(tagg.merge_snapshots(tsnaps)) == \
        _json(jagg.merge_snapshots(jsnaps))


def test_cluster_snapshot_world2_matches_jax_merge(tmp_path):
    outs = spawn_ranks(WORKER, 2, tmp_path)
    decode = lambda a: json.loads(bytes(a).decode())  # noqa: E731
    local = [decode(o["local"]) for o in outs]
    want = _json(jagg.merge_snapshots(local))
    for o in outs:
        merged = decode(o["merged"])
        assert merged.pop("per_rank") == local
        assert merged == want
    m = want["metrics"]
    assert want["ranks"] == 2
    assert {tuple(k): v for k, v in m["t_requests_total"]["series"]} == {
        ("a",): 3.0, ("b",): 5.0, ("only_rank1",): 1.0}
    assert m["t_step_seconds"]["labelnames"] == ["rank", "phase"]
    assert m["t_step_seconds"]["series"] == [[["0", "fwd"], 0.125],
                                             [["1", "fwd"], 0.25]]
    (_, lat), = m["t_latency_seconds"]["series"]
    assert lat["count"] == 6 and lat["sum"] == pytest.approx(6.1)
    assert lat["buckets"] == [2, 2, 2]  # per bucket: <=0.1, <=1, +Inf
    (_, bounds), = m["t_bounds_seconds"]["series"]
    assert bounds["buckets"] == []
    assert (bounds["count"], bounds["sum"]) == (2, 0.75)


def test_cluster_snapshot_world1_round_trips():
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        reg = fill(treg, 0)
        merged = tagg.cluster_snapshot(reg)
        assert merged["ranks"] == 1
        assert merged["per_rank"] == [_json(tagg.snapshot(reg))]
        assert merged["metrics"] == _json(jagg.merge_snapshots(
            [jagg.snapshot(fill(jreg, 0))]))["metrics"]
        # the default registry, as the package exports it
        from horovod_tpu_torch import metrics

        full = metrics.cluster_snapshot()
        assert "hvd_tpu_collectives_total" in full["metrics"]
    finally:
        hvd.shutdown()
