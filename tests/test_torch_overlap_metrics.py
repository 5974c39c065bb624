"""The overlap inventory and overlap metrics against the JAX package's.

* ``ops.comm_model.overlap_inventory`` of the hooked reducer's launch
  record, on the MLP chain of ``tests/test_overlap.py`` (four 16x16
  fp32 weights, ``bucket_bytes`` 1 KiB: one weight a bucket) trained one
  step by ``training.data_parallel_train_step(overlap=True)``, equals
  the JAX ``overlap_inventory`` of the lowered overlapped chain
  (``_chain_fn``) at the JAX mesh's 8 ranks exactly in: the number of
  collectives, each one's payload and stream bytes, which collectives
  trail (``compute_after == 0``), ``exposed_fraction`` (a quarter) and
  ``interleaved``.  The counts themselves differ by construction (the
  port's is gradients still to come, JAX's matmul lines still to run).
* The step without overlap gives ``exposed_fraction == 1.0`` and
  ``interleaved`` false, as the JAX unoverlapped chain does.
* ``record_overlap_metrics`` sets the gauge to the inventory's
  ``exposed_fraction`` and observes one launch lead per collective,
  as the JAX one does for its own inventory (the case of
  ``test_overlap.py``'s ``test_record_overlap_metrics_sets_gauge``).
* ``modeled_overlap_exposed`` is the JAX function.
* ``measured_overlap_exposed`` on synthetic kernel intervals: full,
  partial and no overlap, compute on the collective's own stream not
  counted, and the CPU events, copies and annotation ranges of a
  capture ignored.
"""

import numpy as np
import pytest

import torch
from torch.autograd import DeviceType

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.metrics import instruments as jmetrics
from horovod_tpu.ops import comm_model as jcomm
from horovod_tpu.ops.overlap import record_overlap_metrics as jrecord
from horovod_tpu_torch import training
from horovod_tpu_torch.metrics import instruments as tmetrics
from horovod_tpu_torch.ops import comm_model as tcomm
from horovod_tpu_torch.ops.overlap import (
    exposed_comm_share, measured_overlap_exposed, record_overlap_metrics,
)

from test_overlap import _chain_fn, _mlp_chain

BUCKET_BYTES = 1 << 10


class _Chain(torch.nn.Module):
    """The JAX chain's forward: relu(x @ w_k) for k < 3, then
    mean((h @ w_3) ** 2) as the loss."""

    def __init__(self, params):
        super().__init__()
        self.w = torch.nn.ParameterList(
            torch.nn.Parameter(torch.as_tensor(np.array(params[f"w{k}"])))
            for k in range(len(params)))

    def forward(self, x):
        for w in self.w[:-1]:
            x = torch.relu(x @ w)
        return x @ self.w[-1]


def _port_record(overlap, params, x):
    model = _Chain(params)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = training.data_parallel_train_step(
        model, opt, loss_fn=lambda out, _: (out ** 2).mean(),
        overlap=overlap, bucket_bytes=BUCKET_BYTES)
    state = training.create_train_state(model, opt)
    step(state, torch.as_tensor(np.array(x)), None)
    return step.reducer.last_record


@pytest.fixture(scope="module")
def chain():
    hvd.shutdown()
    hvd.init(device="cpu")
    segments, params, x = _mlp_chain()
    out = {}
    for overlap in (True, False):
        jinv = jcomm.overlap_inventory(_chain_fn(
            segments, jhvd.size(), BUCKET_BYTES, overlap
        ).lower(params, x).as_text())
        out[overlap] = (_port_record(overlap, params, x), jinv)
    hvd.shutdown()
    return out


def _shape(inv):
    return dict(n=len(inv["collectives"]),
                payload=[c["payload_bytes"] for c in inv["collectives"]],
                stream=[c["stream_bytes"] for c in inv["collectives"]],
                trails=[c["compute_after"] == 0 for c in inv["collectives"]],
                total=inv["total_stream_bytes"],
                trailing=inv["trailing_stream_bytes"],
                exposed=inv["exposed_fraction"],
                interleaved=inv["interleaved"])


def test_overlapped_inventory_matches_jax(chain):
    record, jinv = chain[True]
    inv = tcomm.overlap_inventory(record, world=jhvd.size())
    assert _shape(inv) == _shape(jinv)
    assert inv["exposed_fraction"] == 0.25 and inv["interleaved"]
    # one weight a bucket, launched as each gradient lands: 3, 2, 1 and
    # then no gradient still to come
    assert [c["compute_after"] for c in inv["collectives"]] == [3, 2, 1, 0]
    assert record["world"] == 1
    # at the record's own world nothing streams: nothing is exposed
    alone = tcomm.overlap_inventory(record)
    assert alone["total_stream_bytes"] == 0
    assert alone["exposed_fraction"] == 0.0 and not alone["interleaved"]
    assert tcomm.overlap_inventory(
        record, min_payload_bytes=BUCKET_BYTES + 1,
        world=8)["collectives"] == []


def test_unoverlapped_inventory_trails(chain):
    record, jinv = chain[False]
    inv = tcomm.overlap_inventory(record, world=jhvd.size())
    assert inv["exposed_fraction"] == jinv["exposed_fraction"] == 1.0
    assert not inv["interleaved"] and not jinv["interleaved"]
    assert all(c["compute_after"] == 0 for c in inv["collectives"])
    assert sum(c["payload_bytes"] for c in inv["collectives"]) == \
        sum(c["payload_bytes"] for c in jinv["collectives"])


def test_record_overlap_metrics_sets_gauge(chain):
    record, _ = chain[True]
    inv = tcomm.overlap_inventory(record, world=8)
    lead0 = tmetrics.OVERLAP_LAUNCH_LEAD.get()["count"]
    assert record_overlap_metrics(inv) is inv
    assert tmetrics.OVERLAP_EXPOSED_FRACTION.get() == \
        pytest.approx(inv["exposed_fraction"])
    assert tmetrics.OVERLAP_LAUNCH_LEAD.get()["count"] - lead0 == 4
    # the JAX package's own: its gauge reads its inventory's fraction,
    # the same number
    segments, params, x = _mlp_chain()
    jinv = jrecord(_chain_fn(segments, jhvd.size(), BUCKET_BYTES, True)
                   .lower(params, x).as_text())
    assert jmetrics.OVERLAP_EXPOSED_FRACTION.get() == pytest.approx(
        jinv["exposed_fraction"])
    assert tmetrics.OVERLAP_EXPOSED_FRACTION.get() == \
        jmetrics.OVERLAP_EXPOSED_FRACTION.get()


@pytest.mark.parametrize("args", [
    ([4 << 20] * 8, 0.05, 50e9, 4),
    ([1 << 20, 3 << 20, 64 << 20], 0.2, 25e9, 8, 0.5),
    ([1000], 1.0, 1e3, 1),
])
def test_modeled_overlap_exposed_is_jax(args):
    assert tcomm.modeled_overlap_exposed(*args) == \
        jcomm.modeled_overlap_exposed(*args)


class _Event:
    def __init__(self, name, start, end, stream, device=DeviceType.CUDA):
        self.name, self.device_type = name, device
        self.device_resource_id = stream
        self.time_range = type("R", (), {"start": start, "end": end})()


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


@pytest.mark.parametrize("compute, want", [
    ([(0, 100, 7)], 0.0),                       # fully covered
    ([(50, 150, 7)], 0.5),                      # half covered
    ([(20, 40, 7), (30, 60, 8)], 0.6),          # two streams, union 40
    ([(200, 300, 7)], 1.0),                     # no overlap
    ([(0, 100, 3)], 1.0),                       # the collective's stream
])
def test_measured_overlap_exposed(compute, want):
    events = [_Event("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0, 100, 3)]
    events += [_Event("sm90_xmma_gemm_bf16", a, b, s) for a, b, s in compute]
    events.append(_Event("aten::mm", 0, 1000, 7, DeviceType.CPU))
    # the bridge's range mirrored onto the device, and a copy: no compute
    events.append(_Event("hvd_tpu::bucket.0::COMM", 0, 100, 7))
    events.append(_Event("Memcpy DtoD (Device -> Device)", 0, 100, 7))
    assert measured_overlap_exposed(_Prof(events)) == pytest.approx(want)


def test_exposed_comm_share_edges():
    assert exposed_comm_share([], [(0, 1, 1)]) is None
    assert measured_overlap_exposed(_Prof([_Event("gemm", 0, 5, 1)])) is None
    # two collectives, each judged against the other streams' compute
    assert exposed_comm_share([(0, 10, 1), (20, 30, 2)],
                              [(0, 30, 1)]) == pytest.approx(0.5)
