"""The port's program-contract pass (``horovod_tpu_torch.analysis
.programs``) and the record it reads.

* Each check helper reports its drift on synthetic records: an injected
  extra collective, an unequal record sequence, a cross-slice group, a
  modeled != measured byte count, an off-menu key, a trailing overlap;
  and reports nothing on the clean case.  Where the JAX package's
  helper takes the same inputs (menu keys, byte dicts) or the same
  counts (collectives in a lowered module), its findings carry the same
  keys and messages.
* The pass is gated: without ``HVD_TPU_VERIFY_PROGRAMS=1`` it reports
  nothing and runs nothing; with it, ``python -m
  horovod_tpu_torch.analysis programs --device cpu`` runs the training
  (world 2), hierarchical and serving (world 4, two slices of two) legs
  on the CPU, each its full count of checks, and exits 0.  Asked for
  the card where torch sees none, the pass says so instead of falling
  back to the CPU; a job whose topology is not two slices is a finding,
  not an empty leg.
* No collective on a sharded decode step or a flat training step
  escapes ``collective_ops.recording()``: at world 2 over gloo each
  step's records equal its delta of ``hvd_tpu_collectives_total``, and
  the decode step's are the two all-reduces a layer that
  ``comm_model.modeled_serve_psum_bytes`` models.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from horovod_tpu.analysis import programs as jprog
from horovod_tpu_torch.analysis import programs as prog
from horovod_tpu_torch.ops import comm_model as tcm

from test_torch_collectives import spawn_ranks

ROOT = Path(__file__).resolve().parents[1]


def rec(op="all_reduce", nbytes=64, group=(0, 1)):
    return tcm.collective_record(op, nbytes, group)


def _keys(findings):
    return [f.key for f in findings]


def _strip_file(findings):
    return [(f.check, f.line, f.key, f.message) for f in findings]


def test_added_collectives_reports_an_injected_collective():
    base = [rec(), rec(nbytes=128)]
    assert prog.check_added_collectives("g", base, list(base)) == []
    found = prog.check_added_collectives("g", base, base + [rec()])
    assert _keys(found) == ["added-collectives:g"]
    assert "1 collective(s) added" in found[0].message
    assert found[0].file == prog.TRAINING_PY
    # the JAX helper counts the same way on lowered text
    line = "%0 = stablehlo.all_reduce(%x)\n"
    jfound = jprog.check_added_collectives("g", line * 2, line * 3)
    assert _strip_file(found) == _strip_file(jfound)
    # a budget admits that many
    assert prog.check_added_collectives("g", base, base + [rec()],
                                        budget=1) == []


def test_identical_reports_an_unequal_record_sequence():
    base = [rec(), rec(nbytes=128), rec("all_gather", 32)]
    assert prog.check_identical("t", base, [dict(r) for r in base]) == []
    # same count, one call changed: still a difference
    changed = [rec(), rec(nbytes=256), rec("all_gather", 32)]
    found = prog.check_identical("t", base, changed)
    assert _keys(found) == ["identical:t"]
    assert "first at call 1" in found[0].message
    assert "+0 collective(s)" in found[0].message
    # reordered calls differ as well
    assert prog.check_identical("t", base, base[::-1]) != []
    longer = prog.check_identical("t", base, base + [rec()])
    assert "first at call 3" in longer[0].message
    assert "+1 collective(s)" in longer[0].message


def test_dcn_exclusion_reports_a_cross_slice_group():
    slices = [0, 0, 1, 1]
    inside = [rec(group=(0, 1)), rec(group=(2, 3))]
    assert prog.check_dcn_exclusion("s", inside, slices) == []
    found = prog.check_dcn_exclusion(
        "s", inside + [rec(nbytes=80, group=(1, 2))], slices)
    assert _keys(found) == ["serve-dcn:s:all_reduce"]
    assert "payload 80 B, group size 2" in found[0].message
    assert found[0].file == prog.ENGINE_PY


def test_modeled_measured_reports_a_byte_mismatch():
    assert prog.check_modeled_measured(
        "h", {"ici": 10, "dcn": 4}, {"ici": 10, "dcn": 4, "x": 1}) == []
    found = prog.check_modeled_measured("h", {"ici": 10, "dcn": 4},
                                        {"ici": 12, "dcn": 4})
    assert _keys(found) == ["model-mismatch:h:ici"]
    assert "modeled ici = 10 B" in found[0].message
    assert "measure 12 B" in found[0].message
    jfound = jprog.check_modeled_measured("h", {"ici": 10, "dcn": 4},
                                          {"ici": 12, "dcn": 4})
    assert _keys(found) == _keys(jfound)
    # a tier the issued calls never touched measures None
    assert _keys(prog.check_modeled_measured("h", {"dcn": 0}, {})) == [
        "model-mismatch:h:dcn"]


def test_menu_keys_reports_an_off_menu_key():
    warmed = {("decode", 1, 1), ("mixed", 1, 8, None)}
    assert prog.check_menu_keys("e", warmed, warmed) == []
    dispatched = warmed | {("decode", 2, 4)}
    found = prog.check_menu_keys("e", warmed, dispatched)
    assert _keys(found) == ["off-menu:e:decode-2-4"]
    assert _strip_file(found) == _strip_file(
        jprog.check_menu_keys("e", warmed, dispatched))


@pytest.mark.parametrize("pending,want", [
    ((5, 3, 0), []),                       # launched inside the backward
    ((0, 0, 0), ["overlap-trailing:o"]),   # every bucket after it
    ((), ["overlap-trailing:o"]),          # nothing launched at all
])
def test_overlap_reports_a_trailing_schedule(pending, want):
    record = {"world": 2, "buckets": [
        {"bucket": b, "payload_bytes": 4096, "pending": p}
        for b, p in enumerate(pending)]}
    inv = tcm.overlap_inventory(record, min_payload_bytes=1024)
    assert _keys(prog.check_overlap("o", inv)) == want


def test_the_pass_is_gated(monkeypatch):
    from horovod_tpu_torch import analysis

    monkeypatch.delenv(prog.ENV_GATE, raising=False)
    monkeypatch.setattr(prog, "verify", lambda *a, **k: pytest.fail(
        "ran without the gate"))
    assert prog.run(str(ROOT)) == []
    assert analysis.run_all(str(ROOT), ["programs"]) == []
    assert "programs" in analysis.PASSES
    assert list(analysis.NOT_PORTED) == ["c-api"]


def test_the_pass_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setenv(prog.ENV_GATE, "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="sees no card"):
        prog.verify(str(ROOT))
    found = prog.run(str(ROOT))
    assert _keys(found) == ["no-card"]
    assert "--device cpu" in found[0].message


@pytest.mark.parametrize("ids, want", [
    ([0, 0, 1, 1], []),
    (None, ["one-slice:x"]),
    ([0, 0, 0, 0], ["one-slice:x"]),
    ([0, 1, 2, 3], ["one-slice:x"]),
])
def test_a_job_of_other_than_two_slices_is_a_finding(monkeypatch, ids,
                                                     want):
    from horovod_tpu_torch.common import basics

    monkeypatch.setattr(basics, "size", lambda: 4)
    assert _keys(prog._two_slices("x", ids)) == want


def test_the_hierarchical_leg_without_tiers_reports_it(monkeypatch):
    from horovod_tpu_torch.common import basics, topology

    monkeypatch.setattr(basics, "size", lambda: 4)
    monkeypatch.setattr(basics, "rank", lambda: 0)
    monkeypatch.setattr(topology, "tiers", lambda: None)
    leg = prog._verify_hierarchical("cpu")
    assert leg["checks"] == 1
    assert [f["key"] for f in leg["findings"]] == ["one-slice:hierarchical"]


def test_gated_verify_passes_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env[prog.ENV_GATE] = "1"
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis", "programs",
         "--device", "cpu"],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    legs = [ln for ln in res.stderr.splitlines()
            if ln.startswith("programs: ")]
    assert [ln.split(" leg,")[0] for ln in legs] == [
        "programs: training", "programs: hierarchical", "programs: serving"]
    assert all("on cpu" in ln and " 0 finding(s)" in ln for ln in legs)
    checks = [int(ln.split(": ")[2].split(" check")[0]) for ln in legs]
    assert checks == [5, 2, 46]
    assert "all contracts hold" in res.stderr


RECORD_WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.metrics import instruments as I
from horovod_tpu_torch.models.transformer import (Transformer,
    TransformerConfig, init_params)
from horovod_tpu_torch.ops import collective_ops as co
from horovod_tpu_torch.serving import ServeConfig, ServingEngine

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)


def submitted():
    return sum(v for _, v in I.COLLECTIVES.samples())


def issued(fn):
    before = submitted()
    with co.recording() as rec:
        fn()
    return rec, submitted() - before


res = {}
cfg = TransformerConfig(vocab_size=64, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=8, max_seq_len=32, dtype=torch.float32)
params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
eng = ServingEngine(cfg, params, serve=ServeConfig(block_size=4, shards=2,
    decode_tiers=(1, 2)), device="cpu")
eng.warmup()
rec, n = issued(lambda: eng.decode_step_inventory(batch_tier=2))
res["decode/n"] = np.array([len(rec), n])
res["decode/ops"] = np.array([r["op"] for r in rec])
res["decode/bytes"] = np.array([r["payload_bytes"] for r in rec])
res["decode/groups"] = np.array([r["group"] for r in rec])
res["decode/stream"] = np.array(sum(r["stream_bytes"] for r in rec))

tc = TransformerConfig(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
    max_seq_len=16, dtype=torch.float32, attention_impl="flash")
model = Transformer(tc, params=init_params(tc,
    torch.Generator().manual_seed(0), "cpu"))
opt = torch.optim.SGD(model.parameters(), lr=0.1)
step = training.data_parallel_train_step(model, opt)
g = np.random.RandomState(rank)
x = torch.as_tensor(g.randint(0, 64, (2, 16)))
y = torch.as_tensor(g.randint(0, 64, (2, 16)))
rec, n = issued(lambda: step(training.create_train_state(model, opt), x, y))
res["train/n"] = np.array([len(rec), n])
res["train/ops"] = np.array([r["op"] for r in rec])
np.savez(out, **res)
hvd.shutdown()
"""


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    return spawn_ranks(RECORD_WORKER, 2, tmp_path_factory.mktemp("rec"))


def test_sharded_decode_step_records_every_collective(recorded):
    d_model, layers, bt = 4 * 8, 2, 2
    want = tcm.modeled_serve_psum_bytes(bt, 1, d_model, layers, 2)
    for r in recorded:
        n_rec, n_sub = r["decode/n"]
        assert n_rec == n_sub == want["psum_count"] == 2 * layers
        assert set(r["decode/ops"]) == {"all_reduce"}
        assert (r["decode/bytes"] == want["payload_bytes"]).all()
        assert (r["decode/groups"] == [0, 1]).all()
        assert int(r["decode/stream"]) == want["stream_bytes"]


def test_flat_training_step_records_every_collective(recorded):
    for r in recorded:
        n_rec, n_sub = r["train/n"]
        # the gradient buckets and the loss's average, one call each
        assert n_rec == n_sub >= 2
        assert set(r["train/ops"]) == {"all_reduce"}
    np.testing.assert_array_equal(recorded[0]["train/n"],
                                  recorded[1]["train/n"])
