"""horovod_tpu_torch.checkpoint against horovod_tpu.checkpoint.

* The frame is byte-compatible: a file the port publishes reads back
  through the reference's ``_read_verified`` (and its object-state
  reader), and the reverse; a flipped bit fails the checksum on both.
* The same sequence of saves, prunes and ``discard_newer_than`` leaves
  the same files in both packages' directories.
* A ``checkpoint.payload`` chaos flip of the newest entry makes restore
  fall back to the next-oldest.
* Save, restore and continue: gpt_tiny (fp32, flash, AdamW) driven by
  ``fit_epoch`` over a ``DataLoader`` with ``checkpoint_every=2``, then
  a fresh model restored from step 4 runs the rest of the epoch with
  losses bit-identical to the uninterrupted run — at world 1, and at
  world 2 over gloo with ``broadcast=True`` (only rank 0 reads; the
  other rank starts from different weights).
"""

import os

import numpy as np
import pytest
import torch

from horovod_tpu import checkpoint as jckpt
from horovod_tpu_torch import chaos, checkpoint

from test_torch_collectives import spawn_ranks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the frame ------------------------------------------------------------------


@pytest.mark.parametrize("payload", [b"", b"x", bytes(range(256)) * 40])
def test_frame_reads_back_across_packages(tmp_path, payload):
    p = checkpoint._atomic_publish(str(tmp_path), "ckpt-7", payload)
    assert os.path.basename(p) == "ckpt-7"
    assert jckpt._read_verified(p) == payload
    q = jckpt._atomic_publish(str(tmp_path), "ckpt-8", payload)
    assert checkpoint._read_verified(q) == payload
    with open(p, "rb") as f, open(q, "rb") as g:
        assert f.read() == g.read()  # byte for byte the same file
    assert sorted(os.listdir(tmp_path)) == ["ckpt-7", "ckpt-8"]


def test_corrupt_frame_fails_both_checksums(tmp_path):
    p = checkpoint._atomic_publish(str(tmp_path), "ckpt-1", b"payload" * 9)
    blob = bytearray(open(p, "rb").read())
    blob[-5] ^= 0x10
    open(p, "wb").write(bytes(blob))
    assert checkpoint._read_verified(p) is None
    assert jckpt._read_verified(p) is None
    open(p, "wb").write(b"legacy, no header")
    assert checkpoint._read_verified(p) == jckpt._read_verified(p) \
        == b"legacy, no header"


class _Obj:
    """An object state with the snapshot protocol."""

    def __init__(self, value):
        self.value = value

    def _snapshot(self):
        return {"value": self.value, "list": [1, 2.5, "x"]}

    def _apply_snapshot(self, snap):
        self.value = snap["value"]


def test_state_checkpoints_cross_read(tmp_path):
    d = str(tmp_path)
    checkpoint.save_state_checkpoint(d, _Obj(3), step=5)
    assert jckpt.peek_state_checkpoint(d) == (
        5, {"value": 3, "list": [1, 2.5, "x"]})
    jckpt.save_state_checkpoint(d, _Obj(4), step=6)
    assert checkpoint.peek_state_checkpoint(d)[0] == 6
    obj = _Obj(0)
    assert checkpoint.restore_state_checkpoint(d, obj) == 6
    assert obj.value == 4


def _save_sequence(mod, d):
    """A sequence of saves with several ring depths, a stale temp and a
    rollback; returns the directory listing after each operation."""
    seen = []
    for step, keep in [(1, 3), (2, 3), (3, 3), (4, 3), (5, 2), (7, 4),
                       (8, 4), (9, 1), (10, 3), (11, 3), (12, 0)]:
        mod.save_state_checkpoint(d, _Obj(step), step=step, keep=keep)
        seen.append(sorted(os.listdir(d)))
    stale = os.path.join(d, "ckpt-99.tmp.12345")
    open(stale, "wb").close()
    os.utime(stale, (0, 0))  # older than the sweep's age gate
    fresh = os.path.join(d, "ckpt-98.tmp.54321")
    open(fresh, "wb").close()
    mod.save_state_checkpoint(d, _Obj(13), step=13, keep=3)
    seen.append(sorted(os.listdir(d)))
    seen.append(sorted(os.path.basename(p)
                       for p in mod.discard_newer_than(d, 11)))
    seen.append(sorted(os.listdir(d)))
    seen.append(os.path.basename(mod.latest_checkpoint(d)))
    seen.append(mod.checkpoint_step(mod.latest_checkpoint(d)))
    return seen


def test_prune_ring_and_discard_leave_the_same_files(tmp_path):
    got = _save_sequence(checkpoint, str(tmp_path / "port"))
    want = _save_sequence(jckpt, str(tmp_path / "ref"))
    assert got == want
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    assert checkpoint.checkpoint_step("/x/ckpt-12.tmp.3") is None


# -- training-state checkpoints -------------------------------------------------

# shared with the multi-rank worker, which must not import this module
# (it imports JAX): exec'd here and prepended there
HELPERS = r"""
import itertools
import os

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint, data, training
from horovod_tpu_torch.models import Transformer, gpt_tiny, init_params

CFG = gpt_tiny(dtype=torch.float32, attention_impl="flash")
B, S = 4, 16  # six batches an epoch a rank


def _model(seed):
    cfg = CFG
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu", param_dtype=torch.float32)
    return Transformer(cfg, params=params)


def _loader(shard):
    n = 6 * B * shard.num_shards
    toks = np.random.RandomState(5).randint(
        0, CFG.vocab_size, (n, S + 1)).astype(np.int64)
    return data.DataLoader(data.ArraySource(toks[:, :-1], toks[:, 1:]),
                           batch_size=B, seed=3, shard=shard,
                           device_put=False, num_workers=0,
                           prefetch_depth=0)


def _recording(step, losses):
    def run(state, inputs, labels):
        state, loss = step(state, inputs, labels)
        losses.append(float(loss))
        return state, loss
    return run


def _fresh_state(seed):
    model = _model(seed)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4)
    return training.create_train_state(model, opt)


def _run_and_resume(directory, shard, fresh_seed):
    # losses of an uninterrupted epoch (checkpoints every 2 steps, a ring
    # of 2), and of a fresh state restored from step 4 running the rest
    state = training.replicate_state(_fresh_state(0))
    full = []
    step = training.data_parallel_train_step(state.model, state.optimizer)
    state, _ = training.fit_epoch(
        _recording(step, full), state, _loader(shard), epoch=0,
        checkpoint_dir=directory, checkpoint_every=2, checkpoint_keep=2)
    fresh = _fresh_state(fresh_seed)
    step2 = training.data_parallel_train_step(fresh.model, fresh.optimizer)
    if checkpoint._is_root():
        assert sorted(os.listdir(directory)) == ["ckpt-4", "ckpt-6"]
        checkpoint.discard_newer_than(directory, 4)
    hvd.barrier()
    fresh = checkpoint.restore_checkpoint(directory, fresh, broadcast=True)
    assert fresh.step == 4
    rest = []
    loader = _loader(shard)
    loader.set_epoch(0)
    fresh, _ = training.fit_epoch(
        _recording(step2, rest), fresh, itertools.islice(loader, 4, None))
    assert fresh.step == 6
    return np.array(full), np.array(rest)
"""
exec(HELPERS)


def test_payload_bitflip_falls_back_to_next_oldest(tmp_path):
    """``checkpoint.payload:corrupt`` on the third save flips one bit of
    ckpt-3's published bytes: restore skips it (checksum) and loads
    ckpt-2's state."""
    d = str(tmp_path)
    states = []
    chaos.configure("checkpoint.payload:corrupt,at=2", seed=0)
    try:
        for step in (1, 2, 3):
            st = _fresh_state(step)
            checkpoint.save_checkpoint(d, st, step, keep=3)
            states.append(st)
        fired = chaos.injection_trace()
    finally:
        chaos.clear()
    assert fired == [{"site": "checkpoint.payload", "action": "corrupt",
                      "eval": 2, "rank": 0}]
    assert checkpoint._read_verified(os.path.join(d, "ckpt-3")) is None
    assert jckpt._read_verified(os.path.join(d, "ckpt-3")) is None
    fresh = checkpoint.restore_checkpoint(d, _fresh_state(7))
    assert fresh.step == 2
    want = states[1].model.state_dict()
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_save_restore_continue_bit_identical_world1(tmp_path):
    hvd.init(device="cpu")
    try:
        full, rest = _run_and_resume(str(tmp_path / "ck"),
                                     data.ShardSpec(0, 1), fresh_seed=9)
    finally:
        hvd.shutdown()
    assert len(full) == 6 and np.all(np.isfinite(full))
    np.testing.assert_array_equal(rest, full[4:])


RESUME_WORKER = HELPERS + r"""
import sys
rank, world, store, out, ckdir = int(sys.argv[1]), int(sys.argv[2]), \
    sys.argv[3], sys.argv[4], sys.argv[5]
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
full, rest = _run_and_resume(ckdir, data.ShardSpec(rank, world),
                             fresh_seed=9 + rank)
hvd.shutdown()
np.savez(out, full=full, rest=rest)
"""


def test_save_restore_continue_bit_identical_world2_broadcast(tmp_path):
    """Two ranks over gloo: rank 0 writes the ring; on resume only rank
    0 reads it and ``broadcast=True`` hands its weights, AdamW state,
    hyperparameters and step to rank 1 (which starts from other
    weights); every rank's losses after the resume equal the
    uninterrupted run's, bit for bit."""
    outs = spawn_ranks(RESUME_WORKER, 2, tmp_path, str(tmp_path / "ck"))
    for res in outs:
        assert len(res["full"]) == 6
        np.testing.assert_array_equal(res["rest"], res["full"][4:])
    np.testing.assert_array_equal(outs[0]["full"], outs[1]["full"])
