"""The benchmark entry (``python -m horovod_tpu_torch.bench``) and the
serving engine's step inventories.

* ``bench.main`` on the CPU (``--device cpu``, batch 2 of 64x64, one
  warm-up and one timed step), with one device-resident batch and with
  self-seeded npy shards through the input pipeline: the result has
  bench.py's keys and the port's, a finite loss, the gradient
  allreduce's bytes, and no MFU off the card; with ``--timeline`` the
  file holds one ``COMM`` begin/end pair per collective call of the run,
  as many as ``hvd_tpu_collectives_total`` moved.  Without ``--device
  cpu`` and with no card it exits non-zero and prints no result line.
* ``ServingEngine.mixed_step_inventory`` on a tiny engine gathers
  ``batch_tier × modeled_decode_read_bytes(...)["gathered_bytes"]`` at
  the tiers it ran, and exactly the bytes that the JAX package's
  ``serve_gather_read_bytes`` reads from ``lowered_mixed_text`` at the
  same tiers (both gather each row's pages up to the step's page bound:
  the whole table, or ``pages``).
* ``decode_step_inventory`` gathers nothing, by design: the port's
  decode step reads the pools in place through the paged decode kernel
  (on the CPU through its plain version), where the JAX decode program
  gathers ``batch_tier × gathered_bytes`` first.
* Neither inventory touches a live sequence's pages (bit for bit), and
  the engine serves on afterwards as if they had not run.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.models.transformer import Transformer as JaxTransformer
from horovod_tpu.models.transformer import TransformerConfig as JaxConfig
from horovod_tpu.ops.comm_model import serve_gather_read_bytes
from horovod_tpu.serving import ServeConfig as JaxServeConfig
from horovod_tpu.serving import ServingEngine as JaxEngine
from horovod_tpu_torch import bench
from horovod_tpu_torch.metrics import instruments as tmetrics
from horovod_tpu_torch.models import TransformerConfig, params_from_flax
from horovod_tpu_torch.serving import ServeConfig, ServingEngine
from horovod_tpu_torch.serving.kv_cache import modeled_decode_read_bytes

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--batch", "2", "--warmup", "1", "--iters", "1"]
KEYS = {"metric", "value", "unit", "vs_baseline", "backend", "batch",
        "image_size", "step_time_ms", "n_devices", "data", "input_wait_ms",
        "input_wait_pct", "pipeline", "memory_per_rank", "comm_bytes",
        "device", "mfu", "final_loss"}


def _collectives():
    return sum(v for _, v in tmetrics.COLLECTIVES.samples())


@pytest.mark.parametrize("data", ["synthetic", "npy"])
def test_bench_cpu(data, tmp_path):
    hvd.shutdown()
    timeline = tmp_path / "timeline.json"
    c0 = _collectives()
    res = bench.main(TINY + ["--data", data, "--timeline", str(timeline)])
    c1 = _collectives()
    assert not hvd.is_initialized()  # main shuts down what it started
    assert KEYS <= set(res)
    assert res["metric"] == "resnet50_synthetic_train_throughput"
    assert res["unit"] == "images/sec" and res["value"] > 0
    assert (res["backend"], res["batch"], res["image_size"],
            res["n_devices"], res["data"]) == ("cpu", 2, 64, 1, data)
    assert math.isfinite(res["final_loss"])
    assert res["mfu"] is None and res["device"] is None
    mem = res["memory_per_rank"]
    # ResNet-50 with the space-to-depth stem, fp32 masters
    assert mem["params_bytes"] == 25559912 * 4
    assert mem["opt_state_bytes"] == mem["params_bytes"]  # SGD momentum
    # one timed step: the gradient buckets, the running statistics and
    # the loss, all allreduced
    assert res["comm_bytes"]["allreduce"] > mem["params_bytes"]
    if data == "npy":
        assert res["pipeline"]["timed_batches"] == 1
        assert res["input_wait_ms"] >= 0
    else:
        assert res["pipeline"] == {"mode": "device_resident"}
    events = json.loads(timeline.read_text())
    begins = [e for e in events if e["ph"] == "B"]
    assert [e["name"] for e in begins] == ["COMM"] * len(begins)
    assert sum(e["ph"] == "E" for e in events) == len(begins) == c1 - c0
    assert {e["args"]["tensor"] for e in begins} >= {"bucket.0", "allreduce"}


def test_bench_refuses_the_cpu_without_asking():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--batch", "2"],
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert not any(line.startswith("{") for line in res.stdout.splitlines())
    assert "no CUDA device" in res.stderr


VOCAB = 97
SHAPE = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=8, max_seq_len=64)
BS = 8


@pytest.fixture(scope="module")
def engines():
    jc = JaxConfig(dtype=jnp.float32, **SHAPE)
    tc = TransformerConfig(dtype=torch.float32, **SHAPE)
    params = JaxTransformer(jc).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        train=False)["params"]
    sd = params_from_flax(jax.tree.map(np.asarray, params), tc, device="cpu")
    jeng = JaxEngine(jc, params, serve=JaxServeConfig(
        block_size=BS, num_blocks=0, decode_tiers=(1, 2)))
    make = lambda: ServingEngine(tc, sd, serve=ServeConfig(  # noqa: E731
        block_size=BS, decode_tiers=(1, 2)), device="cpu")
    return jeng, make


def _modeled(bt, pages):
    m = modeled_decode_read_bytes(
        BS, block_size=BS, num_heads=4, num_kv_heads=2, head_dim=8,
        num_layers=2, dtype_bytes=4, max_seq_len=SHAPE["max_seq_len"],
        gather_pages=pages)
    return bt * m["gathered_bytes"]


@pytest.mark.parametrize("bt, chunk, pages", [
    (2, None, None), (2, None, 2), (1, 64, 4), (2, 32, 8)])
def test_mixed_step_gather_bytes(engines, bt, chunk, pages):
    jeng, make = engines
    inv = make().mixed_step_inventory(batch_tier=bt, chunk_tier=chunk,
                                      pages=pages)
    assert inv["collectives"] == []
    assert inv["kernels"] and all(k["launches"] > 0
                                  for k in inv["kernels"].values())
    assert inv["gather_bytes"] == _modeled(bt, pages)
    jtxt = jeng.lowered_mixed_text(batch_tier=bt, chunk_tier=chunk,
                                   pages=pages)
    assert inv["gather_bytes"] == serve_gather_read_bytes(jtxt)["gather_bytes"]


@pytest.mark.parametrize("bt, pages", [(1, None), (2, 2), (2, 8)])
def test_decode_step_gathers_nothing(engines, bt, pages):
    jeng, make = engines
    eng = make()
    inv = eng.decode_step_inventory(batch_tier=bt, pages=pages)
    assert inv["gather_bytes"] == 0
    assert inv["collectives"] == []
    # the JAX decode program gathers the pages it reads; the port's
    # kernel reads them in place
    jtxt = jeng.lowered_decode_text(batch_tier=bt, pages=pages)
    pt = pages or eng.page_tiers[0]
    assert serve_gather_read_bytes(jtxt)["gather_bytes"] == _modeled(bt, pt)


def test_inventories_leave_sequences_untouched(engines):
    _, make = engines
    eng, ref = make(), make()
    rs = np.random.RandomState(3)
    prompts = [rs.randint(1, VOCAB, size=n) for n in (11, 20, 5)]
    ids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    rids = [ref.submit(p, max_new_tokens=6) for p in prompts]
    for _ in range(3):
        eng.step()
    k, v = eng.k_pool.clone(), eng.v_pool.clone()
    eng.mixed_step_inventory(batch_tier=2)
    eng.decode_step_inventory(batch_tier=2, pages=4)
    eng.mixed_step_inventory(batch_tier=1, pages=2)
    # block 0 is the trash block: every write of an inventory lands there
    assert torch.equal(eng.k_pool[:, 1:], k[:, 1:])
    assert torch.equal(eng.v_pool[:, 1:], v[:, 1:])
    out, want = eng.run(), ref.run()
    for i, j in zip(ids, rids):
        np.testing.assert_array_equal(out[i], want[j])
