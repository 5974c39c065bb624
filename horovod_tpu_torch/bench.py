"""Headline benchmark of the port: ResNet-50 training throughput.

Port of the repo's ``bench.py`` (reference parity:
examples/pytorch/pytorch_synthetic_benchmark.py): bench.py's
configuration — ResNet-50, 1000 classes, bf16 compute over fp32 master
weights, the space-to-depth stem, SGD 0.1 / momentum 0.9 — through the
port's public training path, ``init`` → ``replicate_state`` →
``data_parallel_train_step``, warm-up steps, then timed steps, one JSON
result line.  Every one of the model's 53 BatchNorm sites runs the
fused-norm kernels (``ops/fused_norm.py``).

    python -m horovod_tpu_torch.bench [--data synthetic|synthetic-stream|npy|folder]
        [--data-path DIR] [--batch N] [--device cuda|cpu]
        [--warmup N] [--iters N] [--timeline PATH]

It runs on the card (batch 128 of 224x224, 5 + 30 steps), or on the CPU
only when given ``--device cpu`` (batch 16 of 64x64, 1 + 2 steps).  With
no card and no ``--device cpu`` it exits non-zero and prints no result:
it never falls back.  ``--data synthetic`` keeps one seeded batch on the
device (the headline); ``synthetic-stream``, ``npy`` and ``folder`` feed
every step through the port's input pipeline (``data.make_loader``);
``npy`` without ``--data-path`` writes seeded uint8 shards into a
temporary directory first.  ``--timeline PATH`` writes the Chrome
timeline of the run (``start_timeline``).

The result line has bench.py's keys (``metric``, ``value`` in
images/s, ``vs_baseline`` over the same V100 constant, ``step_time_ms``,
``input_wait_ms``, ``pipeline``, ``memory_per_rank``, ``comm_bytes`` —
here the ``hvd_tpu_collective_bytes_total`` delta over the timed steps,
by op) plus ``device`` (the card's name and power limit from
``nvidia-smi``), ``mfu`` (bench.py's FLOP count over the H100's dense
bf16 peak; null on any other device) and ``final_loss``.  ``main(argv)``
returns that dict, so that a caller can run it in process.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

#: reference pytorch_synthetic_benchmark on its era's flagship (1x V100,
#: fp32, batch 32): the widely reported ~330 img/s, bench.py's baseline
BASELINE_IMG_PER_SEC = 330.0
#: ResNet-50 fwd @224 is ~4.09 GMACs = ~8.2 GFLOP; a training step is
#: ~3x the forward (bench.py's count)
RESNET50_TRAIN_FLOPS_PER_IMG = 3 * 2 * 4.09e9
#: H100 SXM dense bf16 tensor-core peak, FLOP/s
H100_BF16_PEAK_FLOPS = 989e12


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.bench",
        description="ResNet-50 training throughput through the port")
    p.add_argument("--data", default="synthetic",
                   choices=["synthetic", "synthetic-stream", "npy", "folder"],
                   help="synthetic = one device-resident batch (headline); "
                        "synthetic-stream/npy/folder feed the step through "
                        "the input pipeline")
    p.add_argument("--data-path", default=None,
                   help="dataset root for --data npy/folder (npy "
                        "self-seeds a temporary directory when omitted)")
    p.add_argument("--batch", type=int, default=None,
                   help="per-rank batch (default 128 on the card, 16 on "
                        "the CPU)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--warmup", type=int, default=None,
                   help="untimed steps (default 5 on the card, 1 on the CPU)")
    p.add_argument("--iters", type=int, default=None,
                   help="timed steps (default 30 on the card, 2 on the CPU)")
    p.add_argument("--timeline", default=None,
                   help="write the run's Chrome timeline to this file")
    return p.parse_args(argv)


class _EpochFeed:
    """Endless batch stream over a ``data.DataLoader`` (epoch after
    epoch), keeping every epoch's prefetcher so that the pipeline stats
    sum over the whole run; the timed window subtracts a snapshot taken
    at its start (bench.py's ``_EpochFeed``)."""

    def __init__(self, loader):
        self.loader = loader
        self._iters: List[Any] = []

    def __iter__(self):
        epoch = 0
        while True:
            self.loader.set_epoch(epoch)
            it = iter(self.loader)
            self._iters.append(it)
            for item in it:
                yield item
            epoch += 1

    def stats(self) -> dict:
        totals: Dict[str, float] = {}
        for it in self._iters:
            for k, v in it.stats().items():
                if k == "prefetch_depth":
                    totals[k] = v
                elif not k.endswith("_mean"):  # totals/counts sum cleanly
                    totals[k] = round(totals.get(k, 0) + v, 3)
        n = max(totals.get("batches", 1), 1)
        for key in ("input_wait", "host_produce", "device_put"):
            totals[f"{key}_ms_mean"] = round(
                totals.get(f"{key}_ms_total", 0.0) / n, 3)
        return totals

    def close(self) -> None:
        for it in self._iters:
            it.close()


def _build_feed(args, batch: int, image_size: int, device, tmp: List[str]):
    """The pipeline-fed batch stream of the non-resident modes; a
    self-seeded npy directory is appended to ``tmp`` for the caller to
    remove."""
    import numpy as np

    from . import data

    kind = "synthetic" if args.data == "synthetic-stream" else args.data
    path = args.data_path
    if kind == "npy" and path is None:
        # uint8 shards (the realistic storage dtype; decode is
        # astype(float32)/255 on the worker pool), enough for 8 batches;
        # the feed loops epochs, so the step count is unbounded
        n = 8 * batch
        rng = np.random.RandomState(0)
        inputs = rng.randint(0, 256, size=(n, image_size, image_size, 3),
                             dtype=np.uint8)
        labels = rng.randint(0, 1000, size=(n,)).astype(np.int32)
        path = tempfile.mkdtemp(prefix="hvd_torch_bench_npy_")
        tmp.append(path)
        data.write_npy_shards(path, inputs, labels, num_shards=4)
        print(f"[bench] seeded {n} uint8 samples into {path}",
              file=sys.stderr)
    loader = data.make_loader(
        kind, path, batch_size=batch, image_size=image_size,
        synthetic_samples=8 * batch, device=device,
        # a bf16 host cast halves the host->device bytes; the first conv
        # consumes bf16 anyway (the model's dtype)
        cast="bfloat16" if device.type == "cuda" else None)
    return _EpochFeed(loader)


def card() -> Optional[Dict[str, str]]:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them
    (None without one)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return None
    if not out:
        return None
    name, _, limit = out.splitlines()[0].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def _bytes_by_op() -> Dict[str, float]:
    from .metrics import instruments as _metrics

    return {labels[0]: value
            for labels, value in _metrics.COLLECTIVE_BYTES.samples()}


def main(argv=None) -> Dict[str, Any]:
    """Run the benchmark; returns the result dict (see the module
    docstring).  Raises ``RuntimeError`` on the card's path without a
    card."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from . import training
    from .common import basics
    from .models import ResNet50
    from .optim import state_bytes

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the benchmark on the CPU")
    owned = not basics.is_initialized()
    basics.init(device=None if on_card else "cpu")
    dev = basics.device()
    tmp: List[str] = []
    feed = None
    if args.timeline:
        try:
            basics.start_timeline(args.timeline)
        except BaseException:
            if owned:
                basics.shutdown()
            raise
    try:
        batch = args.batch or (128 if on_card else 16)
        image_size = 224 if on_card else 64
        warmup = args.warmup if args.warmup is not None else (
            5 if on_card else 1)
        iters = args.iters if args.iters is not None else (
            30 if on_card else 2)
        if on_card:
            # the reference's pytorch_synthetic_benchmark sets it
            torch.backends.cudnn.benchmark = True
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         stem="space_to_depth", device=dev,
                         generator=torch.Generator(dev).manual_seed(0))
        if args.data == "synthetic":
            images = torch.as_tensor(
                np.random.RandomState(0)
                .randn(batch, image_size, image_size, 3)
                .astype(np.float32), device=dev)
            labels = torch.as_tensor(
                np.random.RandomState(1).randint(0, 1000, size=(batch,)),
                dtype=torch.long, device=dev)
        else:
            feed = _build_feed(args, batch, image_size, dev, tmp)
            feed_iter = iter(feed)
            images, labels = next(feed_iter)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        state = training.replicate_state(
            training.create_train_state(model, opt))
        step = training.data_parallel_train_step(model, opt)

        state, loss = step(state, images, labels)
        for _ in range(warmup - 1):
            state, loss = step(state, *((images, labels) if feed is None
                                        else next(feed_iter)))
        float(loss)  # a host read of the loss: the card is idle after it
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        wait0 = feed.stats() if feed is not None else {}
        bytes0 = _bytes_by_op()
        t0 = time.perf_counter()
        for _ in range(iters):
            state, loss = step(state, *((images, labels) if feed is None
                                        else next(feed_iter)))
        final_loss = float(loss)
        dt = time.perf_counter() - t0
        bytes1 = _bytes_by_op()
        if not math.isfinite(final_loss):
            raise RuntimeError(f"non-finite loss {final_loss}")

        img_per_sec = batch * basics.size() * iters / dt
        if feed is not None:
            pipeline = feed.stats()
            input_wait_ms = round(
                (pipeline.get("input_wait_ms_total", 0.0)
                 - wait0.get("input_wait_ms_total", 0.0)) / iters, 3)
            pipeline["starved_batches"] = int(
                pipeline.get("starved_batches", 0)
                - wait0.get("starved_batches", 0))
            timed = max(int(pipeline.pop("batches", 0)
                            - wait0.get("batches", 0)), 1)
            pipeline["timed_batches"] = timed
            # per-batch means over the timed window only
            for key in ("host_produce", "device_put"):
                pipeline[f"{key}_ms_mean"] = round(
                    (pipeline.get(f"{key}_ms_total", 0.0)
                     - wait0.get(f"{key}_ms_total", 0.0)) / timed, 3)
            for k in ("input_wait_ms_total", "input_wait_ms_mean",
                      "host_produce_ms_total", "device_put_ms_total"):
                pipeline.pop(k, None)
            from .data import workers as _data_workers

            pipeline["workers"] = _data_workers.default_num_workers()
        else:
            pipeline = {"mode": "device_resident"}
            input_wait_ms = 0.0
        world = basics.size()
        opt_bytes = state_bytes(opt.state)
        memory_per_rank = {
            "params_bytes": int(state_bytes(list(model.parameters()))),
            "opt_state_bytes": int(opt_bytes),
            "opt_state_bytes_zero": int(-(-opt_bytes // world)),
            "world": world,
            "max_memory_allocated": (int(torch.cuda.max_memory_allocated(
                dev)) if on_card else None),
        }
        comm = {op: int(v - bytes0.get(op, 0.0)) for op, v in bytes1.items()
                if v - bytes0.get(op, 0.0) > 0}
        device = card() if on_card else None
        step_ms = dt / iters * 1e3
        mfu = None
        if on_card and device and "H100" in device["name"]:
            mfu = round(img_per_sec / world * RESNET50_TRAIN_FLOPS_PER_IMG
                        / H100_BF16_PEAK_FLOPS, 4)
        return {
            "metric": "resnet50_synthetic_train_throughput",
            "value": round(img_per_sec, 2),
            "unit": "images/sec",
            "vs_baseline": round(img_per_sec / BASELINE_IMG_PER_SEC, 3),
            "baseline": "reference pytorch_synthetic_benchmark, 1x V100 "
                        "fp32 batch 32, ~330 img/s (widely reported)",
            "backend": dev.type,
            "batch": batch,
            "image_size": image_size,
            "step_time_ms": round(step_ms, 2),
            "n_devices": world,
            "data": args.data,
            "input_wait_ms": input_wait_ms,
            "input_wait_pct": round(
                100.0 * input_wait_ms / max(step_ms, 1e-9), 2),
            "pipeline": pipeline,
            "memory_per_rank": memory_per_rank,
            "comm_bytes": comm,
            "device": device,
            "mfu": mfu,
            "final_loss": final_loss,
        }
    finally:
        if feed is not None:
            feed.close()
        for path in tmp:
            shutil.rmtree(path, ignore_errors=True)
        if args.timeline:
            basics.stop_timeline()
        if owned:
            basics.shutdown()


def _cli(argv=None) -> int:
    try:
        result = main(argv)
    except RuntimeError as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
