#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``horovod_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``horovod_tpu_torch/csrc`` (into
``build/horovod_tpu_torch/``), then runs these phases and exits non-zero
if any fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the kernel build time and the compiler's register/shared
   memory report;
3. kernels (kernel vs plain): every kernel against its plain PyTorch
   version on the card, each case with its absolute and per-row relative
   error against their tolerances, its time, the plain version's, SDPA's
   (timed only, never called by the port) and the card's bound (the
   serving cases' kernel time is device time, calls enqueued behind a
   spin kernel, with the host-inclusive call time beside it: the small
   cases' kernels are shorter than the wrapper's host work):
   - the paged forward (serving): decode, chunk and speculative verify
     (B=8 rows of C=8 at serving's decode offsets) cases over gathered
     K/V (llama3_8b heads 32/8 at D=128, an MHA case at D=64, a windowed
     case with nonzero ``kv_start``, decode pad slots and chunk rows
     placed before their first key, which must come back exactly zero
     with the -1e30 log-sum-exp sentinel; bf16 and fp32); the chunk and
     verify cases again at one rank's head slice of tensor-sharded
     serving (``SHARD_HEADS``: 16/4 and 8/2, bf16);
   - the paged decode (serving's decode steps, ``csrc/flash_decode.cu``):
     the decode shapes read through block tables of 16-token pages
     scattered in a pool twice the live size (GQA bf16 and fp32, MHA
     D=64, a window of 256, pad rows exactly zero), each also giving the
     same bits on a second call, timed beside SDPA on the
     already-gathered K/V and beside the gather plus SDPA; the GQA case
     again at the sharded head slices 16/4 and 8/2;
   - the training kernels — the uniform-offset forward (out and lse),
     dQ, and dK/dV: gpt_small's shape (B=8, S=2048, 12 heads of 64; the
     main path's), llama3_8b's attention (32/8 heads, D=128, S=4096,
     the GQA group sum), bidirectional, a causal and a bidirectional
     window of 256, a ragged S=1000; bf16 and fp32;
   - every forward case asserts on the per-variant counters that it ran
     the variant the wrapper's rule gives it: ``sm90`` (wgmma + TMA) for
     every bf16 case with more than four query rows, ``simt`` (CUDA
     cores) for fp32 and decode; every training case likewise for dq and
     dkv (``sm90`` in bf16, ``simt`` in fp32), and that a second dq and
     dkv call gives bitwise identical gradients;
   - the training kernels at a uniform non-zero ``kv_offset`` (B9, ring
     attention's off-diagonal blocks; ``B9_CASES``): one 2048-key block
     of gpt_small's attention (B=8, 12 heads of 64) and of llama3_8b's
     (B=1, 32/8 heads of 128) at offsets ±2048 and ±6144 (a global 8192
     over four ranks) and ±1000, causal and bidirectional, a causal
     window of 256 at −2048 and a bidirectional one at +2048, bf16 and
     fp32: the forward (out, lse), dq and dkv against their plain
     versions at the same offset (bf16 gradient rows against the plain
     arithmetic with the sm90 kernels' rounding points), rows that see
     no key exact zeros with the −1e30 sentinel, keys no query sees zero
     in dK/dV, one launch of each at the offset in the rule's variant,
     dq/dkv bits equal on a second call; times beside SDPA with the
     same visibility as a boolean ``attn_mask`` and the card's bound;
   - the fused BatchNorm kernels (stats, apply, backward reduce, dx):
     all 16 distinct (M, C, ReLU, residual) shapes of ResNet-50's 53
     norm sites at batch 128, 224x224 (the main path's) in bf16, three
     of them in fp32, a ragged case (M=1000, C=96), the scalar path
     (C % 8 != 0 in each dtype, and a base pointer off 16 bytes), and one
     site through the sync-BN ``process_group`` seam over a world-1
     NCCL group (bit-equal to the op without one); each kernel against
     the plain version of its own step on every output (y, mean, var,
     dβ, dγ, dx, dres; the stats kernel's rstd, scale and shift against
     its own mean and var), with a verdict per kernel, its time, the
     plain version's, the library's train-mode BN composite (forward,
     backward; timed only) and the card's bound; the stats kernel also
     gives the same bits on a second call, is timed beside
     ``torch.var_mean`` (its function in one call) and ``x.sum()`` (a
     plain streaming read of the same bytes), and 50 of its launches
     back to back over six shapes each give their shape's first bits
     (its column-tile counters are reset by every launch);
4. serving: ``ServingEngine`` over llama3_8b at full width (32 layers,
   bf16, random weights from a seeded generator on the card) serves two
   waves of requests; every request must complete, every mixed step
   must launch the sm90 forward and every decode step the paged decode
   kernel exactly 32 times (once per layer; no CUDA-core forward), the
   second wave must hit the prefix cache, and each first token's logits
   must match a dense cache-free forward; then a profiled wave (device
   time by kernel class) and 8 profiled decode steps alone; then the
   engine's step inventories (:func:`serving_views`, part (e) of the
   observe phase);
4a. tp: tensor-sharded serving on ONE card: two ranks, one process each
   on the card over gloo (NCCL refuses two ranks on one GPU), each
   holding half of llama3_8b's heads and MLP and of the pool
   (``ServingEngine(shards=2)``, the weights drawn as the serving
   phase's and sliced leaf by leaf), serve the serving phase's waves:
   every request completes on both ranks with identical streams
   (``check_agreement``), equal to the serving phase's tie-aware
   (``BF16_TIE_REL``); each mixed step launches the sm90 forward and
   each decode step the paged decode 32 times a rank, at 16/4 heads;
   the first tokens' logits match a dense forward;
   ``SERVE_SHARD_PSUM_BYTES`` grows by exactly the modeled sum over the
   steps' shapes, which the all-reduces' payloads give too; per-rank
   parameter bytes the replicated leaves' plus half the sliced ones';
   the engine is handed the full tree on the card (the serving phase's
   draws) and keeps copies of its slices: per-rank parameter storage
   (each storage once) is the replicated leaves' plus half the sliced
   ones'; each step's intake broadcast is timed; then the 2-layer fp32
   oracle at shards 2 against one-at-a-time dense decode; then
   ``ulysses_attention(impl="flash")`` over the two ranks (gloo's
   all-to-all) at gpt_small's attention, a global 8192 tokens, forward
   and backward: each rank's output and gradients against its rows of
   one ``flash_attention`` over the whole sequence, one launch of each
   training kernel a rank.  Gloo stages each collective through the
   host: its times are no tensor- or sequence-parallel measurement;
5. oracle: llama3_8b width, 2 layers, fp32 — greedy streams through the
   engine (the CUDA-core forward on mixed steps, the paged decode on
   decode steps), through a speculative engine (``spec_k=4``, the
   oracle drafter below: its verify steps run the CUDA-core forward)
   and through a prefill→decode ``FleetRouter`` pair must each equal
   one-at-a-time plain decode (tie-aware at 1e-4);
5a. spec: llama3_8b at full width (bf16, 32 layers, seeded weights
   shared by every engine, ``num_blocks=1024``) on the serving phase's
   prompts, 32 new tokens each: a plain engine serves them (the first
   wave through ``submit``, the second through ``attach_source``, the
   staged intake); a speculative engine (``spec_k=4``) with a
   ``ModelDrafter`` that drafts each plain stream's continuation, every
   third draft's second token wrong (acceptance and rollback both
   certain), then with ``prompt_lookup``; ``run_static`` beside the
   continuous engine on the same prompts.  Every request completes with
   32 tokens, every verify step launches the sm90 forward 32 times and
   the paged decode never, every decode step the paged decode 32 times,
   every mixed step the sm90 forward 32 times; every stream equals the
   plain one tie-aware (``BF16_TIE_REL``); decode tokens/s, acceptance
   and steps per token under each drafter, then 8 verify steps under
   the profiler;
5b. disagg: the same model behind ``FleetRouter(replicas=1,
   prefill_replicas=1)`` (one ``role="prefill"`` and one decode engine
   on the card) against one ``role="both"`` engine: every request
   completes with 32 tokens; the prefill replica runs mixed steps only
   (32 sm90 forwards each, no paged decode); every handoff is warm and
   booked in ``SERVE_HANDOFFS``; the migrated bytes measured
   (``SERVE_MIGRATED_BYTES``) equal ``modeled_kvsnap_bytes`` exactly;
   the streams equal the single engine's tie-aware; export and import
   time per request, TTFT p50 and tokens/s against the single engine;
6. training: gpt_small at full width and depth (B=8, S=2048, bf16
   compute over fp32 masters, AdamW 1e-3 at optax's defaults) through
   ``init()`` (world 1 over NCCL), ``replicate_state`` and
   ``data_parallel_train_step``, 10 steps on one fixed batch: every loss
   finite and the last below the first, exactly 12 launches of each
   training kernel per step, every forward, dq and dkv the sm90 variant
   (no CUDA-core launch); tokens/s,
   MFU, peak memory, then the
   device busy share and time by kernel class over 2 profiled steps;
7. overlap: the training run again through
   ``data_parallel_train_step(overlap=True)``, each gradient bucket's
   NCCL allreduce launched from the backward's hooks: every loss equal
   to the training phase's bit for bit (world 1: Average divides by 1,
   fusion moves no bits), 12 sm90 launches of each training kernel a
   step, ``BucketSchedule.num_buckets`` gradient allreduces a step (a
   wrapper of ``torch.distributed.all_reduce`` counts them, with the
   loss's), every bucket launched from a hook in schedule order and all
   but the last with gradients still to come (each bucket's hook index:
   the gradients ready at its launch); step time and tokens/s beside
   the training phase's;
8. zero: the training run through ``training.zero_train_setup`` over
   the same AdamW (the flat-shard optimizer; at world 1 the shard is the
   whole model): losses within ZERO_LOSS_REL_TOL of the training
   phase's, 12 sm90 launches of each kernel a step, the optimizer-state
   bytes per rank; then 3 steps of SGD(0.1, momentum 0.9) through
   ``zero_train_setup`` and through ``data_parallel_train_step`` with
   bit-identical losses and parameters; step time and tokens/s beside
   the training phase's;
9. training_oracle: gpt_small width, 2 layers, fp32 — the gradient of
   every parameter through the kernels ("flash") against the plain dense
   path ("dot") on the same weights and batch, through the CUDA-core
   (simt) forward, dq and dkv: 2 launches of each;
10. resnet: ResNet-50 at full width and depth (bench.py's configuration:
   1000 classes, bf16 over fp32 masters, space-to-depth stem), batch
   128 of 224x224 seeded images, SGD(0.1, momentum 0.9), through
   ``init()`` (world 1 over NCCL), ``replicate_state`` and
   ``data_parallel_train_step``, 10 steps on one fixed batch: every loss
   finite and the last below the first, exactly 53 launches of each
   fused-norm kernel per step; images/s, MFU by bench.py's FLOP count,
   peak memory, then the device busy share and time by kernel class
   over 2 profiled steps after a traced warm-up step, with 5 fused-norm
   device kernels a site (stats 1, apply 1, backward reduce 2, dx 1: 265
   a step);
11. resnet_oracle: ResNet-50 width, stage depths [1, 1, 1, 1], batch 4
   of 64x64, fp32 with TF32 off — every parameter gradient and running
   statistic on the card (the kernels) against the CPU (plain versions);
12. remat: the training phase's gpt_small run (10 steps, one seed, one
   batch) under each remat policy — ``none``, ``dots``,
   ``dots_no_batch``, ``full`` and the per-block mix
   ``("none",)*6 + ("full",)*6``: every policy's losses bit-identical to
   ``none``'s at every step, the sm90 forward launched 12 times a step
   plus once per rematted block (24; 18 for the mix: the backward
   recomputes it), dq and dkv 12, peak memory none > dots >=
   dots_no_batch >= full (the mix between full and none); per policy
   step time, tokens/s, peak memory beside ``modeled_activation_bytes``;
13. pipeline: ResNet-50 in the resnet phase's configuration with
   ``remat=True``, fed from the port's data pipeline (16 batches of
   seeded uint8 images written as npy shards into a temporary
   directory, ``make_loader("npy")``, prefetch depth 2) through
   ``training.fit_epoch`` with a checkpoint every 4 steps (a ring of 3)
   and a ``LearningRateWarmupCallback``: losses finite and falling, 105
   launches of the stats and apply kernels a step and 53 of the
   backward ones, the ring's 3 entries, each step's rate the warmup's;
   images/s beside the resnet phase's, the loader's host wait a step,
   the busy share, peak memory with and without remat; then, with
   deterministic cuDNN, a fresh model restored from step 12 runs the
   rest of the epoch with losses bit-identical to the uninterrupted
   run's;
14. ring: the flash ring's schedule at four ranks of 2048 tokens (a
   global 8192) replayed on the card through the package's per-step
   functions (``replay_ring_flash``), at gpt_small's and llama3_8b's
   attention widths, causal, bidirectional and a causal window of 256
   (the rotation cut to 2 steps), bf16 and fp32: outputs and (dq, dk,
   dv) against one ``flash_attention`` over the whole sequence
   (``RING_TOL``; bf16 also against the fp32 result), exact launches of
   each kernel and variant (``ring_blocks``: every diagonal, and each
   later block but a causal ring's future ones), the schedule's time
   beside the single call's;
14a. parallel: the rest of ``parallel/`` on one card at world 1:
   gpt_small's widths (B=8 x S=2048, bf16 over fp32 masters, AdamW)
   through ``MultiAxisTransformer("ring_flash")`` and
   ``make_sharded_train_step`` at the mesh (1, 1, 1), TRAIN_STEPS steps:
   losses finite and falling, 12 launches of each training kernel a
   step; as a side check (not a main path: no all-to-all), Ulysses's
   local attention replayed at n = 2 and 4 on gpt_small's attention at
   a global 8192 tokens (rank j's attention is head chunk j over the
   whole sequence) against one ``flash_attention`` (outputs and
   gradients, n launches of each kernel, times);
   ``ExpertParallelMoe`` (8 experts at gpt_small's width, ep = 1,
   16 k tokens) forward and backward against a dense gated reference;
   ``pipeline_apply`` at pp = 1 over gpt_small's 12 blocks, M = 8,
   against the blocks run microbatch by microbatch;
15. ring4 (four cards; not in the default run): ``ring_flash_attention``
   over NCCL on the ring phase's cases, every rank's output and
   gradients bit-equal to the replay of the same ring on its own card;
   then gpt_small at full width and depth with
   ``attention_impl="ring_flash"``, B=8 x a global 8192 cut into
   2048-token shards, through ``init()``, ``replicate_state`` and
   ``data_parallel_train_step``, 10 steps: losses equal on every rank,
   finite and falling, each rank's launches a step those of its place
   on the ring; tokens/s, step time, peak memory;
15a. tp4 (four cards; not in the default run): llama3_8b served over
   NCCL at shards 1, 2 (two engines: ranks 0-1 and 2-3) and 4, each
   with the tp phase's checks, the streams equal to shards 1's and
   across the ranks; decode tokens/s, TTFT p50, per-rank peak memory,
   the intake broadcast's host ms a step and, alone, a burst of the
   step's 64 all-reduces of each; the dp x sp x tp trainer at
   (1, 2, 2), ``ulysses`` and ``ring_flash``, at gpt_small's widths
   (step time, tokens/s); ``ulysses_attention(impl="flash")`` over
   NCCL at n = 4 as in the tp phase; MoE at ep = 4 (each rank its own
   tokens); the pipeline at pp = 4 (gpt_small's 12 blocks as 4 stages
   of 3, M = 8);
15b. hier4 (four cards; not in the default run): the hier phase's runs
   and checks over NCCL at B=8 x S=2048 a rank, 6 steps each (the
   recorded calls' bytes equal to the model on both tiers), their step
   times, and
   the fp32 gradients' allreduce at gpt_small's parameter shapes timed
   in turns: NCCL's own flat allreduce, the flat rank-ordered sum, the
   two-level sum and the two-level sum with a bf16 wire, with the
   two-level calls' per-tier bytes (one NVLink box: both tiers are
   NVLink);
16. dp4 (four cards; not in the default run, which needs one): gpt_small
   data-parallel training over NCCL, four ranks each on its own seeded
   B=8 x S=2048 batch, through the plain, overlapped and ZeRO steps of
   each package root given by ``--roots`` in turn (another checkout's
   root runs whichever steps it has): every rank's losses equal, the
   overlapped step's bit-identical to the plain step's, ZeRO's within
   ZERO_LOSS_REL_TOL; step times and tokens/s; and the gradients'
   rank-ordered allreduce against NCCL's own, in turns;
17. guard: the training phase's gpt_small twice from one seed, in turns,
   through the unguarded step and ``data_parallel_train_step(guard=
   True)`` feeding an ``IntegrityGuard`` (cadence 5), 10 steps: losses
   and parameters bit-identical, every ``finite`` true, the diag digest
   equal to ``host_digest`` of the post-reduction gradients at steps 3
   and 7, 12 launches of each training kernel a step; the guard's
   overhead (median and mean step time) and ``grad_diag``'s device and
   host-enqueue time (run once under torch's sync debug mode: no host
   sync); then a rollback at world 1 through ``fit_epoch`` (cadence 2,
   checkpoints after steps 5-7, a parameter set to inf before step 7):
   the check at step 8 trips, ``ckpt-7`` is discarded, ``IntegrityError``
   is raised, and steps 7-10 re-run from ``ckpt-6`` to the unguarded
   losses bit for bit;
18. elastic: the same model through ``python -m horovod_tpu_torch.runner
   --host-discovery-script`` (``localhost:2``, ``--min-np 1 --max-np
   1``), 6 steps under ``hvd.elastic.run`` with a ``TpuState``
   committing every step, uninterrupted, with ``training.step:raise``
   at step 5 (``HorovodInternalError``: an exec-restart in place with
   the memfd snapshot) and with ``elastic.commit:kill`` at step 5 (the
   replacement worker auto-resumes from the step-3 checkpoint): both
   faulted runs end with the uninterrupted losses and parameter digest
   bit for bit, 12 launches of each training kernel every step; the
   restart split (persist, snapshot bytes, reboot, restore) and the
   kill's respawn-to-resume time;
19. observe: ``python -m horovod_tpu_torch.bench``'s ``main`` in
   process at full width (bench.py's ResNet-50 configuration, batch 128
   of 224x224, 5 + 30 steps) with a Chrome timeline: a finite loss, MFU
   <= 1, 53 launches of each fused-norm kernel a step, one ``COMM``
   begin/end pair per collective call (as many as
   ``hvd_tpu_collectives_total`` moved); the bench again fed from npy
   shards (2 + 10 steps, its input wait); one overlapped gpt_small step
   under torch.profiler with one ``hvd_tpu::bucket.<b>::COMM`` range per
   bucket; ``record_overlap_metrics(overlap_inventory(...))`` of it (the
   gauge equals the inventory's exposed fraction, the buckets' bytes
   the model's gradient bytes); the serving step inventories (the
   decode step: 32 paged-decode kernels, nothing gathered; the mixed
   step: 32 sm90 forwards, the modeled gather bytes); ``cluster_snapshot``
   at world 1.  Under ``--phases dp4`` each rank also profiles one
   overlapped step (``measured_overlap_exposed`` of the NCCL kernels)
   and the four ranks take a ``cluster_snapshot``;
20. hier: the two-level collectives on ONE card: four ranks, one
   process each over gloo (NCCL refuses two ranks on a card), two
   slices of two (``HVD_TPU_SLICE_SIZE=2``,
   ``HOROVOD_HIERARCHICAL_ALLREDUCE=1``); gpt_small at full width and
   depth, B=2 x S=2048 a rank, the loss in fp32 (the cross entropy of
   the bf16 logits), 3 steps each of the flat step, the flat step with
   the library's own sum (the association baseline), the
   routed step, the routed step with a bf16 cross wire, the overlapped
   routed step and ``zero_train_setup(hierarchical=True)`` with
   ``DcnCompression("bfloat16", error_feedback=True)``, each after an
   init of its own (the flag and the wire are read there): every rank's
   losses equal, finite and falling, 12 launches of each training
   kernel a step, the routed (fp32 wire) losses within
   ZERO_LOSS_REL_TOL of the flat ones over the first 3 steps and at
   every step within HIER_DRIFT_FACTOR times the baseline's drift from
   them (every step's difference and bound recorded), the overlapped
   ones bit-identical to the plain
   routed ones, the ZeRO shard's optimizer state half the replicated
   one; a dyadic allreduce at gpt_small's parameter shapes bit-equal
   routed and flat, the tier counters (fp32 and bf16 wire) equal to
   the model, and the bytes of the calls the primitives recorded equal
   to the model but on the local tier, where gloo's stand-in for the
   reduce-scatter (an all-reduce) moves them twice.  Its times stage
   through the host and measure nothing.

Each main path (serving, tp, spec, disagg, training, overlap, zero,
remat, resnet, pipeline, ring, parallel, ring4, tp4, guard, elastic,
observe's bench runs, hier, hier4) is driven with the kernels' launch
counts set to 0 just before it and read just after (the elastic, tp,
tp4, hier and hier4 workers count in their own processes).  The card's
``nvidia-smi`` line comes next, then the ``kernels`` JSON on the line
before the last (one entry per kernel and C entry, the forward's two
variants apart: ``launches`` from the main paths' runs, the other
numbers from the kernel phase at the main path's shape — the sm90
forward at gpt_small's training forward, the simt one at llama3_8b's
gathered decode (its launches: the fp32 oracles, its path), the paged
decode at serving's decode, the sm90 dq and dkv at gpt_small's bf16
backward, the simt ones at gpt_small's fp32 backward (their path: the
fp32 training oracle),
the fused-norm kernels summed over the 53 sites of one ResNet-50 step;
the sm90 forward launches summed over the serving, tp (both ranks),
spec, disagg, training, overlap, zero, remat, parallel, guard,
elastic and hier runs (and tp4's and hier4's), the paged decode's over
the serving, tp, spec and disagg runs (and tp4's), dq and dkv over the
training, overlap, zero, remat, parallel, guard, elastic and hier runs
(and tp4's and hier4's), the
fused-norm launches over the resnet, pipeline and observe (two bench
runs) runs; the six ``*_kv_offset`` entries (the forward, dq and dkv at
a non-zero offset, each variant) at the ring's own past-block
call at gpt_small's shard, their launches the ring phase's (and
ring4's);
null where ``--phases`` left that phase out);
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout, it exits 1 and prints no result.
``--phases`` runs a subset (e.g. ``--phases kernels,training``; overlap
and zero run training first, whose losses they are held against); the
default runs all but dp4, ring4, tp4 and hier4 (``tp`` runs the
serving phase first: its streams are the reference).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # fp32 outside the tensor cores
# kernel vs plain version, on the outputs: the largest absolute error,
# and the largest per-row error relative to that row's largest |output|
# (a row = one (batch, query, head); rows that must be zero are checked
# for exact zeros).  bf16 outputs round to 8 significant bits, so an
# element may differ by one rounding step (<= 2**-7 of its magnitude,
# hence of its row's largest value) where the two fp32 accumulations
# straddle a rounding boundary; they agree far closer than one step.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
ROW_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
SEED = 1234


def log(*a):
    print(*a, flush=True)


def card_line():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
    except OSError:
        return "nvidia-smi unavailable"
    out = smi.stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi unavailable"


def cuda_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_SPIN = {}


def device_ms(fn, reps=10, warmup=2):
    """Device time per call (ms) of ``fn``, without the host's time
    between its launches: a spin kernel (``torch.cuda._sleep``) holds
    the card while the host enqueues ``reps`` calls behind it, and the
    events around the calls then time them back to back.  The spin is
    sized from a measured cycle rate and must outlast the enqueueing
    (checked on the host's clock; lengthened and repeated if not)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if "cycles_per_ms" not in _SPIN:
        torch.cuda._sleep(10_000_000)  # warm
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _SPIN["cycles_per_ms"] = 10_000_000 / start.elapsed_time(end)
    spin_ms = 50.0
    for _ in range(4):
        torch.cuda._sleep(int(_SPIN["cycles_per_ms"] * spin_ms))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < 0.5 * spin_ms:
            return start.elapsed_time(end) / reps
        spin_ms *= 4
    raise RuntimeError(f"enqueueing {reps} calls took {host_ms:.1f} ms, "
                       f"longer than the spin (device time not measured)")


# -- phase 3: the kernel against its plain version ---------------------------


def make_case(name, *, b, c, h, h_kv, d, s, dtype, q_starts, kv_start=None,
              window=None, decode=False, kv_lens=None):
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((b, c, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, s, h_kv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, s, h_kv, d), generator=g, device="cuda").to(dtype)
    as_i32 = lambda x: None if x is None else torch.tensor(  # noqa: E731
        x, dtype=torch.int32, device="cuda")
    return dict(name=name, q=q, k=k, v=v, q_starts=as_i32(q_starts),
                kv_start=as_i32(kv_start), window=window, decode=decode,
                kv_lens=as_i32(kv_lens))


def visible_mask(case):
    """(B, C, S) bool: the keys each query may attend (the kernel's own
    mask, on global positions)."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    q, k = case["q"], case["k"]
    b, c, s = q.shape[0], q.shape[1], k.shape[1]
    offs = fa._row_offsets(case["q_starts"], case["kv_start"], b, q.device)
    return fa._tile_mask(
        torch.arange(c, device=q.device)[None, :, None],
        torch.arange(s, device=q.device)[None, None, :], True,
        case["window"], s, offs.long()[:, None, None])


def bound_ms(case, mask):
    """Least time on the card: max(bytes / HBM rate, FLOPs / peak).
    Bytes: Q and O once, and each K/V row some query of its batch row
    can see once (per kv head).  FLOPs: 4*D per visible (query head,
    query, key) pair (QK^T and PV)."""
    q, k = case["q"], case["k"]
    b, c, h, d = q.shape
    h_kv, el = k.shape[2], q.element_size()
    keys = int(mask.any(dim=1).sum())             # visible K/V rows
    pairs = int(mask.sum())                       # visible (q, k) pairs
    nbytes = 2 * b * c * h * d * el + 2 * keys * h_kv * d * el
    flops = 4 * d * h * pairs
    peak = PEAK_FLOPS[str(q.dtype).split(".")[-1]]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _variant_counts(fn=None):
    """Launches of each variant of a kernel wrapper (default: the
    forward's, ``flash_fwd_cuda``)."""
    from horovod_tpu_torch.ops import flash_attention as fa

    fn = fn or fa.flash_fwd_cuda
    return {"sm90": fn.sm90_launches, "simt": fn.simt_launches}


def _launched(before, fn=None):
    """The variants of ``fn`` launched since ``before``
    (_variant_counts)."""
    return {k: n - before[k] for k, n in _variant_counts(fn).items()
            if n != before[k]}


def run_case(case):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa

    q, k, v = case["q"], case["k"], case["v"]
    b, c, h, d = q.shape
    # the sm90 forward takes every bf16 chunk (C > 4) at D 64 or 128; the
    # CUDA-core one fp32 and decode
    want = "sm90" if q.dtype == torch.bfloat16 and not case["decode"] \
        else "simt"
    kw = dict(window=case["window"], kv_start=case["kv_start"])
    if case["decode"]:
        call = lambda: fa.flash_decode_attention(  # noqa: E731
            q, k, v, case["kv_lens"], **kw)
    else:
        call = lambda: fa.flash_chunk_attention(  # noqa: E731
            q, k, v, case["q_starts"], **kw)
    plain = lambda: fa.flash_chunk_attention_reference(  # noqa: E731
        q, k, v, case["q_starts"], **kw)
    before = _variant_counts()
    out = call()
    torch.cuda.synchronize()
    variant = _launched(before)
    ref = plain()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    scale = ref.float().abs().amax(dim=-1).clamp_min(1e-30)
    row_err = float((diff.amax(dim=-1) / scale).max())
    dtype = str(q.dtype).split(".")[-1]
    ok = (math.isfinite(err) and err <= TOL[dtype]
          and math.isfinite(row_err) and row_err <= ROW_TOL[dtype]
          and variant == {want: 1})
    mask = visible_mask(case)
    # rows with no visible key (decode pad slots, chunk rows before a
    # sequence starts): exact zeros, and the -1e30 log-sum-exp sentinel
    empty = ~mask.any(dim=-1)  # (B, C)
    if bool(empty.any()):
        zero = bool((out[empty] == 0).all())
        offs = fa._row_offsets(case["q_starts"], case["kv_start"], b,
                               q.device).contiguous()
        _, lse = fa.flash_fwd_cuda(q, k, v, offs, window=case["window"],
                                   with_lse=True)
        sentinel = bool((lse.transpose(1, 2)[empty]
                         == float(np.float32(-1e30))).all())
        ok = ok and zero and sentinel
        log(f"  {case['name']}: {int(empty.sum())} rows without a visible "
            f"key: exactly zero {zero}, lse sentinel {sentinel}")
    bnd, by = bound_ms(case, mask)
    # SDPA on the same function, timed only (never used by the port)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    am = mask[:, None]
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=am, enable_gqa=True)
    try:
        lib_ms = cuda_ms(library)
    except Exception as e:  # an SDPA without enable_gqa: no yardstick
        log(f"  {case['name']}: library call unavailable ({e!r})")
        lib_ms = None
    rec = dict(case=case["name"], shape=[b, c, h, k.shape[2], d, k.shape[1]],
               dtype=dtype, variant=want, launched=variant,
               max_abs_err=err, tol=TOL[dtype],
               max_row_rel_err=row_err, row_tol=ROW_TOL[dtype], ok=ok,
               kernel_ms=device_ms(call), call_ms=cuda_ms(call),
               plain_ms=cuda_ms(plain, reps=3), library_ms=lib_ms,
               bound_ms=bnd, bound_by=by)
    log("  " + json.dumps(rec))
    return rec


def make_paged_case(name, *, b, h, h_kv, d, dtype, kv_lens, bs=16,
                    window=None, layer=1):
    """A decode step's paged inputs: two layers of pools (``layer`` is
    read) holding twice the live pages, each row's pages scattered over
    the pool by a seeded shuffle (block 0, the trash block, pads the
    tables), tables as wide as the longest row's pages (the page tier)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    need = [-(-max(n, 0) // bs) for n in kv_lens]
    width = max(need)
    n_blocks = 1 + 2 * sum(need)
    shape = (2, n_blocks, bs, h_kv, d)
    kp = torch.randn(shape, generator=g, device="cuda").to(dtype)
    vp = torch.randn(shape, generator=g, device="cuda").to(dtype)
    ids = torch.randperm(n_blocks - 1,
                         generator=torch.Generator().manual_seed(SEED)) + 1
    tables = torch.zeros((b, width), dtype=torch.long)
    used = 0
    for i, n in enumerate(need):
        tables[i, :n] = ids[used:used + n]
        used += n
    q = torch.randn((b, 1, h, d), generator=g, device="cuda").to(dtype)
    return dict(name=name, q=q, k_pool=kp, v_pool=vp, tables=tables.cuda(),
                kv_lens=torch.tensor(kv_lens, dtype=torch.int32,
                                     device="cuda"),
                layer=layer, window=window, max_pages=width)


def paged_bound_ms(case):
    """Least time on the card for a paged decode: bytes are q and o once,
    each visible K/V row once per kv head and each live table entry
    once; FLOPs 4*D per visible (query head, key) pair."""
    q, kp = case["q"], case["k_pool"]
    b, _, h, d = q.shape
    bs, h_kv, el = kp.shape[2], kp.shape[3], q.element_size()
    cap = case["max_pages"] * bs
    keys = pages = 0
    for n in case["kv_lens"].tolist():
        lo = 0 if case["window"] is None else max(0, n - case["window"])
        hi = min(n, cap)
        if hi > lo:
            keys += hi - lo
            pages += (hi - 1) // bs - lo // bs + 1
    nbytes = 2 * b * h * d * el + 2 * keys * h_kv * d * el + 8 * pages
    flops = 4 * d * (h // h_kv) * h_kv * keys
    peak = PEAK_FLOPS[str(q.dtype).split(".")[-1]]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def run_paged_case(case):
    """The paged decode kernel against its plain version (the gather then
    the dense reference) on the card: errors, the same bits on a second
    call, exact zeros for pad rows, its time beside the bound, the plain
    version's and two library yardsticks (timed only): SDPA on the
    already-gathered K/V, and the gather plus SDPA (device time, as the
    kernel's)."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa

    q, kp, vp, tables, kv = (case[k] for k in (
        "q", "k_pool", "v_pool", "tables", "kv_lens"))
    kw = dict(layer=case["layer"], window=case["window"],
              max_pages=case["max_pages"])
    b, _, h, d = q.shape
    call = lambda: fa.flash_decode_paged(  # noqa: E731
        q, kp, vp, tables, kv, **kw)
    plain = lambda: fa.flash_decode_paged_reference(  # noqa: E731
        q, kp, vp, tables, kv, **kw)
    before = fa.flash_decode_paged.launches
    fwd_before = _variant_counts()
    out, again = call(), call()
    torch.cuda.synchronize()
    launched = fa.flash_decode_paged.launches - before
    same = bool(torch.equal(out, again))
    ref = plain()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    scale = ref.float().abs().amax(dim=-1).clamp_min(1e-30)
    row_err = float((diff.amax(dim=-1) / scale).max())
    dtype = str(q.dtype).split(".")[-1]
    ok = (math.isfinite(err) and err <= TOL[dtype]
          and math.isfinite(row_err) and row_err <= ROW_TOL[dtype]
          and launched == 2 and not _launched(fwd_before) and same)
    pad = kv <= 0
    if bool(pad.any()):
        zero = bool((out[pad] == 0).all())
        ok = ok and zero
        log(f"  {case['name']}: {int(pad.sum())} pad rows exactly zero "
            f"{zero}")
    bnd, by = paged_bound_ms(case)
    layer, window, width = kw["layer"], kw["window"], kw["max_pages"]

    def gather():
        gk, gv, start = fa.gather_pages(kp[layer], vp[layer], tables, kv - 1,
                                        window=window, max_pages=width)
        pos = start.long()[:, None] + torch.arange(gk.shape[1],
                                                   device="cuda")[None]
        vis = pos < kv.long()[:, None]
        if window is not None:
            vis &= pos >= kv.long()[:, None] - window
        return (gk.transpose(1, 2).contiguous(),
                gv.transpose(1, 2).contiguous(), vis[:, None, None])

    qt = q.transpose(1, 2).contiguous()
    kt, vt, am = gather()
    sdpa = lambda k_, v_, m_: F.scaled_dot_product_attention(  # noqa: E731
        qt, k_, v_, attn_mask=m_, enable_gqa=True)
    try:  # device time, as the kernel's
        lib_ms = device_ms(lambda: sdpa(kt, vt, am))
        lib_gather_ms = device_ms(lambda: sdpa(*gather()))
    except Exception as e:  # an SDPA without enable_gqa: no yardstick
        log(f"  {case['name']}: library call unavailable ({e!r})")
        lib_ms = lib_gather_ms = None
    rec = dict(case=case["name"], kernel="flash_decode_paged",
               shape=[b, h, kp.shape[3], d, kp.shape[2], width],
               kv_lens=kv.tolist(), window=window, dtype=dtype,
               variant="paged", launched=launched, same_bits=same,
               max_abs_err=err, tol=TOL[dtype], max_row_rel_err=row_err,
               row_tol=ROW_TOL[dtype], ok=ok, kernel_ms=device_ms(call),
               call_ms=cuda_ms(call), plain_ms=cuda_ms(plain, reps=3),
               library_ms=lib_ms, library_gather_ms=lib_gather_ms,
               bound_ms=bnd, bound_by=by)
    log("  " + json.dumps(rec))
    return rec


#: (query heads, kv heads, shards) of one rank of llama3_8b's attention
#: under tensor-sharded serving
SHARD_HEADS = ((16, 4, 2), (8, 2, 4))

#: the verify case's row offsets: the serving prompts' lengths (16, 100,
#: 300, 480, 700, 64, 286, 456) plus 15 generated tokens
VERIFY_Q_STARTS = [31, 115, 315, 495, 715, 79, 301, 471]


def phase_kernels():
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    ctx = [1, 9, 100, 700, 1500, 2500, 3333, 4096]
    starts = [0, 256, 512, 1000, 1792, 2500, 3000, 3840]
    cases = []
    for dt in (bf, f32):
        tag = "bf16" if dt is bf else "fp32"
        cases.append(make_case(
            f"decode_gqa_{tag}", b=8, c=1, h=32, h_kv=8, d=128, s=4096,
            dtype=dt, q_starts=[x - 1 for x in ctx], decode=True,
            kv_lens=ctx))
        cases.append(make_case(
            f"chunk_gqa_{tag}", b=8, c=256, h=32, h_kv=8, d=128, s=4096,
            dtype=dt, q_starts=starts))
    for dt in (bf, f32):
        tag = "bf16" if dt is bf else "fp32"
        cases.append(make_case(
            f"decode_mha_d64_{tag}", b=8, c=1, h=32, h_kv=32, d=64, s=2048,
            dtype=dt, q_starts=[min(x, 2048) - 1 for x in ctx], decode=True,
            kv_lens=[min(x, 2048) for x in ctx]))
        cases.append(make_case(
            f"chunk_mha_d64_{tag}", b=8, c=128, h=32, h_kv=32, d=64, s=2048,
            dtype=dt, q_starts=[0, 100, 300, 640, 1000, 1500, 1800, 1920]))
    # windowed: the gather starts at page `first` (kv_start = first*16)
    # and spans window + C - 1 positions plus slack (as PagedKVState does)
    win, cw = 256, 64
    lens = [0, 10, 300, 900, 1200, 2000, 3000, 4000]
    first = [max(0, (n + 1 - win) // 16) for n in lens]
    for dt in (bf, f32):
        tag = "bf16" if dt is bf else "fp32"
        cases.append(make_case(
            f"chunk_window_{tag}", b=8, c=cw, h=32, h_kv=8, d=128,
            s=((win + cw - 1) // 16 + 2) * 16, dtype=dt, q_starts=lens,
            kv_start=[f * 16 for f in first], window=win))
    # chunk rows placed before their sequence's first key (whole rows and
    # the head of a row): no visible key, exact zeros through sm90
    cases.append(make_case(
        "chunk_empty_rows_bf16", b=8, c=64, h=32, h_kv=8, d=128, s=4096,
        dtype=bf, q_starts=[-64, 5, -64, 300, -10, 1000, -64, 4000]))
    # a speculative verify step (spec_k=4: width 8) over gathered pages:
    # the serving prompts 16 tokens into their decode, keys up to the
    # batch's page tier (64 pages of 16)
    cases.append(make_case(
        "verify_gqa_bf16", b=8, c=8, h=32, h_kv=8, d=128, s=1024, dtype=bf,
        q_starts=VERIFY_Q_STARTS))
    # one rank's head slice of tensor-sharded serving (the tp phases):
    # llama3_8b's 32/8 heads cut 2 ways (16/4) and 4 ways (8/2)
    for h, h_kv, shards in SHARD_HEADS:
        cases.append(make_case(
            f"chunk_gqa_shard{shards}_bf16", b=8, c=256, h=h, h_kv=h_kv,
            d=128, s=4096, dtype=bf, q_starts=starts))
        cases.append(make_case(
            f"verify_gqa_shard{shards}_bf16", b=8, c=8, h=h, h_kv=h_kv,
            d=128, s=1024, dtype=bf, q_starts=VERIFY_Q_STARTS))
    pad_lens = [0, 5, 0, 300, 0, 1, 0, 4096]
    cases.append(make_case(
        "decode_pad_rows_bf16", b=8, c=1, h=32, h_kv=8, d=128, s=4096,
        dtype=bf, q_starts=[x - 1 for x in pad_lens], decode=True,
        kv_lens=pad_lens))
    recs = []
    for case in cases:
        recs.append(run_case(case))
        del case
        torch.cuda.empty_cache()
    # the paged decode (serving's decode steps): the shapes above, read
    # through block tables of 16-token pages scattered in a larger pool
    paged = [make_paged_case(f"decode_paged_gqa_{tag}", b=8, h=32, h_kv=8,
                             d=128, dtype=dt, kv_lens=ctx)
             for dt, tag in ((bf, "bf16"), (f32, "fp32"))]
    paged.append(make_paged_case(
        "decode_paged_mha_d64_bf16", b=8, h=32, h_kv=32, d=64, dtype=bf,
        kv_lens=[min(x, 2048) for x in ctx]))
    paged.append(make_paged_case(
        "decode_paged_window_bf16", b=8, h=32, h_kv=8, d=128, dtype=bf,
        kv_lens=ctx, window=256))
    paged.append(make_paged_case(
        "decode_paged_pad_rows_bf16", b=8, h=32, h_kv=8, d=128, dtype=bf,
        kv_lens=pad_lens))
    for h, h_kv, shards in SHARD_HEADS:
        paged.append(make_paged_case(
            f"decode_paged_gqa_shard{shards}_bf16", b=8, h=h, h_kv=h_kv,
            d=128, dtype=bf, kv_lens=ctx))
    for case in paged:
        recs.append(run_paged_case(case))
        del case
        torch.cuda.empty_cache()
    bad = [r["case"] for r in recs if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version (or "
                             f"ran another variant): {bad}")
    return recs


# -- phase 3b: the training kernels (B1 uniform offset, B2, B3) --------------

# (name, B, S, H, H_kv, D, causal, window, dtype); the first is the main
# path's shape (gpt_small at B=8, S=2048)
TRAIN_CASES = [
    ("gpt_small_causal", 8, 2048, 12, 12, 64, True, None, "bfloat16"),
    ("gpt_small_causal", 8, 2048, 12, 12, 64, True, None, "float32"),
    ("llama3_8b_gqa_causal", 1, 4096, 32, 8, 128, True, None, "bfloat16"),
    ("llama3_8b_gqa_causal", 1, 4096, 32, 8, 128, True, None, "float32"),
    ("bidirectional", 4, 2048, 12, 12, 64, False, None, "bfloat16"),
    ("causal_window256", 4, 2048, 12, 12, 64, True, 256, "bfloat16"),
    ("bidirectional_window256", 4, 2048, 12, 12, 64, False, 256,
     "bfloat16"),
    ("ragged_s1000_gqa", 2, 1000, 12, 4, 64, True, None, "bfloat16"),
    ("ragged_s1000_gqa", 2, 1000, 12, 4, 64, True, None, "float32"),
    ("ragged_s1000_bidirectional_window", 2, 1000, 12, 4, 64, False, 100,
     "float32"),
]
# kernel vs plain on the training kernels' outputs (O, lse, dQ, dK, dV):
# absolute error within TOL x max(1, largest |plain output|) (gradients
# are not bounded by 1 as attention outputs are), and per-row error
# relative to the row's largest |output|, where rows whose largest value
# is below 1e-2 of the tensor's are held against 1e-2 of the tensor's
# largest instead (a causal dQ's first row is 0 up to rounding).  The
# fp32 row tolerance is 3e-4: the first rows of a causal dQ sum few
# terms of dS = P∘(dO·Vᵀ − δ), whose difference cancels, so fp32
# rounding that is 1e-6 of the tensor shows as up to ~1e-4 of such a
# row (7.4e-5 observed, llama3_8b GQA dQ on an H100); a dropped or
# misplaced tile is off by O(1).
TRAIN_ROW_TOL = {"bfloat16": 1e-2, "float32": 3e-4}


def _errors(out, ref):
    diff = (out.float() - ref.float()).abs()
    refa = ref.float().abs()
    top = float(refa.max())
    rows = refa.amax(dim=-1).clamp_min(max(1e-2 * top, 1e-30))
    return (float(diff.max()), float((diff.amax(dim=-1) / rows).max()),
            max(1.0, top))


def _train_bounds(b, s, h, h_kv, d, causal, window, el, dtype,
                  kv_offset=0):
    """Least time on the card for each kernel: max(bytes / HBM rate,
    FLOPs / peak).  Triples = visible (head, query, key) entries of this
    run's mask (at ``kv_offset``).  FLOPs per triple: 4·D forward
    (QKᵀ, PV), 6·D dq (QKᵀ, dO·Vᵀ, dS·K), 8·D dkv (QKᵀ, Pᵀ·dO, dO·Vᵀ,
    dSᵀ·Q).  Bytes: each input read once and each output written once
    (q-side (B,S,H,D) tensors, kv-side (B,S,H_kv,D) ones, fp32 (B,H,S)
    statistics)."""
    from horovod_tpu_torch.ops import flash_attention as fa

    mask = fa._self_mask(s, causal, window, "cuda", kv_offset)
    triples = int(mask.sum()) * b * h
    qs, kvs, st = b * s * h * d * el, b * s * h_kv * d * el, b * h * s * 4
    peak = PEAK_FLOPS[dtype]
    out = {}
    for name, nbytes, flops in (
            ("fwd", 2 * qs + 2 * kvs + st, 4 * d * triples),
            ("dq", 3 * qs + 2 * kvs + 2 * st, 6 * d * triples),
            ("dkv", 2 * qs + 4 * kvs + 2 * st, 8 * d * triples)):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
        out[name] = (max(t_b, t_o) * 1e3,
                     "bytes" if t_b >= t_o else "operations")
    del mask
    return out, triples


def run_train_case(name, b, s, h, h_kv, d, causal, window, dtype_name):
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    mk = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device="cuda").to(dtype)
    q, k, v, do = mk(b, s, h, d), mk(b, s, h_kv, d), mk(b, s, h_kv, d), \
        mk(b, s, h, d)
    kw = dict(causal=causal, window=window)
    fwd = lambda: fa.flash_forward(q, k, v, causal, window)  # noqa: E731
    before = _variant_counts()
    out, lse = fwd()
    torch.cuda.synchronize()
    want = "sm90" if dtype == torch.bfloat16 else "simt"
    variant = _launched(before)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq_k = lambda: fa.flash_bwd_dq_cuda(  # noqa: E731
        q, k, v, do, lse, delta, **kw)
    dkv_k = lambda: fa.flash_bwd_dkv_cuda(  # noqa: E731
        q, k, v, do, lse, delta, **kw)
    bwd_fns = {"dq": fa.flash_bwd_dq_cuda, "dkv": fa.flash_bwd_dkv_cuda}
    before = {key: _variant_counts(fn) for key, fn in bwd_fns.items()}
    dq = dq_k()
    dk, dv = dkv_k()
    torch.cuda.synchronize()
    bwd_variant = {key: _launched(before[key], fn)
                   for key, fn in bwd_fns.items()}
    # one writer per output, no atomics: a second call, the same bits
    again = (dq_k(), *dkv_k())
    torch.cuda.synchronize()
    deterministic = all(torch.equal(a, b)
                        for a, b in zip((dq, dk, dv), again))
    del again
    plain_f = lambda: fa.flash_attention_reference(  # noqa: E731
        q, k, v, causal, window)
    plain_dq = lambda: fa.flash_bwd_dq_reference(  # noqa: E731
        q, k, v, do, lse, delta, causal, window)
    plain_dkv = lambda: fa.flash_bwd_dkv_reference(  # noqa: E731
        q, k, v, do, lse, delta, causal, window)
    errs = {}
    r_out, r_lse = plain_f()
    errs["o"] = _errors(out, r_out)
    errs["lse"] = _errors(lse[..., None], r_lse[..., None])
    del r_out, r_lse
    errs["dq"] = _errors(dq, plain_dq())
    r_dk, r_dv = plain_dkv()
    errs["dk"], errs["dv"] = _errors(dk, r_dk), _errors(dv, r_dv)
    del r_dk, r_dv
    ok = (variant == {want: 1} and deterministic
          and bwd_variant == {"dq": {want: 1}, "dkv": {want: 1}}
          and all(math.isfinite(a) and a <= TOL[dtype_name] * top
                  and math.isfinite(r) and r <= TRAIN_ROW_TOL[dtype_name]
                  for a, r, top in errs.values()))
    bounds, triples = _train_bounds(b, s, h, h_kv, d, causal, window,
                                    q.element_size(), dtype_name)
    rec = dict(case=name, shape=[b, s, h, h_kv, d], causal=causal,
               window=window, dtype=dtype_name, ok=ok, variant=want,
               launched=variant, bwd_launched=bwd_variant,
               deterministic=deterministic, triples=triples,
               tol=TOL[dtype_name], row_tol=TRAIN_ROW_TOL[dtype_name],
               errors={key: dict(abs=a, row=r, abs_bound=TOL[dtype_name]
                                 * top) for key, (a, r, top) in errs.items()})
    for key, kern, plain in (("fwd", fwd, plain_f), ("dq", dq_k, plain_dq),
                             ("dkv", dkv_k, plain_dkv)):
        rec[key] = dict(kernel_ms=cuda_ms(kern, reps=5),
                        plain_ms=cuda_ms(plain, reps=2, warmup=1),
                        bound_ms=bounds[key][0], bound_by=bounds[key][1])
        torch.cuda.empty_cache()
    # SDPA on the same function, timed only (never used by the port): its
    # forward beside B1, its whole backward (dQ, dK, dV) beside B2 + B3
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    if window is None:
        sd_kw = dict(is_causal=causal)
    else:
        sd_kw = dict(attn_mask=fa._self_mask(s, causal, window, "cuda"))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, enable_gqa=True, **sd_kw)
    try:
        rec["fwd"]["library_ms"] = cuda_ms(sdpa, reps=5)
        o_sd = sdpa()
        g_sd = do.transpose(1, 2).contiguous()
        bwd = lambda: torch.autograd.grad(  # noqa: E731
            o_sd, (qt, kt, vt), g_sd, retain_graph=True)
        rec["sdpa_bwd_ms"] = cuda_ms(bwd, reps=5)
        del o_sd
    except Exception as e:  # an SDPA without enable_gqa: no yardstick
        log(f"  {name}: library call unavailable ({e!r})")
        rec["fwd"]["library_ms"] = rec["sdpa_bwd_ms"] = None
    rec["dq"]["library_ms"] = rec["dkv"]["library_ms"] = rec["sdpa_bwd_ms"]
    log("  " + json.dumps(rec))
    return rec


def phase_train_kernels():
    import torch

    recs = []
    for case in TRAIN_CASES:
        recs.append(run_train_case(*case))
        torch.cuda.empty_cache()
    bad = [f"{r['case']}/{r['dtype']}" for r in recs if not r["ok"]]
    if bad:
        raise AssertionError(
            f"training kernels disagree with their plain versions: {bad}")
    return recs


# -- phase 3b': the training kernels at a uniform kv_offset (B9) --------------

# (name, B, S, H, H_kv, D, causal, window, kv_offset, dtype): one K/V block
# of S keys whose first key sits kv_offset positions after the first
# query — ring attention's blocks at a 2048-token shard (a global 8192
# over four ranks: offsets ±2048, ±6144).  The first of each width is the
# ring's own off-diagonal call (a past block, bidirectional with no
# window: every key visible), the main path's shape; "future" blocks see
# no key (zeros, the −1e30 sentinel), windows and the ±1000 offsets
# leave some rows or keys with nothing to see and cut the diagonal
# through the tiles.
B9_CASES = [
    ("gpt_small_past", 8, 2048, 12, 12, 64, False, None, -2048, "bfloat16"),
    ("gpt_small_past", 8, 2048, 12, 12, 64, False, None, -2048, "float32"),
    ("gpt_small_causal", 8, 2048, 12, 12, 64, True, None, -2048, "bfloat16"),
    ("gpt_small_causal", 8, 2048, 12, 12, 64, True, None, -6144, "bfloat16"),
    ("gpt_small_causal_future", 8, 2048, 12, 12, 64, True, None, 2048,
     "bfloat16"),
    ("gpt_small_causal_future", 8, 2048, 12, 12, 64, True, None, 6144,
     "float32"),
    ("gpt_small_bidirectional", 8, 2048, 12, 12, 64, False, None, 2048,
     "bfloat16"),
    ("gpt_small_causal_window256", 8, 2048, 12, 12, 64, True, 256, -2048,
     "bfloat16"),
    ("gpt_small_causal_window256", 8, 2048, 12, 12, 64, True, 256, -2048,
     "float32"),
    ("gpt_small_bidirectional_window256", 8, 2048, 12, 12, 64, False, 256,
     2048, "bfloat16"),
    ("gpt_small_bidirectional_window256", 8, 2048, 12, 12, 64, False, 256,
     2048, "float32"),
    ("gpt_small_causal_partial", 8, 2048, 12, 12, 64, True, None, -1000,
     "bfloat16"),
    ("gpt_small_causal_partial", 8, 2048, 12, 12, 64, True, None, 1000,
     "bfloat16"),
    ("gpt_small_causal_partial", 8, 2048, 12, 12, 64, True, None, 1000,
     "float32"),
    ("llama3_8b_past", 1, 2048, 32, 8, 128, False, None, -2048, "bfloat16"),
    ("llama3_8b_past", 1, 2048, 32, 8, 128, False, None, -2048, "float32"),
    ("llama3_8b_causal", 1, 2048, 32, 8, 128, True, None, -6144, "bfloat16"),
    ("llama3_8b_causal_future", 1, 2048, 32, 8, 128, True, None, 6144,
     "bfloat16"),
    ("llama3_8b_causal_window256", 1, 2048, 32, 8, 128, True, 256, -2048,
     "bfloat16"),
    ("llama3_8b_bidirectional_window256", 1, 2048, 32, 8, 128, False, 256,
     2048, "bfloat16"),
    ("llama3_8b_causal_partial", 1, 2048, 32, 8, 128, True, None, -1000,
     "bfloat16"),
    ("llama3_8b_causal_partial", 1, 2048, 32, 8, 128, True, None, 1000,
     "float32"),
]


def _sm90_rounded_bwd(q, k, v, do, lse, delta, causal, window, kv_offset):
    """(dQ, dK, dV) by the plain versions' arithmetic with the sm90
    backward's own rounding points (``csrc/flash_bwd_sm90.cu``): dS
    rounded to bf16 before dS·K and dSᵀ·Q, P before Pᵀ·dO, and the dkv
    kernel's dS formed from the rounded P at D = 128.  A row of few
    terms (a key seen by a handful of queries) can cancel, and rounding
    each term by 2^-9 then moves it by more than 1e-2 of its own largest
    value; against this version only the fp32 sums' order and the
    output's rounding differ."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    b, s, h, d = q.shape
    h_kv = k.shape[2]
    g = h // h_kv
    rnd = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    mask = fa._self_mask(s, causal, window, q.device, kv_offset)
    p = torch.where(mask, torch.exp(fa._grouped_logits(q, k) - lse[..., None]),
                    torch.zeros((), device=q.device))
    dp = fa._grouped_dots(do, v) - delta[..., None]
    dq = torch.einsum("bhgqk,bkhd->bqhgd", rnd(p * dp).reshape(
        b, h_kv, g, s, s), k.float()).reshape(b, s, h, d)

    def per_kv(x, y):
        return torch.einsum("bhqk,bqhd->bkhd", x, y.float()).reshape(
            b, s, h_kv, g, d).sum(dim=3)

    dk = per_kv(rnd((rnd(p) if d == 128 else p) * dp), q)
    dv = per_kv(rnd(p), do)
    scale = 1.0 / math.sqrt(d)
    return (dq * scale).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


def _offset_counts():
    """Launches at a non-zero uniform offset of (fwd, dq, dkv), each's
    (sm90, simt)."""
    return tuple(n for fn in _train_wrappers()
                 for n in (fn.offset_sm90_launches, fn.offset_simt_launches))


def run_b9_case(name, b, s, h, h_kv, d, causal, window, kv_offset,
                dtype_name):
    """One block at ``kv_offset`` through the forward, dq and dkv
    kernels against their plain versions at the same offset: errors as
    the training cases' (live rows and keys; bf16 gradient rows against
    the plain arithmetic with the sm90 kernels' rounding points,
    ``_sm90_rounded_bwd``, their absolute error against the plain
    versions), rows that see no key
    exactly zero with the −1e30 lse sentinel (dq too), keys no query
    sees exactly zero in dK and dV, the variant of each launch counted
    at a non-zero offset, the same dq/dkv bits on a second call; kernel,
    plain and SDPA (a boolean ``attn_mask`` of the same visibility;
    timed only) times and the card's bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    mk = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device="cuda").to(dtype)
    q, k, v, do = mk(b, s, h, d), mk(b, s, h_kv, d), mk(b, s, h_kv, d), \
        mk(b, s, h, d)
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)
    mask = fa._self_mask(s, causal, window, "cuda", kv_offset)
    live_q, live_k = mask.any(dim=1), mask.any(dim=0)
    before = _offset_counts()
    out, lse = fa.flash_block_forward(q, k, v, causal, window, kv_offset)
    torch.cuda.synchronize()
    # the backward's lse: a finite one for every row, as the ring's final
    # (merged) lse is — the block's own where it sees a key, else the
    # row's lse over the diagonal block (offset 0)
    lse_b = torch.where(lse > -1e29, lse,
                        fa.flash_forward(q, k, v, True, window)[1])
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq_k = lambda: fa.flash_bwd_dq_cuda(  # noqa: E731
        q, k, v, do, lse_b, delta, **kw)
    dkv_k = lambda: fa.flash_bwd_dkv_cuda(  # noqa: E731
        q, k, v, do, lse_b, delta, **kw)
    dq = dq_k()
    dk, dv = dkv_k()
    torch.cuda.synchronize()
    want = "sm90" if dtype == torch.bfloat16 else "simt"
    delta_counts = [a - c for a, c in zip(_offset_counts(), before)]
    # (fwd, dq, dkv) x (sm90, simt): one offset launch each, in the variant
    # the rule gives
    want_counts = [int(want == "sm90"), int(want == "simt")] * 3
    again = (dq_k(), *dkv_k())
    torch.cuda.synchronize()
    deterministic = all(torch.equal(x, y)
                        for x, y in zip((dq, dk, dv), again))
    del again
    plain_f = lambda: fa.flash_attention_reference(  # noqa: E731
        q, k, v, causal, window, kv_offset)
    plain_dq = lambda: fa.flash_bwd_dq_reference(  # noqa: E731
        q, k, v, do, lse_b, delta, causal, window, kv_offset)
    plain_dkv = lambda: fa.flash_bwd_dkv_reference(  # noqa: E731
        q, k, v, do, lse_b, delta, causal, window, kv_offset)
    errs = {}
    r_out, r_lse = plain_f()
    errs["o"] = _errors(out, r_out)
    lq = live_q.nonzero()[:, 0]
    errs["lse"] = _errors(lse[..., lq, None], r_lse[..., lq, None]) \
        if lq.numel() else (0.0, 0.0, 1.0)
    del r_out, r_lse
    errs["dq"] = _errors(dq, plain_dq())
    r_dk, r_dv = plain_dkv()
    errs["dk"], errs["dv"] = _errors(dk, r_dk), _errors(dv, r_dv)
    del r_dk, r_dv
    # bf16 gradient rows: the per-row check against the sm90 kernels'
    # own rounding points (the absolute one stays against the plain
    # version above)
    row_errs = {key: errs[key][1] for key in errs}
    if want == "sm90":
        rounded = _sm90_rounded_bwd(q, k, v, do, lse_b, delta, causal,
                                    window, kv_offset)
        for key, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), rounded):
            row_errs[key] = _errors(got, ref)[1]
        del rounded
    dead_q, dead_k = ~live_q, ~live_k
    sentinel = float(np.float32(-1e30))
    exact = dict(
        out=bool((out[:, dead_q] == 0).all()),
        lse=bool((lse[..., dead_q] == sentinel).all()),
        dq=bool((dq[:, dead_q] == 0).all()),
        dkv=bool((dk[:, dead_k] == 0).all() and (dv[:, dead_k] == 0).all()))
    ok = (delta_counts == want_counts and deterministic and all(exact.values())
          and all(math.isfinite(a) and a <= TOL[dtype_name] * top
                  for a, _r, top in errs.values())
          and all(math.isfinite(r) and r <= TRAIN_ROW_TOL[dtype_name]
                  for r in row_errs.values()))
    bounds, triples = _train_bounds(b, s, h, h_kv, d, causal, window,
                                    q.element_size(), dtype_name, kv_offset)
    rec = dict(case=name, shape=[b, s, h, h_kv, d], causal=causal,
               window=window, kv_offset=kv_offset, dtype=dtype_name, ok=ok,
               variant=want, offset_launches=delta_counts,
               deterministic=deterministic, rows_without_key=int(
                   dead_q.sum()), keys_unseen=int(dead_k.sum()),
               exact_zeros_and_sentinel=exact, triples=triples,
               tol=TOL[dtype_name], row_tol=TRAIN_ROW_TOL[dtype_name],
               errors={key: dict(abs=a, row=r, abs_bound=TOL[dtype_name]
                                 * top, row_checked=row_errs[key])
                       for key, (a, r, top) in errs.items()})
    fwd = lambda: fa.flash_block_forward(  # noqa: E731
        q, k, v, causal, window, kv_offset)
    for key, kern, plain in (("fwd", fwd, plain_f), ("dq", dq_k, plain_dq),
                             ("dkv", dkv_k, plain_dkv)):
        rec[key] = dict(kernel_ms=cuda_ms(kern, reps=5),
                        plain_ms=cuda_ms(plain, reps=2, warmup=1),
                        bound_ms=bounds[key][0], bound_by=bounds[key][1])
        torch.cuda.empty_cache()
    # SDPA with the same visibility as a boolean mask, timed only (never
    # used by the port); rows that see nothing give NaN there, which no
    # one reads
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    try:
        rec["fwd"]["library_ms"] = cuda_ms(sdpa, reps=5)
        o_sd = sdpa()
        g_sd = do.transpose(1, 2).contiguous()
        bwd = lambda: torch.autograd.grad(  # noqa: E731
            o_sd, (qt, kt, vt), g_sd, retain_graph=True)
        rec["sdpa_bwd_ms"] = cuda_ms(bwd, reps=5)
        del o_sd
    except Exception as e:  # an SDPA without enable_gqa: no yardstick
        log(f"  {name}: library call unavailable ({e!r})")
        rec["fwd"]["library_ms"] = rec["sdpa_bwd_ms"] = None
    rec["dq"]["library_ms"] = rec["dkv"]["library_ms"] = rec["sdpa_bwd_ms"]
    log("  " + json.dumps(rec))
    return rec


def phase_b9_kernels():
    import torch

    recs = []
    for case in B9_CASES:
        recs.append(run_b9_case(*case))
        torch.cuda.empty_cache()
    bad = [f"{r['case']}@{r['kv_offset']}/{r['dtype']}" for r in recs
           if not r["ok"]]
    if bad:
        raise AssertionError(
            f"kernels at a kv_offset disagree with their plain versions: "
            f"{bad}")
    return recs


# -- phase 3c: the fused BatchNorm kernels (B5-B8) ---------------------------

EPS = 1e-5
# kernel vs plain on the fused-norm outputs.  mean and var: the two sides
# sum up to 1.6 M fp32 terms in different orders (the stats kernel in
# sequential chains of at most 500 terms, its host plan's limit: a
# thread's rows, at most 381 at ResNet-50's sites, then pairwise trees of
# depth <= 8 over a block's row threads, strided slices of at most 17
# partials and a pairwise tree over the slices; the backward reduce in
# chains of at most ~350: a thread's rows, a block's row threads, the
# partials' slices; the plain version in torch's tree), and
# var = E[x²] − mean² cancels, so |Δmean| is held to 1e-4·sqrt(E[x²])
# and |Δvar| to 2e-4·E[x²] per channel (fp32 rounding over a 500-term
# chain is ≤ 500·2⁻²⁴ ≈ 3.0e-5 of the terms' mass).  dβ and dγ likewise
# to 1e-4 of their terms' mass Σ|dy′| and Σ|dy′·x̂|.  y and dx: per
# channel, the largest error relative to that channel's largest |plain
# value| ≤ 1e-2 in bf16 (one rounding step is ≤ 2⁻⁷ of a value) and
# 1e-4 in fp32, and the absolute error ≤ TOL·max(1, largest |value|).
# dres is dy′ cast to x's dtype on both sides: exactly equal.  The stats
# kernel's finalize (rstd, scale, shift from its own mean and var):
# rstd within BN_RSTD_TOL of torch.rsqrt(var + eps) (rsqrtf's 2 ulp on
# either side), scale and shift bit-equal to γ·rstd and β − mean·scale.
BN_STAT_TOL = {"mean": 1e-4, "var": 2e-4, "dbeta": 1e-4, "dgamma": 1e-4}
BN_COL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
BN_RSTD_TOL = 4.8e-7  # 4 ulp of fp32, relative
BN_KERNELS = ("stats", "apply", "bwd_reduce", "dx")


def resnet50_sites():
    """{(M, C, relu, residual): count} of ResNet-50's 53 norm sites at
    batch 128, 224x224, s2d stem (from the model's own ``bn_sites``)."""
    import collections

    import torch
    from horovod_tpu_torch.models import ResNet50

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     stem="space_to_depth", device="cpu")
    sites = model.bn_sites(128, 224, 224)
    assert len(sites) == 53, len(sites)
    return collections.Counter(sites)


def _bn_bounds(m, c, el, relu, res):
    """Least time on the card for each kernel: max(bytes / HBM rate,
    fp32 operations / 67 TFLOP/s).  Bytes: each (M, C) input read once
    and each output written once, plus the per-channel vectors (γ, β,
    the statistics and sums, 4 bytes each); y is read by the backward
    only under a ReLU.  Operations per element: stats 3 (add, multiply,
    add), apply 2 (+1 residual, +1 ReLU), backward reduce 6 (+1 ReLU
    mask), dx 8 (+1 mask)."""
    mc, vec = m * c, c * 4
    work = {
        "stats": (mc * el + 2 * vec + 5 * vec, 3 * mc),
        "apply": (mc * el * (2 + res) + 2 * vec, mc * (2 + res + relu)),
        "bwd_reduce": (mc * el * (2 + relu) + 2 * vec + 2 * vec,
                       mc * (6 + relu)),
        "dx": (mc * el * (2 + relu + 1 + res) + 5 * vec, mc * (8 + relu)),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["float32"]
        out[name] = (t_b * 1e3, t_o * 1e3)
    return out


def _bound(t_bytes_ms, t_ops_ms):
    return (max(t_bytes_ms, t_ops_ms),
            "bytes" if t_bytes_ms >= t_ops_ms else "operations")


def _col_err(out, ref):
    """(largest |diff|, largest per-channel |diff| / channel's max |ref|
    (floored at 1e-2 of the tensor's), max(1, largest |ref|))."""
    diff = (out.float() - ref.float()).abs()
    refa = ref.float().abs()
    top = float(refa.max())
    cols = refa.amax(dim=0).clamp_min(max(1e-2 * top, 1e-30))
    return (float(diff.max()), float((diff.amax(dim=0) / cols).max()),
            max(1.0, top))


def run_bn_case(name, m, c, relu, res, dtype_name, count=1, group=None,
                misalign=False):
    """One fused-norm case: each kernel against the plain version of its
    own step on the same inputs (apply on the kernel's mean and rstd,
    the backward on the kernel forward's y, mean and rstd, so a ReLU
    mask is the same on both sides), a verdict per kernel, the stats
    kernel's bits on a second call, the kernel, plain and library times,
    and the bounds; beside the stats kernel, ``torch.var_mean`` (its own
    function in one call) and ``x.sum()`` (a plain streaming read of the
    same bytes).  ``misalign``: x starts one element past a 16-byte
    boundary (the scalar path)."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import fused_norm as fn

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    offs = 3 * torch.randn((c,), generator=g, device="cuda")
    x = (2 * torch.randn((m, c), generator=g, device="cuda") + offs).to(dtype)
    if misalign:
        buf = torch.empty((m * c + 1,), dtype=dtype, device="cuda")
        buf[1:].view(m, c).copy_(x)
        x = buf[1:].view(m, c)
        assert x.data_ptr() % 16
    gamma = torch.rand((c,), generator=g, device="cuda") + 0.5
    beta = torch.randn((c,), generator=g, device="cuda")
    r = (torch.randn((m, c), generator=g, device="cuda").to(dtype)
         if res else None)
    dy = torch.randn((m, c), generator=g, device="cuda").to(dtype)
    k = {
        "stats": lambda: fn.bn_stats_cuda(x, gamma, beta, EPS),
        "apply": lambda: fn.bn_apply_cuda(x, stats, r, relu),
        "bwd_reduce": lambda: fn.bn_bwd_reduce_cuda(x, dy, y, stats[0],
                                                    stats[2], relu),
        "dx": lambda: fn.bn_dx_cuda(x, dy, y, gamma, stats[0], stats[2],
                                    sums, m, relu, res),
    }
    stats = k["stats"]()
    stats_same_bits = bool(torch.equal(stats, k["stats"]()))
    y = k["apply"]()
    sums = k["bwd_reduce"]()
    dx, dres = k["dx"]()
    torch.cuda.synchronize()
    plain = {
        "stats": lambda: fn.bn_stats_reference(x, EPS),
        "apply": lambda: fn.bn_apply_reference(x, gamma, beta, stats[0],
                                               stats[2], r, relu),
        "bwd_reduce": lambda: fn.bn_bwd_reduce_reference(
            x, dy, y, stats[0], stats[2], relu),
        "dx": lambda: fn.bn_dx_reference(x, dy, y, gamma, stats[0],
                                         stats[2], sums[0], sums[1], m,
                                         relu, res),
    }
    p_mean, p_var, _ = plain["stats"]()
    xf = x.float()
    ex2 = (xf * xf).sum(0) / m
    # (largest |diff|, largest |diff| relative to its scale) per output
    rel = lambda d, scale: (float(d.max()),  # noqa: E731
                            float((d / scale.clamp_min(1e-30)).max()))
    errs = {"mean": rel((stats[0] - p_mean).abs(), ex2.sqrt()),
            "var": rel((stats[1] - p_var).abs(), ex2)}
    rstd_ref = torch.rsqrt(stats[1] + EPS)
    scale_ref = gamma * stats[2]
    finalize_ok = bool(
        ((stats[2] - rstd_ref).abs() <= BN_RSTD_TOL * rstd_ref).all()
        and torch.equal(stats[3], scale_ref)
        and torch.equal(stats[4], beta - stats[0] * scale_ref))
    y_ref = plain["apply"]()
    errs["y"] = _col_err(y, y_ref)
    del y_ref, xf
    p_db, p_dg = plain["bwd_reduce"]()
    dyf = fn._masked_dy(dy, y, relu)
    mass_b = dyf.abs().sum(0)
    mass_g = (dyf * ((x.float() - stats[0]) * stats[2])).abs().sum(0)
    errs["dbeta"] = rel((sums[0] - p_db).abs(), mass_b)
    errs["dgamma"] = rel((sums[1] - p_dg).abs(), mass_g)
    del dyf, mass_b, mass_g
    dx_ref, dres_ref = plain["dx"]()
    errs["dx"] = _col_err(dx, dx_ref)
    dres_equal = (dres is None and dres_ref is None) or bool(
        torch.equal(dres, dres_ref))
    del dx_ref, dres_ref
    stat_ok = lambda key: (math.isfinite(errs[key][1])  # noqa: E731
                           and errs[key][1] <= BN_STAT_TOL[key])
    col_ok = lambda key: (math.isfinite(errs[key][0])  # noqa: E731
                          and errs[key][0] <= TOL[dtype_name] * errs[key][2]
                          and errs[key][1] <= BN_COL_TOL[dtype_name])
    ok_by_kernel = {
        "stats": (stat_ok("mean") and stat_ok("var") and finalize_ok
                  and stats_same_bits),
        "apply": col_ok("y"),
        "bwd_reduce": stat_ok("dbeta") and stat_ok("dgamma"),
        "dx": col_ok("dx") and dres_equal}
    rec = dict(case=name, m=m, c=c, relu=relu, residual=res,
               dtype=dtype_name, sites=count, ok=all(ok_by_kernel.values()),
               ok_by_kernel=ok_by_kernel, dres_equal=dres_equal,
               finalize_ok=finalize_ok, stats_same_bits=stats_same_bits,
               tol=dict(BN_STAT_TOL, col=BN_COL_TOL[dtype_name],
                        rstd=BN_RSTD_TOL),
               errors={key: (dict(abs=v[0], col=v[1],
                                  abs_bound=TOL[dtype_name] * v[2])
                             if len(v) == 3 else dict(abs=v[0], rel=v[1]))
                       for key, v in errs.items()})
    # the library's train-mode BN (cuDNN / native), timed only (never
    # called by the port): F.batch_norm, composed with the residual add
    # and ReLU where the site has them, forward, then its backward
    xl = x.detach().clone().requires_grad_()
    gl = gamma.detach().clone().requires_grad_()
    bl = beta.detach().clone().requires_grad_()

    def lib_fwd():
        out = F.batch_norm(xl, None, None, gl, bl, True, 0.1, EPS)
        if res:
            out = out + r
        return F.relu(out) if relu else out

    o_lib = lib_fwd()
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        o_lib, (xl, gl, bl), dy, retain_graph=True)
    # device time of each kernel wrapper, plain version and library call;
    # the wrapper's call time on the host's clock beside it
    times = [device_ms(f) for f in [k[key] for key in BN_KERNELS]
             + [plain[key] for key in BN_KERNELS] + [lib_fwd, lib_bwd]
             + [lambda: torch.var_mean(x, dim=0, correction=0),
                lambda: x.sum()]]
    del o_lib
    bounds = _bn_bounds(m, c, x.element_size(), int(relu), int(res))
    for i, key in enumerate(BN_KERNELS):
        bnd, by = _bound(*bounds[key])
        rec[key] = dict(kernel_ms=times[i], call_ms=cuda_ms(k[key]),
                        plain_ms=times[4 + i], bound_ms=bnd, bound_by=by,
                        bound_bytes_ms=bounds[key][0],
                        bound_ops_ms=bounds[key][1])
    rec["library_fwd_ms"], rec["library_bwd_ms"] = times[8:10]
    rec["stats"].update(of_bound=rec["stats"]["bound_ms"] / times[0],
                        var_mean_ms=times[10], sum_ms=times[11])
    rec["library_call"] = ("relu(" if relu else "") + "batch_norm(x)" + (
        " + res" if res else "") + (")" if relu else "")
    if group is not None:
        # the sync-BN seam over a world-1 group through the op (autograd):
        # bit-equal to the op without a group
        outs = []
        for pg in (None, group):
            xg = x.detach().clone().requires_grad_()
            gg = gamma.detach().clone().requires_grad_()
            bg = beta.detach().clone().requires_grad_()
            yo, mo, vo = fn.fused_batch_norm_act(xg, gg, bg, r, relu=relu,
                                                 eps=EPS, process_group=pg)
            yo.backward(dy)
            outs.append((yo, mo, vo, xg.grad, gg.grad, bg.grad))
        rec["group_bit_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(*outs))
        rec["ok"] = rec["ok"] and rec["group_bit_equal"]
    log("  " + json.dumps(rec))
    return rec


BN_RESET_LAUNCHES = 50


def bn_stats_counter_check():
    """BN_RESET_LAUNCHES stats launches back to back, round-robin over
    six shapes (1 to 32 column tiles, the vector and scalar paths, both
    dtypes, M = 1), each bit-equal to its shape's first call: a launch
    finds its tiles' counters at 0 only if the last block of every
    earlier launch reset them."""
    import torch
    from horovod_tpu_torch.ops import fused_norm as fn

    shapes = [(401_408, 64, "bfloat16"), (6_272, 2048, "bfloat16"),
              (25_088, 256, "bfloat16"), (100_352, 512, "float32"),
              (4_099, 100, "bfloat16"), (1, 1, "float32")]
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    inputs, first = [], []
    for m, c, dtype_name in shapes:
        x = torch.randn((m, c), generator=g, device="cuda")
        inputs.append((x.to(getattr(torch, dtype_name)),
                       torch.rand((c,), generator=g, device="cuda") + 0.5,
                       torch.randn((c,), generator=g, device="cuda")))
        first.append(fn.bn_stats_cuda(*inputs[-1], EPS))
    torch.cuda.synchronize()
    outs = [fn.bn_stats_cuda(*inputs[i % len(shapes)], EPS)
            for i in range(BN_RESET_LAUNCHES)]
    torch.cuda.synchronize()
    equal = [bool(torch.equal(o, first[i % len(shapes)]))
             for i, o in enumerate(outs)]
    rec = dict(launches=BN_RESET_LAUNCHES, shapes=shapes,
               bit_equal=sum(equal), ok=all(equal))
    log("  bn_stats counter reset: " + json.dumps(rec))
    return rec


def bn_stats_summary(recs):
    """The stats kernel over ResNet-50's 53 sites (each bf16 site shape
    times its count): kernel, bound, var_mean, x.sum() and the library's
    BN forward composite, per step."""
    main = [r for r in recs if r["sites"]]
    total = lambda f: sum(r["sites"] * f(r) for r in main)  # noqa: E731
    rec = dict(sites=sum(r["sites"] for r in main),
               kernel_ms=total(lambda r: r["stats"]["kernel_ms"]),
               bound_ms=total(lambda r: r["stats"]["bound_ms"]),
               var_mean_ms=total(lambda r: r["stats"]["var_mean_ms"]),
               sum_ms=total(lambda r: r["stats"]["sum_ms"]),
               library_fwd_ms=total(lambda r: r["library_fwd_ms"]))
    rec["of_bound"] = rec["bound_ms"] / rec["kernel_ms"]
    log("  bn_stats per ResNet-50 step: " + json.dumps(rec))
    for r in main:
        st = r["stats"]
        log(f"    {r['case']} x{r['sites']}: {st['kernel_ms']:.4f} ms, "
            f"bound {st['bound_ms']:.4f} ({st['of_bound']:.0%}), "
            f"x.sum() {st['sum_ms']:.4f}, var_mean {st['var_mean_ms']:.4f}, "
            f"call {st['call_ms']:.4f}")
    return rec


def phase_bn_kernels():
    """Every ResNet-50 site shape (batch 128, 224x224) in bf16, three of
    them in fp32, a ragged case, a C % 8 != 0 case in each dtype, and
    one site through the process_group path over a world-1 NCCL group;
    then the stats kernel's counter-reset check."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    sites = resnet50_sites()
    cases = []
    for (m, c, relu, res), count in sorted(sites.items(), key=lambda kv:
                                           (-kv[0][0], kv[0][1])):
        tag = f"resnet50_m{m}_c{c}" + ("_relu" if relu else "") + (
            "_res" if res else "")
        cases.append((tag, m, c, relu, res, "bfloat16", count))
    for m, c, relu, res in ((1_605_632, 64, True, False),
                            (100_352, 512, True, True),
                            (6_272, 2048, False, False)):
        cases.append((f"resnet50_m{m}_c{c}_fp32", m, c, relu, res,
                      "float32", 0))
    cases += [("ragged_m1000_c96", 1000, 96, True, True, "bfloat16", 0),
              ("scalar_path_c100", 4099, 100, True, True, "bfloat16", 0),
              ("scalar_path_c30", 4099, 30, True, False, "float32", 0)]
    recs = [run_bn_case(*case) for case in cases]
    recs.append(run_bn_case("scalar_path_misaligned_c64", 4096, 64, True,
                            False, "bfloat16", 0, misalign=True))
    torch.cuda.empty_cache()
    hvd.init()
    recs.append(run_bn_case("process_group_world1_m100352_c512", 100_352,
                            512, True, True, "bfloat16", 0,
                            group=dist.group.WORLD))
    hvd.shutdown()
    torch.cuda.empty_cache()
    bn_stats_summary(recs)
    reset = bn_stats_counter_check()
    bad = [f"{r['case']}:{key}" for r in recs
           for key, ok in r["ok_by_kernel"].items() if not ok]
    bad += [r["case"] + ":group" for r in recs
            if not r.get("group_bit_equal", True)]
    if not reset["ok"]:
        bad.append("stats_counter_reset")
    if bad:
        raise AssertionError(
            f"fused-norm kernels disagree with their plain versions: {bad}")
    return recs


# -- phase 4: serving at full width ------------------------------------------


def phase_serving():
    import numpy as np
    import torch
    from horovod_tpu_torch import trace
    from horovod_tpu_torch.models import init_params, llama3_8b
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serving import ServeConfig, ServingEngine

    cfg = llama3_8b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"  weights: {sum(p.numel() for p in params.values()):,} params "
        f"in {time.perf_counter() - t0:.1f}s")
    eng = ServingEngine(cfg, params, serve=ServeConfig(
        block_size=16, decode_tiers=(1, 2, 4, 8), prefill_chunk=256),
        device="cuda")
    del params
    t0 = time.perf_counter()
    eng.warmup()
    log(f"  warmup {time.perf_counter() - t0:.2f}s, pool "
        f"{eng.pool_bytes / 1e9:.2f} GB ({eng.num_blocks} blocks)")
    eng.first_logits = {}
    eng.token_log = []
    wave1, wave2 = serving_waves(cfg.vocab_size)
    prompts = {}
    torch.cuda.reset_peak_memory_stats()
    since = trace.now()
    fwd, dec = fa.flash_fwd_cuda, fa.flash_decode_paged
    per_step = _count_step_launches(eng)
    fwd.launches = fwd.sm90_launches = fwd.simt_launches = 0
    dec.launches = 0
    steps0 = eng.steps
    t_run = time.perf_counter()
    for p in wave1:
        prompts[eng.submit(p, max_new_tokens=32)] = p
    eng.run()
    for p in wave2:
        prompts[eng.submit(p, max_new_tokens=32)] = p
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    del eng._decode_step, eng._mixed_step  # the counting wrappers
    launches = fwd.launches
    by_variant = {"sm90": fwd.sm90_launches, "simt": fwd.simt_launches}
    paged = dec.launches
    steps = eng.steps - steps0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert sorted(out) == sorted(prompts), "not every request completed"
    assert all(len(out[r]) == 32 for r in prompts), "short stream"
    assert launches + paged == cfg.num_layers * steps, (
        f"attention launches {launches} + {paged} != {cfg.num_layers} x "
        f"{steps} steps")
    # every mixed step (chunks of >= 32 columns) runs the sm90 forward and
    # every decode step the paged decode kernel, once per layer; no step
    # runs the CUDA-core forward
    kinds = [args["kind"] for site, _t, _d, args, _tid
             in trace.snapshot(since) if site == "serve.step" and args]
    step_kinds = {k: kinds.count(k) for k in ("mixed", "decode")}
    assert sum(step_kinds.values()) == steps, (kinds, steps)
    assert step_kinds["mixed"] > 0 and step_kinds["decode"] > 0, step_kinds
    assert [k for k, *_ in per_step] == kinds, (per_step, kinds)
    n = cfg.num_layers
    want = {"mixed": (0, n, 0), "decode": (n, 0, 0)}
    wrong = [(k, c) for k, *c in per_step if tuple(c) != want[k]]
    assert not wrong, (
        f"steps whose (paged decode, sm90, simt) launches differ from "
        f"{want}: {wrong[:4]}")
    hits = eng.scheduler.prefix_hit_blocks
    assert hits > 0, "the second wave hit no cached prefix block"
    # first-token logits against a dense, cache-free forward (bf16)
    worst = 0.0
    with torch.inference_mode():
        for rid, p in prompts.items():
            toks = torch.as_tensor(p, dtype=torch.long, device="cuda")[None]
            dense = eng.model(toks)[0, -1].float().cpu()
            got = eng.first_logits[rid]
            rel = float((got - dense).abs().max() / dense.abs().max())
            worst = max(worst, rel)
    logit_tol = 5e-2
    log(f"  first-token logits vs dense forward: max |diff|/max|logit| = "
        f"{worst:.4g} (tol {logit_tol})")
    assert worst <= logit_tol, "first-token logits disagree"
    ttft = sorted(s - a for s, a in _first_tokens(eng))
    gen = sum(len(v) for v in out.values())
    # decode throughput: tokens emitted by decode steps over their time
    dec = [(args["batch"], dur) for site, _t, dur, args, _tid
           in trace.snapshot(since)
           if site == "serve.step" and args and args["kind"] == "decode"]
    rec = dict(requests=len(out), steps=steps, launches=launches,
               launches_by_variant=by_variant, paged_decode_launches=paged,
               step_kinds=step_kinds,
               prefix_hit_blocks=hits, evictions=eng.scheduler.evictions,
               prefill_tokens_computed=eng.prefill_tokens_computed,
               ttft_p50_s=ttft[len(ttft) // 2], tokens=gen, wall_s=wall,
               tokens_per_s=gen / wall,
               decode_steps=len(dec),
               decode_tokens_per_s=(sum(b for b, _ in dec)
                                    / sum(d for _, d in dec)),
               pool_gb=eng.pool_bytes / 1e9, peak_mem_gb=peak_gb)
    log("  serving: " + json.dumps(rec))
    rec["streams"] = [out[r].tolist() for r in prompts]  # the tp phase's
    rec["profile"] = profile_wave(eng, list(prompts.values()))
    rec["views"] = serving_views(eng)
    del eng
    torch.cuda.empty_cache()
    return rec


def serving_waves(vocab):
    """The serving phase's two waves of prompts (16 to 700 tokens; four
    share a 256-token prefix, two of them in the second wave)."""
    import numpy as np

    rs = np.random.RandomState(SEED)
    shared = rs.randint(1, vocab, size=256).astype(np.int32)
    tail = lambda n: rs.randint(1, vocab, size=n).astype(np.int32)  # noqa
    wave1 = [tail(16), tail(100), np.concatenate([shared, tail(44)]),
             tail(480), np.concatenate([shared, tail(444)]), tail(64)]
    wave2 = [np.concatenate([shared, tail(30)]),
             np.concatenate([shared, tail(200)])]
    return wave1, wave2


def _count_step_launches(eng):
    """Wrap ``eng``'s two step functions (instance attributes, removed by
    ``del``) so that each step appends (kind, paged decode launches, sm90
    forward launches, simt forward launches) to the returned list."""
    from horovod_tpu_torch.ops import flash_attention as fa

    fwd, dec, steps = fa.flash_fwd_cuda, fa.flash_decode_paged, []

    def counted(fn, kind):
        def step(*a, **kw):
            before = (dec.launches, fwd.sm90_launches, fwd.simt_launches)
            out = fn(*a, **kw)
            now = (dec.launches, fwd.sm90_launches, fwd.simt_launches)
            steps.append((kind, *(x - y for x, y in zip(now, before))))
            return out
        return step

    eng._decode_step = counted(eng._decode_step, "decode")
    eng._mixed_step = counted(eng._mixed_step, "mixed")
    return steps


def _kernel_class(name):
    n = name.lower()
    if "flash_decode" in n:
        return "attention_decode_kernel"
    if "flash_fwd" in n:
        return "attention_fwd_kernel"
    if "flash_bwd" in n:
        return "attention_bwd_kernels"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "sm90", "nvjet")):
        return "gemm"
    if "index" in n or "gather" in n or "scatter" in n:
        return "cache_copy"
    return "other"


def _device_breakdown(prof, wall, steps, classify=None):
    """Device time and kernels per step by kernel class, device time by
    kernel name, the device busy share (union of kernel intervals over
    the wall) and kernels per step from a torch.profiler capture."""
    from horovod_tpu_torch.utils.profiler import device_kernels

    # the host spans the profiler mirrors onto the device timeline (the
    # collectives' COMM ranges, overlap.bucket) are not kernels
    kernels = device_kernels(prof)
    by_class, n_class, by_name, spans = {}, {}, {}, []
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        cls = (classify or _kernel_class)(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        n_class[cls] = n_class.get(cls, 0) + 1
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + ms
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    if not kernels:
        log("  profile: the profiler recorded no device kernels "
            "(device time not measured)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        steps=steps, wall_s=wall,
        device_ms_by_class={k: round(v, 3) for k, v in by_class.items()},
        kernels_per_step_by_class={k: v / max(1, steps)
                                   for k, v in n_class.items()},
        device_busy_share=(busy_us / 1e6 / wall) if kernels else None,
        top_kernels_ms={k: round(v, 3) for k, v in top},
        kernels_per_step=len(kernels) / max(1, steps))


DECODE_PROFILE_STEPS = 8


def profile_wave(eng, prompts):
    """Where the time goes: resubmit ``prompts`` (their full blocks are
    cached by now) under torch.profiler; device time by kernel class,
    device busy share (union of kernel intervals over the wall), and the
    mean wall time per step kind from the engine's trace spans."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch import trace

    torch.cuda.synchronize()
    since = trace.now()
    steps0 = eng.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p, max_new_tokens=32)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = _device_breakdown(prof, wall, eng.steps - steps0)
    host = sorted(((a.key, a.self_cpu_time_total / 1e3, a.count)
                   for a in prof.key_averages()
                   if a.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])[:10]
    kinds = {}
    for site, _t0, dur, args, _tid in trace.snapshot(since):
        if site == "serve.step" and args:
            kinds.setdefault(args["kind"], []).append(dur * 1e3)
    rec.update(
        step_ms_mean={k: sum(v) / len(v) for k, v in kinds.items()},
        step_count={k: len(v) for k, v in kinds.items()},
        top_host_self_ms_calls={k: [round(ms, 3), n] for k, ms, n in host})
    log("  profile: " + json.dumps(rec))
    # decode steps alone: the prompts once more, stepped past their
    # prefill, then DECODE_PROFILE_STEPS decode steps under the profiler
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    sched = eng.scheduler
    while sched.pending or not all(s.in_decode for s in sched.running):
        eng.step()
    torch.cuda.synchronize()
    steps0 = eng.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dec = _device_breakdown(prof, wall, eng.steps - steps0)
    n = max(1, dec["steps"])
    dec.update(
        batch=len(sched.running),
        device_ms_per_step=sum(dec["device_ms_by_class"].values()) / n,
        device_ms_per_step_by_class={
            k: v / n for k, v in dec["device_ms_by_class"].items()},
        wall_ms_per_step=wall * 1e3 / n)
    log("  decode-step profile: " + json.dumps(dec))
    eng.run()
    rec["decode_step"] = dec
    return rec


def _first_tokens(eng):
    """(first-token time, arrival) per request, from the token log."""
    seen = {}
    for rid, t, arrival in eng.token_log:
        seen.setdefault(rid, (t, arrival))
    return list(seen.values())


# -- phase 5: the fp32 oracle ------------------------------------------------


def phase_oracle():
    """fp32, 2 layers: the plain engine, a speculative engine (the
    oracle drafter with its wrong tokens) and a prefill→decode router
    pair each serve the prompts; every stream must equal one-at-a-time
    dense decode token for token (up to a near-tie, at 1e-4)."""
    import numpy as np
    import torch
    from horovod_tpu_torch.fleet import FleetRouter
    from horovod_tpu_torch.models import init_params, llama3_8b
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.serving import ServeConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_8b(num_layers=2, dtype=torch.float32)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED + 1),
                         device="cuda")
    serve = ServeConfig(block_size=16, decode_tiers=(1, 2, 4),
                        prefill_chunk=32)
    eng = ServingEngine(cfg, params, serve=serve, device="cuda")
    rs = np.random.RandomState(SEED + 1)
    prompts = [rs.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 23, 40, 61)]
    n_new = 12
    fwd, dec = fa.flash_fwd_cuda, fa.flash_decode_paged
    _reset_attention_counts()
    ids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    out = eng.run()
    # fp32: mixed steps through the CUDA-core forward, decode steps
    # through the paged decode kernel
    launches = {"flash_decode_paged": dec.launches,
                "flash_fwd_simt": fwd.simt_launches,
                "flash_fwd_sm90": fwd.sm90_launches}
    assert launches["flash_decode_paged"] > 0 \
        and launches["flash_fwd_simt"] > 0 \
        and launches["flash_fwd_sm90"] == 0, launches
    streams = {"plain": [out[rid] for rid in ids]}
    # the speculative engine: the oracle drafter's verify steps run the
    # CUDA-core forward (fp32) and its plain decode steps the paged one
    drafter, _calls = oracle_drafter(prompts, streams["plain"],
                                     cfg.vocab_size)
    spec = ServingEngine(cfg, params, serve=dataclasses.replace(
        serve, spec=True, spec_k=4), drafter=drafter, device="cuda")
    _reset_attention_counts()
    sids = [spec.submit(p, max_new_tokens=n_new) for p in prompts]
    sout = spec.run()
    spec_launches = _attention_counts()
    assert spec.spec_accepted_tokens > 0 \
        and spec.spec_rolled_back_tokens > 0, "drafts never landed or " \
        "never rolled back"
    assert spec_launches["flash_fwd_sm90"] == 0 \
        and spec_launches["flash_fwd_simt"] > 0 and spec.spec_steps > 0 \
        and spec_launches["flash_decode_paged"] > 0, spec_launches
    streams["spec"] = [sout[rid] for rid in sids]
    # a prefill→decode router pair over the same weights
    router = FleetRouter(lambda role="both": ServingEngine(
        cfg, params, serve=serve, device="cuda", role=role),
        replicas=1, prefill_replicas=1)
    _reset_attention_counts()
    gids = [router.submit(p, n_new) for p in prompts]
    rout = router.run_until_drained()
    fleet_launches = _attention_counts()
    assert fleet_launches["flash_fwd_sm90"] == 0 \
        and fleet_launches["flash_fwd_simt"] > 0 \
        and fleet_launches["flash_decode_paged"] > 0, fleet_launches
    assert sum(router.handoffs.values()) == len(prompts), router.handoffs
    streams["fleet"] = [rout[g] for g in gids]
    compared = {k: 0 for k in streams}
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            toks = list(p)
            for j in range(n_new):
                x = torch.as_tensor(toks, dtype=torch.long,
                                    device="cuda")[None]
                logits = eng.model(x)[0, -1].float()
                top2 = torch.topk(logits, 2).values
                if float(top2[0] - top2[1]) < 1e-4:
                    break  # a near-tie: the rest of the stream may fork
                t = int(torch.argmax(logits))
                for k, ss in streams.items():
                    assert int(ss[i][j]) == t, (
                        f"{k}: request {i} token {j}: engine "
                        f"{int(ss[i][j])} != reference {t}")
                    compared[k] += 1
                toks.append(t)
    rec = dict(compared=compared, plain_launches=launches,
               spec_launches=spec_launches, fleet_launches=fleet_launches,
               launches={k: launches[k] + spec_launches[k]
                         + fleet_launches[k] for k in launches},
               spec_accepted=spec.spec_accepted_tokens,
               spec_rolled_back=spec.spec_rolled_back_tokens,
               handoffs=router.handoffs)
    log(f"  oracle: {json.dumps(rec)} of {len(ids) * n_new} tokens each, "
        f"all equal")
    assert all(n >= len(ids) * n_new // 2 for n in compared.values()), \
        "too few tokens compared"
    del eng, spec, router
    torch.cuda.empty_cache()
    return rec


def _reset_attention_counts():
    """Set the serving kernels' launch counts to 0."""
    from horovod_tpu_torch.ops import flash_attention as fa

    fwd, dec = fa.flash_fwd_cuda, fa.flash_decode_paged
    fwd.launches = fwd.sm90_launches = fwd.simt_launches = 0
    dec.launches = 0


def _attention_counts():
    from horovod_tpu_torch.ops import flash_attention as fa

    fwd, dec = fa.flash_fwd_cuda, fa.flash_decode_paged
    return {"flash_decode_paged": dec.launches,
            "flash_fwd_sm90": fwd.sm90_launches,
            "flash_fwd_simt": fwd.simt_launches}


def oracle_drafter(prompts, streams, vocab):
    """A ``ModelDrafter`` that drafts each request's known continuation
    (``streams[i]`` after ``prompts[i]``) while the request's stream
    still follows it (once a bf16 stream forks on a tie, it drafts
    nothing), with the second token of every third draft replaced by a
    wrong one: acceptance and rollback are then both certain.  Returns
    (drafter, call counter)."""
    import numpy as np
    from horovod_tpu_torch.serving import ModelDrafter

    order = sorted(range(len(prompts)), key=lambda i: -len(prompts[i]))
    calls = [0]

    def draft(tokens, k):
        toks = np.asarray(tokens)
        for i in order:
            p = prompts[i]
            if len(toks) >= len(p) and np.array_equal(toks[:len(p)], p):
                n = len(toks) - len(p)
                if not np.array_equal(toks[len(p):], streams[i][:n]):
                    return []  # forked from the known stream
                d = [int(t) for t in streams[i][n:n + k]]
                calls[0] += 1
                if calls[0] % 3 == 0 and len(d) >= 2:
                    d[1] = (d[1] + 1) % vocab
                return d
        return []
    return ModelDrafter(draft), calls


#: bf16 streams are compared tie-aware: the verify step's logits come
#: from the chunk kernel and a decode step's from the paged decode
#: kernel (and a prefix hit or a two-tier fleet prefills the tail in
#: another chunk), so two streams may take different tokens where
#: logits nearly tie.  Each path's logits are within 5e-2 of max|logit|
#: of a dense forward (the serving phase's first-token check), so a
#: path can pick a token whose dense logit lies below the dense maximum
#: by up to twice that.
BF16_TIE_REL = 0.1


def tie_aware_equal(model, prompt, got, want, what, verbose=True):
    """``got`` equals ``want``, or at their first difference both tokens'
    logits in a dense cache-free forward lie within ``BF16_TIE_REL`` of
    its largest |logit| below its maximum (so its top-2 gap does too).
    Returns the first differing position (None when equal)."""
    import numpy as np
    import torch

    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = np.flatnonzero(got != want)
    if not diff.size:
        return None
    i = int(diff[0])
    toks = np.concatenate([prompt, want[:i]]).astype(np.int64)
    with torch.inference_mode():
        logits = model(torch.as_tensor(toks, device="cuda")[None])[0, -1]
    logits = logits.float()
    top = float(logits.max())
    below = [top - float(logits[int(t)]) for t in (got[i], want[i])]
    bound = BF16_TIE_REL * float(logits.abs().max())
    (log if verbose else _quiet)(
        f"  {what}: streams fork at token {i} ({int(got[i])} vs "
        f"{int(want[i])}), their dense logits {below[0]:.4g} and "
        f"{below[1]:.4g} below the maximum (bound {bound:.4g})")
    assert max(below) < bound, \
        f"{what}: streams differ at token {i} on no tie"
    return i


def _kinds_since(since):
    """The ``serve.step`` spans' kinds since ``since``, in order."""
    from horovod_tpu_torch import trace

    return [args["kind"] for site, _t, _d, args, _tid in trace.snapshot(since)
            if site == "serve.step" and args]


def _per_kind(per_step, kinds):
    """Label each counted step (``_count_step_launches``) with its span
    kind: a verify step runs ``_mixed_step`` but records ``spec``."""
    assert len(per_step) == len(kinds), (len(per_step), len(kinds))
    out = []
    for (fn_kind, *c), kind in zip(per_step, kinds):
        assert fn_kind == ("mixed" if kind in ("mixed", "spec") else kind), (
            fn_kind, kind)
        out.append((kind, *c))
    return out


def _check_step_launches(per_kind, n_layers, allowed=("mixed", "decode",
                                                      "spec")):
    """Every mixed and verify step launches the sm90 forward and every
    decode step the paged decode kernel once per layer, nothing else."""
    want = {"mixed": (0, n_layers, 0), "spec": (0, n_layers, 0),
            "decode": (n_layers, 0, 0)}
    wrong = [(k, c) for k, *c in per_kind
             if k not in allowed or tuple(c) != want[k]]
    assert not wrong, (f"steps whose (paged decode, sm90, simt) launches "
                       f"differ from {want}: {wrong[:4]}")
    return {k: sum(1 for x in per_kind if x[0] == k) for k in allowed}


def _emitted_by_kind(eng):
    """Wrap ``eng._emit`` (an instance attribute, removed by ``del``) to
    count the tokens emitted after each step kind."""
    counts = {}
    emit = eng._emit

    def counted(seq, token, now):
        kind = eng._last_step[0] if eng._last_step else None
        counts[kind] = counts.get(kind, 0) + 1
        return emit(seq, token, now)
    eng._emit = counted
    return counts


def _decode_rate(since, emitted):
    """Tokens emitted by decode and verify steps over those steps' wall
    time (their ``serve.step`` spans), and steps per emitted token."""
    from horovod_tpu_torch import trace

    dur = {"decode": 0.0, "spec": 0.0}
    n = {"decode": 0, "spec": 0}
    for site, _t, d, args, _tid in trace.snapshot(since):
        if site == "serve.step" and args and args["kind"] in dur:
            dur[args["kind"]] += d
            n[args["kind"]] += 1
    toks = emitted.get("decode", 0) + emitted.get("spec", 0)
    secs = dur["decode"] + dur["spec"]
    return dict(decode_tokens=toks, decode_steps=n["decode"],
                spec_steps=n["spec"],
                decode_tokens_per_s=toks / secs if secs else None,
                steps_per_token=(n["decode"] + n["spec"]) / max(1, toks),
                decode_step_ms=(1e3 * dur["decode"] / n["decode"]
                                if n["decode"] else None),
                spec_step_ms=(1e3 * dur["spec"] / n["spec"]
                              if n["spec"] else None))


SPEC_NEW = 32


def phase_spec():
    """llama3_8b, bf16, full width: speculative decoding and the staged
    intake on the card (module docstring, phase spec)."""
    import torch
    from horovod_tpu_torch import trace
    from horovod_tpu_torch.models import init_params, llama3_8b
    from horovod_tpu_torch.serving import (
        ModelDrafter, PromptLookupDrafter, Request, ServeConfig,
        ServingEngine,
    )

    cfg = llama3_8b(dtype=torch.bfloat16)
    n = cfg.num_layers
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda")
    serve = ServeConfig(block_size=16, num_blocks=1024,
                        decode_tiers=(1, 2, 4, 8), prefill_chunk=256)
    wave1, wave2 = serving_waves(cfg.vocab_size)
    prompts = wave1 + wave2
    plain = ServingEngine(cfg, params, serve=serve, device="cuda")
    warmed = plain.warmup()
    launches = {"flash_decode_paged": 0, "flash_fwd_sm90": 0,
                "flash_fwd_simt": 0}

    def counted_run(eng, drive):
        """Drive ``eng`` with the kernels' counts set to 0 just before
        and read just after; per-step launches by span kind."""
        per_step = _count_step_launches(eng)
        emitted = _emitted_by_kind(eng)
        torch.cuda.synchronize()
        since = trace.now()
        _reset_attention_counts()
        t0 = time.perf_counter()
        out = drive()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _attention_counts()
        del eng._decode_step, eng._mixed_step, eng._emit
        for k in launches:
            launches[k] += got[k]
        per_kind = _per_kind(per_step, _kinds_since(since))
        return out, wall, per_kind, emitted, since

    # 1. the plain engine: wave 1 through submit, wave 2 through the
    #    staged intake (an iterator of Requests)
    def drive_plain():
        ids = [plain.submit(p, max_new_tokens=SPEC_NEW) for p in wave1]
        plain.run()
        plain.attach_source(iter([
            Request(id=10_000 + i, prompt=p, max_new_tokens=SPEC_NEW)
            for i, p in enumerate(wave2)]))
        out = plain.run()
        return [out[r] for r in ids] + [out[10_000 + i]
                                        for i in range(len(wave2))]

    want, wall, per_kind, emitted, since = counted_run(plain, drive_plain)
    assert all(len(x) == SPEC_NEW for x in want), "short stream"
    plain_steps = _check_step_launches(per_kind, n, ("mixed", "decode"))
    plain_rate = _decode_rate(since, emitted)
    recs = {"plain": dict(wall_s=wall, steps=plain_steps, **plain_rate)}
    log("  plain: " + json.dumps(recs["plain"]))

    # 2. the speculative engine, the oracle drafter (known continuation,
    #    every third draft's second token wrong)
    drafter, calls = oracle_drafter(prompts, want, cfg.vocab_size)
    spec = ServingEngine(cfg, params, serve=dataclasses.replace(
        serve, spec=True, spec_k=4), drafter=drafter, device="cuda")
    spec_warmed = spec.warmup()

    def drive_spec():
        ids = [spec.submit(p, max_new_tokens=SPEC_NEW) for p in wave1]
        spec.run()
        ids += [spec.submit(p, max_new_tokens=SPEC_NEW) for p in wave2]
        out = spec.run()
        return [out[r] for r in ids]

    for name, drafter_obj in (("oracle", None),
                              ("prompt_lookup", PromptLookupDrafter())):
        if drafter_obj is not None:
            spec._drafter = drafter_obj
        c0 = (spec.spec_drafted_tokens, spec.spec_accepted_tokens,
              spec.spec_rolled_back_tokens)
        got, wall, per_kind, emitted, since = counted_run(spec, drive_spec)
        assert all(len(x) == SPEC_NEW for x in got), "short stream"
        steps = _check_step_launches(per_kind, n)
        drafted, accepted, rolled = (
            a - b for a, b in zip((spec.spec_drafted_tokens,
                                   spec.spec_accepted_tokens,
                                   spec.spec_rolled_back_tokens), c0))
        forks = [tie_aware_equal(spec.model, p, g, w, f"{name} request {i}")
                 for i, (p, g, w) in enumerate(zip(prompts, got, want))]
        recs[name] = dict(wall_s=wall, steps=steps, drafted=drafted,
                          accepted=accepted, rolled_back=rolled,
                          acceptance_rate=accepted / max(1, drafted),
                          forks=forks, **_decode_rate(since, emitted))
        log(f"  spec ({name}): " + json.dumps(recs[name]))
        if name == "oracle":
            assert accepted > 0 and rolled > 0, (accepted, rolled)
            assert steps["spec"] > 0
    assert plain.program_count == warmed and \
        spec.program_count == spec_warmed, "a step ran outside the menu"

    # 3. run_static on the plain engine, beside the continuous engine on
    #    the same prompts all at once (prefix cache cleared before each)
    reqs = [Request(id=20_000 + i, prompt=p, max_new_tokens=SPEC_NEW)
            for i, p in enumerate(prompts)]
    plain.allocator.clear_cache()
    static, static_wall, per_kind, _e, _s = counted_run(
        plain, lambda: plain.run_static(reqs, batch_size=8))
    _check_step_launches(per_kind, n, ("mixed", "decode"))
    for i, (p, w) in enumerate(zip(prompts, want)):
        assert len(static[20_000 + i]) == SPEC_NEW
        tie_aware_equal(plain.model, p, static[20_000 + i], w,
                        f"run_static request {i}")
    plain.allocator.clear_cache()

    def drive_cont():
        ids = [plain.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]
        out = plain.run()
        return [out[r] for r in ids]

    cont, cont_wall, per_kind, _e, _s = counted_run(plain, drive_cont)
    _check_step_launches(per_kind, n, ("mixed", "decode"))
    total = SPEC_NEW * len(prompts)
    recs["static"] = dict(static_tokens_per_s=total / static_wall,
                          continuous_tokens_per_s=total / cont_wall,
                          static_wall_s=static_wall,
                          continuous_wall_s=cont_wall)
    log("  run_static vs continuous: " + json.dumps(recs["static"]))

    # 4. eight verify steps under the profiler; a drafter that always
    #    proposes k tokens (the last token repeated) keeps every row
    #    drafting, and a verify step's work does not depend on how
    #    many of its drafts are accepted
    spec._drafter = ModelDrafter(lambda toks, k: [int(toks[-1])] * k)
    recs["profile"] = profile_verify(spec, prompts)
    log(f"  spec launches: {json.dumps(launches)}")
    del plain, spec, params
    torch.cuda.empty_cache()
    return dict(launches=launches, **recs)


VERIFY_PROFILE_STEPS = 8


def profile_verify(eng, prompts):
    """Device time by kernel class, busy share and kernels per step over
    ``VERIFY_PROFILE_STEPS`` verify steps of the 8-row batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch import trace

    for p in prompts:
        eng.submit(p, max_new_tokens=2 * SPEC_NEW)
    sched = eng.scheduler
    while sched.pending or not all(s.in_decode for s in sched.running):
        eng.step()
    torch.cuda.synchronize()
    steps0 = eng.steps
    since = trace.now()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(VERIFY_PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds = _kinds_since(since)
    assert kinds == ["spec"] * VERIFY_PROFILE_STEPS, kinds
    rec = _device_breakdown(prof, wall, eng.steps - steps0)
    k = max(1, rec["steps"])
    rec.update(
        batch=len(sched.running),
        device_ms_per_step=sum(rec["device_ms_by_class"].values()) / k,
        device_ms_per_step_by_class={
            c: v / k for c, v in rec["device_ms_by_class"].items()},
        wall_ms_per_step=wall * 1e3 / k)
    log("  verify-step profile: " + json.dumps(rec))
    eng.run()
    return rec


def phase_disagg():
    """llama3_8b, bf16, full width: a prefill→decode router pair on one
    card against one ``role="both"`` engine (module docstring, phase
    disagg)."""
    import torch
    from horovod_tpu_torch.fleet import FleetRouter
    from horovod_tpu_torch.metrics import instruments as instr
    from horovod_tpu_torch.models import init_params, llama3_8b
    from horovod_tpu_torch.ops.comm_model import modeled_kvsnap_bytes
    from horovod_tpu_torch.serving import ServeConfig, ServingEngine

    cfg = llama3_8b(dtype=torch.bfloat16)
    n = cfg.num_layers
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda")
    serve = ServeConfig(block_size=16, num_blocks=1024,
                        decode_tiers=(1, 2, 4, 8), prefill_chunk=256)

    def build(role="both"):
        return ServingEngine(cfg, params, serve=serve, device="cuda",
                             role=role)

    wave1, wave2 = serving_waves(cfg.vocab_size)
    prompts = wave1 + wave2
    launches = {"flash_decode_paged": 0, "flash_fwd_sm90": 0,
                "flash_fwd_simt": 0}
    single = build()
    single.warmup()
    single.token_log = []
    per_step = _count_step_launches(single)
    torch.cuda.synchronize()
    _reset_attention_counts()
    t0 = time.perf_counter()
    ids = [single.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]
    out = single.run()
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t0
    for k, v in _attention_counts().items():
        launches[k] += v
    del single._decode_step, single._mixed_step
    _check_step_launches(per_step, n, ("mixed", "decode"))
    want = [out[r] for r in ids]
    single_ttft = sorted(s - a for s, a in _first_tokens(single))
    del single
    torch.cuda.empty_cache()

    router = FleetRouter(build, replicas=1, prefill_replicas=1)
    pre = next(r for r in router.replicas if r.tier == "prefill")
    dec = next(r for r in router.replicas if r.tier == "decode")
    assert pre.engine.role == "prefill" and dec.engine.role == "both"
    pre_steps = _count_step_launches(pre.engine)
    dec_steps = _count_step_launches(dec.engine)
    timing = {"export": [], "import": []}

    def timed(eng, name, key):
        fn = getattr(eng, name)

        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            timing[key].append(time.perf_counter() - t)
            return res
        setattr(eng, name, wrapper)

    timed(pre.engine, "export_requests", "export")
    timed(dec.engine, "import_kv", "import")
    warm0 = instr.SERVE_HANDOFFS.labels("warm").get()
    bytes0 = instr.SERVE_MIGRATED_BYTES.get()
    torch.cuda.synchronize()
    _reset_attention_counts()
    t0 = time.perf_counter()
    gids = [router.submit(p, SPEC_NEW) for p in prompts]
    res = router.run_until_drained()
    torch.cuda.synchronize()
    fleet_wall = time.perf_counter() - t0
    for k, v in _attention_counts().items():
        launches[k] += v
    got = [res[g] for g in gids]
    assert all(len(x) == SPEC_NEW for x in got), "short stream"
    # pure roles: the prefill replica ran mixed steps only, each with 32
    # sm90 forwards, and never the paged decode kernel
    pre_kinds = _check_step_launches(pre_steps, n, ("mixed",))
    dec_kinds = _check_step_launches(dec_steps, n, ("mixed", "decode"))
    assert pre.engine.spec_steps == 0
    assert sum(c[1] for c in pre_steps) == 0
    assert router.all_compile_free(), "a tier stepped outside its menu"
    # every handoff warm, booked, and its measured bytes the model's
    assert router.handoffs == {"warm": len(prompts), "cold": 0}, \
        router.handoffs
    assert instr.SERVE_HANDOFFS.labels("warm").get() - warm0 == len(prompts)
    for r in router.handoff_records:
        m = modeled_kvsnap_bytes(r["blocks"], serve.block_size, n,
                                 cfg.kv_heads, cfg.head_dim, cfg.dtype)
        assert r["bytes"] == m["wire_bytes"], (r, m)
    measured = instr.SERVE_MIGRATED_BYTES.get() - bytes0
    assert measured == router.migrated_bytes == sum(
        r["bytes"] for r in router.handoff_records)
    forks = [tie_aware_equal(dec.engine.model, p, g, w, f"fleet request {i}")
             for i, (p, g, w) in enumerate(zip(prompts, got, want))]
    ms = lambda xs: sorted(1e3 * x for x in xs)  # noqa: E731
    exp, imp = ms(timing["export"]), ms(timing["import"])
    hand = sorted(r["ms"] for r in router.handoff_records)
    per_req = sorted(a + b for a, b in zip(timing["export"],
                                           timing["import"]))
    # the first token comes from the prefill tier (a decode replica's
    # samples are the handed-off requests' first decode emissions)
    fleet_ttft = sorted(t for _rid, t in pre.ttft_samples())
    total = SPEC_NEW * len(prompts)
    rec = dict(
        handoffs=router.handoffs, forks=forks,
        prefill_steps=pre_kinds, decode_steps=dec_kinds,
        handoff_blocks_export_import_ms=[
            (r["blocks"], round(1e3 * e, 3), round(1e3 * i, 3))
            for r, e, i in zip(router.handoff_records, timing["export"],
                               timing["import"])],
        migrated_bytes=router.migrated_bytes,
        export_ms_p50=exp[len(exp) // 2], export_ms_max=exp[-1],
        import_ms_p50=imp[len(imp) // 2], import_ms_max=imp[-1],
        export_import_ms_p50=1e3 * per_req[len(per_req) // 2],
        export_import_ms_max=1e3 * per_req[-1],
        router_handoff_ms_p50=hand[len(hand) // 2],
        router_handoff_ms_max=hand[-1],
        ttft_p50_s=fleet_ttft[len(fleet_ttft) // 2],
        single_ttft_p50_s=single_ttft[len(single_ttft) // 2],
        tokens_per_s=total / fleet_wall,
        single_tokens_per_s=total / single_wall, launches=launches)
    log("  disagg: " + json.dumps(rec))
    del router, pre, dec, params
    torch.cuda.empty_cache()
    return rec


# -- phase 6: data-parallel training of gpt_small at full width --------------

TRAIN_B, TRAIN_S, TRAIN_STEPS, PROFILE_STEPS = 8, 2048, 10, 2


def _train_wrappers():
    from horovod_tpu_torch.ops import flash_attention as fa

    return fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda


def _reset_train_counts():
    from horovod_tpu_torch.ops import flash_attention as fa

    fa._zero_counts(*_train_wrappers())


TRAIN_COUNTS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                "flash_fwd_sm90", "flash_fwd_simt",
                "flash_bwd_dq_sm90", "flash_bwd_dq_simt",
                "flash_bwd_dkv_sm90", "flash_bwd_dkv_simt")


def _train_counts():
    """Launches of (fwd, dq, dkv), then each one's (sm90, simt)
    variants, in TRAIN_COUNTS' order."""
    fns = _train_wrappers()
    return tuple(fn.launches for fn in fns) + tuple(
        n for fn in fns for n in (fn.sm90_launches, fn.simt_launches))


def _gpt_small(**kw):
    """gpt_small (12 layers, 12 heads of 64, vocab 32000) at full width
    and depth, bf16 compute over fp32 masters from SEED, and the fixed
    B=8 x S=2048 batch: ``(cfg, model, inputs, labels)``; ``kw`` goes
    to the config (e.g. ``remat_policy``)."""
    import numpy as np
    import torch

    from horovod_tpu_torch.models import Transformer, gpt_small, init_params

    cfg = gpt_small(dtype=torch.bfloat16, attention_impl="flash", **kw)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                         device="cuda", param_dtype=torch.float32)
    model = Transformer(cfg, params=params)
    del params
    rs = np.random.RandomState(SEED)
    toks = torch.as_tensor(
        rs.randint(0, cfg.vocab_size, size=(TRAIN_B, TRAIN_S + 1)),
        dtype=torch.long, device="cuda")
    return cfg, model, toks[:, :-1], toks[:, 1:]


def _adamw(params):
    """optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8, weight decay
    1e-4, at lr 1e-3."""
    import torch

    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _drive(step, state, inputs, labels, steps, each=None):
    """``steps`` steps with the training kernels' counts set to 0 first:
    ``(state, losses, per-step kernel counts, step seconds)``; ``each()``
    runs after every step."""
    import torch

    torch.cuda.synchronize()
    _reset_train_counts()
    losses, per_step, times = [], [], []
    for _ in range(steps):
        before = _train_counts()
        t0 = time.perf_counter()
        state, loss = step(state, inputs, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        per_step.append(tuple(a - b for a, b in zip(_train_counts(),
                                                    before)))
        if each is not None:
            each()
    return state, [float(x) for x in losses], per_step, times


def _bucket_host_ms(since, steps):
    """Host ms a step inside the gradient buckets' collective calls (the
    ``overlap.bucket`` trace spans, on whichever thread launched them)."""
    from horovod_tpu_torch import trace

    spans = [r for r in trace.snapshot(since) if r[0] == "overlap.bucket"]
    return sum(r[2] for r in spans) * 1e3 / steps


def _check_train_run(cfg, losses, per_step):
    """Every loss finite and the last below the first; 12 launches of
    each training kernel a step, every one the sm90 variant."""
    assert all(math.isfinite(x) for x in losses), f"loss not finite: {losses}"
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    n = cfg.num_layers
    want = (n, n, n) + (n, 0) * 3
    assert all(c == want for c in per_step), (
        f"kernel launches per step {per_step} != {want} "
        f"({', '.join(TRAIN_COUNTS)})")


def _speed(times, n_params, cfg):
    """Steady step time (the first step pays one-time set-up), tokens/s
    and MFU."""
    tokens = TRAIN_B * TRAIN_S
    steady = times[1:]
    step_s = sum(steady) / len(steady)
    median = sorted(steady)[len(steady) // 2]
    # model FLOPs: 6·N per token (attention's S² term not counted); the
    # attention-inclusive figure adds 6·L·S·d per token (causal half of
    # 12·L·S·d)
    mfu = 6 * n_params * tokens / step_s / PEAK_FLOPS["bfloat16"]
    attn = 6 * cfg.num_layers * TRAIN_S * cfg.d_model * tokens
    return dict(step_s=times, step_s_mean_steady=step_s,
                step_s_median_steady=median,
                tokens_per_s=tokens / step_s, mfu_6n=mfu,
                mfu_6n_plus_attention=mfu + attn / step_s
                / PEAK_FLOPS["bfloat16"])


def _beside(rec, train):
    """A phase's step time and tokens/s beside the training phase's."""
    return (f"step {rec['step_s_mean_steady'] * 1e3:.2f} ms mean, "
            f"{rec['step_s_median_steady'] * 1e3:.2f} median, "
            f"{rec['tokens_per_s']:.0f} tokens/s (training phase: "
            f"{train['step_s_mean_steady'] * 1e3:.2f} ms mean, "
            f"{train['step_s_median_steady'] * 1e3:.2f} median, "
            f"{train['tokens_per_s']:.0f} tokens/s)")


def phase_training():
    """gpt_small at full width and depth, B=8 x S=2048, bf16 compute
    over fp32 master weights, AdamW(1e-3) at optax's defaults, through
    the public training path: init() (world 1 over NCCL) ->
    replicate_state -> data_parallel_train_step, TRAIN_STEPS steps on
    one fixed batch."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import trace, training
    from horovod_tpu_torch.optim import state_bytes

    hvd.init()
    assert hvd.size() == 1 and hvd.device().type == "cuda"
    cfg, model, inputs, labels = _gpt_small()
    n_params = sum(p.numel() for p in model.parameters())
    opt = _adamw(model.parameters())
    state = training.replicate_state(training.create_train_state(model, opt))
    step = training.data_parallel_train_step(model, opt)
    torch.cuda.reset_peak_memory_stats()
    since = trace.now()
    state, losses, per_step, times = _drive(step, state, inputs, labels,
                                            TRAIN_STEPS)
    bucket_ms = _bucket_host_ms(since, TRAIN_STEPS)
    launches = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check_train_run(cfg, losses, per_step)
    assert state.step == TRAIN_STEPS
    rec = dict(params=n_params, batch=[TRAIN_B, TRAIN_S],
               steps=TRAIN_STEPS, losses=losses,
               **_speed(times, n_params, cfg),
               launches=dict(zip(TRAIN_COUNTS, launches)),
               launches_per_step=list(per_step[0]), peak_mem_gb=peak_gb,
               buckets=step.reducer.schedule.num_buckets,
               bucket_launch_host_ms_per_step=bucket_ms,
               opt_state_bytes=state_bytes(opt.state))
    log("  training: " + json.dumps(rec))
    rec["profile"] = profile_train(step, state, inputs, labels)
    hvd.shutdown()
    del state, step, model, opt
    torch.cuda.empty_cache()
    return rec


def phase_overlap(train):
    """The training phase's run through data_parallel_train_step(
    overlap=True): each BucketSchedule bucket's NCCL allreduce launched
    from the backward's hooks.  World 1, so Average divides by 1 and
    fusion moves no bits: every loss equals the training phase's.  Each
    step issues num_buckets gradient allreduces (and the loss's), every
    bucket from a hook inside the backward, in order."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import trace, training

    hvd.init()
    cfg, model, inputs, labels = _gpt_small()
    n_params = sum(p.numel() for p in model.parameters())
    opt = _adamw(model.parameters())
    state = training.replicate_state(training.create_train_state(model, opt))
    step = training.data_parallel_train_step(model, opt, overlap=True)
    reducer = step.reducer
    n_buckets = reducer.schedule.num_buckets
    calls, launches = [0], []
    plain_all_reduce = dist.all_reduce

    def counting(*a, **k):
        calls[0] += 1
        return plain_all_reduce(*a, **k)

    def each():
        launches.append((calls[0], list(reducer.last_launches)))
        calls[0] = 0

    dist.all_reduce = counting
    since = trace.now()
    try:
        state, losses, per_step, times = _drive(step, state, inputs, labels,
                                                TRAIN_STEPS, each)
    finally:
        dist.all_reduce = plain_all_reduce
    bucket_ms = _bucket_host_ms(since, TRAIN_STEPS)
    counts = _train_counts()
    _check_train_run(cfg, losses, per_step)
    assert losses == train["losses"], (
        f"overlapped losses {losses} != the training phase's "
        f"{train['losses']}")
    n_grads = len(reducer.params)
    for n_calls, log_ in launches:
        # one allreduce a bucket, and the loss's
        assert n_calls == n_buckets + 1, (n_calls, n_buckets)
        assert [b for b, _, _ in log_] == list(range(n_buckets)), log_
        assert all(from_hook for _, _, from_hook in log_), log_
        # every bucket but the last launched with gradients still to come
        assert all(ready < n_grads for _, ready, _ in log_[:-1]), log_
    rec = dict(steps=TRAIN_STEPS, losses=losses,
               **_speed(times, n_params, cfg),
               launches=dict(zip(TRAIN_COUNTS, counts)),
               buckets=n_buckets, grads=n_grads,
               allreduces_per_step=launches[-1][0],
               bucket_launch_host_ms_per_step=bucket_ms,
               bucket_hook_index=[ready for _, ready, _ in launches[-1][1]])
    log("  overlap: " + json.dumps(rec))
    log("  overlap: " + _beside(rec, train))
    rec["profile"] = profile_train(step, state, inputs, labels, "overlap")
    hvd.shutdown()
    del state, step, model, opt, reducer
    torch.cuda.empty_cache()
    return rec


#: ZeRO's flat AdamW shard against the training phase's per-tensor
#: AdamW: losses within this relative bound (on the CPU both take the
#: same elementwise path and agree to 0 on gpt_tiny and an MLP, world 1,
#: 2 and 4; the bound is test_torch_training's for two AdamWs whose
#: gradients differ at fp32 rounding)
ZERO_LOSS_REL_TOL = 1e-5
ZERO_SGD_STEPS = 3


def phase_zero(train):
    """gpt_small through training.zero_train_setup over the training
    phase's AdamW: the flat-shard optimizer (at world 1 the shard is the
    whole model), TRAIN_STEPS steps; then SGD(0.1, momentum 0.9) for
    ZERO_SGD_STEPS steps through zero_train_setup and through
    data_parallel_train_step, which must give identical bits."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.optim import state_bytes

    def sgd(ps):
        return torch.optim.SGD(ps, lr=0.1, momentum=0.9)

    hvd.init()
    cfg, model, inputs, labels = _gpt_small()
    n_params = sum(p.numel() for p in model.parameters())
    state, step = training.zero_train_setup(model, _adamw(model.parameters()))
    zopt = state.optimizer
    assert zopt.sharded
    state, losses, per_step, times = _drive(step, state, inputs, labels,
                                            TRAIN_STEPS)
    counts = _train_counts()
    _check_train_run(cfg, losses, per_step)
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, train["losses"])]
    assert max(errs) <= ZERO_LOSS_REL_TOL, (losses, train["losses"])
    rec = dict(steps=TRAIN_STEPS, losses=losses,
               loss_rel_err_vs_training=max(errs),
               loss_rel_tol=ZERO_LOSS_REL_TOL,
               **_speed(times, n_params, cfg),
               launches=dict(zip(TRAIN_COUNTS, counts)),
               opt_state_bytes_per_rank=state_bytes(zopt.state),
               replicated_opt_state_bytes=train.get("opt_state_bytes"))
    rec["profile"] = profile_train(step, state, inputs, labels, "zero")
    del state, step, model, zopt
    torch.cuda.empty_cache()
    runs = []
    for zero in (False, True):
        cfg, model, inputs, labels = _gpt_small()
        if zero:
            state, step = training.zero_train_setup(model,
                                                    sgd(model.parameters()))
        else:
            opt = sgd(model.parameters())
            state = training.create_train_state(model, opt)
            step = training.data_parallel_train_step(model, opt)
        state, sgd_losses, _, _ = _drive(step, state, inputs, labels,
                                         ZERO_SGD_STEPS)
        runs.append((sgd_losses, [p.detach().clone()
                                  for p in model.parameters()]))
        del state, step, model
    assert runs[0][0] == runs[1][0], (runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    rec["sgd_losses"] = runs[0][0]
    rec["sgd_bit_identical"] = True
    log("  zero: " + json.dumps(rec))
    log("  zero: " + _beside(rec, train) + "; optimizer state "
        f"{rec['opt_state_bytes_per_rank']} B per rank")
    hvd.shutdown()
    del runs
    torch.cuda.empty_cache()
    return rec


# -- phase: remat --------------------------------------------------------------

#: the remat phase's policies: each named one for every block, then the
#: per-block mix that remats only the deep half
REMAT_RUNS = ("none", "dots", "dots_no_batch", "full",
              ("none",) * 6 + ("full",) * 6)


def phase_remat():
    """gpt_small at full width and depth (the training phase's model,
    batch and AdamW) under each of REMAT_RUNS, TRAIN_STEPS steps each
    from the same seed through init() (world 1 over NCCL) ->
    replicate_state -> data_parallel_train_step.  Per policy: step time,
    tokens/s, peak memory after a reset (and above what was allocated
    before the policy's model was built) beside the modeled activation
    bytes (``modeled_activation_bytes``), and the flash kernels'
    launches a step.  Asserts: every policy's losses bit-identical to
    ``none``'s at every step; the sm90 forward launched once a layer
    plus once a rematted layer a step (24 under a policy for every
    block, 18 for the mix), dq and dkv 12, every launch the sm90
    variant; peak memory none > dots >= dots_no_batch >= full, and the
    mix between full and none.  Each policy's device time and busy share
    over PROFILE_STEPS more steps follow its record."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import modeled_activation_bytes

    hvd.init()
    assert hvd.size() == 1 and hvd.device().type == "cuda"
    runs, launches = [], None
    for policy in REMAT_RUNS:
        base = torch.cuda.memory_allocated()  # what earlier phases hold
        cfg, model, inputs, labels = _gpt_small(remat_policy=policy)
        n_params = sum(p.numel() for p in model.parameters())
        opt = _adamw(model.parameters())
        state = training.replicate_state(
            training.create_train_state(model, opt))
        step = training.data_parallel_train_step(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, losses, per_step, times = _drive(step, state, inputs, labels,
                                                TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated()
        counts = _train_counts()
        launches = counts if launches is None else tuple(
            a + b for a, b in zip(launches, counts))
        modeled = modeled_activation_bytes(cfg, TRAIN_B, TRAIN_S)
        name = policy if isinstance(policy, str) else "none6_full6"
        n = cfg.num_layers
        remats = sum(p != "none" for p in cfg.block_remat_policies())
        rec = dict(policy=name, losses=losses,
                   **{k: v for k, v in _speed(times, n_params, cfg).items()
                      if k != "step_s"},
                   peak_mem_bytes=peak, base_mem_bytes=base,
                   peak_above_base_bytes=peak - base,
                   modeled_activation_bytes=modeled["total_bytes"],
                   launches_per_step=dict(zip(TRAIN_COUNTS, per_step[0])))
        log("  remat: " + json.dumps(rec))
        rec["profile"] = profile_train(step, state, inputs, labels,
                                       name=f"remat {name}")
        want = (n + remats, n, n, n + remats, 0, n, 0, n, 0)
        assert all(c == want for c in per_step), (
            f"{name}: kernel launches per step {per_step} != {want} "
            f"({', '.join(TRAIN_COUNTS)})")
        assert all(math.isfinite(x) for x in losses), losses
        if runs:
            assert losses == runs[0]["losses"], (
                f"{name}: losses {losses} differ from none's "
                f"{runs[0]['losses']}")
        runs.append(rec)
        del state, step, model, opt
        torch.cuda.empty_cache()
    hvd.shutdown()
    peak = {r["policy"]: r["peak_mem_bytes"] for r in runs}
    assert (peak["none"] > peak["dots"] >= peak["dots_no_batch"]
            >= peak["full"]), f"peak memory out of order: {peak}"
    assert peak["full"] <= peak["none6_full6"] <= peak["none"], peak
    return dict(runs=runs, launches=dict(zip(TRAIN_COUNTS, launches)))


# -- phase: pipeline -----------------------------------------------------------

PIPE_BATCHES, PIPE_DEPTH, PIPE_CKPT_EVERY, PIPE_KEEP = 16, 2, 4, 3
PIPE_LR, PIPE_LR0 = 0.1, 0.01  # warmup from PIPE_LR0 to PIPE_LR in an epoch
PIPE_RESUME_FROM = 12
PIPE_CLASSES = 10


def _resnet50(remat, seed=SEED):
    import torch

    from horovod_tpu_torch.models import ResNet50

    return ResNet50(num_classes=1000, dtype=torch.bfloat16,
                    stem="space_to_depth", device="cuda", remat=remat,
                    generator=torch.Generator("cuda").manual_seed(seed))


def _resnet_state(remat, seed=SEED):
    import torch

    from horovod_tpu_torch import training

    model = _resnet50(remat, seed)
    opt = torch.optim.SGD(model.parameters(), lr=PIPE_LR, momentum=0.9)
    state = training.replicate_state(training.create_train_state(model, opt))
    return state, training.data_parallel_train_step(model, opt)


def _resnet_fixed(remat, images, labels, steps=6):
    """``(peak memory bytes above what was allocated before the model
    was built, steady step seconds)`` of ``steps`` steps on one
    device-resident batch (the first two pay cuDNN's search)."""
    import torch

    base = torch.cuda.memory_allocated()
    state, step = _resnet_state(remat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = step(state, images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    del state, step
    torch.cuda.empty_cache()
    return peak, sum(times[2:]) / len(times[2:])


def _warmup_loop(state):
    """A TrainLoop over ``state`` with the epoch's LR warmup."""
    from horovod_tpu_torch import callbacks

    return callbacks.TrainLoop(state, [callbacks.LearningRateWarmupCallback(
        target_lr=PIPE_LR, warmup_epochs=1, steps_per_epoch=PIPE_BATCHES,
        initial_lr=PIPE_LR0)])


def _looped(step, loop, first_batch, rec):
    """``step`` with the loop's per-batch callbacks around it, recording
    per step: the rate it ran at, the fused-norm launches, the step's
    own seconds (to a synchronize) and when it began."""
    import torch

    batch = [first_batch]

    def run(state, inputs, labels):
        loop.state = state
        loop.on_batch_begin(batch[0])
        rec["lr"].append(loop.lr)
        before = _bn_counts()
        t0 = time.perf_counter()
        state, loss = step(state, inputs, labels)
        torch.cuda.synchronize()
        rec["begin"].append(t0)
        rec["step_s"].append(time.perf_counter() - t0)
        rec["per_step"].append(tuple(a - b for a, b in
                                     zip(_bn_counts(), before)))
        rec["losses"].append(loss)
        loop.on_batch_end(batch[0])
        batch[0] += 1
        return state, loss

    return run


def _new_rec():
    return dict(lr=[], begin=[], step_s=[], per_step=[], losses=[])


def phase_pipeline(resnet):
    """ResNet-50 in bench.py's configuration (batch 128 at 224², bf16
    over fp32 masters, space-to-depth stem, SGD 0.1/0.9) with
    ``remat=True``, fed by the port's data pipeline:
    ``write_npy_shards`` writes PIPE_BATCHES batches of seeded uint8
    images into a temporary directory, ``make_loader("npy")`` reads them
    (uint8 normalized to fp32 on the worker pool, cast to bf16 on the
    host, staged PIPE_DEPTH ahead on a side stream), and
    ``training.fit_epoch`` runs the epoch with a crash-atomic checkpoint
    every PIPE_CKPT_EVERY steps (a ring of PIPE_KEEP) and a
    ``LearningRateWarmupCallback`` on a ``TrainLoop`` around the step.

    The images are seeded noise plus a color per label, over
    PIPE_CLASSES of the 1000 classes.  Asserts: every loss finite and
    the last four below the first four (each step sees a fresh batch);
    105 launches
    of the stats and apply kernels a step (53 sites, 52 of them again in
    the backward's recompute of the 16 blocks) and 53 of the backward
    ones; the ring holds PIPE_KEEP entries; each step's rate is the
    warmup's.  Prints images/s (steady steps from one batch's start to
    the next's, the loader's wait and the checkpoint writes included;
    beside the resnet phase's device-resident figure), the loader's host
    wait a step, the busy share over profiled pipeline-fed steps, and
    the peak memory (above what was allocated before the model was
    built) and step time of remat=True against remat=False at batch 128
    on one device-resident batch.

    Then the resume check, with ``cudnn.deterministic`` on for it alone:
    an uninterrupted epoch with checkpoints, a rollback of the ring to
    step PIPE_RESUME_FROM (``discard_newer_than``), and a fresh model
    and optimizer (another seed) that ``restore_checkpoint`` the newest
    entry and run the rest of the epoch: their losses bit-identical to
    the uninterrupted run's."""
    import itertools
    import shutil
    import tempfile

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks, checkpoint, data, training

    benchmark = torch.backends.cudnn.benchmark
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark = True
    hvd.init()
    assert hvd.size() == 1 and hvd.device().type == "cuda"
    tmp = tempfile.mkdtemp(prefix="hvd_pipeline_")
    try:
        rs = np.random.RandomState(SEED)
        n = PIPE_BATCHES * RESNET_B
        t0 = time.perf_counter()
        # seeded noise plus a color per label (PIPE_CLASSES of the 1000
        # classes), so one epoch of fresh batches has something to learn
        labels = rs.randint(0, PIPE_CLASSES, (n,)).astype(np.int32)
        colors = rs.randint(0, 128, (PIPE_CLASSES, 3)).astype(np.uint8)
        images = rs.randint(0, 128, (n, RESNET_HW, RESNET_HW, 3),
                            dtype=np.uint8)
        images += colors[labels][:, None, None, :]
        data.write_npy_shards(os.path.join(tmp, "data"), images, labels,
                              num_shards=4)
        write_s = time.perf_counter() - t0
        dataset_bytes = images.nbytes + labels.nbytes
        del images, labels

        def loader():
            return data.make_loader(
                "npy", os.path.join(tmp, "data"), batch_size=RESNET_B,
                image_size=RESNET_HW, seed=SEED, prefetch_depth=PIPE_DEPTH,
                cast="bfloat16")

        # peak memory and step time, remat on and off, on one
        # device-resident batch
        ld = loader()
        x0, y0 = next(iter(ld))
        ld._last.close()
        fixed = {r: _resnet_fixed(r, x0, y0) for r in (False, True)}
        del x0, y0

        # the main path: fit_epoch over the loader
        base = torch.cuda.memory_allocated()
        state, step = _resnet_state(True)
        loop = _warmup_loop(state)
        loop.on_epoch_begin(0)
        rec = _new_rec()
        ld = loader()
        ckdir = os.path.join(tmp, "ckpt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in _bn_wrappers():
            w.launches = 0
        t0 = time.perf_counter()
        state, last = training.fit_epoch(
            _looped(step, loop, 0, rec), state, ld, epoch=0,
            checkpoint_dir=ckdir, checkpoint_every=PIPE_CKPT_EVERY,
            checkpoint_keep=PIPE_KEEP)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = _bn_counts()
        pipe_peak = torch.cuda.max_memory_allocated() - base
        loop.on_epoch_end(0)
        stats = ld.stats()
        losses = [float(x) for x in rec["losses"]]
        ring = sorted(os.listdir(ckdir))
        assert state.step == PIPE_BATCHES == len(losses), (state.step,
                                                           len(losses))
        assert all(math.isfinite(x) for x in losses), losses
        # fresh batches every step: compare the first and last four
        assert sum(losses[-4:]) < sum(losses[:4]), (
            f"loss did not fall: {losses}")
        want = (2 * RESNET_SITES - 1,) * 2 + (RESNET_SITES,) * 2
        assert all(c == want for c in rec["per_step"]), (
            f"fused-norm launches per step {rec['per_step']} != {want} "
            f"(stats, apply, bwd_reduce, dx)")
        keep = [f"ckpt-{s}" for s in range(PIPE_BATCHES, 0,
                                           -PIPE_CKPT_EVERY)][:PIPE_KEEP]
        assert ring == sorted(keep), f"checkpoint ring {ring} != {keep}"
        sched = callbacks.warmup_schedule(PIPE_LR, PIPE_BATCHES, PIPE_LR0)
        # the callback's arithmetic: init + (target - init) * progress
        want_lr = [PIPE_LR0 + (PIPE_LR - PIPE_LR0) * (b / PIPE_BATCHES)
                   for b in range(PIPE_BATCHES)]
        assert rec["lr"] == want_lr, (rec["lr"], want_lr)
        assert all(abs(a - sched(b)) <= 1e-6 * PIPE_LR
                   for b, a in enumerate(rec["lr"])), rec["lr"]
        assert loop.lr == PIPE_LR
        # a cycle = one batch's start to the next's: the step, the
        # loader's wait and (on checkpoint steps) the write
        cycles = np.diff(rec["begin"])
        ckpt_steps = {s - 1 for s in range(PIPE_CKPT_EVERY, PIPE_BATCHES,
                                           PIPE_CKPT_EVERY)}
        steady = [c for i, c in enumerate(cycles)
                  if i >= 2 and i not in ckpt_steps]
        cyc_s = sum(steady) / len(steady)
        step_s = sum(rec["step_s"][2:]) / len(rec["step_s"][2:])
        # one step's end to the next's start: the loader's wait and the
        # loop's own work (steady cycles without a checkpoint write)
        gaps = [c - rec["step_s"][i] for i, c in enumerate(cycles)
                if i >= 2 and i not in ckpt_steps]
        out = dict(
            batches=PIPE_BATCHES, batch=RESNET_B, image=RESNET_HW,
            dataset_bytes=dataset_bytes, write_shards_s=write_s,
            losses=losses, lr=rec["lr"], epoch_s=epoch_s,
            cycle_s=list(cycles), cycle_s_mean_steady=cyc_s,
            images_per_s=RESNET_B / cyc_s,
            step_s_mean_steady=step_s,
            images_per_s_step_only=RESNET_B / step_s,
            host_wait_ms_per_step=stats["input_wait_ms_mean"],
            gap_ms_mean_steady=sum(gaps) / len(gaps) * 1e3,
            loader=stats, checkpoint_ring=ring,
            launches=dict(zip(("bn_stats", "bn_apply", "bn_bwd_reduce",
                               "bn_dx"), launches)),
            launches_per_step=list(rec["per_step"][0]),
            peak_mem_bytes_pipeline=pipe_peak,
            peak_mem_bytes_remat=fixed[True][0],
            peak_mem_bytes_no_remat=fixed[False][0],
            resident_step_s_remat=fixed[True][1],
            resident_step_s_no_remat=fixed[False][1],
            resident_images_per_s_remat=RESNET_B / fixed[True][1])
        if resnet:
            out["resnet_phase_images_per_s"] = resnet["images_per_s"]
        log("  pipeline: " + json.dumps(out))
        out["profile"] = profile_pipeline(step, state, loader())
        del state, step, loop

        # the resume check, deterministic cuDNN for it alone
        torch.backends.cudnn.deterministic = True
        state, step = _resnet_state(True)
        loop = _warmup_loop(state)
        loop.on_epoch_begin(0)
        full = _new_rec()
        ckdir = os.path.join(tmp, "resume")
        state, _ = training.fit_epoch(
            _looped(step, loop, 0, full), state, loader(), epoch=0,
            checkpoint_dir=ckdir, checkpoint_every=PIPE_CKPT_EVERY,
            checkpoint_keep=PIPE_KEEP)
        del state, step, loop
        checkpoint.discard_newer_than(ckdir, PIPE_RESUME_FROM)
        state, step = _resnet_state(True, seed=SEED + 1)
        state = checkpoint.restore_checkpoint(ckdir, state)
        assert state.step == PIPE_RESUME_FROM, state.step
        loop = _warmup_loop(state)
        loop.on_epoch_begin(0)
        rest = _new_rec()
        ld = loader()
        ld.set_epoch(0)
        state, _ = training.fit_epoch(
            _looped(step, loop, PIPE_RESUME_FROM, rest), state,
            itertools.islice(ld, PIPE_RESUME_FROM, None))
        ld._last.close()
        assert state.step == PIPE_BATCHES, state.step
        a = [float(x) for x in full["losses"][PIPE_RESUME_FROM:]]
        b = [float(x) for x in rest["losses"]]
        out["resume"] = dict(uninterrupted=a, resumed=b,
                             max_abs_err=max(abs(x - y)
                                             for x, y in zip(a, b)))
        log("  pipeline resume: " + json.dumps(out["resume"]))
        assert a == b, f"resumed losses {b} != uninterrupted {a}"
        assert rest["lr"] == full["lr"][PIPE_RESUME_FROM:], rest["lr"]
        del state, step, loop
    finally:
        torch.backends.cudnn.benchmark = benchmark
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
        hvd.shutdown()
        torch.cuda.empty_cache()
    return out


def profile_pipeline(step, state, loader):
    """Device busy share over PROFILE_STEPS + 1 loader-fed steps under
    torch.profiler (the loader's own threads running beside them)."""
    import itertools

    import torch
    from torch.profiler import ProfilerActivity, profile

    loader.set_epoch(1)
    batches = iter(loader)
    x, y = next(batches)  # the first batch pays the pool's start-up
    state, _ = step(state, x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x, y in itertools.islice(batches, PROFILE_STEPS + 1):
            state, _ = step(state, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    batches.close()
    rec = _device_breakdown(prof, wall, PROFILE_STEPS + 1,
                            classify=_resnet_kernel_class)
    log("  pipeline profile: " + json.dumps(rec))
    return rec


def profile_train(step, state, inputs, labels, name="training"):
    """Device busy share and device time by kernel class over
    PROFILE_STEPS more steps under torch.profiler, and the host ops
    (CUDA runtime calls included) with the most self time a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            state, loss = step(state, inputs, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = _device_breakdown(prof, wall, PROFILE_STEPS)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    rec["top_host_self_ms_per_step"] = {
        e.key[:60]: round(e.self_cpu_time_total / 1e3 / PROFILE_STEPS, 3)
        for e in host[:10]}
    log(f"  {name} profile: " + json.dumps(rec))
    return rec


def phase_training_oracle():
    """gpt_small width, 2 layers, fp32: the gradient of every parameter
    through the kernels ("flash") against the plain dense path ("dot"),
    on the same weights and batch."""
    import dataclasses

    import numpy as np
    import torch

    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import Transformer, gpt_small, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt_small(num_layers=2, dtype=torch.float32,
                    attention_impl="flash")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED + 2),
                         device="cuda")
    rs = np.random.RandomState(SEED + 2)
    toks = torch.as_tensor(rs.randint(0, cfg.vocab_size, size=(2, 513)),
                           dtype=torch.long, device="cuda")
    grads = {}
    _reset_train_counts()
    for impl in ("flash", "dot"):
        model = Transformer(dataclasses.replace(cfg, attention_impl=impl),
                            params={k: v.clone() for k, v in params.items()})
        loss = training.softmax_cross_entropy(model(toks[:, :-1]),
                                              toks[:, 1:])
        loss.backward()
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
    launches = dict(zip(TRAIN_COUNTS, _train_counts()))
    # fp32: the CUDA-core forward, dq and dkv, once per layer each
    n = cfg.num_layers
    want = dict(zip(TRAIN_COUNTS, (n, n, n) + (0, n) * 3))
    assert launches == want, f"oracle launches {launches} != {want}"
    # fp32 on both sides; the kernels sum in another order than the dense
    # einsums, so each gradient agrees to rounding, far inside 1e-4 of
    # its largest entry
    tol = 1e-4
    worst = max(float((grads["flash"][n] - g).abs().max()
                      / g.abs().max().clamp_min(1e-30))
                for n, g in grads["dot"].items())
    log(f"  training oracle: {len(grads['dot'])} parameter gradients, flash "
        f"vs dot: max |diff|/max|grad| = {worst:.3g} (tol {tol}); "
        f"launches {json.dumps(launches)}")
    assert worst <= tol, "gradients through the kernels disagree"
    torch.cuda.empty_cache()
    return dict(worst=worst, launches=launches)


# -- phase 8: ResNet-50 data-parallel training at full width ------------------

RESNET_B, RESNET_HW, RESNET_STEPS = 128, 224, 10
# bench.py:56: ResNet-50 forward ~4.09 GMACs at 224 = 8.18 GFLOP, a
# training step ~3x the forward
RESNET_TRAIN_FLOPS_PER_IMG = 3 * 2 * 4.09e9
RESNET_SITES = 53


def _bn_wrappers():
    from horovod_tpu_torch.ops import fused_norm as fn

    return (fn.bn_stats_cuda, fn.bn_apply_cuda, fn.bn_bwd_reduce_cuda,
            fn.bn_dx_cuda)


def _bn_counts():
    return tuple(w.launches for w in _bn_wrappers())


#: the fused-norm device kernels' names (csrc/fused_norm.cu)
BN_KERNEL_NAMES = ("bn_stats", "bn_reduce_partials", "bn_finalize",
                   "bn_apply_kernel", "bn_bwd_partial", "bn_dx_kernel")


def _resnet_kernel_class(name):
    n = name.lower()
    if any(s in n for s in BN_KERNEL_NAMES):
        return "bn_kernels"
    if "nccl" in n:
        return "nccl"
    if "multi_tensor" in n or "sgd" in n:
        return "optimizer_sgd"
    if any(s in n for s in ("conv", "fprop", "dgrad", "wgrad", "xmma",
                            "implicit", "cudnn", "nhwc", "winograd",
                            "im2col")):
        return "convolution"
    if any(s in n for s in ("gemm", "cutlass", "nvjet", "sm90")):
        return "gemm"
    return "other"


def phase_resnet():
    """ResNet-50 at full width and depth (``bench.py``'s configuration:
    1000 classes, bf16 compute over fp32 masters, the space-to-depth
    stem), batch 128 of 224x224x3 seeded images, SGD(0.1, momentum 0.9),
    through init() (world 1 over NCCL) -> replicate_state ->
    data_parallel_train_step, RESNET_STEPS steps on one fixed batch.
    cudnn.benchmark on, as the reference's pytorch_synthetic_benchmark
    sets it."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import ResNet50

    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    hvd.init()
    assert hvd.size() == 1 and hvd.device().type == "cuda"
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     stem="space_to_depth", device="cuda",
                     generator=torch.Generator("cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    state = training.replicate_state(training.create_train_state(model, opt))
    step = training.data_parallel_train_step(model, opt)
    rs = np.random.RandomState(SEED)
    images = torch.as_tensor(
        rs.randn(RESNET_B, RESNET_HW, RESNET_HW, 3).astype(np.float32),
        device="cuda")
    labels = torch.as_tensor(rs.randint(0, 1000, size=(RESNET_B,)),
                             dtype=torch.long, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in _bn_wrappers():
        w.launches = 0
    losses, per_step, times = [], [], []
    for _ in range(RESNET_STEPS):
        before = _bn_counts()
        t0 = time.perf_counter()
        state, loss = step(state, images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        per_step.append(tuple(a - b for a, b in zip(_bn_counts(), before)))
    launches = _bn_counts()
    losses = [float(x) for x in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert all(math.isfinite(x) for x in losses), f"loss not finite: {losses}"
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    want = (RESNET_SITES,) * 4
    assert all(c == want for c in per_step), (
        f"fused-norm launches per step {per_step} != {want} (stats, apply, "
        f"bwd_reduce, dx)")
    assert state.step == RESNET_STEPS
    steady = times[2:]  # the first steps pay cuDNN's algorithm search
    step_s = sum(steady) / len(steady)
    mfu = RESNET_TRAIN_FLOPS_PER_IMG * RESNET_B / step_s \
        / PEAK_FLOPS["bfloat16"]
    rec = dict(params=n_params, batch=RESNET_B, image=RESNET_HW,
               steps=RESNET_STEPS, losses=losses, step_s=times,
               step_s_mean_steady=step_s, images_per_s=RESNET_B / step_s,
               mfu=mfu, launches=dict(zip(("bn_stats", "bn_apply",
                                           "bn_bwd_reduce", "bn_dx"),
                                          launches)),
               launches_per_step=list(per_step[0]), peak_mem_gb=peak_gb)
    log("  resnet: " + json.dumps(rec))
    rec["profile"] = profile_resnet(step, state, images, labels)
    hvd.shutdown()
    torch.backends.cudnn.benchmark = benchmark
    del state, step, model, opt
    torch.cuda.empty_cache()
    return rec


def profile_resnet(step, state, images, labels):
    """Device busy share, device time and kernels by kernel class
    (convolutions, the fused-norm kernels, other elementwise, SGD) over
    PROFILE_STEPS more steps under torch.profiler, after one warm-up
    step traced and discarded (the profiler's documented warm-up: two
    default runs on an H100 saw the window two fused-norm kernels short
    while the wrappers counted every launch); the fused-norm kernels must
    be 5 a site, each kind's count in the record."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=PROFILE_STEPS,
                                   repeat=1)) as prof:
        state, loss = step(state, images, labels)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(PROFILE_STEPS):
            state, loss = step(state, images, labels)
            if i == PROFILE_STEPS - 1:
                torch.cuda.synchronize()  # the window closes at step()
            prof.step()
        wall = time.perf_counter() - t0
    rec = _device_breakdown(prof, wall, PROFILE_STEPS,
                            classify=_resnet_kernel_class)
    rec["bn_kernels_by_name"] = dict(collections.Counter(
        s for e in prof.events() if e.device_type == DeviceType.CUDA
        for s in BN_KERNEL_NAMES if s in e.name.lower()))
    # a site runs stats 1, apply 1, backward reduce 2 and dx 1 kernels
    bn = rec["kernels_per_step_by_class"].get("bn_kernels")
    assert bn is None or bn == 5 * RESNET_SITES, (
        f"{bn} fused-norm device kernels a step, not {5 * RESNET_SITES}: "
        f"{rec['bn_kernels_by_name']}")
    host = sorted(((a.key, a.self_cpu_time_total / 1e3, a.count)
                   for a in prof.key_averages()
                   if a.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])[:12]
    rec["top_host_self_ms_calls"] = {k: [round(ms, 3), n]
                                     for k, ms, n in host}
    log("  resnet profile: " + json.dumps(rec))
    return rec


def phase_resnet_oracle():
    """ResNet-50 at full width with the stage depths cut to [1, 1, 1, 1]
    (17 norm sites), batch 4 of 64x64, fp32, TF32 off for cuDNN and
    matmuls, deterministic cuDNN algorithms: every parameter's gradient
    and every updated running statistic of one training forward and
    backward, three ways on the same weights — on the card through the
    kernels, on the card through the plain versions (the op's
    ``impl="reference"``; the same convolutions), and on the CPU (the
    plain versions).  Each norm's scale, bias and running statistics are
    drawn at random first (a block's last norm starts at scale 0, which
    would zero its branch's gradients).

    The gradients are compared by their relative L2 error per
    parameter, not entry by entry: a ReLU or max-pool decision on a
    value within rounding of its threshold goes one way on one side and
    the other way on the other, and moves that one entry's gradient by
    O(1) — on the CPU alone, a 1e-6 relative perturbation of the input
    moved one gradient by 1.8 % of its largest entry and 0.6 % in L2.
    A wrong kernel or a wrong layout moves every gradient by O(1)."""
    import functools

    import numpy as np
    import torch

    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.models import resnet as rn
    from horovod_tpu_torch.models.resnet import BatchNorm
    from horovod_tpu_torch.ops import fused_norm as fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    kw = dict(stage_sizes=[1, 1, 1, 1], num_classes=1000,
              dtype=torch.float32, stem="space_to_depth")
    cpu = ResNet50(device="cpu", generator=torch.Generator().manual_seed(
        SEED + 3), **kw)
    g = torch.Generator().manual_seed(SEED + 4)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, BatchNorm):
                c = m.scale.numel()
                m.scale.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.mean.copy_(0.1 * torch.randn(c, generator=g))
                m.var.copy_(1 + 0.1 * torch.rand(c, generator=g))
    init = {k: v.clone() for k, v in cpu.state_dict().items()}
    rs = np.random.RandomState(SEED + 3)
    x = torch.from_numpy(rs.randn(4, 64, 64, 3).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, 1000, size=(4,))).long()

    def train_once(model, dev):
        loss = training.softmax_cross_entropy(model(x.to(dev)),
                                              labels.to(dev))
        loss.backward()
        return (float(loss.detach()),
                {n: p.grad.detach().cpu() for n, p in
                 model.named_parameters()},
                {n: b.detach().cpu() for n, b in model.named_buffers()})

    runs = {"cpu": train_once(cpu, "cpu")}
    card = ResNet50(device="cuda", **kw)
    card.load_state_dict(init)
    before = _bn_counts()
    runs["card"] = train_once(card, "cuda")
    sites = len(cpu.bn_sites(4, 64, 64))
    launched = tuple(a - b for a, b in zip(_bn_counts(), before))
    assert launched == (sites,) * 4, (launched, sites)
    plain = ResNet50(device="cuda", **kw)
    plain.load_state_dict(init)
    op = rn.fused_batch_norm_act
    rn.fused_batch_norm_act = functools.partial(op, impl="reference")
    try:
        runs["card_plain"] = train_once(plain, "cuda")
    finally:
        rn.fused_batch_norm_act = op
    torch.backends.cudnn.deterministic = deterministic
    assert _bn_counts() == tuple(a + sites for a in before)

    def compare(a, b):
        (la, ga, sa), (lb, gb, sb) = runs[a], runs[b]
        l2 = {n: float((ga[n] - t).norm() / t.norm().clamp_min(1e-30))
              for n, t in gb.items()}
        return dict(
            loss_rel=abs(la - lb) / abs(lb),
            grad_l2=max(l2.values()), worst=max(l2, key=l2.get),
            grad_max=max(float((ga[n] - t).abs().max()
                               / t.abs().max().clamp_min(1e-30))
                         for n, t in gb.items()),
            stat=max(float((sa[n] - t).abs().max()
                           / t.abs().max().clamp_min(1e-30))
                     for n, t in sb.items()))

    # the kernels against the plain versions on the card (the same
    # convolutions; the BN arithmetic rounds differently): gradients
    # within 1e-2 in L2 (a single flipped ReLU decision moves one by
    # ~0.6 %), running statistics within 1e-5 of each buffer's largest
    # value; the card against the CPU (cuDNN's convolutions against the
    # CPU's as well, so more decisions flip): gradients within 1e-1 in
    # L2, statistics within 1e-4, the loss within 1e-5
    tol = {"kernels_vs_card_plain": dict(grad_l2=1e-2, stat=1e-5),
           "card_vs_cpu": dict(grad_l2=1e-1, stat=1e-4, loss_rel=1e-5)}
    rec = dict(norm_sites=sites, parameters=len(runs["cpu"][1]),
               losses={k: v[0] for k, v in runs.items()}, tf32=False,
               tolerances=tol,
               kernels_vs_card_plain=compare("card", "card_plain"),
               card_vs_cpu=compare("card", "cpu"))
    log("  resnet oracle: " + json.dumps(rec))
    bad = [f"{pair}.{key}" for pair, bounds in tol.items()
           for key, bound in bounds.items()
           if not rec[pair][key] <= bound]
    assert not bad, f"gradients or running statistics disagree: {bad}"
    del card, plain
    torch.cuda.empty_cache()
    return rec


#: one rank of the dp4 phase: gpt_small data-parallel training over
#: NCCL (gloo with device "cpu"), each rank on its own seeded batch,
#: through whichever of the plain, overlapped and ZeRO steps the
#: imported package has; then (where the package has the rank-ordered
#: sum) the gradients' allreduce through ``allreduce_gradients`` against
#: NCCL's own allreduce of the same fused buffers, in turns.  Writes
#: JSON to OUT.
DP4_WORKER = r"""
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import Transformer, init_params
from horovod_tpu_torch.models import transformer as tm
from horovod_tpu_torch.ops import collective_ops
from horovod_tpu_torch.ops.fusion import FusionPlan, fuse, fusion_threshold
try:  # the observability layer, where the package root has it
    from horovod_tpu_torch.metrics import aggregate as _agg
    from horovod_tpu_torch.ops import comm_model as _cm, overlap as _ov
    observe = hasattr(_ov, "measured_overlap_exposed")
except ImportError:
    observe = False

(rank, world, store, out, device, preset, b, s, steps, seed,
 reps) = sys.argv[1:12]
rank, world, b, s, steps, seed, reps = map(int, (rank, world, b, s, steps,
                                                 seed, reps))
cpu = device == "cpu"
if cpu:
    torch.set_num_threads(1)
hvd.init(device="cpu" if cpu else None, rank=rank, size=world,
         init_method="file://" + store)
dev = hvd.device()
cfg = getattr(tm, preset)(dtype=torch.float32 if cpu else torch.bfloat16,
                          attention_impl="flash")
toks = torch.as_tensor(np.random.RandomState(seed + rank).randint(
    0, cfg.vocab_size, size=(b, s + 1)), dtype=torch.long, device=dev)
x, y = toks[:, :-1], toks[:, 1:]


def sync():
    if not cpu:
        torch.cuda.synchronize()


def model():
    return Transformer(cfg, params=init_params(
        cfg, torch.Generator(dev.type).manual_seed(seed), device=dev,
        param_dtype=torch.float32))


def adamw(ps):
    return torch.optim.AdamW(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


res = {"variants": {}}
variants = ["plain"] + (["overlap", "zero"] if hasattr(
    training, "zero_train_setup") else [])
for tag in variants:
    m = model()
    if tag == "zero":
        state, step = training.zero_train_setup(m, adamw(m.parameters()))
    else:
        opt = adamw(m.parameters())
        state = training.create_train_state(m, opt)
        step = (training.data_parallel_train_step(m, opt, overlap=True)
                if tag == "overlap" else
                training.data_parallel_train_step(m, opt))
    losses, times = [], []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        state, loss = step(state, x, y)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    res["variants"][tag] = dict(losses=losses, step_s=times)
    if tag == "overlap" and observe:
        # one more overlapped step under the profiler: the buckets'
        # bridge ranges and the NCCL kernels' exposed share
        from torch.profiler import ProfilerActivity, profile

        sync()
        with profile(activities=[ProfilerActivity.CPU] + (
                [] if cpu else [ProfilerActivity.CUDA])) as prof:
            state, loss = step(state, x, y)
            sync()
        names = [e.name for e in prof.events()]
        inv = _cm.overlap_inventory(step.reducer.last_record)
        res["observe"] = dict(
            measured_exposed=_ov.measured_overlap_exposed(prof),
            buckets=step.reducer.schedule.num_buckets,
            bucket_ranges=sum(n.startswith("hvd_tpu::bucket.")
                              and n.endswith("::COMM") for n in names),
            inventory={k: v for k, v in inv.items() if k != "collectives"})
    res["grad_bytes"] = sum(p.numel() * 4 for p in m.parameters())
    shapes = [p.shape for p in m.parameters()]
    del state, step, m
    if not cpu:
        torch.cuda.empty_cache()

if hasattr(collective_ops, "_sum_async"):
    g = torch.Generator(dev.type).manual_seed(seed + rank)
    grads = [torch.randn(sh, generator=g, device=dev) for sh in shapes]

    def library():
        # NCCL's (gloo's) own allreduce of the fused buffers, then the
        # division: what the step ran before the rank-ordered sum
        plan = FusionPlan(grads, fusion_threshold())
        bufs = fuse(grads, plan)
        for w in [dist.all_reduce(t, async_op=True) for t in bufs]:
            w.wait()
        return [t / world for t in bufs]

    def port():
        # the rank-ordered sum of the gradient reductions
        return hvd.allreduce_gradients(grads, op=hvd.Average)

    timing = {"library": [], "port": []}
    for i in range(2 * reps):
        name = ("library", "port", "port", "library")[i % 4]
        sync()
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        fn = library if name == "library" else port
        fn()
        sync()
        timing[name].append(time.perf_counter() - t0)
    res["allreduce_s"] = timing
if observe:
    snap = _agg.cluster_snapshot()
    res["cluster"] = dict(
        ranks=snap["ranks"],
        merged=snap["metrics"]["hvd_tpu_collectives_total"]["series"],
        per_rank=[p["metrics"]["hvd_tpu_collectives_total"]["series"]
                  for p in snap["per_rank"]])
with open(out, "w") as f:
    json.dump(res, f)
hvd.shutdown()
"""


def _spawn_dp4(root, device, preset, b, s, steps, reps, world=4,
               timeout=900):
    """Run DP4_WORKER as ``world`` ranks with ``root``'s package; each
    rank's JSON, in rank order."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        env = dict(os.environ, PYTHONPATH=root)
        procs = [subprocess.Popen(
            [sys.executable, "-c", DP4_WORKER, str(r), str(world),
             os.path.join(tmp, "store"), outs[r], device, preset, str(b),
             str(s), str(steps), str(SEED), str(reps)], cwd=root, env=env)
            for r in range(world)]
        try:
            rcs = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert rcs == [0] * world, f"dp4 ranks exited {rcs} ({root})"
        recs = []
        for o in outs:
            with open(o) as f:
                recs.append(json.load(f))
        return recs


def _steady(times):
    steady = times[1:]
    return (sum(steady) / len(steady), sorted(steady)[len(steady) // 2])


def phase_dp4(roots, device="cuda", preset="gpt_small", b=TRAIN_B,
              s=TRAIN_S, steps=TRAIN_STEPS, reps=4):
    """gpt_small data-parallel training on four cards over NCCL, each
    rank on its own seeded B x S batch, once for each package root in
    ``roots`` (in that order: e.g. parent, change, change, parent):
    the plain step, and where the package has them the overlapped and
    ZeRO steps, 10 steps each; step time (rank 0's steady mean and
    median, and the slowest rank's mean) and tokens/s of the global
    batch.  Every rank's losses must be equal; the overlapped step's
    losses bit-identical to the plain step's, ZeRO's within
    ZERO_LOSS_REL_TOL.  Where the package has the rank-ordered sum, the
    gradients' allreduce (fp32, gpt_small's parameter shapes) through
    ``allreduce_gradients`` is timed against NCCL's allreduce of the
    same fused buffers, in turns."""
    world = 4
    if device == "cuda":
        import torch

        assert torch.cuda.device_count() >= world, (
            f"dp4 needs {world} cards, found {torch.cuda.device_count()}")
    runs = []
    for root in roots:
        root = os.path.abspath(root)
        if device == "cuda":
            subprocess.run([sys.executable, "-c",
                            "from horovod_tpu_torch.ops import _build; "
                            "_build.build_all()"], cwd=root, check=True,
                           env=dict(os.environ, PYTHONPATH=root))
        recs = _spawn_dp4(root, device, preset, b, s, steps, reps, world)
        run = dict(root=root, variants={})
        for tag, v in recs[0]["variants"].items():
            for r in recs[1:]:
                assert r["variants"][tag]["losses"] == v["losses"], (
                    f"{tag}: ranks disagree on the losses")
            assert all(math.isfinite(x) for x in v["losses"]), v["losses"]
            mean, median = _steady(v["step_s"])
            slowest = max(_steady(r["variants"][tag]["step_s"])[0]
                          for r in recs)
            run["variants"][tag] = dict(
                losses=v["losses"], step_ms_mean=mean * 1e3,
                step_ms_median=median * 1e3, slowest_rank_ms_mean=slowest
                * 1e3, tokens_per_s=world * b * s / mean)
        var = run["variants"]
        if "overlap" in var:
            assert var["overlap"]["losses"] == var["plain"]["losses"], (
                var["overlap"]["losses"], var["plain"]["losses"])
        if "zero" in var:
            errs = [abs(a - c) / abs(c) for a, c in
                    zip(var["zero"]["losses"], var["plain"]["losses"])]
            assert max(errs) <= ZERO_LOSS_REL_TOL, errs
            var["zero"]["loss_rel_err_vs_plain"] = max(errs)
        if "cluster" in recs[0]:
            # cluster_snapshot at world 4: every rank holds the same
            # merge, each counter the sum of the ranks' own
            c = recs[0]["cluster"]
            assert c["ranks"] == world and len(c["per_rank"]) == world
            assert all(r["cluster"]["merged"] == c["merged"] for r in recs)
            sums = {}
            for series in c["per_rank"]:
                for k, v in series:
                    sums[tuple(k)] = sums.get(tuple(k), 0.0) + v
            assert {tuple(k): v for k, v in c["merged"]} == sums, c
            run["cluster_collectives"] = {"/".join(k): v
                                          for k, v in c["merged"]}
        if "observe" in recs[0]:
            for r in recs:
                o = r["observe"]
                assert o["bucket_ranges"] == o["buckets"], o
                if device == "cuda":
                    assert 0.0 <= o["measured_exposed"] <= 1.0, o
            run["overlap_observe"] = [r["observe"] for r in recs]
        if "allreduce_s" in recs[0]:
            run["allreduce_ms_median"] = {
                k: sorted(t)[len(t) // 2] * 1e3
                for k, t in recs[0]["allreduce_s"].items()}
            run["grad_bytes"] = recs[0]["grad_bytes"]
        log("  dp4: " + json.dumps(run))
        runs.append(run)
    return runs


# -- phase 15: the ring schedule on one card (B9 on its main path) ------------

RING_N, RING_S = 4, 2048  # four ranks of 2048 tokens: a global 8192
# (name, B, H, H_kv, D): gpt_small's attention (B=8 as its training
# batch) and llama3_8b's (GQA 32/8 at D=128)
RING_WIDTHS = (("gpt_small", 8, 12, 12, 64), ("llama3_8b", 1, 32, 8, 128))
RING_MASKS = (("causal", True, None), ("bidirectional", False, None),
              ("causal_window256", True, 256))
# the n-step schedule against one flash_attention over the whole
# sequence: the absolute error within TOL x max(1, largest |output|) in
# bf16 and 1e-4 x that in fp32; fp32 rows within TRAIN_ROW_TOL.  A bf16
# ring rounds each of its blocks' outputs and gradients to bf16 before
# it sums them in fp32 (as the reference's does), where one call rounds
# once, so a row whose blocks cancel can move by more than 1e-2 of
# itself (1.4e-2 on an H100): bf16 rows are instead held, as
# FlashAttention's own tests hold a kernel, against the fp32 result (one
# fp32 flash_attention over the same bf16-valued inputs): the ring's largest
# error there within the single bf16 call's times the ring's steps (the
# bf16 results it composes; a lost or misplaced block is off by O(1)).
RING_TOL = {"bfloat16": TOL["bfloat16"], "float32": 1e-4}


def ring_blocks(n, s, causal, window):
    """(diagonal, off-diagonal) blocks the flash ring of n ranks runs
    through the kernels, forward and backward alike: every rank's
    diagonal, and each later step's block unless a causal ring skips it
    (a future block, ``src > idx``)."""
    from horovod_tpu_torch.parallel.ring_attention import ring_window_steps

    steps = ring_window_steps(n, s, causal=causal, window=window)
    off = sum(1 for idx in range(n) for t in range(1, steps)
              if not (causal and (idx - t) % n > idx))
    return n, off


def _ring_inputs(b, s, h, h_kv, d, dtype, device="cuda", seed=SEED):
    """The global (q, k, v, dO) of one ring case, from a seeded generator
    on ``device`` (the same on every card)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=device).to(dtype)
                 for shape in ((b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d),
                               (b, s, h, d)))


def _shards(t, n):
    s = t.shape[1] // n
    return [t[:, i * s:(i + 1) * s].contiguous() for i in range(n)]


def run_ring_case(width, b, h, h_kv, d, mask_name, causal, window,
                  dtype_name):
    """The flash ring of RING_N ranks replayed on this card through the
    package's per-step functions (``replay_ring_flash``: the ring's own
    order, each rank's bits), against one ``flash_attention`` over the
    whole sequence (RING_TOL; bf16 also against the fp32 result):
    outputs and (dq, dk, dv); the exact launches of each kernel and
    variant (``ring_blocks``); the schedule's time beside the single
    call's (forward + backward each)."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.ring_attention import (
        replay_ring_flash, ring_window_steps)

    dtype = getattr(torch, dtype_name)
    n = RING_N
    q, k, v, do = _ring_inputs(b, n * RING_S, h, h_kv, d, dtype)
    qs, ks, vs, gs = (_shards(t, n) for t in (q, k, v, do))
    torch.cuda.synchronize()
    _reset_train_counts()
    outs, dqs, dks, dvs = replay_ring_flash(qs, ks, vs, gs, causal, window)
    torch.cuda.synchronize()
    counts = dict(zip(TRAIN_COUNTS, _train_counts()))
    offsets = _offset_counts()
    diag, off = ring_blocks(n, RING_S, causal, window)
    steps = ring_window_steps(n, RING_S, causal=causal, window=window)
    want = "sm90" if dtype == torch.bfloat16 else "simt"
    other = "simt" if want == "sm90" else "sm90"
    want_counts = {}
    for kern in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        want_counts.update({kern: diag + off, f"{kern}_{want}": diag + off,
                            f"{kern}_{other}": 0})
    want_offsets = tuple(off if v == want else 0
                         for _ in range(3) for v in ("sm90", "simt"))
    counts_ok = counts == want_counts and offsets == want_offsets
    qf, kf, vf = (x.detach().clone().requires_grad_() for x in (q, k, v))
    single = lambda: torch.autograd.grad(  # noqa: E731
        fa.flash_attention(qf, kf, vf, causal, window), (qf, kf, vf), do)
    of = fa.flash_attention(qf, kf, vf, causal, window)
    gq, gk, gv = torch.autograd.grad(of, (qf, kf, vf), do)
    ring = {key: torch.cat(got, dim=1) for key, got in (
        ("o", outs), ("dq", dqs), ("dk", dks), ("dv", dvs))}
    single_out = dict(o=of.detach(), dq=gq, dk=gk, dv=gv)
    errs = {key: _errors(ring[key], single_out[key]) for key in ring}
    ok = counts_ok and all(math.isfinite(a) and a <= RING_TOL[dtype_name]
                           * top for a, _r, top in errs.values())
    vs_fp32 = None
    if dtype == torch.bfloat16:
        # both bf16 results against the fp32 one
        q32, k32, v32 = (x.detach().float().requires_grad_()
                         for x in (q, k, v))
        o32 = fa.flash_attention(q32, k32, v32, causal, window)
        exact = dict(zip(("o", "dq", "dk", "dv"), (o32.detach(), *(
            torch.autograd.grad(o32, (q32, k32, v32), do.float())))))
        del o32, q32, k32, v32
        vs_fp32 = {key: dict(
            ring=float((ring[key].float() - exact[key]).abs().max()),
            single=float((single_out[key].float() - exact[key]).abs().max()))
            for key in ring}
        del exact
        ok = ok and all(e["ring"] <= steps * e["single"]
                        for e in vs_fp32.values())
    else:
        ok = ok and all(math.isfinite(r) and r <= TRAIN_ROW_TOL[dtype_name]
                        for _a, r, _top in errs.values())
    del of, gq, gk, gv, single_out
    rec = dict(case=f"{width}_{mask_name}", n=n, s_local=RING_S,
               shape=[b, n * RING_S, h, h_kv, d], dtype=dtype_name, ok=ok,
               blocks=dict(diagonal=diag, off_diagonal=off), variant=want,
               launches=counts, offset_launches=dict(zip(
                   ("fwd_sm90", "fwd_simt", "dq_sm90", "dq_simt",
                    "dkv_sm90", "dkv_simt"), offsets)),
               tol=RING_TOL[dtype_name], row_tol=TRAIN_ROW_TOL[dtype_name],
               errors={key: dict(abs=a, row=r, abs_bound=RING_TOL[dtype_name]
                                 * top) for key, (a, r, top) in errs.items()},
               max_abs_err_vs_fp32=vs_fp32,
               schedule_ms=cuda_ms(lambda: replay_ring_flash(
                   qs, ks, vs, gs, causal, window), reps=3, warmup=1),
               single_ms=cuda_ms(single, reps=3, warmup=1))
    log("  " + json.dumps(rec))
    return rec


def phase_ring():
    """The flash ring's schedule at RING_N ranks of RING_S tokens in one
    process (``run_ring_case``): both attention widths, causal,
    bidirectional and a causal window of 256, bf16 and fp32.  The
    launches are counted from 0 around each replay: the offset form's
    path in the one-card run."""
    import torch

    recs = []
    for width, b, h, h_kv, d in RING_WIDTHS:
        for mask_name, causal, window in RING_MASKS:
            for dtype_name in ("bfloat16", "float32"):
                recs.append(run_ring_case(width, b, h, h_kv, d, mask_name,
                                          causal, window, dtype_name))
                torch.cuda.empty_cache()
    bad = [f"{r['case']}/{r['dtype']}" for r in recs if not r["ok"]]
    if bad:
        raise AssertionError(f"ring schedule disagrees with one flash "
                             f"attention (or launched otherwise): {bad}")
    return recs


#: one rank of the ring4 phase (four cards over NCCL; gloo on the CPU):
#: ``ring_flash_attention`` on the ring phase's cases, each rank's output
#: and gradients against the replay of the same ring on its own card;
#: then gpt_small with ``attention_impl="ring_flash"`` through init(),
#: replicate_state and data_parallel_train_step, each rank on its shard
#: of one seeded batch.  Writes JSON to OUT.
RING4_WORKER = r"""
import json, sys, time
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import Transformer, init_params
from horovod_tpu_torch.models import transformer as tm
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel.ring_attention import (
    replay_ring_flash, ring_flash_attention)
import chip_smoke as cs

(rank, world, store, out, device, preset, b, s_local, steps, seed,
 attn) = sys.argv[1:12]
rank, world, b, s_local, steps, seed = map(int, (rank, world, b, s_local,
                                                 steps, seed))
cpu = device == "cpu"
if cpu:
    torch.set_num_threads(1)
hvd.init(device="cpu" if cpu else None, rank=rank, size=world,
         init_method="file://" + store)
dev = hvd.device()
wrappers = (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)


def sync():
    if not cpu:
        torch.cuda.synchronize()


def counts():
    return [n for fn in wrappers for n in (
        fn.launches, fn.offset_sm90_launches, fn.offset_simt_launches)]


res = {"attention": []}
widths = cs.RING_WIDTHS if attn == "full" else (("tiny", 2, 4, 2, 16),)
for width, bb, h, h_kv, d in widths:
    for mask_name, causal, window in cs.RING_MASKS:
        for dtype in (torch.bfloat16, torch.float32) if not cpu else \
                (torch.float32,):
            win = window if attn == "full" or window is None else 3
            q, k, v, do = cs._ring_inputs(bb, world * s_local, h, h_kv, d,
                                          dtype, device=dev, seed=seed)
            qs, ks, vs, gs = (cs._shards(t, world) for t in (q, k, v, do))
            qq, kk, vv = (x[rank].clone().requires_grad_()
                          for x in (qs, ks, vs))
            o = ring_flash_attention(qq, kk, vv, causal=causal, window=win)
            o.backward(gs[rank])
            rep = replay_ring_flash(qs, ks, vs, gs, causal, win)
            got = (o, qq.grad, kk.grad, vv.grad)
            res["attention"].append(dict(
                case=f"{width}_{mask_name}", dtype=str(dtype).split(".")[-1],
                bit_equal=[bool(torch.equal(x, r[rank]))
                           for x, r in zip(got, rep)]))
            del q, k, v, do, qs, ks, vs, gs, rep, got, o
            if not cpu:
                torch.cuda.empty_cache()

cfg = getattr(tm, preset)(
    dtype=torch.float32 if cpu else torch.bfloat16,
    attention_impl="ring_flash", seq_axis_name="seq")
model = Transformer(cfg, params=init_params(
    cfg, torch.Generator(dev.type).manual_seed(seed), device=dev,
    param_dtype=torch.float32))
n_params = sum(p.numel() for p in model.parameters())
toks = torch.as_tensor(np.random.RandomState(seed).randint(
    0, cfg.vocab_size, size=(b, world * s_local + 1)), dtype=torch.long,
    device=dev)
cut = slice(rank * s_local, (rank + 1) * s_local)
x, y = toks[:, :-1][:, cut], toks[:, 1:][:, cut]
opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                        eps=1e-8, weight_decay=1e-4)
state = training.replicate_state(training.create_train_state(model, opt))
step = training.data_parallel_train_step(model, opt)
if not cpu:
    torch.cuda.reset_peak_memory_stats()
fa._zero_counts(*wrappers)
losses, times, per_step = [], [], []
for _ in range(steps):
    before = counts()
    sync()
    t0 = time.perf_counter()
    state, loss = step(state, x, y)
    sync()
    times.append(time.perf_counter() - t0)
    losses.append(float(loss))
    per_step.append([a - c for a, c in zip(counts(), before)])
res["train"] = dict(
    losses=losses, step_s=times, per_step=per_step, params=n_params,
    layers=cfg.num_layers, peak_mem_gb=None if cpu else
    torch.cuda.max_memory_allocated() / 1e9)
with open(out, "w") as f:
    json.dump(res, f)
hvd.shutdown()
"""


def phase_ring4(device="cuda", preset="gpt_small", b=TRAIN_B, s_local=RING_S,
                steps=TRAIN_STEPS, attn="full", timeout=900):
    """Ring attention across four cards over NCCL (RING4_WORKER): every
    rank's ``ring_flash_attention`` output and gradients bit-equal to the
    replay of the same ring (``run_ring_case``'s cases); then gpt_small
    at full width and depth, B=8 x a global 8192 cut into four 2048-token
    shards, bf16 over fp32 masters, AdamW, TRAIN_STEPS steps on one
    seeded batch with ``attention_impl="ring_flash"``: every loss equal
    on every rank, finite, the last below the first; each rank's B9 and
    diagonal launches a step exactly those of its place on the ring;
    tokens/s of the global batch, step time, peak memory."""
    import tempfile

    world = 4
    if device == "cuda":
        import torch

        assert torch.cuda.device_count() >= world, (
            f"ring4 needs {world} cards, found {torch.cuda.device_count()}")
        from horovod_tpu_torch.ops import _build

        _build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        env = dict(os.environ, PYTHONPATH=HERE)
        procs = [subprocess.Popen(
            [sys.executable, "-c", RING4_WORKER, str(r), str(world),
             os.path.join(tmp, "store"), outs[r], device, preset, str(b),
             str(s_local), str(steps), str(SEED), attn], cwd=HERE, env=env)
            for r in range(world)]
        try:
            rcs = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert rcs == [0] * world, f"ring4 ranks exited {rcs}"
        recs = []
        for o in outs:
            with open(o) as f:
                recs.append(json.load(f))
    unequal = [(r, a["case"], a["dtype"]) for r, rec in enumerate(recs)
               for a in rec["attention"] if not all(a["bit_equal"])]
    assert not unequal, f"ring ranks differ from the replay: {unequal}"
    losses = recs[0]["train"]["losses"]
    for rec in recs[1:]:
        assert rec["train"]["losses"] == losses, "ranks disagree on losses"
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    n_layers = recs[0]["train"]["layers"]
    for idx, rec in enumerate(recs):
        # per (fwd, dq, dkv): launches, offset sm90, offset simt; rank idx
        # runs its diagonal and idx past blocks a layer (causal)
        want = ([n_layers * (idx + 1), n_layers * idx, 0] if device == "cuda"
                else [0, 0, 0]) * 3
        assert all(c == want for c in rec["train"]["per_step"]), (
            f"rank {idx} launches a step {rec['train']['per_step'][0]} != "
            f"{want}")
    mean, median = _steady(recs[0]["train"]["step_s"])
    slowest = max(_steady(r["train"]["step_s"])[0] for r in recs)
    tokens = b * world * s_local
    rec = dict(world=world, batch=[b, world * s_local], s_local=s_local,
               params=recs[0]["train"]["params"], losses=losses,
               attention_cases=len(recs[0]["attention"]),
               step_ms_mean=mean * 1e3, step_ms_median=median * 1e3,
               slowest_rank_ms_mean=slowest * 1e3,
               tokens_per_s=tokens / mean,
               peak_mem_gb=[r["train"]["peak_mem_gb"] for r in recs],
               launches_per_step=[r["train"]["per_step"][0] for r in recs],
               offset_launches={k: sum(r["train"]["per_step"][i][j]
                                       for r in recs
                                       for i in range(len(r["train"]
                                                          ["per_step"])))
                                for k, j in (("fwd_sm90", 1), ("fwd_simt", 2),
                                             ("dq_sm90", 4), ("dq_simt", 5),
                                             ("dkv_sm90", 7),
                                             ("dkv_simt", 8))})
    log("  ring4: " + json.dumps(rec))
    return rec


# -- phase 17: the integrity guard on gpt_small (one card) --------------------

GUARD_STEPS = 10
#: steps after which the guarded run's diag digest is held against the
#: host digest of the post-reduction gradients
GUARD_DIGEST_STEPS = (3, 7)
#: the guarded run's cadence (checks at 5 and 10: the cadence check's
#: host sync and param fingerprint are inside the timed steps)
GUARD_CADENCE = 5
#: the rollback run: cadence 2, checkpoints after steps 5-7, a parameter
#: set to inf before step 7, the check at step 8 trips
GUARD_TRIP_STEP = 7
GUARD_ROLLBACK_CADENCE = 2


def _train_model(device="cuda", preset="gpt_small", b=TRAIN_B, s=TRAIN_S):
    """``(cfg, model, inputs, labels)``: on the card the training
    phase's gpt_small (:func:`_gpt_small`); ``device="cpu"`` is the CPU
    rehearsal (``preset``'s widths, fp32, a b x s batch)."""
    if device == "cuda" and preset == "gpt_small" and (b, s) == (
            TRAIN_B, TRAIN_S):
        return _gpt_small()
    import numpy as np
    import torch

    from horovod_tpu_torch import models

    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    cfg = getattr(models, preset)(dtype=dtype, attention_impl="flash")
    model = models.Transformer(cfg, params=models.init_params(
        cfg, torch.Generator(device).manual_seed(SEED), device=device,
        param_dtype=torch.float32))
    toks = torch.as_tensor(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, size=(b, s + 1)), dtype=torch.long, device=device)
    return cfg, model, toks[:, :-1], toks[:, 1:]


def _guard_env_clear():
    """The rollback arms HVD_TPU_GUARD_* markers meant to cross an
    exec-restart; none may reach a later phase's processes."""
    for k in [k for k in os.environ if k.startswith("HVD_TPU_GUARD_")]:
        del os.environ[k]


def phase_guard(device="cuda", preset="gpt_small", b=TRAIN_B, s=TRAIN_S,
                steps=GUARD_STEPS):
    """The integrity guard on the training phase's gpt_small (B=8 x
    S=2048, bf16 over fp32 masters, AdamW, flash attention, world 1 over
    NCCL).

    * Two models from the same seed train ``steps`` steps in turns on
      the fixed batch: the unguarded ``data_parallel_train_step`` and the
      guarded one (``guard=True``) whose diagnostics feed an
      ``IntegrityGuard`` (cadence 5: its host sync, param fingerprint
      and check run inside steps 5 and 10).  Losses and parameters must
      be bit-identical; every ``finite`` true; after steps 3 and 7 the
      diag digest equals ``host_digest`` of the post-reduction gradients
      pulled to the host; 12 launches of each training kernel a step in
      both.  The step times give the guard's overhead (median of the
      steady steps, and the mean, checks included).
    * Rollback at world 1: a third model through ``fit_epoch`` with a
      guard of cadence 2 and checkpoints after steps 5, 6 and 7; the
      phase sets one parameter (``layer_0.ln1.scale[0]``) to inf before
      step 7, so the check at step 8 sees non-finite gradients: it must
      discard ``ckpt-7`` (newer than the verified step 6) and raise
      ``IntegrityError``.  ``restore_checkpoint`` then loads ``ckpt-6``
      and steps 7-10 re-run to the unguarded run's losses bit for bit."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, guard, training

    cuda = device == "cuda"
    hvd.init(None if cuda else "cpu")
    assert hvd.size() == 1

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def build(guarded):
        cfg, model, x, y = _train_model(device, preset, b, s)
        opt = _adamw(model.parameters())
        state = training.replicate_state(
            training.create_train_state(model, opt))
        step = training.data_parallel_train_step(model, opt, guard=guarded)
        return cfg, model, state, step, x, y

    _reset_train_counts()
    cfg, model_a, state_a, step_a, x, y = build(False)
    _, model_b, state_b, step_b, _, _ = build(True)
    g = guard.IntegrityGuard(enabled=True, cadence=GUARD_CADENCE, world=1)
    losses_a, losses_b, finite, per_step = [], [], [], {"plain": [],
                                                         "guarded": []}
    times = {"plain": [], "guarded": []}
    digest_checks = []
    for i in range(1, steps + 1):
        for tag in ("plain", "guarded"):
            before = _train_counts()
            sync()
            t0 = time.perf_counter()
            if tag == "plain":
                state_a, loss = step_a(state_a, x, y)
                losses_a.append(loss)
            else:
                state_b, loss, diag = step_b(state_b, x, y)
                g.on_train_step(i, loss, diag, params=model_b)
                losses_b.append(loss)
                finite.append(diag["finite"])
            sync()
            times[tag].append(time.perf_counter() - t0)
            per_step[tag].append(tuple(
                a - c for a, c in zip(_train_counts(), before)))
        if i in GUARD_DIGEST_STEPS:
            t0 = time.perf_counter()
            host = guard.host_digest([p.grad.cpu()
                                      for p in model_b.parameters()])
            dev = diag["digest"].cpu().numpy().astype(np.uint32)
            digest_checks.append(dict(step=i, device=dev.tolist(),
                                      host=host.tolist(),
                                      host_s=time.perf_counter() - t0))
            assert (dev == host).all(), (
                f"step {i}: device digest {dev} != host digest {host}")
    losses_a = [float(v) for v in losses_a]
    losses_b = [float(v) for v in losses_b]
    assert losses_a == losses_b, f"guarded losses {losses_b} != {losses_a}"
    same = all(torch.equal(pa, pb) for pa, pb in zip(model_a.parameters(),
                                                    model_b.parameters()))
    assert same, "guarded parameters differ from the unguarded run's"
    assert all(bool(f) for f in finite), "a guarded step was not finite"
    assert g.last_verified_step == steps
    if cuda:  # (the CPU rehearsal runs the kernels' plain versions)
        _check_train_run(cfg, losses_a, per_step["plain"])
        _check_train_run(cfg, losses_b, per_step["guarded"])
    med = {k: sorted(v[1:])[len(v[1:]) // 2] for k, v in times.items()}
    mean = {k: sum(v[1:]) / len(v[1:]) for k, v in times.items()}
    grads = [p.grad for p in model_b.parameters()]
    t0 = time.perf_counter()
    guard.device_digest(grads).cpu()
    digest_s = time.perf_counter() - t0
    timing = {}
    if cuda:  # the step's addition alone: device time, host enqueue time
        fn = lambda: guard.grad_diag(grads)  # noqa: E731
        # no host sync in it (torch's sync debug mode raises on one)
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        timing["grad_diag_device_ms"] = device_ms(fn, reps=1)
        sync()
        t0 = time.perf_counter()
        fn()
        timing["grad_diag_enqueue_ms"] = (time.perf_counter() - t0) * 1e3
        sync()
    n_words = sum(p.numel() for p in model_b.parameters())
    del grads
    del model_a, state_a, step_a, model_b, state_b, step_b
    if cuda:
        torch.cuda.empty_cache()

    # -- the rollback at world 1 ------------------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_guard_")
    try:
        _, model_c, state_c, step_c, _, _ = build(True)
        gc = guard.IntegrityGuard(enabled=True,
                                  cadence=GUARD_ROLLBACK_CADENCE, world=1,
                                  ckpt_dir=tmp)
        losses_c = []

        def one(save):
            return training.fit_epoch(
                step_c, state_c, [(x, y)], guard=gc,
                checkpoint_dir=tmp if save else None, checkpoint_every=1)

        for i in range(1, GUARD_TRIP_STEP):
            state_c, loss = one(i >= GUARD_TRIP_STEP - 2)
            losses_c.append(loss)
        assert losses_c == losses_a[:GUARD_TRIP_STEP - 1], (
            losses_c, losses_a)
        with torch.no_grad():
            dict(model_c.named_parameters())["layer_0.ln1.scale"][0] = \
                float("inf")
        state_c, _ = one(True)
        ring_at_trip = sorted(os.listdir(tmp))
        tripped = None
        try:
            one(True)
        except guard.IntegrityError as e:
            tripped = str(e)
        assert tripped is not None, "the guard did not trip on inf gradients"
        verified = gc.last_verified_step
        ring = sorted(os.listdir(tmp))
        want_ring = [f"ckpt-{i}" for i in range(GUARD_TRIP_STEP - 2,
                                                GUARD_TRIP_STEP)]
        assert verified == GUARD_TRIP_STEP - 1, verified
        assert ring == want_ring, (ring, ring_at_trip)
        state_c = checkpoint.restore_checkpoint(tmp, state_c)
        assert state_c.step == GUARD_TRIP_STEP - 1
        rerun = []
        for _ in range(GUARD_TRIP_STEP, steps + 1):
            state_c, loss = one(False)
            rerun.append(loss)
        assert rerun == losses_a[GUARD_TRIP_STEP - 1:], (rerun, losses_a)
        assert gc.last_verified_step == steps
        launches = _train_counts()
        del model_c, state_c, step_c
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _guard_env_clear()
    hvd.shutdown()
    if cuda:
        torch.cuda.empty_cache()
    rec = dict(
        steps=steps, losses=losses_a, bit_identical=True,
        step_s=times, step_s_median_steady=med, step_s_mean_steady=mean,
        overhead_median=med["guarded"] / med["plain"] - 1.0,
        overhead_mean=mean["guarded"] / mean["plain"] - 1.0,
        cadence=GUARD_CADENCE, digest_words=n_words,
        device_digest_s=digest_s, **timing, digest_checks=digest_checks,
        rollback=dict(trip_step=GUARD_TRIP_STEP + 1,
                      verified_step=verified, ring_at_trip=ring_at_trip,
                      ring_after=ring, error=tripped[:160],
                      rerun_losses=rerun),
        launches=dict(zip(TRAIN_COUNTS, launches)))
    log("  guard: " + json.dumps(rec))
    log(f"  guard overhead ({card_line()}): median step "
        f"{med['plain'] * 1e3:.2f} -> "
        f"{med['guarded'] * 1e3:.2f} ms ({rec['overhead_median']:+.2%}), "
        f"mean incl. cadence checks {mean['plain'] * 1e3:.2f} -> "
        f"{mean['guarded'] * 1e3:.2f} ms ({rec['overhead_mean']:+.2%}); "
        f"digest alone {digest_s * 1e3:.2f} ms over {n_words} words "
        f"(device and enqueue ms: {json.dumps(timing)})")
    return rec


# -- phase 18: elastic training through the launcher (one card) ---------------

ELASTIC_STEPS = 6
#: the chaos rules fire at this (0-based) evaluation: step 5's attempt
#: (training.step) or its commit (elastic.commit)
ELASTIC_FAULT_AT = 4
#: the kill run checkpoints every this many steps (the replacement
#: resumes from the newest)
ELASTIC_CKPT_EVERY = 3
ELASTIC_TIMEOUT_S = 400

ELASTIC_WORKER = r'''
import json, os, sys, time
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import chaos, checkpoint, guard, training
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.elastic import worker as elastic_worker
import chip_smoke as cs

logdir, ckpt, device, preset = sys.argv[1:5]
b, s, steps, every = map(int, sys.argv[5:9])
t_boot = time.time()
restarted = elastic_worker.ENV_RESTARTED in os.environ
hvd.init(None if device == "cuda" else "cpu")
wid = os.environ.get("HVD_TPU_ELASTIC_WORKER_ID", "na")


def log(**kv):
    kv["t"] = time.time()
    with open(os.path.join(logdir, f"worker_{wid}.log"), "a") as f:
        f.write(json.dumps(kv) + "\n")


cfg, model, x, y = cs._train_model(device, preset, b, s)
opt = cs._adamw(model.parameters())
step = training.data_parallel_train_step(model, opt)
ts = training.create_train_state(model, opt)
state = hvd.elastic.TpuState(model=model, optimizer=opt, step=0, losses=[])
state.enable_auto_resume(ckpt)
log(event="boot", pid=os.getpid(), t_boot=t_boot, restarted=restarted)
cs._reset_train_counts()


@hvd.elastic.run
def train(state):
    log(event="resume", step=state.step,
        restart=elastic_worker.last_restart_stats)
    while state.step < steps:
        ts.step = state.step
        before = cs._train_counts()
        try:
            _, loss = training.fit_epoch(step, ts, [(x, y)])
        except chaos.ChaosInjected as e:
            # the injected fault stands for a collective that failed
            # mid-step: the HorovodInternalError path
            raise HorovodInternalError(str(e)) from e
        counts = [a - c for a, c in zip(cs._train_counts(), before)]
        state.losses = state.losses + [loss]
        state.step += 1
        state.commit()
        if every and state.step % every == 0:
            checkpoint.save_state_checkpoint(ckpt, state, state.step)
        log(event="step", step=state.step, loss=loss, launches=counts)


train(state)
log(event="done", losses=state.losses,
    digest=guard.device_digest(model).cpu().tolist(),
    restart=elastic_worker.last_restart_stats)
'''


def _elastic_job(tmp, tag, chaos, device, preset, b, s, steps, every):
    """One elastic job through ``python -m horovod_tpu_torch.runner
    --host-discovery-script`` (the script prints ``localhost:2``;
    ``--min-np 1 --max-np 1``: one worker, and a second slot to respawn
    into when the first is blacklisted).  Returns its workers' events."""
    run = os.path.join(tmp, tag)
    logdir, ckpt = os.path.join(run, "logs"), os.path.join(run, "ckpt")
    os.makedirs(logdir)
    os.makedirs(ckpt)
    script = os.path.join(run, "discover.sh")
    with open(script, "w") as f:
        f.write("#!/bin/sh\necho localhost:2\n")
    os.chmod(script, 0o755)
    worker = os.path.join(run, "worker.py")
    with open(worker, "w") as f:
        f.write(ELASTIC_WORKER)
    env = dict(os.environ, PYTHONPATH=HERE, HVD_TPU_ELASTIC_TIMEOUT="180")
    env.pop("HVD_TPU_CHAOS", None)
    if chaos:
        env["HVD_TPU_CHAOS"] = chaos.format(fuse=os.path.join(run, "fuse"))
        env["HVD_TPU_CHAOS_SEED"] = str(SEED)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           "--host-discovery-script", script, "--min-np", "1",
           "--max-np", "1", "--", sys.executable, worker, logdir, ckpt,
           device, preset, str(b), str(s), str(steps), str(every)]
    t0 = time.time()
    proc = subprocess.run(cmd, env=env, cwd=HERE, capture_output=True,
                          text=True, timeout=ELASTIC_TIMEOUT_S)
    wall = time.time() - t0
    assert proc.returncode == 0, (
        f"elastic {tag} job exited {proc.returncode}:\n"
        f"{proc.stderr[-4000:]}")
    events = []
    for name in sorted(os.listdir(logdir)):
        with open(os.path.join(logdir, name)) as f:
            events += [dict(json.loads(line), worker=name) for line in f]
    if chaos:
        assert os.path.exists(os.path.join(run, "fuse")), (
            f"elastic {tag}: the chaos rule never fired")
    # where the job's wall time went: launch -> first worker's imports
    # done, each boot -> resumed training, and the steps
    boots = [e for e in events if e["event"] == "boot"]
    resumes = [e for e in events if e["event"] == "resume"]
    steps_t = [e["t"] for e in events if e["event"] == "step"]
    split = dict(wall_s=wall, launch_to_boot_s=boots[0]["t_boot"] - t0,
                 boot_to_resume_s=[r["t"] - b["t_boot"]
                                   for b, r in zip(boots, resumes)],
                 steps_s=max(steps_t) - resumes[0]["t"],
                 after_last_step_s=t0 + wall - max(steps_t))
    return events, split, proc.stderr


def phase_elastic(device="cuda", preset="gpt_small", b=TRAIN_B, s=TRAIN_S,
                  steps=ELASTIC_STEPS):
    """Fault-tolerant training through the launcher on one card: the
    worker trains the training phase's gpt_small for ``steps`` steps
    under ``hvd.elastic.run`` with a ``TpuState`` (model, AdamW, step,
    losses), committing every step, once uninterrupted and twice with a
    fault at step 5:

    * ``training.step:raise`` — the step's failure surfaces as
      ``HorovodInternalError``; the worker rolls back to its last commit
      and exec-restarts in place with the memfd snapshot (same PID),
      rejoins through rendezvous and finishes;
    * ``elastic.commit:kill`` — the worker dies at its commit; the
      driver blacklists the slot, spawns a replacement in the spare
      slot, which auto-resumes from the newest checkpoint (step 3) and
      re-runs the rest.

    Both faulted runs must end with the uninterrupted run's losses and
    parameter digest, bit for bit, and every step must launch each
    training kernel 12 times.  Prints the exec-restart's split (persist,
    snapshot bytes, reboot, restore) and the kill run's respawn-to-
    resume time."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        kw = dict(device=device, preset=preset, b=b, s=s, steps=steps)
        plain, wall_p, _ = _elastic_job(tmp, "plain", None, every=0, **kw)
        raised, wall_r, _ = _elastic_job(
            tmp, "raise",
            f"training.step:raise,at={ELASTIC_FAULT_AT},rank=0,fuse={{fuse}}",
            every=0, **kw)
        killed, wall_k, err_k = _elastic_job(
            tmp, "kill",
            f"elastic.commit:kill,at={ELASTIC_FAULT_AT},rank=0,fuse={{fuse}}",
            every=ELASTIC_CKPT_EVERY, **kw)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    def done(events):
        d = [e for e in events if e["event"] == "done"]
        assert len(d) == 1, f"expected one finisher: {d}"
        return d[0]

    from horovod_tpu_torch import models

    ref = done(plain)
    assert len(ref["losses"]) == steps
    assert all(math.isfinite(v) for v in ref["losses"])
    # every step on the card launches each training kernel once a layer
    # (the CPU rehearsal runs their plain versions: no launches)
    n = getattr(models, preset)().num_layers if device == "cuda" else 0
    for tag, events in (("plain", plain), ("raise", raised),
                        ("kill", killed)):
        d = done(events)
        assert d["losses"] == ref["losses"], (tag, d["losses"],
                                              ref["losses"])
        assert d["digest"] == ref["digest"], (tag, d["digest"],
                                              ref["digest"])
        for e in events:
            if e["event"] == "step":
                assert e["launches"][:3] == [n, n, n], (tag, e)
    # the raise run: one exec-restart of the same process, carrying the
    # memfd snapshot
    boots = [e for e in raised if e["event"] == "boot"]
    assert len(boots) == 2 and boots[0]["pid"] == boots[1]["pid"], boots
    assert boots[1]["restarted"]
    stats = done(raised)["restart"]
    assert stats and stats["snapshot_bytes"] > 0, stats
    resumed = [e for e in raised if e["event"] == "resume"]
    assert resumed[-1]["step"] == ELASTIC_FAULT_AT, resumed
    # the kill run: a replacement worker that auto-resumed from the
    # checkpoint, with no exec-restart snapshot
    workers = sorted({e["worker"] for e in killed})
    assert len(workers) == 2, workers
    repl = [e for e in killed if e["worker"] == workers[1]]
    r_boot = next(e for e in repl if e["event"] == "boot")
    r_resume = next(e for e in repl if e["event"] == "resume")
    assert not r_boot["restarted"]
    assert r_resume["step"] == ELASTIC_CKPT_EVERY, r_resume
    last_before = max(e["t"] for e in killed
                      if e["worker"] == workers[0] and e["event"] == "step")
    assert "failed with exit code 137" in err_k, err_k[-2000:]
    launches = [0] * len(TRAIN_COUNTS)
    for events in (plain, raised, killed):
        for e in events:
            if e["event"] == "step":
                launches = [a + c for a, c in zip(launches, e["launches"])]
    rec = dict(steps=steps, losses=ref["losses"], digest=ref["digest"],
               time_split=dict(plain=wall_p, raise_=wall_r, kill=wall_k),
               restart=stats,
               kill=dict(kill_to_boot_s=r_boot["t_boot"] - last_before,
                         boot_to_resume_s=r_resume["t"] - r_boot["t_boot"],
                         resumed_from=r_resume["step"]),
               launches=dict(zip(TRAIN_COUNTS, launches)))
    log("  elastic: " + json.dumps(rec))
    log(f"  elastic restart ({card_line()}; training.step:raise, exec "
        f"with memfd): "
        f"persist {stats['persist_s']:.3f} s, snapshot "
        f"{stats['snapshot_bytes']} bytes, reboot {stats['reboot_s']:.2f} s, "
        f"restore {stats['restore_s']:.3f} s, total {stats['total_s']:.2f} s;"
        f" kill -> replacement boot "
        f"{rec['kill']['kill_to_boot_s']:.2f} s, boot -> resumed at step "
        f"{r_resume['step']} {rec['kill']['boot_to_resume_s']:.2f} s")
    return rec


# -- phase 19: observability and the benchmark entry -------------------------

#: the streamed bench run's warm-up and timed steps
OBSERVE_NPY_STEPS = (2, 10)


def _views_engine(device):
    """The serving views' engine when the serving phase did not run: on
    the card the serving phase's llama3_8b engine (bf16, full width,
    seeded weights); on the CPU a two-layer llama-shaped rehearsal."""
    import torch

    from horovod_tpu_torch.models import (TransformerConfig, init_params,
                                          llama3_8b)
    from horovod_tpu_torch.serving import ServeConfig, ServingEngine

    if device == "cuda":
        cfg = llama3_8b(dtype=torch.bfloat16)
    else:
        cfg = TransformerConfig(vocab_size=97, num_layers=2, num_heads=4,
                                num_kv_heads=2, head_dim=8, max_seq_len=64,
                                dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device).manual_seed(SEED),
                         device=device)
    return ServingEngine(cfg, params, serve=ServeConfig(
        block_size=16, decode_tiers=(1, 2, 4, 8), prefill_chunk=256),
        device=device)


def serving_views(eng):
    """(e) The A8f stand-ins on ``eng``: ``decode_step_inventory`` at
    the largest batch tier and a page tier of 8 (128 keys), and
    ``mixed_step_inventory`` at the smallest tiers with the full-table
    gather (the JAX ``lowered_mixed_text`` defaults), each ONE step under
    torch.profiler.  On the card the decode step launches the paged
    decode kernel once a layer, no forward, and gathers nothing (the
    kernel reads the pools in place); the mixed step launches the sm90
    forward once a layer and gathers ``batch_tier ×
    modeled_decode_read_bytes(...)["gathered_bytes"]`` bytes."""
    from horovod_tpu_torch.serving.kv_cache import modeled_decode_read_bytes

    cfg = eng.cfg
    n = cfg.num_layers
    cuda = eng.device.type == "cuda"
    bt_dec, pt = eng.decode_tiers[-1], min(8, eng.page_tiers[-1])
    dec = eng.decode_step_inventory(batch_tier=bt_dec, pages=pt)
    bt, c = eng.decode_tiers[0], eng.chunk_tiers[0]
    mix = eng.mixed_step_inventory(batch_tier=bt, chunk_tier=c)
    el = 2 if cfg.dtype is not None and "16" in str(cfg.dtype) else 4
    modeled = bt * modeled_decode_read_bytes(
        cfg.max_seq_len, block_size=eng.serve_cfg.block_size,
        num_heads=cfg.num_heads, num_kv_heads=cfg.kv_heads,
        head_dim=cfg.head_dim, num_layers=n, dtype_bytes=el,
        max_seq_len=cfg.max_seq_len)["gathered_bytes"]

    def launches(inv, key):
        return sum(k["launches"] for name, k in inv["kernels"].items()
                   if key in name)

    rec = dict(
        decode=dict(batch_tier=bt_dec, pages=pt,
                    gather_bytes=dec["gather_bytes"],
                    paged_decode_kernels=launches(dec, "flash_decode_kernel"),
                    forward_kernels=launches(dec, "flash_fwd"),
                    kernels=len(dec["kernels"]),
                    device_ms=sum(k["device_ms"]
                                  for k in dec["kernels"].values())),
        mixed=dict(batch_tier=bt, chunk_tier=c,
                   gather_bytes=mix["gather_bytes"], modeled_bytes=modeled,
                   sm90_forward_kernels=launches(mix, "flash_fwd_sm90_kernel"),
                   kernels=len(mix["kernels"]),
                   device_ms=sum(k["device_ms"]
                                 for k in mix["kernels"].values())))
    log("  serving views: " + json.dumps(rec))
    assert dec["gather_bytes"] == 0, dec["gather_bytes"]
    assert mix["gather_bytes"] == modeled, (mix["gather_bytes"], modeled)
    if cuda:
        assert rec["decode"]["paged_decode_kernels"] == n, rec["decode"]
        assert rec["decode"]["forward_kernels"] == 0, rec["decode"]
        assert rec["mixed"]["sm90_forward_kernels"] == n, rec["mixed"]
    return rec


def _bench_run(argv):
    """``bench.main(argv)`` in this process, with the fused-norm kernels'
    launch counts set to 0 just before it and read just after, and the
    ``hvd_tpu_collectives_total`` delta over the run."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.metrics import instruments as _m

    def collectives():
        return sum(v for _, v in _m.COLLECTIVES.samples())

    for w in _bn_wrappers():
        w.launches = 0
    c0 = collectives()
    res = bench.main(argv)
    return res, dict(zip(("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_dx"),
                         _bn_counts())), collectives() - c0


def _bench_line(res):
    keys = ("value", "step_time_ms", "mfu", "vs_baseline", "input_wait_ms",
            "input_wait_pct", "final_loss", "batch", "image_size", "data")
    return json.dumps({k: res[k] for k in keys} | {
        "max_memory_gb": (res["memory_per_rank"]["max_memory_allocated"]
                          or 0) / 1e9, "device": res["device"]})


def phase_observe(serving=None, device="cuda", preset="gpt_small", b=TRAIN_B,
                  s=TRAIN_S):
    """The observability layer and the benchmark entry on the card:

    (a) ``python -m horovod_tpu_torch.bench``'s ``main`` in process at
    full width (ResNet-50, batch 128 of 224x224, 5 + 30 steps, one
    device-resident batch) with ``--timeline``: a finite loss, MFU <= 1,
    exactly 53 launches of each fused-norm kernel a step (35 steps), and
    a timeline that parses as JSON and holds one ``COMM`` begin/end pair
    per collective call of the run (each bucket launch one call), as
    many as ``hvd_tpu_collectives_total`` moved;
    (b) the bench again through the input pipeline (``--data npy``,
    self-seeded shards, 2 + 10 steps): its ``input_wait_ms``;
    (c) one gpt_small data-parallel step (``overlap=True``) under
    torch.profiler: one ``hvd_tpu::bucket.<b>::COMM`` range per bucket
    of the step's ``BucketSchedule``, and ``measured_overlap_exposed``
    of the capture (None at world 1: no NCCL kernel);
    (d) ``record_overlap_metrics(overlap_inventory(...))`` of that step:
    the gauge equals the inventory's ``exposed_fraction`` and the
    buckets' bytes sum to the model's gradient bytes (the schedule
    modeled at 8 ranks printed beside);
    (e) the serving views (:func:`serving_views`; the serving phase's
    record when it ran, else a fresh engine);
    (f) ``cluster_snapshot`` at world 1 over NCCL: one rank, its own
    snapshot under ``per_rank``, the collectives counter as merged.

    ``device="cpu"`` is a rehearsal at small sizes (launch counts are
    the card's only)."""
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, training
    from horovod_tpu_torch.metrics import instruments as _m
    from horovod_tpu_torch.ops.comm_model import overlap_inventory
    from horovod_tpu_torch.ops.overlap import (measured_overlap_exposed,
                                               record_overlap_metrics)

    cuda = device == "cuda"
    card = card_line()
    small = [] if cuda else ["--device", "cpu", "--batch", "2"]
    tmp = tempfile.mkdtemp(prefix="hvd_observe_")
    rec = {}
    try:
        # (a) the headline bench with a timeline
        timeline = os.path.join(tmp, "timeline.json")
        steps = (5 + 30) if cuda else (1 + 2)
        res, bn, calls = _bench_run(small + ["--data", "synthetic",
                                             "--timeline", timeline])
        assert math.isfinite(res["final_loss"]), res["final_loss"]
        assert res["mfu"] is None or 0 < res["mfu"] <= 1, res["mfu"]
        if cuda:
            want = RESNET_SITES * steps
            assert all(v == want for v in bn.values()), (
                f"fused-norm launches {bn} != {RESNET_SITES} a step x "
                f"{steps} steps")
        with open(timeline) as f:
            events = json.load(f)
        begins = [e for e in events if e.get("ph") == "B"]
        ends = [e for e in events if e.get("ph") == "E"]
        assert {e["name"] for e in begins + ends} <= {"COMM"}, begins[:3]
        assert len(begins) == len(ends) == calls, (len(begins), len(ends),
                                                   calls)
        rows = {}
        for e in begins:
            rows[e["args"]["tensor"]] = rows.get(e["args"]["tensor"], 0) + 1
        rec["bench"] = dict(result=res, bn_launches=bn, collectives=calls,
                            timeline_rows=rows,
                            cycles=sum(e.get("ph") == "i" for e in events))
        log(f"  observe bench ({card}): " + _bench_line(res))
        log("  observe bench timeline: " + json.dumps(
            dict(collectives=calls, comm_pairs=len(begins), rows=rows,
                 cycles=rec["bench"]["cycles"],
                 comm_bytes=res["comm_bytes"])))
        # (b) the streamed bench
        w, n = OBSERVE_NPY_STEPS if cuda else (1, 2)
        res_npy, bn_npy, _ = _bench_run(small + [
            "--data", "npy", "--warmup", str(w), "--iters", str(n)])
        assert math.isfinite(res_npy["final_loss"]), res_npy["final_loss"]
        if cuda:
            assert all(v == RESNET_SITES * (w + n) for v in bn_npy.values()
                       ), bn_npy
        rec["bench_npy"] = dict(result=res_npy, bn_launches=bn_npy)
        log(f"  observe bench npy ({card}): " + _bench_line(res_npy)
            + f" pipeline {json.dumps(res_npy['pipeline'])}")
        rec["launches"] = {k: bn[k] + bn_npy[k] for k in bn}
        # (c) + (d) the profiler bridge and the overlap metrics
        hvd.init(device=None if cuda else "cpu")
        cfg, model, inputs, labels = _train_model(device, preset, b, s)
        opt = _adamw(model.parameters())
        state = training.create_train_state(model, opt)
        step = training.data_parallel_train_step(model, opt, overlap=True)
        n_buckets = step.reducer.schedule.num_buckets
        state, loss = step(state, inputs, labels)  # outside the capture
        if cuda:
            torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts) as prof:
            state, loss = step(state, inputs, labels)
            if cuda:
                torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        ranges = {bk: names.count(f"hvd_tpu::bucket.{bk}::COMM")
                  for bk in range(n_buckets)}
        assert all(v == 1 for v in ranges.values()), ranges
        assert names.count("hvd_tpu::allreduce::COMM") == 1  # the loss
        measured = measured_overlap_exposed(prof)
        inv = record_overlap_metrics(overlap_inventory(
            step.reducer.last_record))
        assert _m.OVERLAP_EXPOSED_FRACTION.get() == inv["exposed_fraction"]
        grad_bytes = sum(p.numel() * p.element_size()
                         for p in model.parameters())
        assert sum(c["payload_bytes"] for c in inv["collectives"]) == \
            grad_bytes, (inv["collectives"][:2], grad_bytes)
        assert len(inv["collectives"]) == n_buckets
        at8 = overlap_inventory(step.reducer.last_record, world=8)
        rec["overlap"] = dict(
            buckets=n_buckets, comm_ranges=sum(ranges.values()),
            measured_exposed=measured, grad_bytes=grad_bytes,
            exposed_fraction=inv["exposed_fraction"],
            interleaved=inv["interleaved"],
            exposed_fraction_at_8=at8["exposed_fraction"],
            interleaved_at_8=at8["interleaved"],
            compute_after=[c["compute_after"] for c in inv["collectives"]],
            float_loss=float(loss))
        log("  observe overlap: " + json.dumps(rec["overlap"]))
        del state, step, model, opt
        # (f) cluster_snapshot at world 1
        snap = metrics.cluster_snapshot()
        assert snap["ranks"] == 1 and len(snap["per_rank"]) == 1
        mine = snap["per_rank"][0]["metrics"]["hvd_tpu_collectives_total"]
        merged = snap["metrics"]["hvd_tpu_collectives_total"]
        assert merged["series"] == sorted(mine["series"]), (merged, mine)
        info = snap["metrics"]["hvd_tpu_process_info"]["series"]
        assert info == [[["0", "0", "0", "1", "1"], 1.0]], info
        rec["cluster"] = dict(ranks=snap["ranks"], collectives={
            "/".join(k): v for k, v in merged["series"]})
        log("  observe cluster_snapshot: " + json.dumps(rec["cluster"]))
        hvd.shutdown()
        # (e) the serving views
        views = (serving or {}).get("views")
        if views is None:
            eng = _views_engine(device)
            views = serving_views(eng)
            del eng
        rec["views"] = views
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        hvd.shutdown()
        if cuda:
            torch.cuda.empty_cache()
    return rec


# -- phases tp and tp4: tensor-sharded serving -------------------------------

#: the tp phase's ranks share one card: NCCL refuses two ranks on one
#: GPU, so they run over gloo, whose all-reduce stages through the host
TP_SHARDS = 2


def _storage_bytes(tensors):
    """Device bytes the tensors' storages hold, each storage once: a
    view of a larger tensor counts that tensor's whole storage."""
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}.values())


def _time_intake(eng):
    """Wrap a sharded engine's per-step intake broadcast (an instance
    attribute, removed by ``del``) to record each call's host seconds:
    the header broadcast, its ``.tolist()`` and any request objects."""
    times = []
    intake = eng._sync_intake

    def timed(idle):
        t0 = time.perf_counter()
        now = intake(idle)
        times.append(time.perf_counter() - t0)
        return now

    eng._sync_intake = timed
    return times


def allreduce_burst(mesh, device, cfg, batch=8, reps=10):
    """A sharded decode step's all-reduces alone: 2 x num_layers
    back-to-back tensor-parallel sums (``tensor_parallel._all_reduce``,
    the engine's) of a (batch, 1, d_model) activation over ``mesh``,
    then one sync; the median and least of ``reps`` bursts (after one
    more) in ms, on the host's clock."""
    import torch

    from horovod_tpu_torch.parallel.tensor_parallel import _all_reduce

    x = torch.ones((batch, 1, cfg.d_model), dtype=cfg.dtype, device=device)
    times = []
    for _ in range(reps + 1):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(2 * cfg.num_layers):
            _all_reduce(x, mesh)
        _sync(device)
        times.append(time.perf_counter() - t0)
    steady = sorted(times[1:])
    return dict(count=2 * cfg.num_layers,
                payload_bytes=x.numel() * x.element_size(),
                ms_median=1e3 * steady[len(steady) // 2],
                ms_min=1e3 * steady[0])


def _step_shapes(eng):
    """Wrap ``eng``'s step functions (instance attributes, removed by
    ``del``) to record each step's (batch tier, query width)."""
    shapes = []
    mixed, decode = eng._mixed_step, eng._decode_step

    def m(tables, lens, chunk_lens, tokens, pages=None):
        shapes.append(tuple(tokens.shape))
        return mixed(tables, lens, chunk_lens, tokens, pages)

    def d(tables, lens, last_tok, pages):
        shapes.append((last_tok.shape[0], 1))
        return decode(tables, lens, last_tok, pages)

    eng._mixed_step, eng._decode_step = m, d
    return shapes


def serve_sharded(cfg, shards, mesh, device, want=None, check=True,
                  seed=SEED, in_turn=False):
    """llama3_8b's serving run at ``shards``: the serving phase's engine
    config and two waves (8 prompts, 32 new tokens), on this rank of
    ``mesh``.  The engine is handed the FULL tree (``init_params`` from
    ``seed`` on the card: the serving phase's weights), keeps copies of
    its slices, and the full tree is then freed (``in_turn``: one rank
    of the set after the other, for ranks that share a card).  Checks
    every request
    completes, each mixed step launches
    the sm90 forward and each decode step the paged decode once a layer
    (at this rank's H/shards heads), the first tokens' logits against a
    dense forward, the ``SERVE_SHARD_PSUM_BYTES`` delta against the
    modeled sum over the steps' shapes and against the all-reduces'
    payloads booked in ``COLLECTIVE_BYTES``, the per-rank parameter
    storage bytes (each storage once), and the streams against ``want``
    (the serving phase's, tie-aware); with ``check`` every step's tokens
    are held equal across the ranks as they are taken
    (``check_agreement``: one broadcast a step).  Records the host time
    of each step's intake broadcast.  Returns its record and the
    streams."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch import trace
    from horovod_tpu_torch.metrics import instruments as instr
    from horovod_tpu_torch.models import init_params
    from horovod_tpu_torch.models.transformer import param_shapes
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops.comm_model import modeled_serve_psum_bytes
    from horovod_tpu_torch.parallel import tensor_parallel
    from horovod_tpu_torch.serving import ServeConfig, ServingEngine
    from horovod_tpu_torch.serving.engine import _allreduce_totals

    cuda = device.type == "cuda"
    full = param_shapes(cfg)
    dims = tensor_parallel.transformer_shard_specs(dict.fromkeys(full))
    el = torch.empty((), dtype=cfg.dtype).element_size()
    numel = lambda s: math.prod(s)  # noqa: E731
    rep_bytes = sum(numel(s) * (4 if k.endswith(".scale") else el)
                    for k, (s, _d) in full.items() if dims[k] is None)
    cut_bytes = sum(numel(s) * el for k, (s, _d) in full.items()
                    if dims[k] is not None)
    me = 0 if mesh is None else mesh.rank_in_set(_world_rank())
    for turn in range(shards if in_turn else 1):
        if in_turn and turn != me:
            dist.barrier(group=mesh.group)
            continue
        params = init_params(
            cfg, torch.Generator(device.type).manual_seed(seed),
            device=device)
        eng = ServingEngine(cfg, params, serve=ServeConfig(
            block_size=16, decode_tiers=(1, 2, 4, 8), prefill_chunk=256),
            device=device, mesh=mesh if shards > 1 else None)
        del params  # sharded: the engine holds copies of its slices alone
        if cuda:  # give the full tree's blocks back to the card
            torch.cuda.empty_cache()
        if in_turn:
            dist.barrier(group=mesh.group)
    # this rank's heads: H/shards query and H_kv/shards kv heads, the
    # pool's pages at its kv slice
    assert eng.model.layer_0.attn.q.kernel.shape[1] == \
        cfg.num_heads // shards
    assert eng.k_pool.shape[3] == cfg.kv_heads // shards
    rank_bytes = _storage_bytes(eng.model.parameters())
    assert rank_bytes == rep_bytes + cut_bytes // shards, (
        rank_bytes, rep_bytes, cut_bytes)
    eng.check_agreement = check and shards > 1
    eng.warmup()
    eng.first_logits, eng.token_log = {}, []
    waves = serving_waves(cfg.vocab_size)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    since = trace.now()
    per_step = _count_step_launches(eng)
    shapes = _step_shapes(eng)
    _reset_attention_counts()
    intake = _time_intake(eng) if shards > 1 else []
    psum0 = instr.SERVE_SHARD_PSUM_BYTES.get()
    red0 = _allreduce_totals()
    steps0 = eng.steps
    prompts = {}
    t0 = time.perf_counter()
    for wave in waves:
        for p in wave:
            prompts[eng.submit(p, max_new_tokens=32)] = p
        out = eng.run()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng._decode_step, eng._mixed_step
    if shards > 1:
        del eng._sync_intake
    steps = eng.steps - steps0
    launches = _attention_counts()
    assert sorted(out) == sorted(prompts), "not every request completed"
    assert all(len(out[r]) == 32 for r in prompts), "short stream"
    n = cfg.num_layers
    per_kind = _per_kind(per_step, _kinds_since(since))
    step_kinds = {k: sum(1 for x in per_kind if x[0] == k)
                  for k in ("mixed", "decode")}
    if cuda:  # n sm90 forwards a mixed step, n paged decodes a decode one
        _check_step_launches(per_kind, n, ("mixed", "decode"))
    assert step_kinds["mixed"] > 0 and step_kinds["decode"] > 0, step_kinds
    psum = instr.SERVE_SHARD_PSUM_BYTES.get() - psum0
    modeled = sum(modeled_serve_psum_bytes(
        bt, q, cfg.d_model, n, shards, cfg.dtype)["stream_bytes"]
        for bt, q in shapes)
    calls, payload = (int(a - b) for a, b in zip(_allreduce_totals(), red0))
    assert len(shapes) == steps
    assert psum == modeled == eng.shard_psum_bytes, (psum, modeled)
    assert calls == (2 * n * steps if shards > 1 else 0), (calls, steps)
    assert payload * 2 * (shards - 1) // shards == psum, (payload, psum)
    worst = 0.0
    with torch.inference_mode():
        for rid, p in prompts.items():
            toks = torch.as_tensor(p, dtype=torch.long, device=device)[None]
            dense = eng.model(toks)[0, -1].float().cpu()
            rel = float((eng.first_logits[rid] - dense).abs().max()
                        / dense.abs().max())
            worst = max(worst, rel)
    assert worst <= 5e-2, f"first-token logits disagree: {worst}"
    streams = [out[r].tolist() for r in prompts]
    forks = []
    if want is not None:
        for i, (p, got) in enumerate(zip(prompts.values(), streams)):
            forks.append(tie_aware_equal(
                eng.model, p, got, want[i], f"shards={shards} request {i}",
                verbose=_world_rank() == 0))
    ttft = sorted(s - a for s, a in _first_tokens(eng))
    dec = [(args["batch"], dur) for site, _t, dur, args, _tid
           in trace.snapshot(since)
           if site == "serve.step" and args and args["kind"] == "decode"]
    gen = sum(len(v) for v in out.values())
    rec = dict(shards=shards, requests=len(out), steps=steps,
               step_kinds=step_kinds, launches=launches,
               psum_bytes=psum, modeled_psum_bytes=modeled,
               allreduce_calls=calls, allreduce_payload_bytes=payload,
               rank_param_bytes=rank_bytes,
               full_param_bytes=rep_bytes + cut_bytes,
               pool_bytes_per_rank=eng.pool_bytes_per_shard,
               first_logits_rel=worst, forks=forks,
               ttft_p50_s=ttft[len(ttft) // 2], tokens=gen, wall_s=wall,
               tokens_per_s=gen / wall,
               decode_tokens_per_s=(sum(b for b, _ in dec)
                                    / sum(d for _, d in dec)),
               decode_step_ms=1e3 * sum(d for _, d in dec) / len(dec),
               step_wall_ms=1e3 * wall / steps,
               intake_calls=len(intake),
               intake_ms_mean=1e3 * sum(intake) / len(intake)
               if intake else None,
               intake_share=sum(intake) / wall,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9
               if cuda else None)
    del eng
    gc.collect()  # the engine's scheduler closure holds it in a cycle
    if cuda:
        torch.cuda.empty_cache()
    return rec, streams


def oracle_sharded(shards, mesh, device):
    """phase_oracle's plain engine at ``shards``: llama3_8b width, 2
    layers, fp32; the greedy streams against one-at-a-time dense decode
    of the same sharded model (tie-aware at 1e-4)."""
    import numpy as np
    import torch

    from horovod_tpu_torch.models import init_params, llama3_8b
    from horovod_tpu_torch.serving import ServeConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama3_8b(num_layers=2, dtype=torch.float32)
    eng = ServingEngine(cfg, init_params(
        cfg, torch.Generator(device.type).manual_seed(SEED + 1),
        device=device), serve=ServeConfig(
        block_size=16, decode_tiers=(1, 2, 4), prefill_chunk=32),
        device=device, mesh=mesh)
    eng.check_agreement = True
    rs = np.random.RandomState(SEED + 1)
    prompts = [rs.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 23, 40, 61)]
    n_new = 12
    ids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    out = eng.run()
    compared = 0
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            toks = list(p)
            for j in range(n_new):
                x = torch.as_tensor(toks, dtype=torch.long,
                                    device=device)[None]
                logits = eng.model(x)[0, -1].float()
                top2 = torch.topk(logits, 2).values
                if float(top2[0] - top2[1]) < 1e-4:
                    break  # a near-tie: the rest may fork
                t = int(torch.argmax(logits))
                assert int(out[ids[i]][j]) == t, (
                    f"shards={shards} oracle request {i} token {j}: "
                    f"{int(out[ids[i]][j])} != {t}")
                compared += 1
                toks.append(t)
    assert compared >= len(prompts) * n_new // 2, "too few tokens compared"
    del eng
    return dict(shards=shards, compared=compared,
                of=len(prompts) * n_new)


def tiny_serving_cfg():
    """A CPU rehearsal's stand-in for llama3_8b: two layers of 8/4
    heads of 8, long enough for the serving waves."""
    import torch

    from horovod_tpu_torch.models import TransformerConfig

    return TransformerConfig(vocab_size=256, num_layers=2, num_heads=8,
                             num_kv_heads=4, head_dim=8, max_seq_len=1024,
                             dtype=torch.float32)


def _quiet(*_a):
    pass


def _world_rank():
    import horovod_tpu_torch as hvd

    return hvd.rank()


TP_WORKER = r"""
import json, sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import llama3_8b
from horovod_tpu_torch.parallel import tensor_shard_mesh
import chip_smoke as cs

rank, world, store, out, given, device = sys.argv[1:7]
rank, world = int(rank), int(world)
cpu = device == "cpu"
if cpu:
    torch.set_num_threads(1)
# every rank on the one card (or the CPU), over gloo
hvd.init(device="cpu" if cpu else "cuda:0", rank=rank, size=world,
         init_method="file://" + store, backend="gloo")
dev = hvd.device()
with open(given) as f:
    want = json.load(f)
mesh = tensor_shard_mesh("tp", world)
cfg = cs.tiny_serving_cfg() if cpu else llama3_8b(dtype=torch.bfloat16)
rec, streams = cs.serve_sharded(cfg, world, mesh, dev, want=want["streams"],
                                in_turn=True)
rec["oracle"] = None if cpu else cs.oracle_sharded(world, mesh, dev)
rec["streams"] = streams
# Ulysses through its entry point: gloo's all-to-all on the card
rec["ulysses"] = cs.ulysses_run(hvd.global_process_set, dev,
                                **(cs.ULYSSES_CPU if cpu else {}))
with open(out, "w") as f:
    json.dump(rec, f)
hvd.shutdown()
"""


def _spawn(code, world, args, timeout, tag):
    """Run ``code`` in ``world`` processes (argv: rank, world, store,
    output, *args) from the checkout's root; returns each rank's JSON
    output."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        env = dict(os.environ, PYTHONPATH=HERE)
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world),
             os.path.join(tmp, "store"), outs[r],
             *[a(tmp) if callable(a) else str(a) for a in args]],
            cwd=HERE, env=env) for r in range(world)]
        try:
            rcs = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert rcs == [0] * world, f"{tag} ranks exited {rcs}"
        recs = []
        for o in outs:
            with open(o) as f:
                recs.append(json.load(f))
    return recs


def phase_tp(serving, device="cuda", timeout=900):
    """Tensor-sharded serving on ONE card (module docstring, phase tp):
    two ranks, one process each over gloo, llama3_8b at full width
    sharded two ways through ``ServingEngine(shards=2)``; the serving
    phase's streams are the reference; then ``ulysses_attention(impl=
    "flash")`` over the two ranks (gloo's all-to-all).  Gloo stages each
    collective through the host, so the times are no tensor- or
    sequence-parallel measurement."""
    free_gb = None
    if device == "cuda":
        import torch

        from horovod_tpu_torch.ops import _build

        _build.build_all()
        # the ranks share this card, each holding the full tree while its
        # engine is built: give back what earlier phases left (an engine
        # stays alive in a reference cycle until collected)
        gc.collect()
        torch.cuda.empty_cache()
        free_gb = torch.cuda.mem_get_info()[0] / 1e9
    want = serving["streams"] if serving else None

    def given(tmp):
        path = os.path.join(tmp, "given.json")
        with open(path, "w") as f:
            json.dump({"streams": want}, f)
        return path

    recs = _spawn(TP_WORKER, TP_SHARDS, [given, device], timeout, "tp")
    assert recs[0]["streams"] == recs[1]["streams"], "ranks' streams differ"
    rec = {k: v for k, v in recs[0].items()
           if k not in ("streams", "ulysses")}
    rec["rank_peak_mem_gb"] = [r["peak_mem_gb"] for r in recs]
    rec["card_free_gb_before"] = free_gb
    rec["launches"] = {k: sum(r["launches"][k] for r in recs)
                       for k in recs[0]["launches"]}
    rec["ulysses"] = [r["ulysses"] for r in recs]
    rec["ulysses_launches"] = {k: sum(r["ulysses"]["launches"][k]
                                      for r in recs) for k in TRAIN_COUNTS}
    rec["note"] = ("two ranks on one card over gloo: the collectives "
                   "stage through the host; no tensor- or sequence-"
                   "parallel time")
    log("  tp: " + json.dumps(rec))
    return rec


# -- phase parallel: the rest of parallel/ on one card ------------------------

ULYSSES_S = 8192
ULYSSES_N = (2, 4)
#: ``ulysses_run``'s shape in a CPU rehearsal
ULYSSES_CPU = dict(b=2, s=64, h=4, d=8)
MOE_EXPERTS = 8
PIPE_M = 8


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def multi_axis_run(dims, impl, device, preset="gpt_small", b=TRAIN_B,
                   s=TRAIN_S, steps=TRAIN_STEPS):
    """``preset``'s widths through ``MultiAxisTransformer`` (bf16 over
    fp32 masters, AdamW at optax's defaults, ``init_sharded`` from SEED)
    and ``make_sharded_train_step`` on this rank of the ``dims`` mesh,
    ``steps`` steps on one seeded global B x S batch (this rank's
    (B/dp, S/sp) slice): losses, the training kernels' launches a step,
    step times."""
    import numpy as np
    import torch

    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import transformer as tm
    from horovod_tpu_torch.parallel import sharded as sh

    cfg = getattr(tm, preset)()
    cpu = device.type == "cpu"
    mesh = sh.multi_axis_mesh(*dims)
    model = sh.MultiAxisTransformer(
        cfg.vocab_size, cfg.d_model, cfg.num_heads, cfg.num_layers, s,
        dtype=torch.float32 if cpu else torch.bfloat16,
        attention_impl=impl, mesh=mesh, device=device)
    sh.init_sharded(model, seed=SEED)
    opt, _specs = sh.init_opt_sharded(_adamw, model)
    step = sh.make_sharded_train_step(model, opt, mesh)
    state = training.create_train_state(model, opt)
    toks = np.random.RandomState(SEED).randint(0, cfg.vocab_size,
                                               size=(b, s + 1))
    bl, sl = b // mesh.dp, s // mesh.sp
    rows = slice(mesh.dp_idx * bl, (mesh.dp_idx + 1) * bl)
    cols = slice(mesh.sp_idx * sl, (mesh.sp_idx + 1) * sl)
    x = torch.as_tensor(toks[rows, :-1][:, cols], device=device)
    y = torch.as_tensor(toks[rows, 1:][:, cols], device=device)
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    losses, per_step, times = [], [], []
    for _ in range(steps):
        before = _train_counts()
        _sync(device)
        t0 = time.perf_counter()
        state, loss = step(state, x, y)
        _sync(device)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        per_step.append([a - c for a, c in zip(_train_counts(), before)])
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    n_params = sum(p.numel() for p in model.parameters())
    steady = times[1:]
    rec = dict(mesh=list(dims), impl=impl, batch=[b, s], losses=losses,
               step_s=times, step_ms_mean=1e3 * sum(steady) / len(steady),
               step_ms_median=1e3 * sorted(steady)[len(steady) // 2],
               tokens_per_s=b * s / (sum(steady) / len(steady)),
               rank_params=n_params, per_step=per_step,
               launches=dict(zip(TRAIN_COUNTS, _train_counts())),
               peak_mem_gb=None if cpu
               else torch.cuda.max_memory_allocated() / 1e9)
    del state, step, model, opt
    gc.collect()  # the reducer's hooks hold the parameters in a cycle
    return rec


def ulysses_run(ps, device, b=TRAIN_B, s=ULYSSES_S, h=12, d=64):
    """``ulysses_attention(q, k, v, process_set=ps, impl="flash")``, the
    entry point with its two all-to-alls, forward and backward, this
    rank holding its S/n rows of a global ``s`` tokens of gpt_small's
    attention shape (B=8, 12 heads of 64; the inputs seeded alike on
    every rank): its output and (dq, dk, dv) against its rows of one
    ``flash_attention`` over the whole sequence and every head on this
    card, within RING_TOL (and whether bit-equal); the training
    kernels' counts set to 0 just before the call and read just after
    (one launch of each a rank, on H/n heads); the call's time beside
    the single call's."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import ulysses_attention

    cuda = device.type == "cuda"
    n, me = ps.size(), ps.rank_in_set(_world_rank())
    dtype = torch.bfloat16 if cuda else torch.float32
    q, k, v, do = _ring_inputs(b, s, h, h, d, dtype, device=device)
    rows = slice(me * s // n, (me + 1) * s // n)

    def run(fn, ins, dout):
        xs = [t.clone().requires_grad_() for t in ins]
        o = fn(*xs)
        o.backward(dout)
        return [o.detach()] + [t.grad for t in xs]

    def call():
        return run(lambda *xs: ulysses_attention(*xs, process_set=ps,
                                                 impl="flash"),
                   [t[:, rows] for t in (q, k, v)], do[:, rows])

    def single():
        return run(fa.flash_attention, (q, k, v), do)

    _sync(device)
    _reset_train_counts()
    got = call()
    _sync(device)
    launches = dict(zip(TRAIN_COUNTS, _train_counts()))
    want = [t[:, rows] for t in single()]
    tol = RING_TOL[str(dtype).split(".")[-1]]
    errs = [float((a.float() - w.float()).abs().max()) for a, w in
            zip(got, want)]
    bits = [bool(torch.equal(a, w)) for a, w in zip(got, want)]
    assert max(errs) <= tol, f"ulysses_attention n={n}: {errs} > {tol}"
    if cuda:
        assert launches["flash_fwd_sm90"] == 1 and \
            launches["flash_bwd_dq_sm90"] == 1 and \
            launches["flash_bwd_dkv_sm90"] == 1, launches
    rec = dict(n=n, rank=me, shape=[b, s, h, d], errors=errs,
               bit_equal=bits, launches=launches)
    if cuda:
        rec["ms"] = cuda_ms(call, reps=3)
        rec["single_ms"] = cuda_ms(single, reps=3)
    return rec


def ulysses_replay(n, device, b=TRAIN_B, s=ULYSSES_S, h=12, d=64):
    """A side check, not a main path: ``ulysses_attention(impl=
    "flash")``'s local attention replayed for n ranks on one card (rank
    j's is ``flash_attention`` over the WHOLE sequence on head chunk j),
    with no all-to-all: the n calls (forward and backward) against one
    ``flash_attention`` over every head, on gpt_small's attention shape
    (B=8, 12 heads of 64) at a global ``s`` tokens: outputs and
    gradients within RING_TOL (and whether bit-equal), n launches of each
    kernel, the replay's time beside the single call's.  The entry point
    itself runs in the tp and tp4 phases (``ulysses_run``)."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    q, k, v, do = _ring_inputs(b, s, h, h, d, dtype, device=device)

    def attn(qs, ks, vs, dos):
        outs, grads = [], []
        for qq, kk, vv, dd in zip(qs, ks, vs, dos):
            xs = [t.clone().requires_grad_() for t in (qq, kk, vv)]
            o = fa.flash_attention(*xs)
            o.backward(dd)
            outs.append(o.detach())
            grads.append([t.grad for t in xs])
        return outs, grads

    hl = h // n
    chunk = lambda t: [t[:, :, j * hl:(j + 1) * hl].contiguous()  # noqa
                       for j in range(n)]
    parts = [chunk(t) for t in (q, k, v, do)]
    _sync(device)
    _reset_train_counts()
    outs, grads = attn(*parts)
    _sync(device)
    launches = dict(zip(TRAIN_COUNTS, _train_counts()))
    ref_o, ref_g = attn([q], [k], [v], [do])
    got = [torch.cat(outs, dim=2)] + [torch.cat([g[i] for g in grads], dim=2)
                                      for i in range(3)]
    want = [ref_o[0]] + ref_g[0]
    tol = RING_TOL[str(dtype).split(".")[-1]]
    errs = [float((a.float() - w.float()).abs().max()) for a, w in
            zip(got, want)]
    bits = [bool(torch.equal(a, w)) for a, w in zip(got, want)]
    assert max(errs) <= tol, f"ulysses n={n}: {errs} > {tol}"
    if device.type == "cuda":
        assert launches["flash_fwd_sm90"] == n and \
            launches["flash_bwd_dq_sm90"] == n and \
            launches["flash_bwd_dkv_sm90"] == n, launches
    rec = dict(n=n, shape=[b, s, h, d], errors=errs, bit_equal=bits,
               launches=launches)
    if device.type == "cuda":
        rec["replay_ms"] = cuda_ms(lambda: attn(*parts), reps=3)
        rec["single_ms"] = cuda_ms(lambda: attn([q], [k], [v], [do]),
                                   reps=3)
    return rec


def moe_run(device, ep_set=None, b=TRAIN_B, s=TRAIN_S, d=768, dff=3072,
            experts=MOE_EXPERTS, x_seed=SEED):
    """``ExpertParallelMoe`` at gpt_small's width (``experts`` experts,
    ``ep_set``'s ranks sharing them), this rank's B x S tokens, forward
    and backward of mean(out²) + 0.01·aux: the output against a dense
    reference (every token through its expert's MLP, gated), the
    gradients finite, the time of a forward and backward."""
    import torch

    from horovod_tpu_torch.parallel import ExpertParallelMoe
    from horovod_tpu_torch.parallel.tensor_parallel import gelu

    cpu = device.type == "cpu"
    dtype = torch.float32 if cpu else torch.bfloat16
    ep = 1 if ep_set is None else ep_set.size()
    me = 0 if ep_set is None else ep_set.rank_in_set(_world_rank())
    full = ExpertParallelMoe(experts, d, dff, dtype=dtype, device=device)
    full.reset_parameters(torch.Generator(device.type).manual_seed(SEED))
    mod = ExpertParallelMoe(experts, d, dff, process_set=ep_set,
                            dtype=dtype, device=device)
    le = experts // ep
    with torch.no_grad():
        mod.gate.copy_(full.gate)
        mod.wi.copy_(full.wi[me * le:(me + 1) * le])
        mod.wo.copy_(full.wo[me * le:(me + 1) * le])
    g = torch.Generator(device.type).manual_seed(x_seed)
    x = torch.randn((b, s, d), generator=g, device=device).to(dtype)

    def fwd_bwd():
        mod.zero_grad(set_to_none=True)
        out, aux = mod(x)
        (out.float().pow(2).mean() + 0.01 * aux).backward()
        return out, aux

    out, aux = fwd_bwd()
    with torch.no_grad():
        tokens = x.reshape(-1, d)
        probs = torch.softmax(tokens.float() @ full.gate, dim=-1)
        gate, idx = probs.max(dim=-1)
        cap = max(1, int(mod.capacity_factor * tokens.shape[0] / experts))
        pos = (torch.cumsum(torch.nn.functional.one_hot(idx, experts), 0)
               - 1).gather(1, idx[:, None])[:, 0]
        keep = pos < cap
        ref = torch.zeros_like(tokens)
        for e in range(experts):
            sel = (idx == e) & keep
            h = gelu(tokens[sel] @ full.wi[e].to(dtype))
            ref[sel] = (h @ full.wo[e].to(dtype)) * gate[sel, None].to(dtype)
    err = float((out.detach().reshape(-1, d).float()
                 - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    tol = 1e-4 if cpu else 2e-2
    assert err <= tol * scale, f"moe ep={ep}: {err} > {tol} x {scale}"
    finite = all(bool(torch.isfinite(p.grad).all()) for p in mod.parameters())
    aux = float(aux.detach())
    assert finite and math.isfinite(aux) and aux > 0
    rec = dict(ep=ep, tokens=b * s, experts=experts, capacity=cap,
               dropped=int((~keep).sum()), aux=aux,
               max_abs_err=err, ref_scale=scale)
    if not cpu:
        rec["fwd_bwd_ms"] = cuda_ms(fwd_bwd, reps=3)
    return rec


def pipeline_run(device, pp_set=None, preset="gpt_small", m=PIPE_M,
                 s=TRAIN_S):
    """``pipeline_apply`` over ``pp_set``'s ranks (None: pp = 1):
    ``preset``'s decoder blocks (flash attention, bf16 over fp32 masters
    from SEED) cut into one stage a rank, M microbatches of 1 x S
    activations: the outputs on every rank against the blocks run one
    microbatch at a time on this rank (the same shapes through the same
    kernels), every stage gradient finite, the training kernels'
    launches (M a block of this stage), the forward and backward's
    time."""
    import torch
    from torch.func import functional_call

    from horovod_tpu_torch.models import Transformer, init_params
    from horovod_tpu_torch.models import transformer as tm
    from horovod_tpu_torch.parallel.pipeline import pipeline_apply

    cpu = device.type == "cpu"
    cfg = getattr(tm, preset)(attention_impl="flash",
                              dtype=torch.float32 if cpu else torch.bfloat16)
    model = Transformer(cfg, params=init_params(
        cfg, torch.Generator(device.type).manual_seed(SEED), device=device,
        param_dtype=torch.float32))
    blocks = [getattr(model, f"layer_{i}") for i in range(cfg.num_layers)]
    pos = torch.arange(s, device=device)[None]

    class Stage(torch.nn.Module):
        def __init__(self, mods):
            super().__init__()
            self.mods = torch.nn.ModuleList(mods)

        def forward(self, h):
            for blk in self.mods:
                h = blk(h, pos.expand(h.shape[:2]))
            return h

    pp = 1 if pp_set is None else pp_set.size()
    me = 0 if pp_set is None else pp_set.rank_in_set(_world_rank())
    per = cfg.num_layers // pp
    stage = Stage(blocks[me * per:(me + 1) * per])
    params = dict(stage.named_parameters())
    g = torch.Generator(device.type).manual_seed(SEED)
    x = torch.randn((m, 1, s, cfg.d_model), generator=g,
                    device=device).to(cfg.dtype)
    _sync(device)
    _reset_train_counts()
    t0 = time.perf_counter()
    y = pipeline_apply(lambda p, h: functional_call(stage, p, (h,)),
                       params, x, m, process_set=pp_set)
    y.float().pow(2).mean().backward()
    _sync(device)
    wall = time.perf_counter() - t0
    launches = dict(zip(TRAIN_COUNTS, _train_counts()))
    whole = Stage(blocks)
    with torch.no_grad():
        ref = torch.stack([whole(x[i]) for i in range(m)])
    same = bool(torch.equal(y.detach(), ref))
    err = float((y.detach().float() - ref.float()).abs().max())
    finite = all(bool(torch.isfinite(p.grad).all()) for p in params.values())
    assert finite, "a stage gradient is not finite"
    assert err <= (1e-4 if cpu else 2e-2) * float(ref.float().abs().max()), \
        f"pipeline pp={pp}: {err}"
    if not cpu:
        assert launches["flash_fwd_sm90"] == m * per and \
            launches["flash_bwd_dq_sm90"] == m * per and \
            launches["flash_bwd_dkv_sm90"] == m * per, launches
    del model, stage, y
    return dict(pp=pp, microbatches=m, blocks_per_stage=per,
                bit_equal=same, max_abs_err=err, launches=launches,
                fwd_bwd_s=wall)


def phase_parallel(device="cuda", preset="gpt_small", b=TRAIN_B, s=TRAIN_S,
                   steps=TRAIN_STEPS, s_ulysses=ULYSSES_S):
    """The rest of ``parallel/`` on one card (module docstring, phase
    parallel), through ``init()`` at world 1."""
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu" if device == "cpu" else None)
    dev = hvd.device()
    rec = {"train": multi_axis_run((1, 1, 1), "ring_flash", dev, preset,
                                   b, s, steps)}
    if dev.type == "cuda":
        n = 12  # gpt_small's layers
        want = [n, n, n, n, 0, n, 0, n, 0]
        assert all(c == want for c in rec["train"]["per_step"]), (
            rec["train"]["per_step"][0], want)
        torch.cuda.empty_cache()
    # a side check of the local attention, no main path: the entry
    # point runs in the tp and tp4 phases
    rec["ulysses_replay"] = [ulysses_replay(n, dev, b=b, s=s_ulysses)
                             for n in ULYSSES_N]
    rec["moe"] = moe_run(dev, None, b=b, s=s)
    rec["pipeline"] = pipeline_run(dev, None, preset, s=s)
    hvd.shutdown()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log("  parallel: " + json.dumps(rec))
    return rec


TP4_WORKER = r"""
import json, sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import llama3_8b
from horovod_tpu_torch.parallel import tensor_shard_mesh
import chip_smoke as cs

rank, world, store, out, device, preset, b, s = sys.argv[1:9]
rank, world, b, s = int(rank), int(world), int(b), int(s)
cpu = device == "cpu"
if cpu:
    torch.set_num_threads(1)
hvd.init(device="cpu" if cpu else None, rank=rank, size=world,
         init_method="file://" + store)
dev = hvd.device()
cfg = cs.tiny_serving_cfg() if cpu else llama3_8b(dtype=torch.bfloat16)
res = {"serve": [], "train": []}
want = None
for shards in (1, 2, 4):
    mesh = tensor_shard_mesh("tp", shards) if shards > 1 else None
    # the timed runs: the ranks' streams are compared after the run
    rec, streams = cs.serve_sharded(cfg, shards, mesh, dev, want=want,
                                    check=False)
    want = want or streams
    rec["streams"] = streams
    if mesh is not None:  # the step's all-reduces alone, at batch 8
        rec["allreduce_burst"] = cs.allreduce_burst(mesh, dev, cfg)
    res["serve"].append(rec)
    if not cpu:
        torch.cuda.empty_cache()
for impl in ("ulysses", "ring_flash"):
    res["train"].append(cs.multi_axis_run((1, 2, 2), impl, dev, preset,
                                          b=b, s=s))
    if not cpu:
        torch.cuda.empty_cache()
# Ulysses through its entry point over NCCL at n = 4
res["ulysses"] = cs.ulysses_run(
    hvd.global_process_set, dev,
    **(dict(cs.ULYSSES_CPU, b=b) if cpu else dict(b=b)))
res["moe"] = cs.moe_run(dev, hvd.global_process_set, b=b, s=s,
                        x_seed=cs.SEED + rank)
res["pipeline"] = cs.pipeline_run(dev, hvd.global_process_set, preset, s=s)
with open(out, "w") as f:
    json.dump(res, f)
hvd.shutdown()
"""


def phase_tp4(device="cuda", preset="gpt_small", b=TRAIN_B, s=TRAIN_S,
              timeout=1500):
    """Four cards over NCCL (TP4_WORKER; not in the default run):
    llama3_8b served at shards 1, 2 (two engines, ranks {0, 1} and
    {2, 3}) and 4, each run's decode tokens/s, TTFT p50 and per-rank
    peak memory, every rank's streams equal to shards = 1's (tie-aware)
    and across the ranks; the dp x sp x tp trainer at (1, 2, 2) with
    ``ulysses`` and ``ring_flash`` at ``preset``'s widths (step time,
    tokens/s, losses equal on every rank, finite and falling); MoE at
    ep = 4 (each rank its own tokens); the pipeline at pp = 4
    (``preset``'s blocks as four stages, M = 8)."""
    world = 4
    if device == "cuda":
        import torch

        assert torch.cuda.device_count() >= world, (
            f"tp4 needs {world} cards, found {torch.cuda.device_count()}")
        from horovod_tpu_torch.ops import _build

        _build.build_all()
    recs = _spawn(TP4_WORKER, world, [device, preset, b, s], timeout, "tp4")
    for i in range(3):
        runs = [r["serve"][i] for r in recs]
        assert all(r["streams"] == runs[0]["streams"] for r in runs), (
            f"shards={runs[0]['shards']}: ranks' streams differ")
    for i in range(2):
        losses = recs[0]["train"][i]["losses"]
        assert all(r["train"][i]["losses"] == losses for r in recs), \
            "ranks disagree on the trainer's losses"
    rec = dict(
        serve=[{k: v for k, v in r.items() if k != "streams"}
               | {"rank_peak_mem_gb": [x["serve"][i]["peak_mem_gb"]
                                       for x in recs]}
               for i, r in enumerate(recs[0]["serve"])],
        train=[{k: v for k, v in t.items() if k not in ("step_s",
                                                        "per_step")}
               | {"slowest_rank_ms_mean": max(
                   x["train"][i]["step_ms_mean"] for x in recs)}
               for i, t in enumerate(recs[0]["train"])],
        moe=[r["moe"] for r in recs], pipeline=[r["pipeline"] for r in recs],
        ulysses=[r["ulysses"] for r in recs])
    # every rank's launches: the serving kernels over the three serving
    # runs, the training kernels over the trainers and the pipeline
    rec["serve_launches"] = {k: sum(s["launches"][k] for r in recs
                                    for s in r["serve"])
                             for k in recs[0]["serve"][0]["launches"]}
    rec["train_launches"] = {k: sum(t["launches"][k] for r in recs
                                    for t in r["train"] + [r["pipeline"],
                                                           r["ulysses"]])
                             for k in TRAIN_COUNTS}
    log("  tp4: " + json.dumps(rec))
    return rec


# -- phases hier and hier4: the two-level collectives --------------------------

#: ranks a slice (``HVD_TPU_SLICE_SIZE``) in both phases: two slices of two
HIER_SLICE = 2
#: the one-card phase's per-rank batch (four ranks share the card) and steps
HIER_B, HIER_STEPS = 2, 3
HIER4_STEPS = 6
HIER_VARIANTS = ("flat", "flat_lib", "hier", "hier_bf16", "hier_overlap",
                 "zero_hier_ef")
#: ``HOROVOD_HIERARCHICAL_ALLREDUCE`` and ``HVD_TPU_DCN_WIRE_DTYPE`` for
#: each variant's init (the env is read there)
HIER_ENV = {"flat": ("0", ""), "flat_lib": ("0", ""), "hier": ("1", ""),
            "hier_bf16": ("1", "bf16"), "hier_overlap": ("1", ""),
            "zero_hier_ef": ("0", "")}
#: the routed run's loss may drift from the flat run's at most this many
#: times as far as the flat run with the library's own sum drifts (the
#: largest drift of that pair so far, and at least one fp32 step of the
#: loss, 2^-23 relative): both pairs differ only in how the gradients'
#: sums associate
HIER_DRIFT_FACTOR = 8


def _inner_state_bytes(opt):
    """The optimizer's own state bytes (a ZeRO shard's error-feedback
    residual left out)."""
    from horovod_tpu_torch.optim import state_bytes

    return state_bytes([{k: v for k, v in st.items() if k != "dcn_residual"}
                        for st in opt.state.values()])


def _fp32_cross_entropy(logits, labels):
    """The hier phases' loss: the step's cross entropy over its bf16
    logits, in fp32.  They hold the routed losses against the flat ones,
    whose gradients add in another order: a bf16 loss would round their
    last-bit differences to whole bf16 steps of 0.0625 at a loss of
    10."""
    from horovod_tpu_torch.training import softmax_cross_entropy

    return softmax_cross_entropy(logits.float(), labels)


def hier_variant(tag, device, preset="gpt_small", b=HIER_B, s=TRAIN_S,
                 steps=HIER_STEPS):
    """One ``HIER_VARIANTS`` run on this rank: ``preset`` at full width
    (bf16 over fp32 masters from SEED, AdamW at optax's defaults), this
    rank's seeded B x S batch, the loss in fp32, ``steps`` steps through
    ``data_parallel_train_step`` (flat: the flag off; hier: on; bf16:
    on with a bf16 cross wire; overlap: on, buckets from the hooks;
    the init set them, ``HIER_ENV``), the flat step with the library's
    own sum (``flat_lib``: ``grouped_allreduce`` of the gradients, the
    association baseline) or ``zero_train_setup(hierarchical=True,
    dcn_compression=DcnCompression("bfloat16", error_feedback=True))``,
    the training kernels' counts reset just before: losses, launches a
    step, step times, peak memory, optimizer state bytes."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import Transformer, init_params
    from horovod_tpu_torch.models import transformer as tm

    cpu = device.type == "cpu"
    cfg = getattr(tm, preset)(dtype=torch.float32 if cpu else torch.bfloat16,
                              attention_impl="flash")
    model = Transformer(cfg, params=init_params(
        cfg, torch.Generator(device.type).manual_seed(SEED), device=device,
        param_dtype=torch.float32))
    toks = torch.as_tensor(np.random.RandomState(SEED + hvd.rank()).randint(
        0, cfg.vocab_size, size=(b, s + 1)), dtype=torch.long, device=device)
    x, y = toks[:, :-1], toks[:, 1:]
    if tag == "zero_hier_ef":
        state, step = training.zero_train_setup(
            model, _adamw(model.parameters()), loss_fn=_fp32_cross_entropy,
            hierarchical=True, dcn_compression=hvd.DcnCompression(
                "bfloat16", error_feedback=True))
        opt = state.optimizer
        assert opt.tiers is not None and opt.sharded
    elif tag == "flat_lib":
        opt = _adamw(model.parameters())
        state = training.create_train_state(model, opt)
        step = _library_sum_step(model, opt, _fp32_cross_entropy)
    else:
        opt = _adamw(model.parameters())
        state = training.create_train_state(model, opt)
        step = training.data_parallel_train_step(
            model, opt, loss_fn=_fp32_cross_entropy,
            overlap=tag == "hier_overlap")
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    losses, per_step, times = [], [], []
    for _ in range(steps):
        before = _train_counts()
        _sync(device)
        t0 = time.perf_counter()
        state, loss = step(state, x, y)
        _sync(device)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        per_step.append([a - c for a, c in zip(_train_counts(), before)])
    if not cpu:  # every layer's training kernels, the sm90 variants
        n = cfg.num_layers
        want = [n, n, n] + [n, 0] * 3
        assert all(c == want for c in per_step), (tag, per_step, want)
    steady = times[1:]
    rec = dict(tag=tag, batch=[b, s], losses=losses, step_s=times,
               step_ms_mean=1e3 * sum(steady) / len(steady),
               step_ms_median=1e3 * sorted(steady)[len(steady) // 2],
               per_step=per_step,
               launches=dict(zip(TRAIN_COUNTS, _train_counts())),
               opt_state_bytes=_inner_state_bytes(opt),
               peak_mem_gb=None if cpu
               else torch.cuda.max_memory_allocated() / 1e9)
    shapes = [tuple(p.shape) for p in model.parameters()]
    del state, step, model, opt
    gc.collect()  # the reducer's hooks hold the parameters in a cycle
    if not cpu:
        torch.cuda.empty_cache()
    return rec, shapes


def _library_sum_step(model, opt, loss_fn):
    """The flat data-parallel step with the gradients averaged by the
    library's own all-reduce (``grouped_allreduce``: NCCL's ring, or
    gloo's) instead of the rank-ordered sum: the same step, its sums
    associated otherwise."""
    import horovod_tpu_torch as hvd

    def step(state, x, y):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), y)
        loss.backward()
        ps = [p for p in model.parameters() if p.grad is not None]
        for p, g in zip(ps, hvd.grouped_allreduce([p.grad for p in ps],
                                                  op=hvd.Average)):
            p.grad = g
        opt.step()
        return state, hvd.allreduce(loss.detach(), op=hvd.Average)

    return step


def hier_allreduce(shapes, device, timed_reps=0):
    """The gradients' allreduce at ``shapes`` (the model's parameters,
    fp32) through ``allreduce_gradients``: dyadic values (every partial
    sum exact), routed (``hierarchical=True``) and flat, bit-equal; the
    routed call's measured per-tier bytes (the ``torch.distributed``
    calls its primitives recorded as they issued them) and the tier
    counters' increase against the model, bucket by bucket of the
    fusion plan: the counters book the model, the calls move its bytes
    exactly over NCCL, and over gloo the local hop's bytes twice over
    (gloo's stand-in for the reduce-scatter is an all-reduce of the
    whole bucket); the same with a bf16 wire.  With ``timed_reps`` the four ways to reduce them are timed in
    turns (host clock, synchronised, barrier first): NCCL's own
    allreduce of the fused buffers, the flat rank-ordered sum, the
    two-level sum and the two-level sum with a bf16 wire."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import topology
    from horovod_tpu_torch.metrics import instruments as I
    from horovod_tpu_torch.ops import collective_ops as co
    from horovod_tpu_torch.ops import comm_model as cm
    from horovod_tpu_torch.ops.fusion import FusionPlan, fuse, fusion_threshold

    t = topology.tiers()
    world = hvd.size()
    g = torch.Generator(device.type).manual_seed(SEED + hvd.rank())
    grads = [torch.randint(-32, 33, sh, generator=g, device=device).float()
             / 8 for sh in shapes]
    plan = FusionPlan(grads, fusion_threshold())
    sizes = [sum(math.prod(plan.specs[i][0]) for i in idxs)
             for _, idxs in plan.buckets]
    bf16 = hvd.DcnCompression("bfloat16")
    rec = dict(grad_bytes=4 * sum(sizes), buckets=len(sizes),
               n_dcn=t.n_dcn, n_ici=t.n_ici, backend=dist.get_backend())
    # gloo's reduce-scatter over two ranks is an all-reduce of the bucket
    staged = rec["backend"] == "gloo" and t.n_ici == 2
    extra_ici = sum(-(-n // 2) * 2 * 4 // 2 for n in sizes) if staged \
        else 0

    def routed(wire):
        ici, dcn = I.COLLECTIVE_ICI_BYTES.get(), I.COLLECTIVE_DCN_BYTES.get()
        with co.recording() as calls:
            out = hvd.allreduce_gradients(grads, op=hvd.Sum,
                                          hierarchical=True,
                                          dcn_compression=wire)
        _sync(device)
        meas = cm.measured_tier_bytes(calls, t.slice_ids())
        model = [cm.modeled_collective_bytes(
            (n,), world, t.n_ici, None if wire is None else "bfloat16")
            for n in sizes]
        want = [sum(m[k] for m in model) for k in ("ici_bytes", "dcn_bytes")]
        got = [meas["ici_bytes"], meas["dcn_bytes"]]
        counted = [I.COLLECTIVE_ICI_BYTES.get() - ici,
                   I.COLLECTIVE_DCN_BYTES.get() - dcn]
        assert counted == want, (counted, want)
        assert got == [want[0] + extra_ici, want[1]], (got, want, extra_ici)
        return out, dict(modeled=want, measured=got, counters=counted,
                         measured_minus_modeled=[got[0] - want[0],
                                                 got[1] - want[1]],
                         calls=len(calls),
                         ops=sorted({o["op"] + ":" + o["tier"]
                                     for o in meas["ops"]}))

    hier, rec["fp32_bytes"] = routed(None)
    flat = hvd.allreduce_gradients(grads, op=hvd.Sum, hierarchical=False)
    _sync(device)
    assert all(torch.equal(a, c) for a, c in zip(hier, flat)), \
        "routed and flat dyadic sums differ"
    del hier, flat
    _, rec["bf16_bytes"] = routed(bf16)
    rec["bit_equal"] = True
    if timed_reps:
        def nccl():
            bufs = fuse(grads, plan)
            for w in [dist.all_reduce(b, async_op=True) for b in bufs]:
                w.wait()
            return bufs

        ways = {"nccl": nccl,
                "ordered": lambda: hvd.allreduce_gradients(
                    grads, op=hvd.Sum, hierarchical=False),
                "two_level": lambda: hvd.allreduce_gradients(
                    grads, op=hvd.Sum, hierarchical=True),
                "two_level_bf16": lambda: hvd.allreduce_gradients(
                    grads, op=hvd.Sum, hierarchical=True,
                    dcn_compression=bf16)}
        order = list(ways) + list(ways)[::-1]
        timing = {k: [] for k in ways}
        for i in range(timed_reps * len(order)):
            name = order[i % len(order)]
            _sync(device)
            dist.barrier()
            _sync(device)
            t0 = time.perf_counter()
            ways[name]()
            _sync(device)
            timing[name].append(time.perf_counter() - t0)
        rec["allreduce_s"] = timing
    del grads
    return rec


HIER_WORKER = r"""
import json, os, sys
import torch
os.environ["HVD_TPU_SLICE_SIZE"] = sys.argv[9]
import horovod_tpu_torch as hvd
import chip_smoke as cs

rank, world, store, out, device, backend, b, steps = sys.argv[1:9]
rank, world, b, steps = int(rank), int(world), int(b), int(steps)
cpu = device == "cpu"
if cpu:
    torch.set_num_threads(1)


def start(tag, flag, wire):
    # the flag and the wire are read at init: one init a setting
    os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = flag
    os.environ["HVD_TPU_DCN_WIRE_DTYPE"] = wire
    hvd.init(device=device, rank=rank, size=world,
             init_method="file://" + store + "." + tag, backend=backend)
    return hvd.device()


preset = "gpt_tiny" if cpu else "gpt_small"
s = 16 if cpu else cs.TRAIN_S
res = {"variants": {}}
for tag in cs.HIER_VARIANTS:
    dev = start(tag, *cs.HIER_ENV[tag])
    res["variants"][tag], shapes = cs.hier_variant(tag, dev, preset, b, s,
                                                   steps)
    hvd.shutdown()
dev = start("allreduce", "0", "")
res["allreduce"] = cs.hier_allreduce(shapes, dev,
                                     timed_reps=int(sys.argv[10]))
with open(out, "w") as f:
    json.dump(res, f)
hvd.shutdown()
"""


def _hier_checks(recs, name):
    """The hier phases' checks over every rank's record: losses equal
    across ranks, finite and falling; hierarchical fp32 within
    ZERO_LOSS_REL_TOL of flat over the first HIER_STEPS steps, and at
    every step within HIER_DRIFT_FACTOR times the drift of the flat
    step with the library's sum (``flat_lib``) from the flat one (the
    pairs differ only in how the gradients' sums associate, a
    difference that grows step by step through the bf16 forward; every
    step's reading and bound is recorded); overlapped hierarchical
    bit-identical to plain; the ZeRO shard's optimizer state half the replicated one
    (two ranks a slice, give or take the padding and its step
    scalars); the allreduce checks ran on every rank.  Returns the
    phase's record."""
    var = {}
    for tag in HIER_VARIANTS:
        losses = recs[0]["variants"][tag]["losses"]
        for r in recs[1:]:
            assert r["variants"][tag]["losses"] == losses, (
                f"{name} {tag}: ranks disagree on the losses")
        assert all(math.isfinite(v) for v in losses), (tag, losses)
        assert losses[-1] < losses[0], f"{name} {tag}: {losses}"
        v = recs[0]["variants"][tag]
        var[tag] = dict(losses=losses, step_ms_mean=v["step_ms_mean"],
                        step_ms_median=v["step_ms_median"],
                        slowest_rank_ms_mean=max(
                            r["variants"][tag]["step_ms_mean"] for r in recs),
                        launches_per_step=v["per_step"][0],
                        opt_state_bytes=v["opt_state_bytes"],
                        peak_mem_gb=[r["variants"][tag]["peak_mem_gb"]
                                     for r in recs])
    flat = var["flat"]["losses"]
    by_step = {tag: [abs(a - c) / abs(c) for a, c in
                     zip(var[tag]["losses"], flat)]
               for tag in HIER_VARIANTS if tag != "flat"}
    errs = {tag: max(e[:HIER_STEPS]) for tag, e in by_step.items()}
    assert errs["hier"] <= ZERO_LOSS_REL_TOL, (var["hier"]["losses"], flat)
    base = by_step["flat_lib"]
    bound = [HIER_DRIFT_FACTOR * max(max(base[:k + 1]), 2.0 ** -23)
             for k in range(len(base))]
    assert all(e <= b for e, b in zip(by_step["hier"], bound)), (
        f"{name}: routed drift {by_step['hier']} against the library "
        f"sum's {base} (bounds {bound})")
    assert var["hier_overlap"]["losses"] == var["hier"]["losses"], (
        var["hier_overlap"]["losses"], var["hier"]["losses"])
    zero, rep = (var["zero_hier_ef"]["opt_state_bytes"],
                 var["hier"]["opt_state_bytes"])
    assert abs(zero - rep / HIER_SLICE) <= 1024, (zero, rep)
    assert var["flat_lib"]["opt_state_bytes"] == rep
    assert all(r["allreduce"]["bit_equal"] for r in recs)
    a = recs[0]["allreduce"]
    rec = dict(variants=var, loss_rel_err_vs_flat=errs,
               loss_rel_tol=ZERO_LOSS_REL_TOL,
               loss_rel_err_vs_flat_by_step=by_step,
               routed_drift_bound_by_step=bound,
               zero_state_over_replicated=zero / rep,
               allreduce={k: v for k, v in a.items() if k != "allreduce_s"},
               launches={k: sum(r["variants"][tag]["launches"][k]
                                for r in recs for tag in HIER_VARIANTS)
                         for k in TRAIN_COUNTS})
    if "allreduce_s" in a:
        rec["allreduce_ms_median"] = {
            k: sorted(v)[len(v) // 2] * 1e3 for k, v in
            a["allreduce_s"].items()}
        rec["allreduce_ms_all"] = {k: [x * 1e3 for x in v] for k, v in
                                   a["allreduce_s"].items()}
    return rec


def phase_hier(device="cuda", b=HIER_B, steps=HIER_STEPS, timeout=900):
    """The two-level collectives on ONE card (HIER_WORKER): four ranks,
    one process each, over gloo (NCCL refuses two ranks on one card),
    two slices of two (``HVD_TPU_SLICE_SIZE=2``,
    ``HOROVOD_HIERARCHICAL_ALLREDUCE=1``); gpt_small at full width and
    depth, B = 2 x S = 2048 a rank, through every ``HIER_VARIANTS`` run,
    ``_hier_checks``, and the dyadic allreduce at gpt_small's parameter
    shapes (``hier_allreduce``).  Gloo stages every collective through
    the host: the times are no measure of the two-level path."""
    if device == "cuda":
        import torch

        from horovod_tpu_torch.ops import _build

        _build.build_all()
        gc.collect()
        torch.cuda.empty_cache()
    dev = "cpu" if device == "cpu" else "cuda:0"
    recs = _spawn(HIER_WORKER, 4, [dev, "gloo", b, steps, HIER_SLICE, 0],
                  timeout, "hier")
    rec = _hier_checks(recs, "hier")
    rec["note"] = ("four ranks on one card over gloo: every collective "
                   "stages through the host; no time here measures the "
                   "two-level path")
    log("  hier: " + json.dumps(rec))
    return rec


def phase_hier4(device="cuda", b=TRAIN_B, steps=HIER4_STEPS, reps=4,
                timeout=1500):
    """The two-level collectives on FOUR cards over NCCL (HIER_WORKER;
    not in the default run): the hier phase's runs and checks at
    B = 8 x S = 2048 a rank, their step times, and the gradients'
    allreduce at gpt_small's parameter shapes timed in turns: NCCL's
    flat allreduce, the flat rank-ordered sum, the two-level sum and
    the two-level sum with a bf16 wire, with the two-level calls'
    per-tier bytes.  One NVLink box: both tiers are NVLink."""
    world = 4
    if device == "cuda":
        import torch

        assert torch.cuda.device_count() >= world, (
            f"hier4 needs {world} cards, found {torch.cuda.device_count()}")
        from horovod_tpu_torch.ops import _build

        _build.build_all()
    backend = "gloo" if device == "cpu" else "nccl"
    recs = _spawn(HIER_WORKER, world, [device, backend, b, steps,
                                       HIER_SLICE, reps], timeout, "hier4")
    rec = _hier_checks(recs, "hier4")
    log("  hier4: " + json.dumps(rec))
    return rec


PHASES = ("kernels", "serving", "tp", "oracle", "spec", "disagg",
          "training", "overlap", "zero", "training_oracle", "remat",
          "resnet", "resnet_oracle", "pipeline", "ring", "parallel",
          "guard", "elastic", "observe", "hier")


BN_ENTRIES = (("bn_stats", "stats", 77, ("mean", "var")),
              ("bn_apply", "apply", 89, ("y",)),
              ("bn_bwd_reduce", "bwd_reduce", 99, ("dbeta", "dgamma")),
              ("bn_dx", "dx", 116, ("dx",)))


def bn_entries(bn_kern, resnet):
    """The fused-norm kernels' entries: ``launches`` summed over the
    main paths' runs in ``resnet`` (the resnet, pipeline and observe
    phases);
    ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` summed
    over ResNet-50's 53 sites at batch 128 (each site shape's bf16 case
    times its count: one training step's worth), ``library_ms``
    ``torch.var_mean`` beside stats (its function in one call), the
    forward (apply) or backward (bwd_reduce, dx) of the library's BN
    composite beside the others; ``max_abs_err`` over every fused-norm
    case."""
    entries = []
    for name, key, line, outs in BN_ENTRIES:
        runs = [r for r in resnet if r]
        e = dict(name=name, route="cuda",
                 source="horovod_tpu_torch/csrc/fused_norm.cu",
                 replaces=f"horovod_tpu/ops/fused_norm.py:{line}",
                 launches=sum(r["launches"][name] for r in runs)
                 if runs else None,
                 max_abs_err=None, ms=None, plain_ms=None, bound_ms=None,
                 bound_by=None, library_ms=None)
        if bn_kern:
            main = [r for r in bn_kern if r["sites"]]
            total = lambda f: sum(r["sites"] * f(r) for r in main)  # noqa
            lib = {"stats": lambda r: r["stats"]["var_mean_ms"],
                   "apply": lambda r: r["library_fwd_ms"]}.get(
                       key, lambda r: r["library_bwd_ms"])
            by = _bound(total(lambda r: r[key]["bound_bytes_ms"]),
                        total(lambda r: r[key]["bound_ops_ms"]))[1]
            bnd = total(lambda r: r[key]["bound_ms"])
            e.update(max_abs_err=max(r["errors"][o]["abs"] for r in bn_kern
                                     for o in outs),
                     ms=total(lambda r: r[key]["kernel_ms"]),
                     plain_ms=total(lambda r: r[key]["plain_ms"]),
                     bound_ms=bnd, bound_by=by,
                     library_ms=total(lib))
        entries.append(e)
    return entries


def kernel_entries(kern, train_kern, serving, train, train_oracle, oracle,
                   serving_runs=()):
    """The ``kernels`` JSON line: one entry per kernel and C entry.  The
    forward has two: ``flash_fwd_sm90`` (its numbers at the training
    forward's shape, gpt_small bf16: the main path's) and
    ``flash_fwd_simt`` (at llama3_8b's gathered decode,
    ``decode_gqa_bf16``); dq and dkv two each: ``*_sm90`` at gpt_small's
    bf16 backward (the training run's launches) and ``*_simt`` at
    gpt_small's fp32 backward; ``flash_decode_paged`` at
    ``decode_paged_gqa_bf16`` (serving's launches).  ``launches`` come
    from the main paths' runs (the forwards: serving's, the spec and
    disagg phases' (``serving_runs``) and training's; the simt kernels'
    from the fp32 oracles, the paths that run them; the paged decode:
    serving's, spec's and disagg's),
    the other numbers from the kernel phase; ``max_abs_err`` over every
    kernel-phase case of that kernel and variant; a phase left out by
    ``--phases`` leaves its numbers null."""
    main = train_kern[0] if train_kern else None
    at_case = {(r["case"], r["dtype"]): r for r in train_kern or ()}
    bwd_at = {"sm90": at_case.get(("gpt_small_causal", "bfloat16")),
              "simt": at_case.get(("gpt_small_causal", "float32"))}
    fwd_launches = {}
    more = [r["launches"] for r in serving_runs if r]
    for variant in ("sm90", "simt"):
        runs = [(serving or {}).get("launches_by_variant", {}).get(variant),
                *(m[f"flash_fwd_{variant}"] for m in more),
                *((r or {}).get("launches", {}).get(f"flash_fwd_{variant}")
                  for r in (train, train_oracle if variant == "simt" else None,
                            oracle if variant == "simt" else None))]
        if any(n is not None for n in runs):
            fwd_launches[variant] = sum(n or 0 for n in runs)
    decode = next((r for r in kern or () if r["case"] == "decode_gqa_bf16"),
                  None)
    entries = []
    for name, key, variant, src, line in (
            ("flash_fwd_sm90", "fwd", "sm90", "flash_fwd_sm90.cu", 104),
            ("flash_fwd_simt", "fwd", "simt", "flash_fwd.cu", 104),
            ("flash_bwd_dq_sm90", "dq", "sm90", "flash_bwd_sm90.cu", 301),
            ("flash_bwd_dkv_sm90", "dkv", "sm90", "flash_bwd_sm90.cu", 342),
            ("flash_bwd_dq_simt", "dq", "simt", "flash_bwd.cu", 301),
            ("flash_bwd_dkv_simt", "dkv", "simt", "flash_bwd.cu", 342)):
        if key == "fwd":
            launches = fwd_launches.get(variant)
        else:
            run = train if variant == "sm90" else train_oracle
            launches = run["launches"][name] if run else None
        e = dict(name=name, route="cuda",
                 source=f"horovod_tpu_torch/csrc/{src}",
                 replaces=f"horovod_tpu/ops/flash_attention.py:{line}",
                 launches=launches, max_abs_err=None, ms=None,
                 plain_ms=None, bound_ms=None, bound_by=None,
                 library_ms=None)
        at = None
        if key == "fwd" and kern and train_kern:
            errs = [r["errors"][o]["abs"] for r in train_kern
                    if r["variant"] == variant for o in ("o", "lse")]
            errs += [r["max_abs_err"] for r in kern
                     if r["variant"] == variant]
            at = main["fwd"] if variant == "sm90" else dict(
                kernel_ms=decode["kernel_ms"], plain_ms=decode["plain_ms"],
                bound_ms=decode["bound_ms"], bound_by=decode["bound_by"],
                library_ms=decode["library_ms"])
        elif key != "fwd" and bwd_at[variant]:
            errs = [r["errors"][o]["abs"] for r in train_kern
                    if r["variant"] == variant
                    for o in {"dq": ("dq",), "dkv": ("dk", "dv")}[key]]
            at = bwd_at[variant][key]
        if at:
            e.update(max_abs_err=max(errs), ms=at["kernel_ms"],
                     plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
                     bound_by=at["bound_by"], library_ms=at["library_ms"])
        entries.append(e)
    # the paged decode: serving's decode steps; its numbers at
    # decode_paged_gqa_bf16, library = SDPA on the already-gathered K/V
    e = dict(name="flash_decode_paged", route="cuda",
             source="horovod_tpu_torch/csrc/flash_decode.cu",
             replaces="horovod_tpu/ops/flash_attention.py:104",
             launches=(serving["paged_decode_launches"] if serving else 0)
             + sum(m["flash_decode_paged"] for m in more)
             if serving or more else None,
             max_abs_err=None, ms=None, plain_ms=None, bound_ms=None,
             bound_by=None, library_ms=None)
    paged = [r for r in kern or () if r.get("kernel") == "flash_decode_paged"]
    at = next((r for r in paged if r["case"] == "decode_paged_gqa_bf16"),
              None)
    if at:
        e.update(max_abs_err=max(r["max_abs_err"] for r in paged),
                 ms=at["kernel_ms"], plain_ms=at["plain_ms"],
                 bound_ms=at["bound_ms"], bound_by=at["bound_by"],
                 library_ms=at["library_ms"])
    entries.append(e)
    return entries


def _tp4_launches(tp4):
    """The serving kernels' launches over tp4's sharded serving runs."""
    return {"launches": tp4["serve_launches"]} if tp4 else None


OFFSET_ENTRIES = (
    ("flash_fwd_sm90_kv_offset", "fwd", "sm90", "flash_fwd_sm90.cu", 104),
    ("flash_fwd_simt_kv_offset", "fwd", "simt", "flash_fwd.cu", 104),
    ("flash_bwd_dq_sm90_kv_offset", "dq", "sm90", "flash_bwd_sm90.cu", 301),
    ("flash_bwd_dkv_sm90_kv_offset", "dkv", "sm90", "flash_bwd_sm90.cu",
     342),
    ("flash_bwd_dq_simt_kv_offset", "dq", "simt", "flash_bwd.cu", 301),
    ("flash_bwd_dkv_simt_kv_offset", "dkv", "simt", "flash_bwd.cu", 342))
_OUTPUTS = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}


def offset_entries(b9, ring, ring4):
    """The ``kernels`` line's entries for the kernels at a non-zero
    uniform kv_offset (B9): ``launches`` those of the ring phase's runs
    (and ring4's when it ran), the other numbers from the B9 case of the
    ring's own off-diagonal call at gpt_small's shard (``gpt_small_past``:
    bf16 for sm90, fp32 for simt); ``max_abs_err`` over every B9 case of
    that kernel and variant."""
    at = {r["dtype"]: r for r in b9 or () if r["case"] == "gpt_small_past"}
    entries = []
    for name, key, variant, src, line in OFFSET_ENTRIES:
        runs = [r["offset_launches"] for r in ring or ()]
        if ring4:
            runs.append(ring4["offset_launches"])
        e = dict(name=name, route="cuda",
                 source=f"horovod_tpu_torch/csrc/{src}",
                 replaces=f"horovod_tpu/ops/flash_attention.py:{line}",
                 launches=sum(r[f"{key}_{variant}"] for r in runs)
                 if runs else None,
                 max_abs_err=None, ms=None, plain_ms=None, bound_ms=None,
                 bound_by=None, library_ms=None)
        case = at.get("bfloat16" if variant == "sm90" else "float32")
        if case:
            e.update(max_abs_err=max(r["errors"][o]["abs"] for r in b9
                                     if r["variant"] == variant
                                     for o in _OUTPUTS[key]),
                     ms=case[key]["kernel_ms"], plain_ms=case[key]["plain_ms"],
                     bound_ms=case[key]["bound_ms"],
                     bound_by=case[key]["bound_by"],
                     library_ms=case[key]["library_ms"])
        entries.append(e)
    return entries


_T0 = time.perf_counter()


def _phase(name):
    """Log a phase's start with the seconds since the script began."""
    log(f"phase {name}: (at {time.perf_counter() - _T0:.0f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--roots", default=HERE,
                    help="dp4: package roots to run in turns, comma-"
                         "separated (e.g. parent,.,.,parent)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from horovod_tpu_torch.ops import _build
        from horovod_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 1
    card = card_line()
    log(f"device: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_build.build_seconds:.1f}s)")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if any(w in line for w in ("Used", "spill", "Performance",
                                       "warning")):
                log(f"  {name}: {line.strip()}")
    kern = train_kern = bn_kern = serving = train = resnet = None
    train_oracle = remat = pipeline = b9 = ring = ring4 = None
    if "kernels" in phases:
        _phase("kernels")
        kern = phase_kernels()
        train_kern = phase_train_kernels()
        b9 = phase_b9_kernels()
        bn_kern = phase_bn_kernels()
    tp = parallel = tp4 = None
    if {"serving", "tp"} & set(phases):
        # the tp phase holds its streams against the serving phase's
        _phase("serving")
        serving = phase_serving()
    if "tp" in phases:
        _phase("tp")
        tp = phase_tp(serving)
    oracle = spec = disagg = None
    if "oracle" in phases:
        _phase("oracle")
        oracle = phase_oracle()
    if "spec" in phases:
        _phase("spec")
        spec = phase_spec()
    if "disagg" in phases:
        _phase("disagg")
        disagg = phase_disagg()
    overlap = zero = None
    if {"training", "overlap", "zero"} & set(phases):
        # the overlap and zero phases are held against its losses
        _phase("training")
        train = phase_training()
    if "overlap" in phases:
        _phase("overlap")
        overlap = phase_overlap(train)
    if "zero" in phases:
        _phase("zero")
        zero = phase_zero(train)
    if "training_oracle" in phases:
        _phase("training_oracle")
        train_oracle = phase_training_oracle()
    if "remat" in phases:
        _phase("remat")
        remat = phase_remat()
    if "resnet" in phases:
        _phase("resnet")
        resnet = phase_resnet()
    if "resnet_oracle" in phases:
        _phase("resnet_oracle")
        phase_resnet_oracle()
    if "pipeline" in phases:
        _phase("pipeline")
        pipeline = phase_pipeline(resnet)
    if "ring" in phases:
        _phase("ring")
        ring = phase_ring()
    if "parallel" in phases:
        _phase("parallel")
        parallel = phase_parallel()
    guard = elastic = None
    if "guard" in phases:
        _phase("guard")
        guard = phase_guard()
    if "elastic" in phases:
        _phase("elastic")
        elastic = phase_elastic()
    observe = None
    if "observe" in phases:
        _phase("observe")
        observe = phase_observe(serving)
    if "dp4" in phases:
        _phase("dp4")
        phase_dp4(args.roots.split(","))
    if "ring4" in phases:
        _phase("ring4")
        ring4 = phase_ring4()
    if "tp4" in phases:
        _phase("tp4")
        tp4 = phase_tp4()
    hier = hier4 = None
    if "hier" in phases:
        _phase("hier")
        hier = phase_hier()
    if "hier4" in phases:
        _phase("hier4")
        hier4 = phase_hier4()
    runs = [r for r in (train, overlap, zero, remat, guard, elastic) if r]
    if parallel:  # the trainer and the pipeline (the replays are checks)
        runs += [parallel["train"], parallel["pipeline"]]
    if tp:  # ulysses_attention on both ranks
        runs.append({"launches": tp["ulysses_launches"]})
    if tp4:  # every rank's trainers, pipeline and ulysses_attention
        runs.append({"launches": tp4["train_launches"]})
    runs += [r for r in (hier, hier4) if r]  # every rank's variants
    if runs:  # the training kernels ran on these main paths
        train = dict(train or {}, launches={k: sum(
            r["launches"][k] for r in runs) for k in TRAIN_COUNTS})
    entries = (kernel_entries(kern, train_kern, serving, train,
                              train_oracle, oracle,
                              (spec, disagg, tp, _tp4_launches(tp4)))
               + offset_entries(b9, ring, ring4)
               + bn_entries(bn_kern, (resnet, pipeline, observe)))
    log(f"done: {time.perf_counter() - _T0:.0f} s")
    log(card)
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
