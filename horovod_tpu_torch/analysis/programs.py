"""Program-contract verifier (pass ``programs``) over the calls as issued.

Port of ``horovod_tpu/analysis/programs.py``.  The source passes read
source; this one runs the package's training and serving steps and
machine-checks the invariants the docs promise in prose:

* **zero-added-collectives** — the integrity guard and the tracer are
  pure observers: ``guard=False`` and ``HVD_TPU_GUARD=0`` issue the
  same collectives, ``guard=True`` adds none (plain and ZeRO steps),
  and tracing on and off issue the same collectives
  (docs/FAULT_TOLERANCE.md, docs/TRACING.md).
* **serving DCN-exclusion** — no collective of a serving step (decode,
  mixed, speculative verify; every tier, shards 1 and 2) has a group
  spanning more than one slice: the token loop never crosses the cross
  tier (docs/SERVING.md sharding section).
* **modeled == measured** — ``ops/comm_model``'s modeled per-tier bytes
  equal the bytes of the calls issued, per serving step and for the
  two-level allreduce (docs/COLLECTIVES.md).
* **zero-recompile** — under a randomized request load, every step key
  the engine dispatches is in the menu ``warmup()`` booked, and
  ``program_count`` stays where warmup left it (docs/SERVING.md menu
  contract).
* **overlap interleave** — the overlapped train step launches gradient
  buckets from inside the backward, not all after it
  (docs/tensor-fusion.md).

The JAX pass reads the StableHLO the framework lowers; eager PyTorch
lowers nothing, so each invariant is checked on what the steps issue
when they run:

* ``collective_ops.recording()``'s records: one per ``torch.distributed``
  call, with its op, its bytes and its group's world ranks
  (``comm_model.collective_record``).  Two steps "issue the same
  collectives" when their record sequences are equal entry by entry
  (:func:`check_identical`).  That takes the place of the JAX pass's
  sha256 over lowered text, which has no torch counterpart: there is no
  program text to hash, and the record is what an observer could add
  to or change.
* the overlapped reducer's launch record (``step.reducer.last_record``)
  for the interleave, read by ``comm_model.overlap_inventory``.
* the serving engine's step-key book (``ServingEngine._progs``,
  ``program_count``, ``warmup()``).  The JAX contract has two halves:
  no off-menu key, and no XLA compile under load.  The port compiles no
  program per key (its kernels are built once, at ``warmup``), so the
  second half stands as the book's size: ``program_count`` may not grow
  under load.

Each leg runs in processes of its own, one per rank, over gloo: the
training leg at world 2; the two-level allreduce and serving at world 4
with ``HVD_TPU_SLICE_SIZE=2`` (two slices of two, so a group that
crossed slices would show; a job whose topology is not two slices is
a finding, not an empty leg).  ``device`` places every rank on one card
(``"cuda:0"``, the default: the ranks share it, over gloo), where the
training leg's flash kernels launch, or, when the caller asks, on the
CPU (``"cpu"``; the CLI's ``--device cpu``).  Asking for the card where
there is none raises, as the package's entry points do.

Unlike the source passes this one needs torch and the package's runtime,
so it is GATED: inside ``run_all`` it reports nothing unless
``HVD_TPU_VERIFY_PROGRAMS=1`` is set.  The check helpers are plain
Python over records, so the tests feed them synthetic drift.

Suppression: the allowlist file, with the finding's key (generated
calls have no source line to mark).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ._common import PORT, Finding, Layout

CHECK = "programs"

#: env gate: the verification only runs when this is "1"
ENV_GATE = "HVD_TPU_VERIFY_PROGRAMS"

ENGINE_PY = "horovod_tpu_torch/serving/engine.py"
TRAINING_PY = "horovod_tpu_torch/training.py"
HIERARCHICAL_PY = "horovod_tpu_torch/ops/hierarchical.py"

#: each leg's job: (name, world, extra environment)
JOBS = (("training", 2, {}),
        ("hierarchical+serving", 4, {"HVD_TPU_SLICE_SIZE": "2"}))
#: a job's ranks that have not exited by then fail it
JOB_TIMEOUT_S = 600.0

Records = Sequence[Dict[str, object]]


def collective_count(records: Records) -> int:
    """Collectives issued: one record per ``torch.distributed`` call."""
    return len(records)


# -- pure check helpers (synthetic-testable) ---------------------------------


def check_identical(name: str, baseline: Records, candidate: Records,
                    file: str = TRAINING_PY) -> List[Finding]:
    """The strongest no-op claim: the two steps issue the SAME calls,
    record for record (op, bytes, group), in the same order."""
    if list(baseline) == list(candidate):
        return []
    added = collective_count(candidate) - collective_count(baseline)
    first = next((i for i, (a, b) in enumerate(zip(baseline, candidate))
                  if a != b), min(len(baseline), len(candidate)))
    return [Finding(
        CHECK, file, 0, f"identical:{name}",
        f"{name}: issued collectives differ (first at call {first}, "
        f"{added:+d} collective(s)) — the no-op path must issue the "
        "same calls as the baseline",
    )]


def check_added_collectives(name: str, baseline: Records,
                            candidate: Records, budget: int = 0,
                            file: str = TRAINING_PY) -> List[Finding]:
    """The candidate step may issue at most ``budget`` (default 0)
    collectives more than the baseline."""
    added = collective_count(candidate) - collective_count(baseline)
    if added <= budget:
        return []
    return [Finding(
        CHECK, file, 0, f"added-collectives:{name}",
        f"{name}: {added} collective(s) added over the baseline "
        f"(budget {budget}) — observers must not grow the collective "
        "inventory (the exchange rides the host control plane)",
    )]


def check_dcn_exclusion(name: str, records: Records,
                        slice_ids: Sequence[int],
                        file: str = ENGINE_PY) -> List[Finding]:
    """No collective group of a serving step may span >1 slice of
    ``slice_ids`` (world rank -> slice) — the cross tier stays out of
    the token loop."""
    from ..ops.comm_model import measured_tier_bytes

    out: List[Finding] = []
    inv = measured_tier_bytes(records, slice_ids)
    for op in inv["ops"]:
        if op["tier"] == "dcn":
            out.append(Finding(
                CHECK, file, 0, f"serve-dcn:{name}:{op['op']}",
                f"{name}: {op['op']} (payload {op['payload_bytes']} B, "
                f"group size {op['group_size']}) spans >1 slice — a "
                "serving step collective crossed onto DCN; the token "
                "loop must stay inside one ICI slice "
                "(docs/SERVING.md)",
            ))
    return out


def check_menu_keys(name: str, warmed: Iterable[tuple],
                    dispatched: Iterable[tuple],
                    file: str = ENGINE_PY) -> List[Finding]:
    """Every step key dispatched under load must be in the warmup
    menu — an off-menu key is a step the menu never prepared."""
    extra = sorted(set(dispatched) - set(warmed), key=repr)
    return [Finding(
        CHECK, file, 0, f"off-menu:{name}:{'-'.join(map(str, key))}",
        f"{name}: program key {key!r} dispatched but never warmed — a "
        "mid-traffic compile (multi-second p99 spike); the tier menu "
        "must cover every reachable (kind, tier...) combination",
    ) for key in extra]


def check_modeled_measured(name: str, modeled: Dict[str, int],
                           measured: Dict[str, int],
                           file: str = HIERARCHICAL_PY) -> List[Finding]:
    """Per-tier modeled bytes must equal the issued calls' bytes, key by
    key (keys present in ``modeled`` are compared)."""
    out: List[Finding] = []
    for tier, want in modeled.items():
        got = measured.get(tier)
        if got != want:
            out.append(Finding(
                CHECK, file, 0, f"model-mismatch:{name}:{tier}",
                f"{name}: modeled {tier} = {want} B but the issued "
                f"calls measure {got} B — comm_model and the "
                "collectives issued disagree "
                "(docs/COLLECTIVES.md byte model)",
            ))
    return out


def check_overlap(name: str, inventory: Dict[str, object],
                  file: str = TRAINING_PY) -> List[Finding]:
    """``comm_model.overlap_inventory``'s verdict on one overlapped
    step: some bucket must launch with backward compute still to come,
    and not every streamed byte may trail the backward."""
    if inventory["interleaved"] and inventory["exposed_fraction"] < 1.0:
        return []
    return [Finding(
        CHECK, file, 0, f"overlap-trailing:{name}",
        "overlapped train step launches every collective trailing the "
        f"backward (exposed_fraction={inventory['exposed_fraction']}) — "
        "the bucket-boundary schedule is not interleaving "
        "(docs/tensor-fusion.md)",
    )]


# -- the PASSES entry --------------------------------------------------------


def run(root: str, layout: Layout = PORT,
        device: str = "cuda:0") -> List[Finding]:
    """Gated: the plain checker sees an empty pass;
    ``HVD_TPU_VERIFY_PROGRAMS=1`` with torch importable runs
    :func:`verify` on ``device`` and prints one line a leg to stderr.
    No card where one was asked for is a finding."""
    if os.environ.get(ENV_GATE, "") != "1":
        return []
    try:
        import torch  # noqa: F401
    except Exception:
        return [Finding(
            CHECK, "pyproject.toml", 0, "no-torch",
            f"{ENV_GATE}=1 but torch is not importable — run this pass "
            "from an environment with the package installed",
        )]
    report: List[dict] = []
    try:
        findings = verify(root, device=device, report=report)
    except RuntimeError as e:
        return [Finding(CHECK, "pyproject.toml", 0, "no-card", str(e))]
    for leg in report:
        print(f"programs: {leg['leg']} leg, world {leg['world']} on "
              f"{leg['device']}: {leg['checks']} check(s), "
              f"{leg['findings']} finding(s) ({leg['seconds']:.1f} s)",
              file=sys.stderr)
    return findings


# -- the verification (torch and the package's runtime) ----------------------


class _Leg:
    """One leg's findings, the checks it ran and its clock."""

    def __init__(self, name: str):
        self.name = name
        self.findings: List[Finding] = []
        self.checks = 0
        self.t0 = time.perf_counter()

    def add(self, found: List[Finding]) -> None:
        self.checks += 1
        self.findings += found

    def result(self, **extra) -> dict:
        return dict(leg=self.name, checks=self.checks,
                    findings=[f.__dict__ for f in self.findings],
                    seconds=time.perf_counter() - self.t0, **extra)


def _serve_load(rs, n: int, max_seq_len: int) -> List[Tuple[list, int]]:
    """Randomized (prompt, max_new_tokens) pairs with a templated
    prefix mix (prefix-cache hits AND misses both exercised)."""
    templates = [list(rs.randint(1, 100, size=rs.randint(4, 20)))
                 for _ in range(4)]
    load = []
    for _ in range(n):
        head = templates[rs.randint(len(templates))] if rs.rand() < 0.5 \
            else []
        tail = list(rs.randint(1, 100, size=rs.randint(2, 12)))
        prompt = (head + tail)[:max_seq_len // 2]
        gen = int(rs.randint(1, 9))
        load.append((prompt, gen))
    return load


def _drive(eng, load) -> None:
    import numpy as np

    ids = [eng.submit(np.asarray(p, np.int32), max_new_tokens=g)
           for p, g in load]
    eng.run()
    assert all(r in eng.results for r in ids)


def _issued(fn) -> list:
    """The records of the collectives ``fn()`` issues."""
    from ..ops import collective_ops

    with collective_ops.recording() as records:
        fn()
    return list(records)


def _train_counts() -> Dict[str, int]:
    """Launches of the flash training kernels in this process."""
    from ..ops import flash_attention as fa

    return {"flash_fwd": fa.flash_fwd_cuda.launches,
            "flash_bwd_dq": fa.flash_bwd_dq_cuda.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv_cuda.launches}


def _verify_training(device: str) -> dict:
    """Guard/trace identity, zero-added-collectives (plain and ZeRO
    steps) and the overlap interleave, each step run once on this
    rank's shard of a fixed batch."""
    import numpy as np
    import torch

    from .. import trace, training
    from ..common import basics
    from ..models.transformer import Transformer, TransformerConfig, \
        init_params
    from ..ops.comm_model import overlap_inventory

    leg = _Leg("training")
    before = _train_counts()
    cfg = TransformerConfig(
        vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
        max_seq_len=16, dtype=torch.float32, attention_impl="flash",
        causal=True)
    world, rank = basics.size(), basics.rank()
    batch = max(world, 8)
    rs = np.random.RandomState(0)
    x = rs.randint(1, cfg.vocab_size, size=(batch, cfg.max_seq_len))
    y = rs.randint(0, cfg.vocab_size, size=(batch, cfg.max_seq_len))
    per = batch // world
    x = torch.as_tensor(x[rank * per:(rank + 1) * per], device=device)
    y = torch.as_tensor(y[rank * per:(rank + 1) * per], device=device)
    gen_dev = torch.device(device)

    def fresh():
        """A model with the same weights every time, and its AdamW."""
        gen = torch.Generator(device=gen_dev).manual_seed(0)
        model = Transformer(cfg, params=init_params(cfg, gen, gen_dev))
        return model, torch.optim.AdamW(model.parameters(), lr=1e-3)

    def issued(**kw):
        model, opt = fresh()
        step = training.data_parallel_train_step(model, opt, **kw)
        state = training.create_train_state(model, opt)
        return _issued(lambda: step(state, x, y)), step

    plain, _ = issued(guard=False)
    # guard=None defers to HVD_TPU_GUARD: disabled, it must issue the
    # SAME calls as guard=False — the observer leaves no residue
    saved = os.environ.get("HVD_TPU_GUARD")
    os.environ["HVD_TPU_GUARD"] = "0"
    try:
        disabled, _ = issued(guard=None)
    finally:
        if saved is None:
            os.environ.pop("HVD_TPU_GUARD", None)
        else:
            os.environ["HVD_TPU_GUARD"] = saved
    leg.add(check_identical("guard-disabled", plain, disabled))
    leg.add(check_added_collectives("guard-enabled", plain,
                                    issued(guard=True)[0]))

    was = trace.enabled()
    try:
        trace.configure(enabled=True)
        on, _ = issued(guard=False)
        trace.configure(enabled=False)
        off, _ = issued(guard=False)
    finally:
        trace.configure(enabled=was)
    leg.add(check_identical("trace-on-off", on, off))

    # overlap: buckets launched from inside the backward (bucket_bytes
    # small enough that the tiny model splits into several buckets —
    # one bucket legitimately trails whole)
    _, step = issued(overlap=True, bucket_bytes=4096)
    leg.add(check_overlap("overlap", overlap_inventory(
        step.reducer.last_record, min_payload_bytes=1024)))

    # ZeRO: the guarded step adds 0 collectives over the unguarded one
    def zero(guard):
        model, _ = fresh()
        state, zstep = training.zero_train_setup(
            model, torch.optim.AdamW(model.parameters(), lr=1e-3),
            guard=guard)
        return _issued(lambda: zstep(state, x, y))

    leg.add(check_added_collectives("zero-guard", zero(False), zero(True)))
    after = _train_counts()
    return leg.result(launches={k: after[k] - before[k] for k in after})


def _slice_ids() -> List[int]:
    """World rank -> slice, from the topology's rank grid."""
    from ..common import topology
    from ..ops.comm_model import mesh_slice_ids

    return mesh_slice_ids(topology.hierarchical_mesh())


def _two_slices(name: str, ids: Optional[Sequence[int]]) -> List[Finding]:
    """A finding unless ``ids`` (world rank -> slice) holds two slices:
    the job sets ``HVD_TPU_SLICE_SIZE`` to half its world, and with one
    slice the tier and DCN checks would compare nothing."""
    from ..common import basics

    if ids is not None and len(set(ids)) == 2:
        return []
    return [Finding(
        CHECK, HIERARCHICAL_PY, 0, f"one-slice:{name}",
        f"{name}: world {basics.size()} resolved to slices "
        f"{None if ids is None else list(ids)}, not the two of its job's "
        "slice size — the leg's per-tier checks would hold nothing")]


def _verify_hierarchical(device: str) -> dict:
    """``modeled_collective_bytes`` == the per-tier bytes of the calls
    ``ops/hierarchical.py``'s allreduce issues over the topology's two
    slices; a topology of other than two slices is a finding."""
    import numpy as np
    import torch

    from ..common import basics, topology
    from ..ops import hierarchical
    from ..ops.comm_model import measured_tier_bytes, \
        modeled_collective_bytes
    from ..ops.reduce_ops import Sum

    leg = _Leg("hierarchical")
    world, rank = basics.size(), basics.rank()
    tiers = topology.tiers()
    ids = _slice_ids() if world >= 4 and tiers is not None else None
    leg.add(_two_slices("hierarchical", ids))
    if ids is None:
        return leg.result()
    numel = 4096
    x = torch.as_tensor(np.arange(world * numel, dtype=np.float32)
                        .reshape(world, numel)[rank], device=device)
    records = _issued(lambda: hierarchical.hierarchical_allreduce(
        x, op=Sum, tiers=tiers))
    measured = measured_tier_bytes(records, ids)
    modeled = modeled_collective_bytes((numel,), world, tiers.n_ici)
    leg.add(check_modeled_measured(
        "hierarchical-allreduce",
        {"ici": modeled["ici_bytes"], "dcn": modeled["dcn_bytes"]},
        {"ici": measured["ici_bytes"], "dcn": measured["dcn_bytes"]}))
    return leg.result()


def _verify_serving(device: str, shards_list: Sequence[int],
                    requests: int, seed: int) -> dict:
    """Engines per shard count (+ one speculative): warm the whole
    menu, run one step of every family at every batch tier under the
    record (DCN-exclusion + modeled == measured all-reduce stream),
    then the zero-recompile lint under the randomized load."""
    import numpy as np
    import torch

    from ..models.transformer import TransformerConfig, init_params
    from ..ops.comm_model import measured_tier_bytes, \
        modeled_serve_psum_bytes
    from ..serving import ServeConfig, ServingEngine

    leg = _Leg("serving")
    world_slices = _slice_ids()
    leg.add(_two_slices("serving", world_slices))
    kv = max(2, max(shards_list))
    cfg = TransformerConfig(
        vocab_size=128, num_layers=2, num_heads=2 * kv, num_kv_heads=kv,
        head_dim=16, max_seq_len=96, dtype=torch.float32,
        attention_impl="dot", causal=True)
    serve = dict(block_size=8, num_blocks=0, token_budget=256,
                 watermark=2, prefill_tiers=(32,), decode_tiers=(1, 2, 4),
                 prefill_chunk=8)
    dev = torch.device(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)

    legs: List[Tuple[str, ServeConfig, int]] = []
    for s in shards_list:
        legs.append((f"shards{s}", ServeConfig(shards=s, **serve),
                     requests if s == min(shards_list)
                     else max(requests // 4, 16)))
    legs.append(("spec", ServeConfig(spec=True, spec_k=3, **serve),
                 max(requests // 4, 16)))

    def stream(records) -> int:
        # the engine's ranks' step collectives: one slice, local tier
        return measured_tier_bytes(records, [0] * len(world_slices))[
            "ici_bytes"]

    for name, scfg, n_req in legs:
        eng = ServingEngine(cfg, params, serve=scfg, device=dev)
        eng.warmup()
        warmed = set(eng._progs)
        for bt in eng.decode_tiers:
            pt = eng.page_tiers[0]
            rec = _issued(lambda: eng.decode_step_inventory(
                batch_tier=bt, pages=pt))
            leg.add(check_dcn_exclusion(
                f"{name}:decode:b{bt}:p{pt}", rec, world_slices))
            modeled = modeled_serve_psum_bytes(
                bt, 1, cfg.d_model, cfg.num_layers, eng.shards, "float32")
            leg.add(check_modeled_measured(
                f"{name}:decode:b{bt}", {"ici": modeled["stream_bytes"]},
                {"ici": stream(rec)}, file=ENGINE_PY))
            for c in eng.chunk_tiers:
                mrec = _issued(lambda: eng.mixed_step_inventory(
                    batch_tier=bt, chunk_tier=c))
                leg.add(check_dcn_exclusion(
                    f"{name}:mixed:b{bt}:c{c}", mrec, world_slices))
                mmod = modeled_serve_psum_bytes(
                    bt, c, cfg.d_model, cfg.num_layers, eng.shards,
                    "float32")
                leg.add(check_modeled_measured(
                    f"{name}:mixed:b{bt}:c{c}",
                    {"ici": mmod["stream_bytes"]}, {"ici": stream(mrec)},
                    file=ENGINE_PY))
            if eng.spec_w:
                srec = _issued(lambda: eng.mixed_step_inventory(
                    batch_tier=bt, chunk_tier=eng.spec_w,
                    pages=eng.page_tiers[0]))
                leg.add(check_dcn_exclusion(
                    f"{name}:spec:b{bt}:w{eng.spec_w}", srec,
                    world_slices))
        # zero-recompile lint: the randomized load must dispatch only
        # warmed keys, and the book must not grow
        rs = np.random.RandomState(seed + len(name))
        _drive(eng, _serve_load(rs, n_req, cfg.max_seq_len))
        leg.add(check_menu_keys(name, warmed, set(eng._progs)))
        grew = [] if eng.program_count == len(warmed) else [Finding(
            CHECK, ENGINE_PY, 0, f"recompile:{name}",
            f"{name}: program_count grew {len(warmed)} -> "
            f"{eng.program_count} under load — a mid-traffic "
            "compile slipped past the menu",
        )]
        leg.add(grew)
    return leg.result()


def _rank_main(argv: Optional[Sequence[str]] = None) -> None:
    """One rank of one job: ``job rank world store out device requests
    seed shards...``; writes its legs' results to ``out`` as JSON."""
    job, rank, world, store, out, device, requests, seed, *shards = (
        argv if argv is not None else sys.argv[1:])
    import torch

    from ..common import basics

    if device == "cpu":
        torch.set_num_threads(1)
    basics.init(device=device, rank=int(rank), size=int(world),
                init_method="file://" + store, backend="gloo")
    try:
        if job == "training":
            legs = [_verify_training(device)]
        else:
            legs = [_verify_hierarchical(device),
                    _verify_serving(device, tuple(int(s) for s in shards),
                                    int(requests), int(seed))]
        if device.startswith("cuda"):
            torch.cuda.synchronize()
    finally:
        basics.shutdown()
    with open(out, "w") as f:
        json.dump(legs, f)


_WORKER = ("import sys\n"
           "from horovod_tpu_torch.analysis import programs\n"
           "programs._rank_main(sys.argv[1:])\n")


def _run_job(job: str, world: int, env_extra: Dict[str, str], device: str,
             args: Sequence[str]) -> Tuple[List[dict], List[Finding]]:
    """Run ``job`` in ``world`` processes; returns every rank's legs, or
    a finding when a rank fails or outlives ``JOB_TIMEOUT_S``."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, **env_extra)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (here, os.environ.get("PYTHONPATH")) if p)
        if device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, job, str(r), str(world),
             os.path.join(tmp, "store"), outs[r], device, *args],
            cwd=here, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        deadline = time.monotonic() + JOB_TIMEOUT_S
        try:
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            with open(os.path.join(tmp, f"rank{bad[0]}.log")) as f:
                tail = f.read()[-2000:]
            return [], [Finding(
                CHECK, TRAINING_PY if job == "training" else ENGINE_PY, 0,
                f"leg-failed:{job}",
                f"{job}: rank(s) {bad} of {world} exited "
                f"{[procs[r].returncode for r in bad]} (timeout "
                f"{JOB_TIMEOUT_S:.0f} s); rank {bad[0]}'s log ends:\n{tail}")]
        ranks = []
        for o in outs:
            with open(o) as f:
                ranks.append(json.load(f))
    return ranks, []


def verify(root: str = ".", shards: Sequence[int] = (1, 2),
           requests: int = 512, seed: int = 0,
           device: str = "cuda:0",
           report: Optional[List[dict]] = None) -> List[Finding]:
    """The full verification — every invariant in the module docstring.
    ``root`` is accepted for PASSES signature parity; the steps run from
    this package.  ``device``: ``"cuda:0"`` for every rank on the one
    card, or ``"cpu"``; ``RuntimeError`` when torch sees no card for a
    ``cuda`` device.  Each leg's
    ``{leg, world, device, checks, findings, seconds, launches}`` is
    appended to ``report`` (findings counted once across ranks,
    launches summed over them)."""
    if device != "cpu":
        import torch

        if not device.startswith("cuda"):
            raise ValueError(f"device {device!r}: 'cuda:0' or 'cpu'")
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"the program pass was asked to run on {device}, but torch "
                "sees no card; pass device='cpu' (the CLI's --device cpu) "
                "to run it on the CPU")
    findings: List[Finding] = []
    args = [str(requests), str(seed), *map(str, shards)]
    for job, world, env_extra in JOBS:
        t0 = time.perf_counter()
        ranks, failed = _run_job(job, world, env_extra, device, args)
        findings += failed
        for i, name in enumerate(leg["leg"] for leg in
                                 (ranks[0] if ranks else [])):
            seen = {}
            for legs in ranks:
                for f in legs[i]["findings"]:
                    seen.setdefault(tuple(f.values()), Finding(**f))
            findings += seen.values()
            launches: Dict[str, int] = {}
            for legs in ranks:
                for k, v in legs[i].get("launches", {}).items():
                    launches[k] = launches.get(k, 0) + v
            if report is not None:
                report.append(dict(
                    leg=name, world=world, device=device,
                    checks=ranks[0][i]["checks"], findings=len(seen),
                    seconds=max(legs[i]["seconds"] for legs in ranks),
                    launches=launches))
        if failed and report is not None:
            report.append(dict(leg=job, world=world, device=device,
                               checks=0, findings=len(failed),
                               seconds=time.perf_counter() - t0,
                               launches={}))
    return findings
