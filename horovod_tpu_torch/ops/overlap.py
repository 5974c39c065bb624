"""Backward/collective overlap: the bucket autotuner and the overlap
metrics.

Port of ``horovod_tpu/ops/overlap.py``'s policy code (``Candidate``,
``BucketAutotuner``) and ``record_overlap_metrics``.  The overlap itself
needs no module here: the JAX package splits the backward into a chain
of segments so that each bucket's reduction can sit between them in one
compiled program (``overlapped_value_and_grad``); in PyTorch autograd's
post-accumulate-grad hooks mark the bucket boundaries, and the hooked
``optim.DistributedOptimizer`` launches each
:class:`~.fusion.BucketSchedule` bucket's allreduce from the hook that
completes it.

:func:`record_overlap_metrics` feeds the overlap instruments from an
inventory (:func:`~.comm_model.overlap_inventory` of the reducer's
launch record: the static, schedule-structure view), and
:func:`measured_overlap_exposed` is its wall-clock twin, read from a
``torch.profiler`` capture of an overlapped step: the share of the
communication kernels' time that no compute kernel on another stream
covers.

:class:`BucketAutotuner` sweeps bucket-size candidates against step
times the caller measures, pins the fastest within a trial budget, and
never does worse than the static default, which is always trial zero.
"""

from __future__ import annotations

import statistics
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from .. import trace as _trace
from ..metrics import instruments as _metrics
from ..utils import profiler as _profiler
from ..utils.env_parser import Config


def record_overlap_metrics(inventory: Dict[str, Any]) -> Dict[str, Any]:
    """Feed the ``hvd_tpu_overlap_*`` instruments from an overlap
    inventory (:func:`~.comm_model.overlap_inventory`): the static
    exposed-comm fraction, and each bucket's launch lead (its
    ``compute_after``).  Returns the inventory, so that benches and
    tests share the numbers the gauges saw."""
    _metrics.OVERLAP_EXPOSED_FRACTION.set(inventory["exposed_fraction"])
    for op in inventory["collectives"]:
        _metrics.OVERLAP_LAUNCH_LEAD.observe(op["compute_after"])
    return inventory


def _is_comm_kernel(name: str) -> bool:
    return "nccl" in name.lower()


def exposed_comm_share(comm: Sequence[Tuple[float, float, Any]],
                       compute: Sequence[Tuple[float, float, Any]]
                       ) -> Optional[float]:
    """The share of the communication kernels' time that no compute
    kernel on another stream covers.  Each kernel is ``(start, end,
    stream)``; a communication kernel's exposed time is its interval
    less the union of the compute intervals on the other streams.
    None when there is no communication time."""
    total = exposed = 0.0
    for a, b, stream in comm:
        total += b - a
        cover = sorted((max(a, c0), min(b, c1)) for c0, c1, s in compute
                       if s != stream and c0 < b and c1 > a)
        covered, end = 0.0, a
        for c0, c1 in cover:
            if c1 > end:
                covered += c1 - max(c0, end)
                end = c1
        exposed += (b - a) - covered
    return exposed / total if total > 0 else None


def measured_overlap_exposed(prof) -> Optional[float]:
    """The wall-clock exposed-comm fraction of a ``torch.profiler``
    capture (``prof``, CUDA activity on) of an overlapped step: over
    the device kernels, the share of NCCL kernel time that no compute
    kernel on another stream covers (:func:`exposed_comm_share`).  None
    when the capture holds no NCCL kernel (world 1 runs none)."""
    comm, compute = [], []
    for e in _profiler.device_kernels(prof):
        iv = (e.time_range.start, e.time_range.end,
              getattr(e, "device_resource_id", None))
        if _is_comm_kernel(e.name):
            comm.append(iv)
        elif not e.name.startswith(("Memcpy", "Memset")):
            compute.append(iv)
    return exposed_comm_share(comm, compute)


class Candidate(NamedTuple):
    """One autotuner trial point: bucket size and (for the two-level
    collectives, :mod:`.hierarchical`) the cross hop's wire dtype."""

    bucket_bytes: int
    wire_dtype: Optional[str] = None


_DEFAULT_SWEEP_MB = (1, 2, 4, 8, 16, 32)


def _time_thunk(thunk: Callable[[], Any]) -> float:
    t0 = time.perf_counter()
    thunk()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


class BucketAutotuner:
    """Step-time-driven sweep over bucket-size candidates.

    Protocol::

        tuner = BucketAutotuner()
        while not tuner.converged:
            cand = tuner.propose()
            step = build_step(bucket_bytes=cand.bucket_bytes)
            tuner.observe(timed_step(step))   # once per step
        plan = tuner.pinned

    * The default (``HVD_TPU_OVERLAP_BUCKET_BYTES``) is always trial
      zero, and the winner is the argmin over every scored trial, so the
      pinned plan never does worse than the default.
    * A trial scores as the median of ``steps_per_trial`` step times
      with the first left out (it pays the new plan's set-up).
    * The sweep stops when ``trial_budget`` trials have scored, pinning
      the best so far.
    """

    def __init__(self, candidates: Optional[Sequence[Candidate]] = None,
                 default: Optional[Candidate] = None,
                 trial_budget: Optional[int] = None,
                 steps_per_trial: Optional[int] = None):
        cfg = Config.from_env()
        if default is None:
            default = Candidate(cfg.overlap_bucket_bytes)
        if candidates is None:
            candidates = [Candidate(mb << 20) for mb in _DEFAULT_SWEEP_MB]
        if trial_budget is None:
            trial_budget = cfg.overlap_autotune_trials
        if steps_per_trial is None:
            steps_per_trial = cfg.overlap_autotune_steps
        if trial_budget < 1 or steps_per_trial < 1:
            raise ValueError(
                "trial_budget and steps_per_trial must be >= 1, got "
                f"{trial_budget}/{steps_per_trial}")
        self.default = default
        self.candidates: List[Candidate] = [default] + [
            c for c in candidates if c != default]
        self.trial_budget = int(trial_budget)
        self.steps_per_trial = int(steps_per_trial)
        self._trial = 0
        self._times: List[float] = []
        self._scores: List[Tuple[Candidate, float]] = []
        self._pinned: Optional[Candidate] = None

    @property
    def converged(self) -> bool:
        return self._pinned is not None

    @property
    def pinned(self) -> Optional[Candidate]:
        return self._pinned

    @property
    def scores(self) -> List[Tuple[Candidate, float]]:
        return list(self._scores)

    def propose(self) -> Candidate:
        """The candidate to run the next step with (stable within a
        trial; the pinned winner once converged)."""
        if self._pinned is not None:
            return self._pinned
        return self.candidates[self._trial]

    def observe(self, step_time_s: float) -> None:
        """Record one step's wall time under the current candidate."""
        if self._pinned is not None:
            return
        self._times.append(float(step_time_s))
        if len(self._times) < self.steps_per_trial:
            return
        scored = self._times[1:] if len(self._times) > 1 else self._times
        score = float(statistics.median(scored))
        cand = self.candidates[self._trial]
        self._scores.append((cand, score))
        _metrics.OVERLAP_AUTOTUNE_TRIALS.inc()
        _trace.event("overlap.autotune", trial=self._trial,
                     bucket_bytes=cand.bucket_bytes,
                     wire_dtype=cand.wire_dtype, score_s=score)
        self._times = []
        self._trial += 1
        if (self._trial >= len(self.candidates)
                or len(self._scores) >= self.trial_budget):
            best, _ = min(self._scores, key=lambda ct: ct[1])
            self._pinned = best
            _metrics.OVERLAP_AUTOTUNE_PINNED_BYTES.set(best.bucket_bytes)

    def run(self, build_step: Callable[[Candidate], Callable[[], Any]],
            time_fn: Optional[Callable[[Callable[[], Any]], float]] = None
            ) -> Candidate:
        """Drive the whole sweep: ``build_step(candidate)`` returns a
        zero-argument step; each is timed ``steps_per_trial`` times (by
        default on the host clock, after a device synchronize).  Returns
        the pinned candidate."""
        time_fn = time_fn or _time_thunk
        while not self.converged:
            thunk = build_step(self.propose())
            for _ in range(self.steps_per_trial):
                if self.converged:
                    break
                self.observe(time_fn(thunk))
        return self._pinned
