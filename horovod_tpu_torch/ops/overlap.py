"""Backward/collective overlap: the bucket autotuner.

Port of ``horovod_tpu/ops/overlap.py``'s policy code (``Candidate``,
``BucketAutotuner``).  The overlap itself needs no module here: the JAX
package splits the backward into a chain of segments so that each
bucket's reduction can sit between them in one compiled program
(``overlapped_value_and_grad``); in PyTorch autograd's
post-accumulate-grad hooks mark the bucket boundaries, and the hooked
``optim.DistributedOptimizer`` launches each
:class:`~.fusion.BucketSchedule` bucket's allreduce from the hook that
completes it.  ``record_overlap_metrics`` reads a lowered StableHLO
program the port does not have; its profiler-measured stand-in is
queued (ROADMAP).

:class:`BucketAutotuner` sweeps bucket-size candidates against step
times the caller measures, pins the fastest within a trial budget, and
never does worse than the static default, which is always trial zero.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import trace as _trace
from ..metrics import instruments as _metrics
from ..utils.env_parser import Config


class Candidate(NamedTuple):
    """One autotuner trial point: bucket size and (for the two-level
    collectives, not ported) the slow hop's wire dtype."""

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
