"""Shared retry policy and validated environment reads.

Copied from ``horovod_tpu/common/retry.py``:

* :func:`retry_call` — exponential backoff capped at ``max_delay``, full
  jitter (sleep ~ U[0, cap]), deadline-aware, attempts per call booked
  in the ``hvd_tpu_retry_attempts`` histogram by ``site`` (the fleet
  replica's spawn rides it);
* :func:`env_float` / :func:`env_int` — the spelling every env-tunable
  number uses: a garbled value warns and falls back to the default
  rather than killing the process.
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from ..utils.logging import get_logger

__all__ = ["retry_call", "env_float", "env_int"]

T = TypeVar("T")


def env_float(name: str, default: float) -> float:
    """Validated float read of the environment variable ``name`` with a
    fall-through default."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        get_logger().warning("%s=%r is not a number; using %s",
                             name, raw, default)
        return default


def env_int(name: str, default: int) -> int:
    """Validated integer read of ``name`` (see :func:`env_float`)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        get_logger().warning("%s=%r is not an integer; using %s",
                             name, raw, default)
        return default


def retry_call(
    fn: Callable[[], T],
    *,
    site: str,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    attempts: Optional[int] = None,
    timeout: Optional[float] = None,
    base_delay: float = 0.1,
    max_delay: float = 5.0,
    rng: Optional[random.Random] = None,
    describe: Optional[str] = None,
) -> T:
    """Call ``fn()`` until it succeeds, an exception outside ``retry_on``
    escapes, ``attempts`` are exhausted, or the ``timeout`` deadline
    passes.  The final failure re-raises the last error unchanged (the
    caller's except-clauses keep working).

    Args:
      site: metrics/log label (e.g. ``"elastic.rendezvous"``).
      retry_on: exception classes that mean "transient, try again".
      attempts: max calls (None = bounded by ``timeout`` only; with both
        None, a single failure re-raises immediately).
      timeout: overall wall-clock budget in seconds, measured from the
        first call; sleeps are clipped so the budget is never overshot.
      base_delay/max_delay: backoff cap grows ``base_delay * 2**n`` up to
        ``max_delay``; actual sleep is uniform in [0, cap] (full jitter).
      rng: jitter source (tests/chaos replay); default module random.
      describe: human phrase for warning logs (default: ``site``).
    """
    from ..metrics import instruments as _instr

    if attempts is None and timeout is None:
        attempts = 1
    draw = (rng or random).random
    deadline = None if timeout is None else time.monotonic() + timeout
    what = describe or site
    n = 0
    while True:
        n += 1
        try:
            result = fn()
            _instr.RETRY_ATTEMPTS.labels(site).observe(n)
            return result
        except retry_on as e:
            out_of_attempts = attempts is not None and n >= attempts
            out_of_time = (deadline is not None
                           and time.monotonic() >= deadline)
            if out_of_attempts or out_of_time:
                _instr.RETRY_ATTEMPTS.labels(site).observe(n)
                get_logger().warning(
                    "%s failed after %d attempt(s) (%s); giving up: %s",
                    what, n,
                    "deadline exceeded" if out_of_time else "attempts "
                    "exhausted", e,
                )
                raise
            cap = min(max_delay, base_delay * (2 ** (n - 1)))
            sleep = cap * draw()
            if deadline is not None:
                sleep = min(sleep, max(0.0, deadline - time.monotonic()))
            get_logger().info(
                "%s attempt %d failed (%s); retrying in %.2fs",
                what, n, e, sleep,
            )
            time.sleep(sleep)
