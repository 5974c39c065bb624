"""Deterministic fault injection (chaos) for horovod_tpu_torch.

Copied from ``horovod_tpu/chaos/__init__.py`` (jax-free there too): the
same spec grammar, sites, actions, per-rank draw streams and
``HVD_TPU_CHAOS*`` variables, so a spec replays the same injection
trace in either package.  The port has no native core yet, so
:func:`configure_native_lib` raises and ``transport.*`` rules never
fire; the crash bundle a ``kill`` writes in the JAX package (its flight
recorder) is not ported.

The subsystem that PROVES the recovery machinery works: named injection
points throughout the framework evaluate a seed-driven plan and, when a
rule fires, inject one of eight faults::

    drop     the caller discards the unit of work (frame, batch)
    delay    sleep ``delay`` seconds, then continue
    corrupt  flip one bit of the payload handed to :func:`point`
    raise    raise :class:`ChaosInjected` at the call site
    kill     SIGKILL this process (the classic elastic fault)
    hang     sleep forever — a live-but-silent worker, the fault only
             heartbeats (not process-exit watching) can see
    flipbit  flip ONE high-order bit of a numeric payload (ndarray,
             float, int; bytes get one mid-buffer bit) — the silent-
             data-corruption model ("Cores that don't count"): a
             materially wrong VALUE inside a structurally valid
             container, visible only to integrity checks (guard.*)
    scale    multiply a numeric payload by ``factor`` (default 1024) —
             the runaway-gradient model the guard's loss-spike EMA sees

Configured entirely from the environment so any launcher can inject::

    HVD_TPU_CHAOS="elastic.commit:kill,at=8,rank=1;transport.frame.send:corrupt,at=400,rank=1,fuse=/tmp/f1"
    HVD_TPU_CHAOS_SEED=42

Per-rank derived streams (spec.Rule.stream_seed) make runs replay
exactly: same seed + same rank + same call sequence = same injection
trace.  Sites under ``transport.`` live in the native C++ core; their
rules are exported through the ``hvdtpu_chaos_*`` C API at controller
load (native/src/chaos.h mirrors the evaluation semantics).

When ``HVD_TPU_CHAOS`` is unset the whole subsystem is a single module
bool check per call site — free in steady state.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, List, Optional

from ..metrics import instruments as _metrics
from ..utils.logging import get_logger
from .spec import ACTIONS, ChaosSpecError, Rule, parse_spec

__all__ = [
    "ChaosInjected", "DROP", "SITES", "active", "clear", "configure",
    "configure_native_lib", "injection_trace", "install_from_env", "point",
    "raise_point",
]

ENV_SPEC = "HVD_TPU_CHAOS"
ENV_SEED = "HVD_TPU_CHAOS_SEED"
#: Optional JSONL file every Python-side fire is appended to (replay
#: assertions in tools/chaos_soak.py read it back).
ENV_LOG = "HVD_TPU_CHAOS_LOG"

#: Sites evaluated in the native C++ core, exported via hvdtpu_chaos_*.
NATIVE_PREFIX = "transport."

#: Injection-point catalogue (docs/FAULT_TOLERANCE.md mirrors this).
SITES = (
    "transport.frame.send",    # native: outgoing negotiation frame
    "transport.frame.recv",    # native: incoming negotiation frame
    "controller.enqueue",      # collective submission (ctypes layer)
    "controller.resolve",      # fused-response execution callback
    "data.batch",              # input-pipeline worker collate
    "data.prefetch",           # device staging in the prefetcher
    "elastic.commit",          # elastic state commit (per training step)
    "training.step",           # fit_epoch loop body
    "fleet.preempt",           # preemption-notice poll (fleet/preemption.py)
    "guard.grad",              # per-step gradient tap (guard.py tap_grads)
    "guard.param",             # cadence param-fingerprint tap (guard.py)
    "checkpoint.payload",      # checkpoint bytes about to be published
    "serve.dispatch",          # router->replica request hand-off
    "serve.replica_step",      # one fleet replica's engine step
    "serve.migrate",           # KV snapshot wire on the warm recovery path
    "serve.snapshot",          # periodic in-flight KV export (replica)
    "serve.handoff",           # kvsnap wire at the prefill->decode boundary
)


class ChaosInjected(RuntimeError):
    """Raised at a chaos point by an ``action=raise`` rule."""


class _Drop:
    def __repr__(self):  # pragma: no cover - repr cosmetics
        return "<chaos.DROP>"


#: Sentinel returned by :func:`point` when a ``drop`` rule fired — the
#: caller discards the unit of work it was about to process.
DROP = _Drop()

#: Fast-path flag: False means every point() returns immediately.
active = False

_lock = threading.Lock()
_plan: dict = {}          # site -> List[_Armed]
_seed: int = 0
_rank: int = 0
_trace: List[dict] = []
_log_path: Optional[str] = None


class _Armed:
    """One installed rule + its deterministic draw stream."""

    __slots__ = ("rule", "state")

    def __init__(self, rule: Rule, stream_seed: int):
        self.rule = rule
        self.state = stream_seed  # xorshift64 state (matches chaos.h)

    def draw(self) -> float:
        x = self.state
        x ^= (x << 13) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 7
        x ^= (x << 17) & 0xFFFFFFFFFFFFFFFF
        self.state = x
        return (x >> 11) / float(1 << 53)


def configure(spec: str, seed: int = 0, rank: int = 0) -> List[Rule]:
    """Install a chaos plan (replacing any previous one).  Rules whose
    ``rank`` param names a different process are filtered out here —
    per-rank plans never reach the hot path."""
    global active, _seed, _rank
    rules = parse_spec(spec) if spec else []
    with _lock:
        _plan.clear()
        _trace.clear()
        _seed, _rank = int(seed), int(rank)
        for i, rule in enumerate(rules):
            if rule.rank is not None and rule.rank != rank:
                continue
            _plan.setdefault(rule.site, []).append(
                _Armed(rule, rule.stream_seed(_seed, rank, i))
            )
        active = bool(_plan)
    if active:
        get_logger().warning(
            "chaos: fault injection ACTIVE (%d rule(s), seed=%d, rank=%d)",
            sum(len(v) for v in _plan.values()), _seed, rank,
        )
    return rules


def install_from_env(rank: int = 0) -> bool:
    """Read ``HVD_TPU_CHAOS`` / ``HVD_TPU_CHAOS_SEED`` and install the
    plan for this process (called from ``hvd.init()``).  Returns whether
    any rule is active here."""
    global _log_path
    from ..common.retry import env_int

    spec = os.environ.get(ENV_SPEC, "")
    seed = env_int(ENV_SEED, 0)
    _log_path = os.environ.get(ENV_LOG) or None
    configure(spec, seed=seed, rank=rank)
    return active


def clear() -> None:
    """Disarm every rule (tests)."""
    global active
    with _lock:
        _plan.clear()
        _trace.clear()
        active = False


def injection_trace() -> List[dict]:
    """Python-side fires so far, in order (replay assertions)."""
    with _lock:
        return list(_trace)


def _burn_fuse(path: str) -> bool:
    """True when this process wins the fuse (O_EXCL create); False when
    the fuse was already burnt — by this boot or a previous one."""
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
        os.close(fd)
        return True
    except FileExistsError:
        return False
    except OSError:
        # an unwritable fuse path must not turn a one-shot rule into a
        # repeating one: treat it as burnt and warn
        get_logger().warning("chaos: fuse path %r unusable; skipping rule",
                             path)
        return False


def _record_fire(site: str, action: str, eval_idx: int) -> None:
    _metrics.CHAOS_INJECTIONS.labels(site, action).inc()
    event = {"site": site, "action": action, "eval": eval_idx,
             "rank": _rank}
    _trace.append(event)
    # chaos fires are first-class timeline events: a crash bundle or a
    # /trace export shows the injection in sequence with the spans it
    # broke (docs/TRACING.md)
    from .. import trace as _span_trace

    _span_trace.event("chaos.inject", site=site, action=action,
                      eval=eval_idx)
    get_logger().warning("chaos: injecting %s at %s (eval %d)",
                         action, site, eval_idx)
    if _log_path:
        try:
            with open(_log_path, "a") as f:
                f.write(json.dumps(event) + "\n")
        except OSError:
            pass


def _corrupt(payload: Any) -> Any:
    """Flip one bit of a bytes-like payload; other types pass through a
    best-effort mangling (numeric negate-and-offset)."""
    if isinstance(payload, (bytes, bytearray)):
        buf = bytearray(payload)
        if buf:
            buf[len(buf) // 2] ^= 0x01
        return bytes(buf)
    if isinstance(payload, (int, float)):
        return -payload - 1
    return payload


def _flipbit(payload: Any) -> Any:
    """Flip ONE bit of a numeric payload, placed high in the element's
    representation so the value change is material (for little-endian
    floats bit 6 of the top byte is an exponent bit): the silent-data-
    corruption model — wrong VALUE, valid container.  Returns None when
    the payload type carries no flippable value (caller raises)."""
    import numpy as np

    if isinstance(payload, np.ndarray):
        out = np.array(payload, copy=True)
        if out.size == 0 or out.dtype.hasobject:
            return None
        flat = out.reshape(-1).view(np.uint8)
        # middle element's most-significant byte (little-endian
        # layout), bit 4: a mid-exponent bit for floats — a 2^±32
        # value change that stays FINITE (flipping the top exponent
        # bits of a ~1.0 float would make Inf, which the cheap NaN/Inf
        # sentinel catches; SDC's interesting case is the wrong value
        # only a digest can see)
        i = (out.size // 2) * out.itemsize + (out.itemsize - 1)
        flat[i] ^= 0x10
        return out
    if isinstance(payload, (bytes, bytearray)):
        buf = bytearray(payload)
        if not buf:
            return None
        buf[len(buf) // 2] ^= 0x10
        return bytes(buf)
    if isinstance(payload, bool):
        return not payload
    if isinstance(payload, int):
        return payload ^ (1 << 30)
    if isinstance(payload, float):
        bits = np.array([payload], np.float64).view(np.uint64)
        bits[0] ^= np.uint64(1 << 52)  # exponent LSB: a large change
        return float(bits.view(np.float64)[0])
    return None


def _scale(payload: Any, factor: float) -> Any:
    """Multiply a numeric payload by ``factor`` (dtype preserved for
    ndarrays) — the runaway-value model.  None = not scalable."""
    import numpy as np

    if isinstance(payload, np.ndarray):
        if payload.dtype.hasobject or payload.dtype.kind in "SUV":
            return None
        return np.asarray(payload * factor).astype(payload.dtype)
    if isinstance(payload, bool):
        return None  # a scaled bool is a no-op, not a fault
    if isinstance(payload, (int, float)):
        return type(payload)(payload * factor)
    return None


def point(site: str, payload: Any = None) -> Any:
    """Evaluate the chaos plan at ``site``.

    Returns ``payload`` (possibly corrupted), or :data:`DROP` when the
    caller should discard the unit of work.  ``delay`` sleeps in place;
    ``raise`` raises :class:`ChaosInjected`; ``kill``/``hang`` never
    return.  One module-bool check when chaos is off.
    """
    if not active:
        return payload
    with _lock:
        armed = _plan.get(site)
        if not armed:
            return payload
        fire: Optional[Rule] = None
        eval_idx = 0
        for a in armed:
            r = a.rule
            eval_idx = r.evals
            r.evals += 1
            if fire is not None:
                continue  # counters still advance for later rules
            if r.times is not None and r.fired >= r.times:
                continue
            if eval_idx < r.after:
                continue
            if r.at is not None:
                if eval_idx != r.at:
                    continue
            elif r.prob < 1.0 and a.draw() >= r.prob:
                continue
            if r.fuse and not _burn_fuse(r.fuse):
                # burnt in a prior boot: retire the rule so the hot path
                # never re-probes the filesystem for it
                r.times = r.fired
                continue
            r.fired += 1
            fire = r
            _record_fire(site, r.action, eval_idx)
    if fire is None:
        return payload
    action = fire.action
    if action == "drop":
        return DROP
    if action == "delay":
        time.sleep(fire.delay)
        return payload
    if action == "corrupt":
        if payload is None:
            # no payload to corrupt at this site: inject as a failure so
            # a fault counted in the trace is a fault that happened
            raise ChaosInjected(
                f"chaos: corrupt at {site} (no payload; injected as "
                "failure)"
            )
        return _corrupt(payload)
    if action in ("flipbit", "scale"):
        out = None if payload is None else (
            _flipbit(payload) if action == "flipbit"
            else _scale(payload, fire.factor))
        if out is None:
            # nothing numeric to mangle: same inject-as-failure contract
            # as payload-less corrupt — a counted fault must be a fault
            raise ChaosInjected(
                f"chaos: {action} at {site} (no numeric payload; "
                "injected as failure)"
            )
        return out
    if action == "raise":
        raise ChaosInjected(
            f"chaos: injected failure at {site} (eval {fire.evals - 1})"
        )
    if action == "kill":
        if fire.code < 0:
            # code=-N delivers signal N to this process instead of
            # exiting — the preemption-notice drill (a SIGTERM the
            # fleet.preemption guard's grace path then handles); the
            # point returns and the handler runs asynchronously
            get_logger().error("chaos: delivering signal %d to self at %s",
                               -fire.code, site)
            os.kill(os.getpid(), -fire.code)
            return payload
        get_logger().error("chaos: self-kill at %s", site)
        os._exit(fire.code)
    if action == "hang":
        get_logger().error("chaos: self-hang at %s", site)
        while True:  # a live-but-silent process: only liveness probes see it
            time.sleep(3600)
    return payload  # pragma: no cover - exhaustive actions above


def raise_point(site: str) -> None:
    """:func:`point` for sites with NO droppable unit of work (commit,
    resolve, staging): a ``drop`` rule raises :class:`ChaosInjected`
    instead — the fault is actually injected, never merely recorded in
    the metrics/trace while the code path sails on."""
    if point(site) is DROP:
        raise ChaosInjected(
            f"chaos: drop at {site} (no droppable unit; injected as "
            "failure)"
        )


def configure_native_lib(lib, rank: Optional[int] = None) -> int:
    """Export the ``transport.*`` rules into the native core: the port
    has no native core yet (ROADMAP.md, item A13), so this raises."""
    raise NotImplementedError(
        "the native core is not ported yet (ROADMAP.md A13); transport.* "
        "chaos rules have nowhere to go")
