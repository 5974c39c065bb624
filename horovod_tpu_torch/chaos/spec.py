"""Chaos spec grammar: parse ``HVD_TPU_CHAOS`` into injection rules.

A copy of ``horovod_tpu/chaos/spec.py`` (the grammar, the rule fields
and the per-(seed, rank, site, rule) stream derivation are the JAX
package's, so one spec means the same plan in both packages).

Grammar (documented for users in docs/FAULT_TOLERANCE.md)::

    spec   := rule (";" rule)*
    rule   := site ":" action ("," param)*
    param  := key "=" value

``site`` is the dotted name of an injection point (the catalogue lives in
docs/FAULT_TOLERANCE.md; ``horovod_tpu.chaos.SITES`` mirrors it).
``action`` is one of ``drop | delay | corrupt | raise | kill | hang |
flipbit | scale``.  ``flipbit`` flips ONE high-order bit of a numeric
payload (ndarray/float/int; bytes get one mid-buffer bit) — the
Hochschild-style silent-corruption model: the value changes materially,
the container stays structurally valid.  ``scale`` multiplies a numeric
payload by ``factor`` — the runaway-gradient / loss-spike model.
Params:

    prob=F    fire probability per evaluation (default 1.0)
    at=N      fire exactly on the Nth evaluation of the site (0-based);
              implies times=1 unless overridden
    after=N   eligible only from the Nth evaluation on (default 0)
    times=N   maximum number of fires (default unlimited; 1 for at=)
    rank=R    only on the process with cross-rank R at install time
              (default: every rank)
    delay=F   seconds to sleep for action=delay (default 0.05)
    code=N    exit code for action=kill (default 137).  A NEGATIVE N
              delivers signal -N to the process instead of exiting
              (Python sites only) — the preemption drill:
              ``fleet.preempt:kill,code=-15`` is a SIGTERM notice the
              fleet.preemption guard's grace path handles
    factor=F  multiplier for action=scale (default 1024.0)
    fuse=PATH fire at most once ACROSS process generations: the first
              fire creates PATH (O_EXCL) and any process that finds it
              existing skips the rule.  This is how a kill/corrupt
              injection is kept from re-arming after the elastic
              exec-restart it provoked.

Determinism: probability draws come from a per-(rank, site, rule) stream
derived from ``HVD_TPU_CHAOS_SEED`` via SHA-256 — the same seed, rank and
call sequence replay the exact same injection trace (the acceptance bar
of tools/chaos_soak.py).  Evaluation counters are per process boot.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional

ACTIONS = ("drop", "delay", "corrupt", "raise", "kill", "hang",
           "flipbit", "scale")

#: Action enum values shared with the native side (native/src/chaos.h).
#: The native core implements only the first six; flipbit/scale are
#: Python-site actions (chaos.configure_native_lib skips them with a
#: warning when a transport.* rule names one).
ACTION_ENUM = {name: i + 1 for i, name in enumerate(ACTIONS)}

#: Actions the native engine (chaos.h Action enum) implements.
NATIVE_ACTIONS = frozenset(ACTIONS[:6])


class ChaosSpecError(ValueError):
    """Malformed HVD_TPU_CHAOS spec (bad grammar, unknown action/param)."""


@dataclass
class Rule:
    site: str
    action: str
    prob: float = 1.0
    at: Optional[int] = None
    after: int = 0
    times: Optional[int] = None
    rank: Optional[int] = None
    delay: float = 0.05
    code: int = 137
    factor: float = 1024.0
    fuse: Optional[str] = None
    # runtime state (per process boot)
    evals: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def stream_seed(self, seed: int, rank: int, index: int) -> int:
        """64-bit per-(seed, rank, site, rule-index) stream seed — the
        derivation both the Python and the native engine use, so a rule
        moved between the two fires on the same draws."""
        material = f"{seed}:{rank}:{self.site}:{index}".encode()
        return int.from_bytes(
            hashlib.sha256(material).digest()[:8], "little"
        ) or 1  # xorshift64 state must be nonzero


def _parse_rule(text: str) -> Rule:
    head, *params = [p.strip() for p in text.split(",")]
    if ":" not in head:
        raise ChaosSpecError(
            f"chaos rule {text!r} lacks ':' (want site:action[,k=v...])"
        )
    site, action = (s.strip() for s in head.split(":", 1))
    if not site:
        raise ChaosSpecError(f"chaos rule {text!r} has an empty site")
    if action not in ACTIONS:
        raise ChaosSpecError(
            f"chaos rule {text!r}: unknown action {action!r} "
            f"(want one of {', '.join(ACTIONS)})"
        )
    rule = Rule(site=site, action=action)
    for param in params:
        if not param:
            continue
        if "=" not in param:
            raise ChaosSpecError(
                f"chaos rule {text!r}: param {param!r} lacks '='"
            )
        key, value = (s.strip() for s in param.split("=", 1))
        try:
            if key == "prob":
                rule.prob = float(value)
                if not 0.0 <= rule.prob <= 1.0:
                    raise ChaosSpecError(
                        f"chaos rule {text!r}: prob must be in [0, 1]"
                    )
            elif key == "at":
                rule.at = int(value)
            elif key == "after":
                rule.after = int(value)
            elif key == "times":
                rule.times = int(value)
            elif key == "rank":
                rule.rank = int(value)
            elif key == "delay":
                rule.delay = float(value)
            elif key == "code":
                rule.code = int(value)
            elif key == "factor":
                rule.factor = float(value)
            elif key == "fuse":
                rule.fuse = value
            else:
                raise ChaosSpecError(
                    f"chaos rule {text!r}: unknown param {key!r}"
                )
        except ChaosSpecError:
            raise
        except ValueError as e:
            raise ChaosSpecError(
                f"chaos rule {text!r}: bad value for {key!r}: {e}"
            ) from None
    if rule.at is not None and rule.times is None:
        rule.times = 1
    return rule


def parse_spec(spec: str) -> List[Rule]:
    """Parse a full ``HVD_TPU_CHAOS`` value into rules (may be empty)."""
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if part:
            rules.append(_parse_rule(part))
    return rules
