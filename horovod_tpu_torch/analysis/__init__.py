"""Cross-layer contract checker (static analysis) for horovod_tpu_torch.

Port of ``horovod_tpu/analysis/``: six source passes and the gated
program pass.  The package
names its knobs, metrics, chaos sites and trace sites in code, in
catalogues and in ``docs/``; drift between them is silent (an
uncatalogued chaos site is a rule that never fires, an undocumented
knob is a knob nobody finds), and so is a collective that bypasses the
public API's counters and byte accounting.  Each pass reads source
only, with the standard library:

=========== =====================================================
pass        contract
=========== =====================================================
env         HVD_TPU_* reads == docs/running.md rows; no raw parses
metrics     code-built names ⊆ instruments.py ⊆ docs/METRICS.md
chaos       point() sites == native Decide sites == doc site table
trace       span/event sites == trace SITES == docs/TRACING.md
locks       lock-order acyclic; no mixed guarded/unguarded writes
collectives no rank-gated collectives; raw torch.distributed
            collectives only in ops//parallel/
programs    observers add no collective, modeled == issued bytes,
            no off-menu serving step (torch; HVD_TPU_VERIFY_PROGRAMS=1)
=========== =====================================================

The JAX package's ``c-api`` pass waits for the port's native core
(:data:`NOT_PORTED`); asking for it is a usage error.  ``programs``
runs the package's steps in processes of their own and reports nothing
unless ``HVD_TPU_VERIFY_PROGRAMS=1`` is set (:mod:`.programs`).
Findings the port accepts are listed, each with its reason, in
``allowlist.txt`` beside this file.

Run it::

    python -m horovod_tpu_torch.analysis            # every pass
    python -m horovod_tpu_torch.analysis env chaos  # a subset
    HVD_TPU_VERIFY_PROGRAMS=1 python -m horovod_tpu_torch.analysis programs
    HVD_TPU_VERIFY_PROGRAMS=1 python -m horovod_tpu_torch.analysis \
        programs --device cpu                       # no card: the CPU

Exit status: 0 clean, 1 findings, 2 usage error.  The ``-m`` spelling
imports the ``horovod_tpu_torch`` package (and so torch) first; the
source passes import nothing of it, and ``programs`` imports it only
once its gate is set.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

from . import (chaos_sites, collectives, envvars, locks, metrics_catalogue,
               programs, trace_sites)
from ._common import JAX, PORT, Finding, Layout, Suppressions

__all__ = ["Finding", "JAX", "PORT", "Layout", "NOT_PORTED", "PASSES",
           "run_all", "main"]

PASSES: Dict[str, Callable[..., List[Finding]]] = {
    "env": envvars.run,
    "metrics": metrics_catalogue.run,
    "chaos": chaos_sites.run,
    "trace": trace_sites.run,
    "locks": locks.run,
    "collectives": collectives.run,
    "programs": programs.run,
}

#: the JAX package's passes the port does not run yet, and why
NOT_PORTED = {
    "c-api": "ROADMAP A13b: the port has no native core, so no C API "
             "or ctypes bindings to hold against each other",
}


def _check_names(checks: Sequence[str]) -> None:
    for c in checks:
        if c in NOT_PORTED:
            raise ValueError(f"pass {c!r} is not ported ({NOT_PORTED[c]})")
    unknown = [c for c in checks if c not in PASSES]
    if unknown:
        raise ValueError(f"unknown pass(es) {unknown}; have {list(PASSES)}")


def run_all(root: str, checks: Optional[Sequence[str]] = None,
            suppress: bool = True, layout: Layout = PORT,
            stats: Optional[dict] = None,
            device: str = "cuda:0") -> List[Finding]:
    """Run the selected passes (default: all) against ``root`` and
    return the surviving findings, allowlist and markers applied.
    ``stats``, when given, receives ``raw`` (the findings before
    suppression) and ``allowlisted`` (the allowlist's entries).
    ``device`` is where the gated ``programs`` pass runs its steps
    (``"cuda:0"`` or ``"cpu"``); the source passes run none."""
    selected = list(checks) if checks else list(PASSES)
    _check_names(selected)
    findings: List[Finding] = []
    for name in selected:
        if name == "programs":
            findings.extend(programs.run(root, layout, device=device))
        else:
            findings.extend(PASSES[name](root, layout))
    if not suppress:
        return findings
    sup = Suppressions(root, layout)
    out = sup.filter(findings)
    out.extend(sup.extra_findings)
    if not checks:  # stale-entry audit only makes sense on a full run
        out.extend(sup.stale_entries())
    if stats is not None:
        stats.update(raw=len(findings), allowlisted=sup.entries)
    return sorted(out, key=lambda f: (f.file, f.line, f.check, f.key))


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis",
        description="horovod_tpu_torch cross-layer contract checker",
    )
    parser.add_argument("checks", nargs="*",
                        help=f"passes to run (default all): {list(PASSES)}")
    parser.add_argument("--root", default=None,
                        help="repo root (default: derived from this file)")
    parser.add_argument("--device", default="cuda:0",
                        choices=("cuda:0", "cpu"),
                        help="where the gated programs pass runs its "
                             "steps (default cuda:0; no card there is a "
                             "finding)")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="findings only, no summary line")
    args = parser.parse_args(argv)
    root = args.root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    t0 = time.perf_counter()
    stats: dict = {}
    try:
        findings = run_all(root, args.checks or None, stats=stats,
                           device=args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for f in findings:
        print(f.render())
    if not args.quiet:
        n = len(args.checks or PASSES)
        dt = time.perf_counter() - t0
        verdict = (f"{len(findings)} finding(s)" if findings
                   else "all contracts hold")
        print(f"horovod_tpu_torch.analysis: {n} pass(es), {verdict}; "
              f"{stats['raw']} raw finding(s), {stats['allowlisted']} "
              f"allowlisted entr(ies) ({dt * 1000:.0f} ms)",
              file=sys.stderr)
    return 1 if findings else 0
