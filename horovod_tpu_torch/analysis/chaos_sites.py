"""Chaos-site parity lint (pass ``chaos``).

Copied from ``horovod_tpu/analysis/chaos_sites.py``.  The
fault-injection subsystem names its points three times: the Python
``SITES`` catalogue (``chaos/__init__.py``), the native twin's
``chaos::Decide("...")`` call sites (``native/src``), and the
documented site table in ``docs/FAULT_TOLERANCE.md``.  A site present
in one layer but not the others is a rule that silently never fires —
the worst possible failure mode for the subsystem whose job is proving
failures are handled.

Checked equivalences:

* every ``chaos.point("...")`` / ``raise_point("...")`` literal in the
  package names a catalogued site;
* every catalogued non-native site has at least one Python call site
  (a catalogue entry nothing evaluates is dead);
* the native ``Decide`` sites are exactly the catalogue's
  ``transport.*`` entries (both directions);
* the FAULT_TOLERANCE.md site table is exactly the catalogue.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Set, Tuple

from ._common import (
    PORT, Finding, Layout, count_lines, doc_rows, iter_native_files,
    iter_py_files, read_text, sites_tuple,
)

CHECK = "chaos"

#: catalogue prefix whose sites are evaluated in the native core
NATIVE_PREFIX = "transport."

_POINT_RE = re.compile(r"\b(?:raise_)?point\(\s*\"([a-z0-9_.]+)\"")
_DECIDE_RE = re.compile(r"\bDecide\(\s*\"([a-z0-9_.]+)\"")


def catalogue(root: str, layout: Layout = PORT) -> Dict[str, int]:
    """site -> line of the SITES tuple in chaos/__init__.py."""
    text = read_text(os.path.join(root, layout.chaos_init_py))
    return {} if text is None else sites_tuple(text)


def run(root: str, layout: Layout = PORT) -> List[Finding]:
    findings: List[Finding] = []
    init_py = layout.chaos_init_py
    sites = catalogue(root, layout)
    if not sites:
        findings.append(Finding(
            CHECK, init_py, 0, "missing",
            "chaos/__init__.py SITES catalogue not found/empty — the "
            "site registry is gone"))
        return findings

    # -- Python call sites ---------------------------------------------------
    py_used: Set[str] = set()
    for rel in iter_py_files(root, layout.package,
                             exclude_dirs=("analysis", "chaos",
                                           "__pycache__")):
        text = read_text(os.path.join(root, rel))
        if text is None:
            continue
        for m in _POINT_RE.finditer(text):
            site = m.group(1)
            py_used.add(site)
            if site not in sites:
                findings.append(Finding(
                    CHECK, rel, count_lines(text, m.start()), site,
                    f"chaos point {site!r} is evaluated here but not in "
                    "the SITES catalogue — no HVD_TPU_CHAOS rule can "
                    "ever be validated against it",
                ))

    for site, lineno in sorted(sites.items()):
        if site.startswith(NATIVE_PREFIX):
            continue
        if site not in py_used:
            findings.append(Finding(
                CHECK, init_py, lineno, site,
                f"catalogued site {site!r} has no chaos.point()/"
                "raise_point() call site in the package (dead catalogue "
                "entry)",
            ))

    # -- native twin ---------------------------------------------------------
    native_used: Dict[str, Tuple[str, int]] = {}
    for rel in iter_native_files(root, layout):
        text = read_text(os.path.join(root, rel))
        if text is None:
            continue
        for m in _DECIDE_RE.finditer(text):
            site = m.group(1)
            lineno = count_lines(text, m.start())
            native_used.setdefault(site, (rel, lineno))
            if site not in sites:
                findings.append(Finding(
                    CHECK, rel, lineno, site,
                    f"native chaos site {site!r} is evaluated here but "
                    "not in the SITES catalogue",
                ))
            elif not site.startswith(NATIVE_PREFIX):
                findings.append(Finding(
                    CHECK, rel, lineno, site,
                    f"native code evaluates {site!r} but only "
                    f"{NATIVE_PREFIX}* sites are exported to the native "
                    "engine (chaos.configure_native_lib) — the rule "
                    "would never arrive",
                ))
    for site, lineno in sorted(sites.items()):
        if site.startswith(NATIVE_PREFIX) and site not in native_used:
            findings.append(Finding(
                CHECK, init_py, lineno, site,
                f"catalogued native site {site!r} has no chaos::Decide "
                "call in native/src (dead catalogue entry)",
            ))

    # -- documented table ----------------------------------------------------
    doc_text = read_text(os.path.join(root, layout.fault_md))
    if doc_text is None:
        findings.append(Finding(CHECK, layout.fault_md, 0, "missing",
                                "docs/FAULT_TOLERANCE.md not found"))
        return findings
    doc_sites = doc_rows(doc_text)
    for site, lineno in sorted(sites.items()):
        if site not in doc_sites:
            findings.append(Finding(
                CHECK, init_py, lineno, site,
                f"site {site!r} is catalogued but missing from the "
                "docs/FAULT_TOLERANCE.md site table",
            ))
    for site, lineno in sorted(doc_sites.items()):
        if site not in sites:
            findings.append(Finding(
                CHECK, layout.fault_md, lineno, site,
                f"docs/FAULT_TOLERANCE.md documents site {site!r} but "
                "the SITES catalogue does not contain it",
            ))
    return findings
