"""Trace-site parity lint (pass ``trace``).

Copied from ``horovod_tpu/analysis/trace_sites.py``.  The span recorder
names its instrumentation points twice — the ``SITES`` catalogue in
``trace/__init__.py`` and the site table in ``docs/TRACING.md`` — and
the site literals of the package's ``trace.span``, ``trace.event``
and ``trace.add_span`` calls must agree with both.  A span site
present in one layer but not the others is either a timeline name no
dashboard can look up, or a documented signal that never records.

Checked equivalences:

* every ``span``/``event``/``add_span`` literal in the package names a
  catalogued site;
* every catalogued site has at least one call site in the package (a
  catalogue entry nothing records is dead);
* the docs/TRACING.md site table is exactly the catalogue (both
  directions).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Set

from ._common import (
    PORT, Finding, Layout, count_lines, doc_rows, iter_py_files, read_text,
    sites_tuple,
)

CHECK = "trace"

# a literal site of trace.span / _trace.event / trace.add_span: any
# alias ending in `trace.`; the method set keeps collective_ops'
# unrelated span helpers out
_CALL_RE = re.compile(
    r"\w*trace\.(?:span|event|add_span)\(\s*[\"']([a-z0-9_.]+)[\"']")


def catalogue(root: str, layout: Layout = PORT) -> Dict[str, int]:
    """site -> line of the SITES tuple in trace/__init__.py."""
    text = read_text(os.path.join(root, layout.trace_init_py))
    return {} if text is None else sites_tuple(text)


def run(root: str, layout: Layout = PORT) -> List[Finding]:
    findings: List[Finding] = []
    init_py = layout.trace_init_py
    sites = catalogue(root, layout)
    if not sites:
        findings.append(Finding(
            CHECK, init_py, 0, "missing",
            "trace/__init__.py SITES catalogue not found/empty — the "
            "span-site registry is gone"))
        return findings

    # -- call sites ----------------------------------------------------------
    used: Set[str] = set()
    for rel in iter_py_files(root, layout.package,
                             exclude_dirs=("analysis", "trace",
                                           "__pycache__")):
        text = read_text(os.path.join(root, rel))
        if text is None:
            continue
        for m in _CALL_RE.finditer(text):
            site = m.group(1)
            used.add(site)
            if site not in sites:
                findings.append(Finding(
                    CHECK, rel, count_lines(text, m.start()), site,
                    f"trace site {site!r} is recorded here but not in "
                    "the trace SITES catalogue — the timeline carries a "
                    "name no site table explains",
                ))

    for site, lineno in sorted(sites.items()):
        if site not in used:
            findings.append(Finding(
                CHECK, init_py, lineno, site,
                f"catalogued trace site {site!r} has no span()/event()/"
                "add_span() call site in the package (dead catalogue "
                "entry)",
            ))

    # -- documented table ----------------------------------------------------
    doc_text = read_text(os.path.join(root, layout.tracing_md))
    if doc_text is None:
        findings.append(Finding(CHECK, layout.tracing_md, 0, "missing",
                                "docs/TRACING.md not found"))
        return findings
    doc_sites = doc_rows(doc_text)
    for site, lineno in sorted(sites.items()):
        if site not in doc_sites:
            findings.append(Finding(
                CHECK, init_py, lineno, site,
                f"trace site {site!r} is catalogued but missing from "
                "the docs/TRACING.md site table",
            ))
    for site, lineno in sorted(doc_sites.items()):
        if site not in sites:
            findings.append(Finding(
                CHECK, layout.tracing_md, lineno, site,
                f"docs/TRACING.md documents trace site {site!r} but the "
                "SITES catalogue does not contain it",
            ))
    return findings
