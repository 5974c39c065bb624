"""Metric catalogue lint (pass ``metrics``).

Copied from ``horovod_tpu/analysis/metrics_catalogue.py``.  Invariant:

    metric names constructed in code  ⊆  instruments.py catalogue
                                       ⊆  docs/METRICS.md

* every ``counter("...")/gauge("...")/histogram("...")`` call with a
  literal name outside ``metrics/instruments.py`` is an undeclared
  metric — declare it in the catalogue so the name/labels/buckets live
  in one place;
* every catalogue name must appear in docs/METRICS.md;
* every ``hvd_tpu_*`` name METRICS.md mentions must exist in the
  catalogue (doc rot).

METRICS.md brace shorthand is understood:
``hvd_tpu_native_response_cache_{hits,misses}`` expands, a label set
``...seconds{phase}`` is stripped, and a trailing ``*`` makes a prefix
wildcard (``hvd_tpu_native_*``).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Set

from ._common import (
    PORT, Finding, Layout, count_lines, iter_py_files, read_text,
)

CHECK = "metrics"

_CTOR_RE = re.compile(
    r"\b(?:counter|gauge|histogram)\(\s*[\r\n]*\s*\"([a-z_][a-z0-9_]*)\""
)
_DOC_TOKEN_RE = re.compile(
    r"\bhvd_tpu_[a-z0-9_{},]*[a-z0-9_}]|\bhvd_tpu_[a-z0-9_]*_(?=\*)")


def catalogue(root: str, layout: Layout = PORT) -> Dict[str, int]:
    """name -> line of every instrument declared in instruments.py."""
    text = read_text(os.path.join(root, layout.instruments_py))
    if text is None:
        return {}
    return {m.group(1): count_lines(text, m.start())
            for m in _CTOR_RE.finditer(text)}


def _expand_doc_token(token: str) -> List[str]:
    m = re.search(r"\{([^}]*)\}", token)
    if not m:
        return [token]
    inner = m.group(1)
    if "," in inner:
        return [token[:m.start()] + alt + token[m.end():]
                for alt in inner.split(",")]
    return [token[:m.start()] + token[m.end():]]  # {label} annotation


def run(root: str, layout: Layout = PORT) -> List[Finding]:
    findings: List[Finding] = []
    names = catalogue(root, layout)
    if not names:
        findings.append(Finding(
            CHECK, layout.instruments_py, 0, "missing",
            "metrics/instruments.py declares no instruments (or is "
            "missing) — the catalogue side of the contract is gone"))
        return findings

    # -- code ⊆ catalogue ----------------------------------------------------
    for rel in iter_py_files(root, layout.package):
        if rel.replace(os.sep, "/") in layout.metrics_exempt:
            continue
        text = read_text(os.path.join(root, rel))
        if text is None:
            continue
        for m in _CTOR_RE.finditer(text):
            name = m.group(1)
            if name not in names:
                findings.append(Finding(
                    CHECK, rel, count_lines(text, m.start()), name,
                    f"metric {name!r} is constructed here but not "
                    "declared in metrics/instruments.py — move the "
                    "declaration into the catalogue",
                ))

    # -- catalogue ⊆ docs (and docs ⊆ catalogue) -----------------------------
    doc_text = read_text(os.path.join(root, layout.metrics_md))
    if doc_text is None:
        findings.append(Finding(CHECK, layout.metrics_md, 0, "missing",
                                "docs/METRICS.md not found"))
        return findings
    doc_exact: Set[str] = set()
    doc_prefixes: List[str] = []
    for m in _DOC_TOKEN_RE.finditer(doc_text):
        token = m.group(0)
        if doc_text[m.end():m.end() + 1] == "*":
            doc_prefixes.append(token)
            continue
        doc_exact.update(_expand_doc_token(token))

    for name, lineno in sorted(names.items()):
        if name in doc_exact or any(name.startswith(p)
                                    for p in doc_prefixes):
            continue
        findings.append(Finding(
            CHECK, layout.instruments_py, lineno, name,
            f"metric {name!r} is in the catalogue but docs/METRICS.md "
            "never mentions it — add a catalogue row",
        ))

    doc_lines = doc_text.splitlines()
    for name in sorted(doc_exact):
        if name in names:
            continue
        # tolerate documented sub-series of declared histograms/counters
        if any(name.startswith(base) and name[len(base):] in
               ("_sum", "_count", "_bucket", "_total")
               for base in names):
            continue
        lineno = next((i for i, ln in enumerate(doc_lines, 1)
                       if name in ln), 0)
        findings.append(Finding(
            CHECK, layout.metrics_md, lineno, name,
            f"docs/METRICS.md mentions {name!r} but the catalogue "
            "(metrics/instruments.py) does not declare it (stale doc "
            "or renamed metric)",
        ))
    return findings
