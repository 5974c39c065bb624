"""Env-var registry lint (pass ``env``).

Copied from ``horovod_tpu/analysis/envvars.py``.  Every ``HVD_TPU_*``
variable the package reads must have a row in ``docs/running.md``;
every documented row must correspond to a live read (doc rot is drift
too); and numeric parses must go through the validated ``env_*``
helpers — a raw ``int(os.environ[...])`` turns a typo'd knob into a
process-killing ValueError at boot instead of a warning + default.

Read detection covers the package's actual spellings:

* direct reads: ``os.environ.get/pop/[...]``, ``os.getenv``;
* the validated helpers: ``env_int(...)``, ``env_float(...)``;
* name constants: a module-level ``SOME_ENV = "HVD_TPU_X"`` (the
  constant exists to be read through);
* ``utils/env_parser.py``'s prefixing ``_get*("NAME")`` calls
  (resolved to ``HVD_TPU_NAME``);
* native reads: ``getenv("HVD_TPU_...")`` under ``native/src``.

A read spelled through an f-string (``f"HVD_TPU_{name}"``) is not
seen: spell knobs out.  Launcher *writes* (``env["HVD_TPU_X"] = ...``)
are not reads and are not required to be documented individually.
On the JAX package's layout, reads in its ``tools/`` scripts legitimize
rows but raise no findings; on the port's, only the port's reads do.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Set, Tuple

from ._common import (
    PORT, Finding, Layout, count_lines, iter_native_files, iter_py_files,
    read_text, strip_comment,
)

CHECK = "env"

_READ_RES = (
    re.compile(r"os\.environ\.get\(\s*\"(HVD_TPU_\w+)\""),
    re.compile(r"os\.environ\.pop\(\s*\"(HVD_TPU_\w+)\""),
    re.compile(r"os\.getenv\(\s*\"(HVD_TPU_\w+)\""),
    re.compile(r"os\.environ\[\s*\"(HVD_TPU_\w+)\"\s*\](?!\s*=[^=])"),
    re.compile(r"env_(?:int|float|str|bool)\(\s*\"(HVD_TPU_\w+)\""),
    # keyword hand-off to a validated reader (metrics exposition)
    re.compile(r"env_var\s*=\s*\"(HVD_TPU_\w+)\""),
    # a name constant holding the variable (read through elsewhere)
    re.compile(r"^\s*[A-Za-z_]\w*\s*=\s*\"(HVD_TPU_\w+)\"\s*$",
               re.MULTILINE),
)
# std::getenv plus the validated native helpers (EnvSeconds & friends)
_NATIVE_READ_RE = re.compile(r"(?:getenv|Env\w*)\(\s*\"(HVD_TPU_\w+)\"")
_ENV_PARSER_GET_RE = re.compile(
    r"_get(?:_int|_float|_bool|_int_validated)?\(\s*[\r\n]*\s*\"(\w+)\""
)
_RAW_PARSE_RE = re.compile(r"\b(?:int|float)\s*\(\s*os\.(?:environ|getenv)")
_CONST_DEF_RE = re.compile(r"^\s*([A-Za-z_]\w*)\s*=\s*\"(HVD_TPU_\w+)\"\s*$",
                           re.MULTILINE)
_DOC_TOKEN_RE = re.compile(r"(HVD_TPU_[A-Z0-9_]+)(\*)?")

Reads = Dict[str, List[Tuple[str, int]]]


def _strip_comments(text: str, kind: str) -> str:
    """Comment-stripped text with line numbers preserved, so reads that
    wrap across lines (black-style call breaks) still match."""
    return "\n".join(strip_comment(ln, kind) for ln in text.splitlines())


def _scan_python(relfile: str, text: str, reads: Reads,
                 findings: List[Finding], layout: Layout) -> None:
    # normalize quote style so single-quoted reads match the patterns
    clean = _strip_comments(text, "py").replace("'", '"')
    consts = {m.group(1): m.group(2) for m in _CONST_DEF_RE.finditer(clean)}
    for rx in _READ_RES:
        for m in rx.finditer(clean):
            reads.setdefault(m.group(1), []).append(
                (relfile, count_lines(clean, m.start())))
    if relfile.replace(os.sep, "/") == layout.env_parser_py:
        for m in _ENV_PARSER_GET_RE.finditer(clean):
            reads.setdefault("HVD_TPU_" + m.group(1), []).append(
                (relfile, count_lines(clean, m.start())))
    for m in _RAW_PARSE_RE.finditer(clean):
        # name the variable when the call shows it (literal or a known
        # constant) so the allowlist key is stable
        context = clean[m.start():m.start() + 200]
        key = "raw"
        lit = re.search(r"\"(HVD_TPU_\w+)\"", context)
        if lit:
            key = lit.group(1)
        else:
            for name, value in consts.items():
                if re.search(rf"\b{re.escape(name)}\b", context):
                    key = value
                    break
        findings.append(Finding(
            CHECK, relfile, count_lines(clean, m.start()), key,
            "raw numeric parse of an environment variable "
            f"({context.splitlines()[0].strip()[:60]}…) — use the "
            "validated env_int/env_float helpers (common/retry.py) so a "
            "garbled value warns and defaults instead of killing the "
            "process",
        ))


def _documented(root: str, layout: Layout) -> Tuple[Set[str], List[str], str]:
    """(exact tokens, wildcard prefixes, text) of docs/running.md."""
    text = read_text(os.path.join(root, layout.running_md))
    if text is None:
        return set(), [], ""
    exact: Set[str] = set()
    wild: List[str] = []
    for m in _DOC_TOKEN_RE.finditer(text):
        if m.group(2):  # HVD_TPU_FOO_* family
            wild.append(m.group(1))
        else:
            exact.add(m.group(1))
    return exact, wild, text


def run(root: str, layout: Layout = PORT) -> List[Finding]:
    findings: List[Finding] = []
    reads: Reads = {}
    for rel in iter_py_files(root, layout.package):
        text = read_text(os.path.join(root, rel))
        if text is not None:
            _scan_python(rel, text, reads, findings, layout)
    # tools/ scripts (benches, soaks) legitimize docs/running.md rows —
    # their reads are collected SEPARATELY so the package-hygiene
    # findings (undocumented read, raw parse) stay scoped to the package
    tool_reads: Reads = {}
    tool_files = (iter_py_files(root, layout.tools_dir)
                  if layout.tools_dir else [])
    for rel in tool_files:
        text = read_text(os.path.join(root, rel))
        if text is not None:
            _scan_python(rel, text, tool_reads, [], layout)
    for rel in iter_native_files(root, layout):
        text = read_text(os.path.join(root, rel))
        if text is None:
            continue
        clean = _strip_comments(text, "c")
        for m in _NATIVE_READ_RE.finditer(clean):
            reads.setdefault(m.group(1), []).append(
                (rel, count_lines(clean, m.start())))

    exact, wild, doc_text = _documented(root, layout)
    if not doc_text:
        findings.append(Finding(CHECK, layout.running_md, 0, "missing",
                                "docs/running.md not found — the env-var "
                                "registry has no documentation side"))
        return findings

    for var, sites in sorted(reads.items()):
        if var in exact or any(var.startswith(w) for w in wild):
            continue
        relfile, lineno = sites[0]
        findings.append(Finding(
            CHECK, relfile, lineno, var,
            f"{var} is read here but has no row in docs/running.md "
            "(every knob must be documented)",
        ))

    doc_lines = doc_text.splitlines()
    for var in sorted(exact):
        if var in reads or var in tool_reads:
            continue
        lineno = next((i for i, ln in enumerate(doc_lines, 1)
                       if var in ln), 0)
        findings.append(Finding(
            CHECK, layout.running_md, lineno, var,
            f"docs/running.md documents {var} but nothing in the "
            "package reads it (stale row, or the read uses an "
            "unrecognized spelling)",
        ))
    return findings
