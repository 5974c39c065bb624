"""Shared plumbing for the static-analysis passes.

Copied from ``horovod_tpu/analysis/_common.py``.  Everything in
``horovod_tpu_torch.analysis`` is stdlib only: it imports neither torch
nor anything of the port's runtime, so a pass runs on a box with
nothing but a Python interpreter.

Where the passes look is one :class:`Layout`: the port's
(:data:`PORT`, the default) or the JAX package's (:data:`JAX`), which
the tests use to hold each pass against the JAX package's own over the
same tree.

Suppression model (docs/ANALYSIS.md):

* inline — the offending line (or the line directly above it) carries a
  ``contract-ok: <check> -- <justification>`` marker in a comment
  (``#``, ``//`` or ``<!-- -->``).  The justification is REQUIRED: a
  bare marker is itself reported, so nobody can wave a finding through
  silently.
* allowlist file — entries ``<check>:<key> -- <justification>`` in the
  layout's allowlist (the port's: ``horovod_tpu_torch/analysis/
  allowlist.txt``, a fixed path).  Stale entries (matching nothing) and
  entries without a justification are reported too, so the list can
  only shrink back to honest.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Layout:
    """The relative paths every pass reads, under one package directory.
    Synthetic trees in the tests recreate exactly these paths under a
    tmp root."""

    package: str
    allowlist: str
    #: scripts whose reads legitimize docs/running.md rows; ``None``
    #: when only the package's own reads count
    tools_dir: Optional[str] = None
    running_md: str = "docs/running.md"
    metrics_md: str = "docs/METRICS.md"
    fault_md: str = "docs/FAULT_TOLERANCE.md"
    tracing_md: str = "docs/TRACING.md"

    def _in(self, rel: str) -> str:
        return f"{self.package}/{rel}"

    @property
    def native_src_dir(self) -> str:
        return self._in("native/src")

    @property
    def env_parser_py(self) -> str:
        return self._in("utils/env_parser.py")

    @property
    def instruments_py(self) -> str:
        return self._in("metrics/instruments.py")

    @property
    def chaos_init_py(self) -> str:
        return self._in("chaos/__init__.py")

    @property
    def trace_init_py(self) -> str:
        return self._in("trace/__init__.py")

    @property
    def metrics_exempt(self) -> Tuple[str, ...]:
        """Files whose constructor calls are the catalogue itself or
        harmless (registry machinery, the package docstring example)."""
        return tuple(self._in(f"metrics/{f}") for f in
                     ("registry.py", "__init__.py", "instruments.py"))

    @property
    def collective_layers(self) -> Tuple[str, ...]:
        """Directories whose modules ARE the public collective layer."""
        return (self._in("ops/"), self._in("parallel/"))


#: the port: only ``horovod_tpu_torch/`` makes a documented row live
#: (``tools/`` holds the JAX package's scripts)
PORT = Layout("horovod_tpu_torch",
              allowlist="horovod_tpu_torch/analysis/allowlist.txt")
JAX = Layout("horovod_tpu", allowlist="tools/analysis_allowlist.txt",
             tools_dir="tools")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation.  ``key`` is the stable handle suppression
    matches on (env-var name, metric name, chaos site, lock cycle)."""

    check: str
    file: str      # path relative to the analysis root
    line: int      # 1-based; 0 when the finding is file-scoped
    key: str
    message: str

    def render(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        return f"{loc}: [{self.check}] {self.message}"


_MARKER_RE = re.compile(
    r"contract-ok:\s*(?P<check>[\w*-]+)\s*(?:--\s*(?P<why>.*?))?\s*(?:-->)?\s*$"
)


def read_text(path: str) -> Optional[str]:
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            return f.read()
    except OSError:
        return None


def iter_py_files(root: str, subdir: str,
                  exclude_dirs: Tuple[str, ...] = ("analysis",
                                                   "__pycache__"),
                  ) -> List[str]:
    """Relative paths of the .py files under ``subdir``, sorted for
    stable output.  The analysis package itself is excluded: its regex
    source would otherwise trip the very patterns it searches for."""
    base = os.path.join(root, subdir)
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames if d not in exclude_dirs]
        for fn in filenames:
            if fn.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, fn), root))
    return sorted(out)


def iter_native_files(root: str, layout: Layout) -> List[str]:
    base = os.path.join(root, layout.native_src_dir)
    if not os.path.isdir(base):
        return []
    return sorted(
        os.path.join(layout.native_src_dir, fn)
        for fn in os.listdir(base)
        if fn.endswith((".h", ".cc"))
    )


def strip_comment(line: str, kind: str) -> str:
    """Drop the trailing comment of one source line (naive but
    sufficient: the tokens these passes search for never legitimately
    contain ``#`` / ``//``)."""
    marker = "//" if kind == "c" else "#"
    idx = line.find(marker)
    return line if idx < 0 else line[:idx]


def count_lines(text: str, pos: int) -> int:
    """The 1-based line of offset ``pos``."""
    return text.count("\n", 0, pos) + 1


def sites_tuple(text: str) -> Dict[str, int]:
    """site -> line of each string of a module's ``SITES = (...)``
    tuple literal (balanced scan)."""
    m = re.search(r"^SITES\s*=\s*\(", text, re.MULTILINE)
    if not m:
        return {}
    i = text.index("(", m.start())
    depth, j = 0, i
    while j < len(text):
        if text[j] == "(":
            depth += 1
        elif text[j] == ")":
            depth -= 1
            if depth == 0:
                break
        j += 1
    return {sm.group(1): count_lines(text, sm.start())
            for sm in _SITE_STR_RE.finditer(text, i, j)}


_SITE_STR_RE = re.compile(r"\"([a-z0-9_.]+)\"")


#: a documented site-table row: a backticked dotted token in column one
#: (plain words in other columns, action names and knob values, never
#: match: site tokens always carry a dot)
DOC_ROW_RE = re.compile(
    r"^\|\s*`([a-z0-9_]+(?:\.[a-z0-9_]+)+)`\s*\|", re.MULTILINE)


def doc_rows(text: str) -> Dict[str, int]:
    return {m.group(1): count_lines(text, m.start())
            for m in DOC_ROW_RE.finditer(text)}


class Suppressions:
    """Inline markers + the allowlist file, resolved per run."""

    def __init__(self, root: str, layout: Layout = PORT):
        self.root = root
        self._inline_cache: Dict[str, List[str]] = {}
        self.extra_findings: List[Finding] = []
        self._allow: Dict[Tuple[str, str], str] = {}
        self._used: set = set()
        self._allow_path = layout.allowlist
        self._load_allowlist()

    # -- allowlist file ------------------------------------------------------

    def _load_allowlist(self) -> None:
        text = read_text(os.path.join(self.root, self._allow_path))
        if text is None:
            return
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            m = re.match(r"([\w-]+):(\S+)\s+--\s+(.+)$", line)
            if not m:
                self.extra_findings.append(Finding(
                    "allowlist", self._allow_path, lineno, line,
                    "malformed allowlist entry (want "
                    "'<check>:<key> -- <justification>'): " + line,
                ))
                continue
            self._allow[(m.group(1), m.group(2))] = m.group(3)

    @property
    def entries(self) -> int:
        """The number of well-formed allowlist entries."""
        return len(self._allow)

    # -- inline markers ------------------------------------------------------

    def _lines(self, relfile: str) -> List[str]:
        if relfile not in self._inline_cache:
            text = read_text(os.path.join(self.root, relfile)) or ""
            self._inline_cache[relfile] = text.splitlines()
        return self._inline_cache[relfile]

    def _inline_marker(self, f: Finding) -> Optional[Tuple[str, str, int]]:
        """(check, justification, lineno) of a marker on the finding's
        line or the line above it."""
        lines = self._lines(f.file)
        for lineno in (f.line, f.line - 1):
            if 1 <= lineno <= len(lines):
                m = _MARKER_RE.search(lines[lineno - 1])
                if m:
                    return m.group("check"), (m.group("why") or "").strip(), \
                        lineno
        return None

    # -- resolution ----------------------------------------------------------

    def filter(self, findings: Iterable[Finding]) -> List[Finding]:
        out: List[Finding] = []
        for f in findings:
            entry = self._allow.get((f.check, f.key))
            if entry is not None:
                self._used.add((f.check, f.key))
                continue
            marker = self._inline_marker(f)
            if marker is not None and marker[0] in (f.check, "*"):
                why, lineno = marker[1], marker[2]
                if not why:
                    out.append(Finding(
                        "allowlist", f.file, lineno, f.key,
                        f"contract-ok marker for [{f.check}] has no "
                        "justification (write 'contract-ok: "
                        f"{f.check} -- <why>')",
                    ))
                continue
            out.append(f)
        return out

    def stale_entries(self) -> List[Finding]:
        out = []
        for (check, key), why in sorted(self._allow.items()):
            if (check, key) not in self._used:
                out.append(Finding(
                    "allowlist", self._allow_path, 0, f"{check}:{key}",
                    f"stale allowlist entry {check}:{key} (nothing "
                    "matches it any more — delete the line)",
                ))
        return out
