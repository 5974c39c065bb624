"""Collective-discipline lint (pass ``collectives``).

Port of ``horovod_tpu/analysis/collectives.py``.  Two classes of drift
that deadlock or silently mis-account a distributed program, both
checkable from the AST:

* **rank-gated collective** — a collective call (``allreduce*``,
  ``allgather*``, ``broadcast``, ``all_to_all``, ``barrier``, ...)
  inside control flow conditioned on the caller's rank / process
  identity.  Collectives are rendezvous points: if rank 0 takes the
  branch and rank 1 does not, the job hangs at the next matched call.
  Branching on *world size* is fine (every rank agrees on it);
  branching on *rank* is not.  The rule is the JAX package's, as it is.
* **raw torch.distributed collective outside ops//parallel/** —
  ``dist.all_reduce`` and friends called directly from other layers
  bypass the public API's reduce-op semantics, hierarchical routing,
  counters, byte accounting and spans (the JAX package's rule reads
  ``jax.lax.p*``; this one reads ``torch.distributed``, spelled
  ``dist.X``, ``torch.distributed.X``, through an ``import
  torch.distributed as <alias>`` or a ``from torch.distributed import
  X``).  ``get_rank``, ``is_initialized``, ``new_group`` and the other
  non-collective functions are not flagged.

Suppress a justified exception with ``contract-ok: collectives --
<why>`` (docs/ANALYSIS.md); a legitimate rank branch or raw call must
explain why every rank still reaches a matched call.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional

from ._common import PORT, Finding, Layout, iter_py_files, read_text

CHECK = "collectives"

#: terminal call names that are collective rendezvous points.
_COLLECTIVE_PREFIXES = (
    "allreduce", "allgather", "alltoall", "all_to_all", "reducescatter",
    "reduce_scatter", "hierarchical_allreduce", "grouped_allreduce",
)
_COLLECTIVE_NAMES = {
    "psum", "psum_scatter", "pmean", "pmax", "pmin", "ppermute",
    "pbroadcast", "all_gather", "broadcast", "barrier",
}
#: non-collective lookalikes the prefix match must not trip on.
_FALSE_FRIENDS = {
    "broadcast_to", "broadcast_arrays", "broadcast_shapes",
    "broadcast_in_dim", "barrier_wait",
}

#: torch.distributed functions only ops//parallel/ may call.
_DIST_COLLECTIVES = {
    "all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
    "broadcast_object_list", "all_gather_object", "send", "recv", "isend",
    "irecv", "barrier", "monitored_barrier", "reduce", "gather", "scatter",
    "gather_object", "scatter_object_list", "batch_isend_irecv",
}
_DIST_PREFIXES = ("reduce_scatter", "all_to_all", "_all_gather",
                  "_reduce_scatter")
_DIST_MODULE = "torch.distributed"

#: identifiers whose value diverges per rank — branching on them gates
#: the branch body per rank.
_RANK_TOKENS = {
    "rank", "local_rank", "node_rank", "cross_rank", "cross_size_rank",
    "process_index", "process_id", "rank_id", "my_rank", "worker_index",
    "task_index",
}


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    return ".".join(reversed(parts))


def _is_collective_call(name: str) -> bool:
    terminal = name.rsplit(".", 1)[-1]
    if terminal in _FALSE_FRIENDS:
        return False
    return (terminal in _COLLECTIVE_NAMES
            or terminal.startswith(_COLLECTIVE_PREFIXES))


def _is_dist_collective(fn: str) -> bool:
    return fn in _DIST_COLLECTIVES or fn.startswith(_DIST_PREFIXES)


def _rank_token_in(test: ast.AST) -> Optional[str]:
    """The first rank-valued identifier the branch condition reads."""
    for node in ast.walk(test):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name is not None and name.lstrip("_") in _RANK_TOKENS:
            return name
    return None


def _dist_names(tree: ast.Module) -> Dict[str, str]:
    """How the module spells torch.distributed: module aliases
    (``dist``, ``torch.distributed``, ``import ... as td``) map to "",
    names imported from it map to the function they are."""
    out: Dict[str, str] = {"dist": "", _DIST_MODULE: ""}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _DIST_MODULE and a.asname:
                    out[a.asname] = ""
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for a in node.names:
                if node.module == "torch" and a.name == "distributed":
                    out[a.asname or a.name] = ""
                elif node.module == _DIST_MODULE:
                    out[a.asname or a.name] = a.name
    return out


class _Scan(ast.NodeVisitor):
    def __init__(self, rel: str, findings: List[Finding], layout: Layout,
                 dist_names: Dict[str, str]):
        self.rel = rel
        self.findings = findings
        self.in_layer = rel.replace(os.sep, "/").startswith(
            layout.collective_layers)
        self.dist_names = dist_names
        self._rank_gate: List[str] = []

    def _visit_gated(self, node: ast.stmt, bodies) -> None:
        token = _rank_token_in(node.test)
        self.visit(node.test)
        if token is not None:
            self._rank_gate.append(token)
        for body in bodies:
            for stmt in body:
                self.visit(stmt)
        if token is not None:
            self._rank_gate.pop()

    def visit_If(self, node: ast.If) -> None:
        # both arms diverge per rank: the else of `if rank() == 0` is
        # exactly as rank-conditional as the body
        self._visit_gated(node, (node.body, node.orelse))

    def visit_While(self, node: ast.While) -> None:
        self._visit_gated(node, (node.body, node.orelse))

    def visit_IfExp(self, node: ast.IfExp) -> None:
        token = _rank_token_in(node.test)
        if token is None:
            self.generic_visit(node)
            return
        self.visit(node.test)
        self._rank_gate.append(token)
        self.visit(node.body)
        self.visit(node.orelse)
        self._rank_gate.pop()

    def _dist_function(self, name: str) -> Optional[str]:
        """The torch.distributed function ``name`` calls, or None."""
        owner, _, fn = name.rpartition(".")
        if owner:
            return fn if self.dist_names.get(owner) == "" else None
        return self.dist_names.get(name) or None

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        terminal = name.rsplit(".", 1)[-1]
        if self._rank_gate and _is_collective_call(name):
            self.findings.append(Finding(
                CHECK, self.rel, node.lineno, terminal,
                f"collective {terminal!r} under rank-conditional control "
                f"flow (branch tests {self._rank_gate[-1]!r}): ranks that "
                "skip the branch never reach the rendezvous — the "
                "mismatched-collective deadlock; hoist the call out of "
                "the branch or mask its inputs instead",
            ))
        fn = None if self.in_layer else self._dist_function(name)
        if fn is not None and _is_dist_collective(fn):
            self.findings.append(Finding(
                CHECK, self.rel, node.lineno, f"dist.{fn}",
                f"raw torch.distributed.{fn} outside ops//parallel/ "
                "bypasses the public collective API (reduce-op "
                "semantics, hierarchical routing, counters, byte "
                "accounting, spans) — call the horovod_tpu_torch.ops "
                "spelling instead",
            ))
        self.generic_visit(node)


def run(root: str, layout: Layout = PORT) -> List[Finding]:
    findings: List[Finding] = []
    for rel in iter_py_files(root, layout.package):
        text = read_text(os.path.join(root, rel))
        if text is None:
            continue
        try:
            tree = ast.parse(text)
        except SyntaxError as e:
            findings.append(Finding(
                CHECK, rel, e.lineno or 0, "syntax",
                f"unparseable module: {e.msg}"))
            continue
        _Scan(rel, findings, layout, _dist_names(tree)).visit(tree)
    return findings
