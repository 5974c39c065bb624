"""Host-side lock-discipline lint (pass ``locks``).

Copied from ``horovod_tpu/analysis/locks.py``.  The host side runs a
dozen concurrent threads — the fleet router's replica steppers, the
autoscaler, heartbeats, data prefetchers, the preemption guard, the
metrics registry — and the two failure classes this pass checks are
the classic ones:

* **lock-order inversion** — thread 1 acquires A then B, thread 2
  acquires B then A: a deadlock that only fires under contention.  The
  pass builds a lock-acquisition graph per module (``with self._lock:``
  scopes, plus nested acquisitions reached through one level of
  same-class method calls) and reports every cycle.
* **unguarded shared state** — in a class that spawns threads, an
  attribute written both under and outside a lock (inconsistent
  discipline: the unguarded write races the guarded readers), and a
  ``threading.Thread`` target mutating attributes no lock protects
  while other methods also write them (write/write race).

Everything is stdlib ``ast``; ``__init__`` writes are construction-time
and never counted.  The analysis is per class / per module:
cross-object inversions (A's lock held across a call into B) are out of
static reach.  Suppress a justified finding with ``contract-ok: locks
-- <why>`` (single-threaded-use invariants must be named in the
justification; docs/ANALYSIS.md).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from ._common import PORT, Finding, Layout, iter_py_files, read_text

CHECK = "locks"

#: threading factories whose instances define a guard scope.
_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}
#: call names that mark a class as spawning concurrency.
_THREAD_FACTORIES = {"Thread", "Timer", "ThreadPoolExecutor",
                     "start_new_thread"}


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target / attribute chain."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    elif isinstance(cur, ast.Call):
        parts.append(_dotted(cur.func) + "()")
    return ".".join(reversed(parts))


def _self_attr(node: ast.AST) -> Optional[str]:
    """``attr`` when the node is ``self.attr``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _write_target_attr(target: ast.AST) -> Optional[str]:
    """The ``self`` attribute a store target mutates: ``self.x = ...``,
    ``self.x[k] = ...``, ``self.x += ...`` all write ``x``."""
    a = _self_attr(target)
    if a is not None:
        return a
    if isinstance(target, ast.Subscript):
        return _self_attr(target.value)
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            a = _write_target_attr(elt)
            if a is not None:
                return a
    return None


class _MethodScan(ast.NodeVisitor):
    """One method's lock-relevant events.

    ``acquires``: (lock, line, frozenset(held-before)) per ``with``
    item that takes a known lock.  ``writes``: (attr, line,
    held-nonempty) per ``self``-attribute store.  ``calls``: (method,
    line, frozenset(held)) per ``self.m(...)`` call.  ``spawns``:
    thread-target method names passed to a thread factory.
    """

    def __init__(self, lock_names: Set[str], module_locks: Set[str]):
        self.lock_names = lock_names
        self.module_locks = module_locks
        self.acquires: List[Tuple[str, int, frozenset]] = []
        self.writes: List[Tuple[str, int, bool]] = []
        self.calls: List[Tuple[str, int, frozenset]] = []
        self.spawns: List[str] = []
        self._held: Tuple[str, ...] = ()

    # -- lock identification -------------------------------------------------

    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        a = _self_attr(expr)
        if a is not None and a in self.lock_names:
            return a
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return expr.id
        return None

    # -- visitors ------------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        entered: List[str] = []
        for item in node.items:
            lock = self._lock_of(item.context_expr)
            if lock is not None:
                self.acquires.append(
                    (lock, item.context_expr.lineno,
                     frozenset(self._held + tuple(entered))))
                entered.append(lock)
        self._held = self._held + tuple(entered)
        for stmt in node.body:
            self.visit(stmt)
        if entered:
            self._held = self._held[: len(self._held) - len(entered)]

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        terminal = name.rsplit(".", 1)[-1]
        # explicit .acquire() counts as an acquisition event (no scope)
        if terminal == "acquire":
            lock = self._lock_of(getattr(node.func, "value", None))
            if lock is not None:
                self.acquires.append(
                    (lock, node.lineno, frozenset(self._held)))
        if terminal in _THREAD_FACTORIES:
            for kw in node.keywords:
                if kw.arg == "target":
                    tgt = _self_attr(kw.value)
                    if tgt is not None:
                        self.spawns.append(tgt)
            # submit(self.m) style targets ride the positional args too
            for arg in node.args:
                tgt = _self_attr(arg)
                if tgt is not None:
                    self.spawns.append(tgt)
        method = _self_attr(node.func)
        if method is not None:
            self.calls.append((method, node.lineno, frozenset(self._held)))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            attr = _write_target_attr(t)
            if attr is not None:
                self.writes.append((attr, node.lineno, bool(self._held)))
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = _write_target_attr(node.target)
        if attr is not None:
            self.writes.append((attr, node.lineno, bool(self._held)))
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            attr = _write_target_attr(node.target)
            if attr is not None:
                self.writes.append((attr, node.lineno, bool(self._held)))
        self.generic_visit(node)

    # nested defs/lambdas run later (often on another thread); their
    # bodies are scanned as separate contexts by the class walker, so
    # don't double-visit them under the current held set
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        pass


def _class_lock_names(cls: ast.ClassDef) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        if not isinstance(node.value, ast.Call):
            continue
        if _dotted(node.value.func).rsplit(".", 1)[-1] in _LOCK_FACTORIES:
            for t in node.targets:
                attr = _write_target_attr(t)
                if attr is not None:
                    out.add(attr)
    return out


def _module_lock_names(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and _dotted(node.value.func).rsplit(".", 1)[-1]
                in _LOCK_FACTORIES):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _cycles(edges: Dict[str, Dict[str, int]]) -> List[Tuple[Tuple[str, ...],
                                                            int]]:
    """Elementary cycles of the acquisition digraph (DFS; the graphs
    here are a handful of nodes).  Returns (canonical node tuple, line
    of one participating edge) per distinct cycle."""
    seen: Set[Tuple[str, ...]] = set()
    out: List[Tuple[Tuple[str, ...], int]] = []

    def dfs(start: str, node: str, path: List[str]) -> None:
        for nxt, line in sorted(edges.get(node, {}).items()):
            if nxt == start:
                cyc = path + [node]
                rot = min(range(len(cyc)),
                          key=lambda i: tuple(cyc[i:] + cyc[:i]))
                canon = tuple(cyc[rot:] + cyc[:rot])
                if canon not in seen:
                    seen.add(canon)
                    out.append((canon, line))
            elif nxt not in path and nxt != node and nxt > start:
                # only walk nodes > start so each cycle is found from
                # its smallest node exactly once
                dfs(start, nxt, path + [node])

    for start in sorted(edges):
        dfs(start, start, [])
    return out


def _scan_class(rel: str, cls: ast.ClassDef, module_locks: Set[str],
                findings: List[Finding],
                edge_out: Dict[str, Dict[str, int]]) -> None:
    locks = _class_lock_names(cls)
    methods = _methods(cls)
    scans: Dict[str, _MethodScan] = {}
    for name, fn in methods.items():
        scan = _MethodScan(locks, module_locks)
        for stmt in fn.body:
            scan.visit(stmt)
        scans[name] = scan

    def qual(lock: str) -> str:
        return f"{cls.name}.{lock}" if lock in locks else lock

    # -- acquisition graph (order-inversion edges) ---------------------------
    for name, scan in scans.items():
        for lock, line, held in scan.acquires:
            for h in held:
                if h != lock:
                    edge_out.setdefault(qual(h), {}).setdefault(
                        qual(lock), line)
        for callee, line, held in scan.calls:
            if not held or callee not in scans:
                continue
            for lock, _line, _h in scans[callee].acquires:
                for h in held:
                    if h != lock:
                        edge_out.setdefault(qual(h), {}).setdefault(
                            qual(lock), line)

    # -- shared-state discipline (threaded classes only) ---------------------
    spawns: List[str] = []
    for scan in scans.values():
        spawns.extend(scan.spawns)
    if not spawns:
        return
    # writes per attr, construction (__init__) excluded
    guarded: Dict[str, int] = {}
    unguarded: Dict[str, int] = {}
    writers: Dict[str, Set[str]] = {}
    for name, scan in scans.items():
        if name == "__init__":
            continue
        for attr, line, held in scan.writes:
            if attr in locks:
                continue
            writers.setdefault(attr, set()).add(name)
            if held:
                guarded.setdefault(attr, line)
            else:
                unguarded.setdefault(attr, line)
    flagged: Set[str] = set()
    for attr in sorted(set(guarded) & set(unguarded)):
        flagged.add(attr)
        findings.append(Finding(
            CHECK, rel, unguarded[attr], f"{cls.name}.{attr}",
            f"{cls.name}.{attr} is written both under a lock (line "
            f"{guarded[attr]}) and outside one (here) in a class that "
            "spawns threads — the unguarded write races every guarded "
            "reader; take the lock or name the single-threaded-use "
            "invariant in a contract-ok justification",
        ))
    if not locks:
        return
    # thread targets mutating attrs other methods also write, no lock
    thread_methods = {m for m in spawns if m in scans}
    for m in sorted(thread_methods):
        for attr, line, held in scans[m].writes:
            if held or attr in locks or attr in flagged:
                continue
            others = writers.get(attr, set()) - {m}
            if not others:
                continue
            flagged.add(attr)
            findings.append(Finding(
                CHECK, rel, line, f"{cls.name}.{attr}",
                f"thread target {cls.name}.{m} writes {attr!r} with no "
                f"lock held while {sorted(others)[0]} also writes it — "
                "a write/write race across threads; guard both sides "
                "with one of the class's locks",
            ))


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
        module_locks = _module_lock_names(tree)
        edges: Dict[str, Dict[str, int]] = {}
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                _scan_class(rel, node, module_locks, findings, edges)
        # module-level functions can nest module locks too
        mod_scan = _MethodScan(set(), module_locks)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for stmt in node.body:
                    mod_scan.visit(stmt)
        for lock, line, held in mod_scan.acquires:
            for h in held:
                if h != lock:
                    edges.setdefault(h, {}).setdefault(lock, line)
        for cyc, line in _cycles(edges):
            key = "->".join(cyc + (cyc[0],))
            findings.append(Finding(
                CHECK, rel, line, key,
                f"lock-order inversion: acquisition cycle {key} — two "
                "threads taking these locks in opposite order deadlock "
                "under contention; pick one global order",
            ))
    return findings
