"""Lockset race sanitizer (static half): per-class lock discipline (a copy
of the JAX package's ``analysis/locks.py``).

The serving stack shares mutable objects across three thread boundaries —
the gateway event loop, the single render-executor thread, and the temporal
store's checkpoint-writer thread. The serving stack's discipline (either
a ``threading.Lock`` guards the state, or a single thread owns it); this
pass enforces it structurally instead of by review:

``locks.inconsistent_guard``
    Eraser-style intra-class lockset check: an instance attribute that is
    accessed under ``with self.<lock>`` somewhere in the class but *written*
    with no lock held somewhere else (``__init__`` excluded — construction
    happens-before sharing). Mixed discipline is the tell-tale of a
    forgotten guard: either every post-init access takes the lock, or the
    attribute is single-threaded and none should.

``locks.thread_shared_write``
    For classes that *create* their own concurrency — ``threading.Thread(
    target=self.m)``, ``executor.submit(self.m)``, ``loop.run_in_executor(
    ex, self.m)`` — attributes written on one side of the boundary (methods
    reachable from a thread entry point) and touched on the other, with no
    lock common to both sides. Designs whose ordering is real but invisible
    to a lockset (e.g. ``queue.Queue.join`` happens-before) waive the
    finding with a reasoned pragma on the method header.

The runtime half (``analysis/tsan.py``) checks the same property
dynamically under ``REPRO_TSAN=1``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.common import Finding, SourceFile

__all__ = ["run", "analyze_class"]

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "add", "update", "pop",
    "popitem", "popleft", "remove", "discard", "clear", "setdefault",
    "sort", "reverse",
}


def _self_attr(node) -> str | None:
    """'X' when node is ``self.X``."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _Access:
    __slots__ = ("attr", "write", "method", "line", "locks")

    def __init__(self, attr, write, method, line, locks):
        self.attr = attr
        self.write = write
        self.method = method
        self.line = line
        self.locks = frozenset(locks)


class _MethodScanner(ast.NodeVisitor):
    """Collect self-attribute accesses (with held-lock sets), self-method
    calls, and thread entry points within one method body."""

    def __init__(self, method: str, lock_attrs: set[str]):
        self.method = method
        self.lock_attrs = lock_attrs
        self.accesses: list[_Access] = []
        self.calls: set[str] = set()         # self.m() targets
        self.thread_roots: set[str] = set()  # self.m handed to a thread
        self._held: list[str] = []

    # ---- lock scope
    def visit_With(self, node: ast.With):
        entered = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr in self.lock_attrs:
                entered.append(attr)
        self._held.extend(entered)
        self.generic_visit(node)
        if entered:
            del self._held[-len(entered):]

    visit_AsyncWith = visit_With

    # ---- writes
    def _record(self, attr: str, write: bool, line: int):
        self.accesses.append(
            _Access(attr, write, self.method, line, self._held)
        )

    def _target_attrs(self, target):
        """self-attrs written by an assignment target (incl. tuple unpack
        and subscript stores like ``self.d[k] = v``)."""
        out = []
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                out.extend(self._target_attrs(el))
            return out
        attr = _self_attr(target)
        if attr is not None:
            out.append((attr, target.lineno))
        elif isinstance(target, ast.Subscript):
            attr = _self_attr(target.value)
            if attr is not None:
                out.append((attr, target.lineno))
        return out

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            for attr, line in self._target_attrs(t):
                self._record(attr, True, line)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        for attr, line in self._target_attrs(node.target):
            self._record(attr, True, line)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            for attr, line in self._target_attrs(node.target):
                self._record(attr, True, line)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete):
        for t in node.targets:
            for attr, line in self._target_attrs(t):
                self._record(attr, True, line)
        self.generic_visit(node)

    # ---- reads, mutating method calls, self-calls, thread entries
    def visit_Attribute(self, node: ast.Attribute):
        attr = _self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            self._record(attr, False, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        f = node.func
        # self.attr.append(...) and friends mutate self.attr
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            attr = _self_attr(f.value)
            if attr is not None:
                self._record(attr, True, node.lineno)
        # thread entry points: Thread(target=self.m), submit(self.m, ...),
        # run_in_executor(ex, self.m, ...)
        callee = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None
        )
        if callee == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    m = _self_attr(kw.value)
                    if m is not None:
                        self.thread_roots.add(m)
        elif callee == "submit" and node.args:
            m = _self_attr(node.args[0])
            if m is not None:
                self.thread_roots.add(m)
        elif callee == "run_in_executor" and len(node.args) >= 2:
            m = _self_attr(node.args[1])
            if m is not None:
                self.thread_roots.add(m)
        # intra-class call graph edge
        if isinstance(f, ast.Attribute):
            m = _self_attr(f)
            if m is not None:
                self.calls.add(m)
        self.generic_visit(node)


def analyze_class(sf: SourceFile, cls: ast.ClassDef) -> list[Finding]:
    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    if not methods:
        return []
    # pass 1: lock attributes (assigned a threading lock ctor anywhere)
    lock_attrs: set[str] = set()
    for m in methods:
        for node in ast.walk(m):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                callee = node.value.func
                name = (callee.attr if isinstance(callee, ast.Attribute)
                        else callee.id if isinstance(callee, ast.Name) else None)
                if name in _LOCK_CTORS:
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is not None:
                            lock_attrs.add(attr)
    # pass 2: per-method accesses, calls, thread roots
    scans: dict[str, _MethodScanner] = {}
    roots: set[str] = set()
    for m in methods:
        sc = _MethodScanner(m.name, lock_attrs)
        sc.visit(m)
        scans[m.name] = sc
        roots |= sc.thread_roots
    # pass 3: methods reachable from thread entry points
    thread_side: set[str] = set()
    frontier = [r for r in roots if r in scans]
    while frontier:
        m = frontier.pop()
        if m in thread_side:
            continue
        thread_side.add(m)
        frontier.extend(c for c in scans[m].calls if c in scans)

    accesses = [a for sc in scans.values() for a in sc.accesses
                if a.method not in ("__init__", "__post_init__")
                and a.attr not in lock_attrs]
    by_attr: dict[str, list[_Access]] = {}
    for a in accesses:
        by_attr.setdefault(a.attr, []).append(a)

    findings: list[Finding] = []
    for attr, accs in sorted(by_attr.items()):
        guarded = [a for a in accs if a.locks]
        bare_writes = [a for a in accs if a.write and not a.locks]
        if guarded and bare_writes:
            w = bare_writes[0]
            locks = sorted({l for a in guarded for l in a.locks})
            findings.append(Finding(
                "locks.inconsistent_guard", sf.relpath, w.line,
                f"{cls.name}.{attr}",
                f"{cls.name}.{attr} is guarded by {'/'.join(locks)} in "
                f"{guarded[0].method}() but written without it in "
                f"{w.method}() — hold the lock at every post-init access, "
                "or drop it everywhere if the attribute is single-threaded",
            ))
            continue  # one finding per attr: the stronger rule wins
        if not thread_side:
            continue
        t_acc = [a for a in accs if a.method in thread_side]
        c_acc = [a for a in accs if a.method not in thread_side]
        cross = ((any(a.write for a in t_acc) and c_acc)
                 or (any(a.write for a in c_acc) and t_acc))
        if not cross:
            continue
        common = None
        for a in t_acc + c_acc:
            common = a.locks if common is None else common & a.locks
        if common:
            continue
        w = next(a for a in t_acc + c_acc if a.write)
        t_m = sorted({a.method for a in t_acc})
        c_m = sorted({a.method for a in c_acc})
        findings.append(Finding(
            "locks.thread_shared_write", sf.relpath, w.line,
            f"{cls.name}.{attr}",
            f"{cls.name}.{attr} crosses the thread boundary (thread side: "
            f"{', '.join(t_m)}; caller side: {', '.join(c_m)}) with no "
            "common lock — guard both sides, or waive with a pragma naming "
            "the ordering that makes it safe",
        ))
    return findings


def run(files: list[SourceFile]) -> list[Finding]:
    out: list[Finding] = []
    for sf in files:
        findings: list[Finding] = []
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(analyze_class(sf, node))
        out.extend(sf.apply_pragmas(findings))
    return out
