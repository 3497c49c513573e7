"""Retrace lint: enforce the one-trace-per-sequence invariant statically.

A copy of the JAX package's ``analysis/retrace.py`` that also knows the
port's spelling of the same construction: under the same four rule ids it
flags the PyTorch calls that build a compiled or captured callable
(``TORCH_CTORS``: ``torch.compile``, ``torch.jit.script`` and ``trace``, a
CUDA graph and its capture). They are matched by their dotted spelling
after the file's import aliases are resolved (``import torch as th``,
``from torch.cuda import CUDAGraph``), never by the last attribute alone,
which would catch ``re.compile``. On code with none of them its findings
are the JAX pass's. A CUDA graph captured per call or per iteration is this
pass's bug in PyTorch's idiom: a fresh capture, and fresh memory pools,
every time.

The stack's throughput story (exactly ONE train-step trace per
sequence, a fixed per-(shape, level, bucket) serving trace budget) is only
guarded by recompile-count tests on the specific paths they exercise. This
pass flags the *construction patterns* that create hidden retraces anywhere
in the tree:

``retrace.jit_in_loop``
    ``jax.jit`` / ``pjit`` / ``shard_map`` / ``pallas_call`` constructed
    inside a ``for``/``while`` body or comprehension. Every iteration builds
    a fresh callable with a fresh trace cache — the canonical
    recompile-per-step bug (and the closure-capture bug: a function defined
    in the loop and jitted there captures loop state into the trace).

``retrace.factory_in_loop``
    A call, inside a loop, to a *jit factory* — any function in the scanned
    tree whose body constructs a jit (``make_train_step``,
    ``make_batched_eval_render``, ...). Same failure mode one call deeper.

``retrace.jit_outside_factory``
    A jit constructed inside a function that is not module scope, not an
    ``__init__``, and not factory-named (``make_*``/``build_*``/``create_*``
    /``resolve_*``/``get_*``, underscore-prefixed variants included). Such a
    function re-traces on every call unless every caller caches the result —
    a per-call cost invisible at the call site. One-shot CLI mains and
    build-once helpers waive this with a reasoned pragma.

``retrace.unhashable_static``
    ``static_argnums``/``static_argnames`` given a list/dict/set literal.
    jax hashes static arguments into the trace-cache key; unhashable
    containers either fail at call time or (as dict values) defeat caching.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.common import Finding, SourceFile

__all__ = ["run", "JIT_CTORS", "TORCH_CTORS"]

# names whose *call* constructs a traced/compiled callable
JIT_CTORS = {"jit", "pjit", "shard_map", "pallas_call"}
# PyTorch's constructors of a compiled or captured callable, by dotted name
TORCH_CTORS = {
    "torch.compile",
    "torch.jit.script",
    "torch.jit.trace",
    "torch.cuda.CUDAGraph",
    "torch.cuda.graph",
    "torch.cuda.make_graphed_callables",
}

_FACTORY_NAME = re.compile(r"^_?(make|build|create|resolve|get)_")
_CTOR_OK_FUNCS = {"__init__", "__post_init__", "__call__"}


def _call_name(node: ast.Call) -> str | None:
    """Simple name of the called function: jax.jit -> "jit", jit -> "jit"."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def import_aliases(tree: ast.AST) -> dict[str, str]:
    """Local name -> the dotted path an import binds it to (``th`` ->
    ``torch``, ``CUDAGraph`` -> ``torch.cuda.CUDAGraph``). Scope-blind: one
    table per file."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _torch_ctor(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """The dotted constructor ``node`` spells (``th.compile`` ->
    ``torch.compile``), when it is one of ``TORCH_CTORS``."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    name = ".".join(reversed(parts))
    return name if name in TORCH_CTORS else None


def _ctor_name(node: ast.Call, aliases: dict[str, str]) -> str | None:
    """The name a construction is reported under (``jit``, ``partial``,
    ``torch.compile``), or None when the call constructs nothing."""
    name = _call_name(node)
    if name in JIT_CTORS:
        return name
    torch_name = _torch_ctor(node.func, aliases)
    if torch_name is not None:
        return torch_name
    # functools.partial(jax.jit, ...) builds a jit ctor; calling IT later is
    # caught as a plain ctor call only if spelled directly — treat the
    # partial itself as the construction site
    if name == "partial" and node.args:
        first = node.args[0]
        if isinstance(first, (ast.Attribute, ast.Name)):
            inner = first.attr if isinstance(first, ast.Attribute) else first.id
            if inner in JIT_CTORS or _torch_ctor(first, aliases) is not None:
                return name
    return None


def collect_jit_factories(files: list[SourceFile]) -> set[str]:
    """Names of functions (anywhere in the tree) whose body constructs a jit
    directly — the set ``factory_in_loop`` checks call sites against."""
    factories: set[str] = set()
    for sf in files:
        aliases = import_aliases(sf.tree)
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # only factory-NAMED functions join the set: call sites resolve
            # by bare name, and a generic name ("run") that happens to build
            # a kernel somewhere would flag every unrelated obj.run() call
            if not _FACTORY_NAME.match(node.name):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and _ctor_name(sub, aliases) is not None:
                    factories.add(node.name)
                    break
    return factories


class _Visitor(ast.NodeVisitor):
    def __init__(self, sf: SourceFile, factories: set[str]):
        self.sf = sf
        self.factories = factories
        self.aliases = import_aliases(sf.tree)
        self.findings: list[Finding] = []
        self._funcs: list[str] = []   # enclosing function-name stack
        self._loops = 0               # enclosing for/while/comprehension depth

    # ---- scope bookkeeping
    def _visit_func(self, node):
        # decorators evaluate at def time in the ENCLOSING scope: visit them
        # before entering the function (else @partial(jax.jit, ...) on a
        # module-level function reads as construction inside it)
        for dec in node.decorator_list:
            self.visit(dec)
        self._funcs.append(node.name)
        outer_loops, self._loops = self._loops, 0  # a nested def resets loop
        for arg_default in node.args.defaults + node.args.kw_defaults:
            if arg_default is not None:
                self.visit(arg_default)
        for stmt in node.body:                     # context: its body runs
            self.visit(stmt)                       # when called, not per-iter
        self._loops = outer_loops
        self._funcs.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = _visit_func

    def _visit_loop(self, node):
        self._loops += 1
        self.generic_visit(node)
        self._loops -= 1

    visit_For = visit_AsyncFor = visit_While = _visit_loop
    visit_ListComp = visit_SetComp = visit_DictComp = visit_GeneratorExp = _visit_loop

    # ---- the rules
    def visit_Call(self, node: ast.Call):
        name = _call_name(node)
        ctx = ".".join(self._funcs) or "<module>"
        ctor = _ctor_name(node, self.aliases)
        if ctor is not None:
            name = ctor
            detail = f"{ctx}:{name}"
            if self._loops:
                self.findings.append(Finding(
                    "retrace.jit_in_loop", self.sf.relpath, node.lineno, detail,
                    f"{name}(...) constructed inside a loop in {ctx}: every "
                    "iteration builds a fresh traced callable (fresh trace "
                    "cache) — hoist the construction out of the loop",
                ))
            elif self._funcs and not self._factory_scope_ok():
                self.findings.append(Finding(
                    "retrace.jit_outside_factory", self.sf.relpath, node.lineno,
                    detail,
                    f"{name}(...) constructed inside {ctx}(): re-traces on "
                    "every call unless callers cache the result — move into a "
                    "make_*/build_* factory called once, or waive with a "
                    "pragma if this path runs once per process",
                ))
            self._check_static_args(node, ctx, name)
        elif self._loops and name in self.factories and name != (
            self._funcs[-1] if self._funcs else None
        ):
            self.findings.append(Finding(
                "retrace.factory_in_loop", self.sf.relpath, node.lineno,
                f"{ctx}:{name}",
                f"jit factory {name}() called inside a loop in {ctx}: each "
                "call builds a fresh jitted callable — build once before the "
                "loop and reuse it",
            ))
        self.generic_visit(node)

    @staticmethod
    def _factory_ok(fname: str) -> bool:
        return bool(_FACTORY_NAME.match(fname)) or fname in _CTOR_OK_FUNCS

    def _factory_scope_ok(self) -> bool:
        """OK when ANY enclosing function is factory-named: a closure built
        inside ``make_*`` (the kernel pattern — ``make_composite``'s inner
        ``run`` wrapping a ``pallas_call``) is constructed per *trace* of its
        jitted caller, not per call."""
        return any(self._factory_ok(f) for f in self._funcs)

    def _check_static_args(self, node: ast.Call, ctx: str, name: str):
        for kw in node.keywords:
            if kw.arg not in ("static_argnums", "static_argnames"):
                continue
            for sub in ast.walk(kw.value):
                if isinstance(sub, (ast.List, ast.Dict, ast.Set)):
                    self.findings.append(Finding(
                        "retrace.unhashable_static", self.sf.relpath,
                        node.lineno, f"{ctx}:{name}:{kw.arg}",
                        f"{kw.arg} passed a {type(sub).__name__.lower()} "
                        f"literal in {ctx}: jax hashes static arguments into "
                        "the trace-cache key — use a tuple",
                    ))
                    break


def run(files: list[SourceFile]) -> list[Finding]:
    factories = collect_jit_factories(files)
    out: list[Finding] = []
    for sf in files:
        v = _Visitor(sf, factories)
        v.visit(sf.tree)
        out.extend(sf.apply_pragmas(v.findings))
    return out
