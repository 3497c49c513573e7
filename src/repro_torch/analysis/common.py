"""Shared infrastructure for the port's static passes (``analysis/``).

A copy of the JAX package's ``analysis/common.py``, kept in the port so a
tree that holds only ``repro_torch`` can lint itself. The rule ids, the
``Finding`` fields, the pragma syntax and the baseline's keys and file
format are the same, so one ``ANALYSIS_baseline.json`` and one set of
pragmas serve both packages' CLIs.

Every pass produces :class:`Finding` records over a parsed source tree; this
module owns the pieces they share:

``SourceFile``
    One parsed python file: raw lines, AST, and its pragma table. Parsed
    once, handed to every pass (the whole-``src/`` sweep stays well under a
    second).

Pragmas
    Findings are suppressed (not hidden — reported as *allowed*) with a
    comment pragma::

        x = risky()  # analysis: allow(locks.thread_shared_write, ordered by queue.join)

    The pragma covers its own line and the line below it; placed on a
    ``def``/``class`` header line it covers the whole block — the shape a
    per-attribute or per-method waiver needs. A second pragma form feeds the
    vocabulary pass at dynamic registration sites::

        metrics.gauge(f"{prefix}.bytes.{dev}")  # analysis: declare(train.devmem.*)

    declaring name families the AST cannot resolve statically.

Baseline ratchet
    ``ANALYSIS_baseline.json`` maps finding keys (rule|path|detail — no line
    numbers, so unrelated edits don't shift the baseline) to counts.
    Pre-existing findings pass; a new key, or a count above baseline, fails.
    Keys no longer found are reported as fixed so the baseline can be
    re-tightened with ``--update-baseline``.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re

__all__ = [
    "Finding",
    "SourceFile",
    "Pragma",
    "iter_python_files",
    "load_tree",
    "baseline_key",
    "load_baseline",
    "save_baseline",
    "diff_against_baseline",
]

_PRAGMA_RE = re.compile(r"#\s*analysis:\s*(allow|declare)\(([^)]*)\)")


@dataclasses.dataclass
class Finding:
    """One rule violation at one site."""

    rule: str       # dotted rule id, e.g. "retrace.jit_in_loop"
    path: str       # repo-relative file path
    line: int       # 1-based line of the offending node
    detail: str     # stable symbol-ish context (baseline key part, no line)
    message: str    # human-facing explanation
    allowed_by: str | None = None  # pragma reason when suppressed

    def key(self) -> str:
        return baseline_key(self.rule, self.path, self.detail)

    def to_dict(self) -> dict:
        d = {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "detail": self.detail,
            "message": self.message,
        }
        if self.allowed_by is not None:
            d["allowed_by"] = self.allowed_by
        return d


@dataclasses.dataclass
class Pragma:
    kind: str            # "allow" | "declare"
    line: int
    args: list[str]      # declare: declared names; allow: [rule]
    reason: str          # allow: waiver reason ("" for declare)
    scope_end: int | None = None  # block end when on a def/class header


class SourceFile:
    """One parsed file: lines + AST + pragmas, shared by every pass."""

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=relpath)
        self._block_ends = self._scan_blocks()
        self.pragmas = self._scan_pragmas()

    def _scan_blocks(self) -> dict[int, int]:
        """def/class header line -> end line of its block."""
        ends: dict[int, int] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                ends[node.lineno] = node.end_lineno or node.lineno
        return ends

    def _scan_pragmas(self) -> list[Pragma]:
        out = []
        for i, line in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(line)
            if not m:
                continue
            kind, body = m.group(1), m.group(2)
            parts = [p.strip() for p in body.split(",")]
            if kind == "allow":
                rule = parts[0] if parts else ""
                reason = ", ".join(parts[1:]).strip()
                args = [rule]
            else:
                args, reason = [p for p in parts if p], ""
            out.append(Pragma(kind, i, args, reason, self._block_ends.get(i)))
        return out

    def declared_names(self) -> list[str]:
        """Every name/family from ``declare(...)`` pragmas in this file."""
        return [n for p in self.pragmas if p.kind == "declare" for n in p.args]

    def allow_reason(self, rule: str, line: int) -> str | None:
        """The waiver reason when an ``allow`` pragma covers (rule, line).

        A pragma matches the exact rule, a dotted prefix ("locks."), or "*".
        Coverage: its own line, the next line, or — on a def/class header —
        the whole block."""
        for p in self.pragmas:
            if p.kind != "allow":
                continue
            want = p.args[0]
            if not (want == "*" or want == rule
                    or (want.endswith(".") and rule.startswith(want))):
                continue
            if line in (p.line, p.line + 1):
                return p.reason or "(no reason given)"
            if p.scope_end is not None and p.line <= line <= p.scope_end:
                return p.reason or "(no reason given)"
        return None

    def declare_covers(self, line: int) -> bool:
        """True when a ``declare`` pragma covers ``line`` (same placement
        rules as ``allow``) — waives ``names.dynamic_unresolved`` there."""
        for p in self.pragmas:
            if p.kind != "declare":
                continue
            if line in (p.line, p.line + 1):
                return True
            if p.scope_end is not None and p.line <= line <= p.scope_end:
                return True
        return False

    def apply_pragmas(self, findings: list[Finding]) -> list[Finding]:
        """Stamp ``allowed_by`` onto findings a pragma waives."""
        for f in findings:
            reason = self.allow_reason(f.rule, f.line)
            if reason is not None:
                f.allowed_by = reason
        return findings


def iter_python_files(root: str, *, skip_dirs=("__pycache__", ".git")) -> list[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in skip_dirs]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def load_tree(paths: list[str], repo_root: str) -> list[SourceFile]:
    """Parse every file once; syntax errors become loud ValueErrors (an
    unparseable file would silently escape every pass)."""
    files = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            text = f.read()
        rel = os.path.relpath(p, repo_root)
        try:
            files.append(SourceFile(p, rel, text))
        except SyntaxError as e:
            raise ValueError(f"cannot parse {rel}: {e}") from e
    return files


# ------------------------------------------------------------------ baseline
def baseline_key(rule: str, path: str, detail: str) -> str:
    return f"{rule}|{path}|{detail}"


def load_baseline(path: str) -> dict[str, int]:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def save_baseline(path: str, findings: list[Finding]) -> dict[str, int]:
    counts: dict[str, int] = {}
    for f in findings:
        if f.allowed_by is None:
            counts[f.key()] = counts.get(f.key(), 0) + 1
    with open(path, "w") as fp:
        json.dump(
            {"version": 1, "findings": dict(sorted(counts.items()))}, fp, indent=1
        )
        fp.write("\n")
    return counts


def diff_against_baseline(
    findings: list[Finding], baseline: dict[str, int]
) -> tuple[list[Finding], list[str], dict[str, int]]:
    """Ratchet: returns (new findings over baseline, fixed keys, live counts).

    Per key, the first ``baseline[key]`` findings pass; extras are new.
    Baseline keys with no live finding are fixed (informational)."""
    counts: dict[str, int] = {}
    new: list[Finding] = []
    for f in findings:
        if f.allowed_by is not None:
            continue
        k = f.key()
        counts[k] = counts.get(k, 0) + 1
        if counts[k] > baseline.get(k, 0):
            new.append(f)
    fixed = sorted(k for k in baseline if counts.get(k, 0) < baseline[k])
    return new, fixed, counts
