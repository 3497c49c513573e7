"""Error-handling hygiene: no silent broad exception swallowing (a copy of
the JAX package's ``analysis/hygiene.py``).

``hygiene.broad_except``
    A ``except Exception:`` / bare ``except:`` / ``except BaseException:``
    handler. Broad handlers on the serving hot path turn real failures
    (encoder bugs, engine state corruption) into silently-wrong frames.
    Legitimate catch-alls — last-ditch dispatcher survival, reader-death
    fan-out — must (a) record an ``obs`` error counter or re-raise/surface
    the error, and (b) carry a reasoned pragma::

        except Exception:  # analysis: allow(hygiene.broad_except, last-ditch: counted on gateway.engine_errors)
"""
from __future__ import annotations

import ast

from repro_torch.analysis.common import Finding, SourceFile

__all__ = ["run"]

_BROAD = {"Exception", "BaseException"}


def _is_broad(node: ast.ExceptHandler) -> bool:
    t = node.type
    if t is None:
        return True  # bare except:
    if isinstance(t, ast.Name):
        return t.id in _BROAD
    if isinstance(t, ast.Attribute):  # builtins.Exception spelled out
        return t.attr in _BROAD
    if isinstance(t, ast.Tuple):
        return any(isinstance(el, (ast.Name, ast.Attribute)) and
                   (el.id if isinstance(el, ast.Name) else el.attr) in _BROAD
                   for el in t.elts)
    return False


def run(files: list[SourceFile]) -> list[Finding]:
    out: list[Finding] = []
    for sf in files:
        findings: list[Finding] = []
        func_stack: list[tuple[str, int, int]] = []
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func_stack.append((node.name, node.lineno, node.end_lineno or node.lineno))
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ExceptHandler) and _is_broad(node):
                enclosing = [f for f in func_stack if f[1] <= node.lineno <= f[2]]
                # innermost enclosing function = the one starting last
                ctx = max(enclosing, key=lambda f: f[1])[0] if enclosing else "<module>"
                findings.append(Finding(
                    "hygiene.broad_except", sf.relpath, node.lineno, ctx,
                    f"broad exception handler in {ctx}: narrow the caught "
                    "types, or keep it broad with a reasoned pragma (and an "
                    "obs error counter if this swallows on a hot path)",
                ))
        out.extend(sf.apply_pragmas(findings))
    return out
