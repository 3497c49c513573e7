"""CLI: run the port's static passes (``analysis/``) with a baseline ratchet.

::

    PYTHONPATH=src python -m repro_torch.launch.analyze \
        --report ANALYSIS_report.json

The JAX package's CLI (its ``launch/analyze.py``) with the same flags,
defaults, report schema and exit codes, over the port's own copy of the
passes: both CLIs read the same ``ANALYSIS_baseline.json`` and pragmas and
report the same findings on a tree without PyTorch's graph constructors
(``analysis/retrace.py`` adds those). It imports neither JAX nor the JAX
package, so it runs on a machine that has only the port.

Runs the retrace lint, the vocabulary checker, the static lockset pass, and
the broad-except lint over ``src/`` (vocabulary additionally scans
``benchmarks/``, ``tests/``, and the docs), applies ``# analysis:
allow(...)`` pragmas, and ratchets the remaining findings against
``ANALYSIS_baseline.json``: pre-existing findings pass, new ones fail with
exit code 1. ``--update-baseline`` rewrites the baseline to the current
findings (the "accept this debt, block growth" workflow). Pure AST — never
imports jax or torch; a full-repo run takes a few seconds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.analysis import common
from repro_torch.analysis import hygiene, locks, names, retrace

PASSES = {
    "retrace": retrace.run,
    "locks": locks.run,
    "hygiene": hygiene.run,
    # "names" runs separately: it takes extra code roots + doc files
}

DOC_FILES = ("README.md", os.path.join("benchmarks", "bench_schema.py"))


def run_analysis(
    repo_root: str,
    *,
    src_root: str = "src",
    extra_code_roots: tuple[str, ...] = ("benchmarks", "tests"),
    doc_files: tuple[str, ...] = DOC_FILES,
    rules: set[str] | None = None,
) -> list[common.Finding]:
    """Run every pass; returns findings (pragma-waived ones included, with
    ``allowed_by`` set)."""
    src_files = common.load_tree(
        common.iter_python_files(os.path.join(repo_root, src_root)), repo_root
    )
    findings: list[common.Finding] = []
    for fn in PASSES.values():
        findings.extend(fn(src_files))

    # the vocabulary pass sees benchmarks + tests too (uses/reads live
    # there), and the docs for drift
    vocab_files = list(src_files)
    for root in extra_code_roots:
        p = os.path.join(repo_root, root)
        if os.path.isdir(p):
            vocab_files.extend(
                common.load_tree(common.iter_python_files(p), repo_root)
            )
    docs = {}
    for rel in doc_files:
        p = os.path.join(repo_root, rel)
        if os.path.exists(p):
            with open(p, encoding="utf-8") as f:
                docs[rel.replace(os.sep, "/")] = f.read()
    findings.extend(names.run(vocab_files, docs))

    if rules:  # selectors are exact rules or prefixes ("retrace." etc.)
        findings = [f for f in findings
                    if any(f.rule == r or f.rule.startswith(r) for r in rules)]
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.detail))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="repo root (default: cwd)")
    ap.add_argument("--src", default="src", help="source tree to lint")
    ap.add_argument("--baseline", default="ANALYSIS_baseline.json")
    ap.add_argument("--report", default=None, help="write the JSON report here")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to the current findings")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule filter (e.g. 'retrace.,names.unread')")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    rules = set(r.strip() for r in args.rules.split(",") if r.strip()) if args.rules else None
    try:
        findings = run_analysis(args.root, src_root=args.src, rules=rules)
    except ValueError as e:
        print(f"analyze: {e}", file=sys.stderr)
        return 2

    active = [f for f in findings if f.allowed_by is None]
    allowed = [f for f in findings if f.allowed_by is not None]
    baseline_path = os.path.join(args.root, args.baseline)
    baseline = common.load_baseline(baseline_path)
    new, fixed, counts = common.diff_against_baseline(findings, baseline)
    elapsed = time.perf_counter() - t0

    if args.update_baseline:
        common.save_baseline(baseline_path, findings)
        print(f"analyze: baseline rewritten with {len(active)} finding(s) "
              f"-> {baseline_path}")
        new, fixed = [], []

    by_rule: dict[str, int] = {}
    for f in active:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    report = {
        "schema": 1,
        "elapsed_s": round(elapsed, 3),
        "findings": len(active),
        "allowed": len(allowed),
        "by_rule": dict(sorted(by_rule.items())),
        "baseline": {
            "path": args.baseline,
            "entries": sum(baseline.values()),
            "new": len(new),
            "fixed": len(fixed),
            "fixed_keys": fixed,
        },
        "new_findings": [f.to_dict() for f in new],
        "all_findings": [f.to_dict() for f in active],
        "allowed_findings": [f.to_dict() for f in allowed],
    }
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")

    if not args.quiet:
        print(f"analyze: {len(active)} finding(s) "
              f"({len(allowed)} pragma-allowed) in {elapsed*1e3:.0f} ms; "
              f"baseline covers {sum(baseline.values())}, new: {len(new)}, "
              f"fixed: {len(fixed)}")
        for f in new:
            print(f"  NEW {f.rule} {f.path}:{f.line} [{f.detail}] {f.message}")
        if fixed:
            for k in fixed:
                print(f"  fixed (re-tighten baseline): {k}")
    if new:
        print(
            f"analyze: {len(new)} new finding(s) over the baseline — fix "
            "them, pragma them with a reason, or (for accepted debt) rerun "
            "with --update-baseline",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
