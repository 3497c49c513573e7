"""PyTorch port, static analysis: the port's passes (``src/repro_torch/analysis/``)
and CLI (``src/repro_torch/launch/analyze.py``) against the JAX package's.

Every fixture tree of tests/test_analysis.py goes through both packages'
passes, which must give identical ``Finding.to_dict()`` lists; both CLIs
run on the live repo and agree section for section against the committed
baseline, which neither rewrites. The port's CLI is held to the JAX CLI's
contract (seeded regressions, ``--update-baseline`` on a copy, ``--rules``,
parse errors), its retrace pass to PyTorch's constructors of compiled and
captured callables, and it runs from a copy of ``src/repro_torch`` alone
with neither JAX nor the JAX package loaded.

Pure AST: no fixture is imported or run. Fixture sources keep their metric
literals inside source strings (``*.fixture_*``), so the live ``names``
pass scanning tests/ sees no use or registration in this file.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import common as j_common
from repro.analysis import hygiene as j_hygiene
from repro.analysis import locks as j_locks
from repro.analysis import names as j_names
from repro.analysis import retrace as j_retrace
from repro.launch import analyze as j_analyze
from repro_torch.analysis import common, hygiene, locks, names, retrace
from repro_torch.launch import analyze

REPO = Path(__file__).resolve().parents[1]
JAX_PASSES = {"retrace": j_retrace.run, "locks": j_locks.run, "hygiene": j_hygiene.run, "names": j_names.run}
PORT_PASSES = {"retrace": retrace.run, "locks": locks.run, "hygiene": hygiene.run, "names": names.run}

# tests/test_analysis.py's fixture trees: name -> (pass, {relpath: source},
# docs, the rules its assertions expect, pragma-allowed findings included)
FIXTURES = {
    "retrace_jit_in_loop": ("retrace", {"mod.py": """
        import jax
        def caller(xs):
            for x in xs:
                f = jax.jit(step)
            gs = [jax.jit(g) for g in xs]
    """}, None, ["retrace.jit_in_loop"] * 2),
    "retrace_factory_in_loop": ("retrace", {"mod.py": """
        import jax
        def make_step():
            return jax.jit(step)
        def caller(xs):
            for x in xs:
                s = make_step()
    """}, None, ["retrace.factory_in_loop"]),
    "retrace_jit_outside_factory_and_waivers": ("retrace", {"mod.py": """
        import jax
        def handler(x):
            g = jax.jit(step)       # per-call retrace: flagged
            return g(x)
        def make_kernel():
            def run(x):             # closure inside a factory: fine
                return pallas_call(kern)(x)
            return jax.jit(run)
        def __init__(self):
            self.f = jax.jit(step)  # construction-time: fine
    """}, None, ["retrace.jit_outside_factory"]),
    "retrace_decorator_is_enclosing_scope": ("retrace", {"mod.py": """
        import jax
        from functools import partial
        @partial(jax.jit, static_argnums=(1,))
        def render(x, n):
            return x * n
        def caller(xs):
            return [render(x, 2) for x in xs]
    """}, None, []),
    "retrace_generic_names_never_factories": ("retrace", {"mod.py": """
        import jax
        class K:
            def run(self):
                return jax.jit(step)
        def drive(server, xs):
            for x in xs:
                server.run()
    """}, None, ["retrace.jit_outside_factory"]),
    "retrace_unhashable_static": ("retrace", {"mod.py": """
        import jax
        f = jax.jit(step, static_argnums=[1])
        g = jax.jit(step, static_argnames=("n",))
    """}, None, ["retrace.unhashable_static"]),
    "names_vocabulary": ("names", {"mod.py": """
        def wire(m, snap):
            m.counter("server.fixture_hits").inc()
            m.gauge("server.fixture_dead").set(1)
            return snap["server.fixture_hits"], snap["server.fixture_typo"]
    """}, None, ["names.unread", "names.unregistered_use"]),
    "names_doc_evidence_and_drift": ("names", {"mod.py": """
        def wire(m):
            m.gauge("server.fixture_doc").set(1)
    """}, {"README.md": "reports `server.fixture_doc` and `server.fixture_ghost`"}, ["names.doc_drift"]),
    "names_dynamic_families_and_declare": ("names", {"mod.py": """
        def wire(m, prefix, snap, i):
            m.gauge(f"server.fixture_l{i}").set(1)     # family: resolvable
            m.gauge(prefix + ".depth").set(1)          # unresolvable: flagged
            m.gauge(prefix + ".width").set(1)  # analysis: declare(train.fixture_w.*)
            return snap["server.fixture_l3"], snap["train.fixture_w.depth"]
    """}, {"README.md": "see `server.fixture_l<i>` per level"}, ["names.dynamic_unresolved"]),
    "names_prefix_read_reclassification": ("names", {"mod.py": """
        def wire(m, snap):
            m.counter("server.fixture_a.s0").inc()
            m.counter("server.fixture_a.s1").inc()
            return {k: v for k, v in snap.items()
                    if k.startswith("server.fixture_a.s")}
    """}, None, []),
    "names_spans": ("names", {"mod.py": """
        STAGES = ("alpha", "beta")
        def go(rec, rid):
            rec.record(rid, "alpha", 0.0)
            rec.record(rid, "gamma", 0.0)
    """}, None, ["names.unknown_span", "names.unrecorded_stage"]),
    "names_test_files_may_record_offvocab_spans": ("names", {
        "src/trace.py": "STAGES = ('alpha',)\ndef go(r, rid): r.record(rid, 'alpha', 0)\n",
        "tests/t_x.py": "def go(r, rid): r.record(rid, 'mystery', 0)\n",
    }, None, []),
    "locks_inconsistent_guard": ("locks", {"mod.py": """
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.items = []
            def put(self, x):
                with self._lock:
                    self.items.append(x)
            def drop(self):
                self.items = []
    """}, None, ["locks.inconsistent_guard"]),
    "locks_consistent_guard_is_clean": ("locks", {"mod.py": """
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.items = []
            def put(self, x):
                with self._lock:
                    self.items.append(x)
            def drain(self):
                with self._lock:
                    out, self.items = self.items, []
                return out
    """}, None, []),
    "locks_thread_shared_write": ("locks", {"mod.py": """
        import threading
        class W:
            def start(self):
                self._t = threading.Thread(target=self._loop)
                self._t.start()
            def _loop(self):
                self.count = 1
            def read(self):
                return self.count
    """}, None, ["locks.thread_shared_write"]),
    "locks_thread_shared_guarded_is_clean": ("locks", {"mod.py": """
        import threading
        class W:
            def start(self):
                self._lock = threading.Lock()
                threading.Thread(target=self._loop).start()
            def _loop(self):
                with self._lock:
                    self.count = 1
            def read(self):
                with self._lock:
                    return self.count
    """}, None, []),
    "locks_pragma_on_method_header_covers_block": ("locks", {"mod.py": """
        import threading
        class W:
            def start(self):
                threading.Thread(target=self._loop).start()
            def _loop(self):  # analysis: allow(locks.thread_shared_write, ordered by queue.join)
                self.count = 1
            def read(self):
                return self.count
    """}, None, ["locks.thread_shared_write"]),
    "hygiene_broad_except": ("hygiene", {"mod.py": """
        def f():
            try:
                g()
            except Exception:
                pass
            try:
                g()
            except (ValueError, BaseException):
                pass
            try:
                g()
            except:
                pass
            try:
                g()
            except ValueError:
                pass
    """}, None, ["hygiene.broad_except"] * 3),
    "pragma_placements": ("retrace", {"mod.py": """
        import jax
        def a(x):
            g = jax.jit(step)  # analysis: allow(retrace.jit_outside_factory, one-shot path)
            return g(x)
        def b(x):
            # analysis: allow(retrace., whole-family prefix on next line)
            g = jax.jit(step)
            return g(x)
        def c(x):  # analysis: allow(*, block scope from the def header)
            g = jax.jit(step)
            return g(x)
        def d(x):
            g = jax.jit(step)  # analysis: allow(locks.thread_shared_write, wrong rule)
            return g(x)
    """}, None, ["retrace.jit_outside_factory"] * 4),
}


def _tree(root: Path, files: dict) -> list[str]:
    paths = []
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
        paths.append(str(p))
    return paths


def _findings(load_tree, passes, which, paths, root, docs):
    fs = load_tree(paths, str(root))
    found = passes[which](fs, docs) if which == "names" else passes[which](fs)
    return [f.to_dict() for f in found]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_passes_match_jax_fixture_by_fixture(tmp_path, name):
    which, files, docs, rules = FIXTURES[name]
    paths = _tree(tmp_path, files)
    want = _findings(j_common.load_tree, JAX_PASSES, which, paths, tmp_path, docs)
    got = _findings(common.load_tree, PORT_PASSES, which, paths, tmp_path, docs)
    assert got == want
    assert sorted(f["rule"] for f in got) == sorted(rules)


def test_baseline_ratchet_matches_jax(tmp_path):
    """The same findings give the same baseline file, byte for byte, and the
    same ratchet: counts per key, fixed keys, pragma-allowed never counted."""
    def findings(mod):
        fs = [mod.Finding("r.x", "a.py", 3, "A.f", "m"), mod.Finding("r.x", "a.py", 9, "A.f", "m"),
              mod.Finding("r.y", "b.py", 1, "B.g", "m"), mod.Finding("r.x", "a.py", 20, "A.f", "m"),
              mod.Finding("r.z", "c.py", 2, "C.h", "m")]
        fs[4].allowed_by = "waived"
        return fs

    out = {}
    for label, mod in (("jax", j_common), ("port", common)):
        path = tmp_path / f"{label}.json"
        counts = mod.save_baseline(str(path), findings(mod)[:3])
        base = mod.load_baseline(str(path))
        runs = [mod.diff_against_baseline(fs, base) for fs in (findings(mod)[:3], findings(mod)[:2], findings(mod))]
        out[label] = (path.read_bytes(), counts, base,
                      [([f.to_dict() for f in new], fixed, live) for new, fixed, live in runs])
    assert out["port"] == out["jax"]
    assert out["port"][2] == {"r.x|a.py|A.f": 2, "r.y|b.py|B.g": 1}
    assert out["port"][3][1][1] == ["r.y|b.py|B.g"]
    assert [f["line"] for f in out["port"][3][2][0]] == [20]


# ---------------------------------------------------------------- PyTorch's constructors
TORCH_SOURCE = """
import functools
import re

import torch
import torch as th
from torch.cuda import CUDAGraph


def step(x):
    return x


def train(xs, net):
    for x in xs:
        f = torch.compile(step)
        pattern = re.compile("a+")
        net.compile()
        graph(x)
    return f


def export(mods, xs):
    out = []
    for m in mods:
        out.append(torch.jit.script(m))
        out.append(torch.jit.trace(m, xs))
    return out + [torch.cuda.make_graphed_callables(m, (xs,)) for m in mods]


def handler(x):
    g = CUDAGraph()
    with th.cuda.graph(g):
        y = step(x)
    return g, y, functools.partial(torch.compile, mode="max-autotune")


def make_captured(x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = step(x)
    return g, y


def replay(xs):
    for x in xs:
        make_captured(x)


compiled = torch.compile(step)
"""

TORCH_WANT = [
    ("retrace.jit_in_loop", "train:torch.compile"),
    ("retrace.jit_in_loop", "export:torch.jit.script"),
    ("retrace.jit_in_loop", "export:torch.jit.trace"),
    ("retrace.jit_in_loop", "export:torch.cuda.make_graphed_callables"),
    ("retrace.jit_outside_factory", "handler:torch.cuda.CUDAGraph"),
    ("retrace.jit_outside_factory", "handler:torch.cuda.graph"),
    ("retrace.jit_outside_factory", "handler:partial"),
    ("retrace.factory_in_loop", "replay:make_captured"),
]


def test_retrace_flags_pytorch_constructors(tmp_path):
    """torch.compile, TorchScript and CUDA-graph construction in a loop or a
    per-call function, and a capturing make_* factory called in a loop, under
    the JAX rule ids; ``re.compile``, a method named ``compile`` and a bare
    ``graph`` are not constructors, nor is module scope or a factory. The JAX
    pass knows none of these spellings."""
    paths = _tree(tmp_path, {"mod.py": TORCH_SOURCE})
    got = retrace.run(common.load_tree(paths, str(tmp_path)))
    assert sorted((f.rule, f.detail) for f in got) == sorted(TORCH_WANT)
    assert all(f.allowed_by is None for f in got)
    assert j_retrace.run(j_common.load_tree(paths, str(tmp_path))) == []


def test_retrace_pytorch_constructors_waived_by_pragmas(tmp_path):
    """A reasoned pragma on each flagged line waives it: the findings stay,
    reported as allowed, and none is left active."""
    lines = TORCH_SOURCE.splitlines()
    paths = _tree(tmp_path, {"mod.py": TORCH_SOURCE})
    flagged = {f.line for f in retrace.run(common.load_tree(paths, str(tmp_path)))}
    waived = [line + "  # analysis: allow(retrace., built once per process)" if i in flagged else line
              for i, line in enumerate(lines, start=1)]
    paths = _tree(tmp_path, {"mod.py": "\n".join(waived) + "\n"})
    got = retrace.run(common.load_tree(paths, str(tmp_path)))
    assert sorted((f.rule, f.detail) for f in got) == sorted(TORCH_WANT)
    assert {f.allowed_by for f in got} == {"built once per process"}


# ---------------------------------------------------------------- the CLI
def _seeded_module() -> str:
    from test_analysis import _BAD_MODULE

    return _BAD_MODULE


def _seeded_root(tmp_path: Path) -> Path:
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "seeded.py").write_text(_seeded_module())
    return tmp_path


def test_cli_seeded_regressions_fail_then_baseline(tmp_path):
    """tests/test_analysis.py's seeded module through the port's CLI: rc 1
    with every rule, the same report as the JAX CLI's; accepted into a
    baseline on this copy, rc 0; growth over it, rc 1 again."""
    from test_analysis import _EXPECT_SEEDED

    root = _seeded_root(tmp_path)
    reports = {}
    for label, main in (("jax", j_analyze.main), ("port", analyze.main)):
        rep = root / f"{label}.json"
        assert main(["--root", str(root), "--report", str(rep), "-q"]) == 1
        reports[label] = {k: v for k, v in json.loads(rep.read_text()).items() if k != "elapsed_s"}
    assert reports["port"] == reports["jax"]
    assert set(reports["port"]["by_rule"]) == _EXPECT_SEEDED
    assert reports["port"]["findings"] == reports["port"]["baseline"]["new"] == len(reports["port"]["new_findings"])

    assert analyze.main(["--root", str(root), "--update-baseline", "-q"]) == 0
    assert (root / "ANALYSIS_baseline.json").exists()
    assert analyze.main(["--root", str(root), "-q"]) == 0
    assert j_analyze.main(["--root", str(root), "-q"]) == 0  # one baseline file serves both CLIs

    with open(root / "src" / "seeded.py", "a") as f:
        f.write("\ndef another(x):\n    return jax.jit(step)(x)\n")
    rep = root / "grown.json"
    assert analyze.main(["--root", str(root), "--report", str(rep), "-q"]) == 1
    assert [n["detail"] for n in json.loads(rep.read_text())["new_findings"]] == ["another:jit"]


def test_cli_rule_filter_and_parse_error(tmp_path):
    root = _seeded_root(tmp_path)
    rep = root / "r.json"
    assert analyze.main(["--root", str(root), "--rules", "locks.", "-q", "--report", str(rep)]) == 1
    assert set(json.loads(rep.read_text())["by_rule"]) == {"locks.inconsistent_guard", "locks.thread_shared_write"}
    assert analyze.main(["--root", str(root), "--rules", "hygiene.,retrace.unhashable", "-q",
                         "--report", str(rep)]) == 1
    assert set(json.loads(rep.read_text())["by_rule"]) == {"hygiene.broad_except", "retrace.unhashable_static"}

    (root / "src" / "broken.py").write_text("def f(:\n")
    assert analyze.main(["--root", str(root), "-q"]) == 2


def test_live_repo_both_clis_agree_against_the_committed_baseline(tmp_path):
    """Both CLIs on the live tree: exit 0, the same findings, allowed
    findings, rules and baseline sections (only the elapsed time differs);
    the port's report meets tests/test_analysis.py's bounds, and neither
    run touches ANALYSIS_baseline.json."""
    baseline = (REPO / "ANALYSIS_baseline.json").read_bytes()
    reports = {}
    for label, main in (("jax", j_analyze.main), ("port", analyze.main)):
        rep = tmp_path / f"{label}.json"
        assert main(["--root", str(REPO), "--report", str(rep), "-q"]) == 0, rep.read_text()
        reports[label] = json.loads(rep.read_text())
    port, jax_rep = reports["port"], reports["jax"]
    for key in ("all_findings", "allowed_findings", "by_rule", "baseline", "findings", "allowed", "new_findings"):
        assert port[key] == jax_rep[key], key
    assert port["baseline"]["new"] == 0
    assert port["findings"] <= 6
    assert port["elapsed_s"] < 30.0
    assert (REPO / "ANALYSIS_baseline.json").read_bytes() == baseline


def test_cli_runs_from_the_port_alone(tmp_path):
    """A copy of src/repro_torch alone: ``python -m repro_torch.launch.analyze
    --root <copy>`` runs with no JAX, no JAX package and no torch loaded. The
    structural passes are clean there; the vocabulary pass reports only
    metrics whose readers (the tests, the README) are not in the copy."""
    shutil.copytree(REPO / "src" / "repro_torch", tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import runpy, sys\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.analyze', run_name='__main__', alter_sys=True)\n"
        "finally:\n"
        "    loaded = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'torch'))\n"
        "    print('LOADED', loaded, file=sys.stderr)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(tmp_path / "src")}

    def run(*flags):
        rep = tmp_path / "rep.json"
        out = subprocess.run([sys.executable, "-c", code, "--root", str(tmp_path), "--report", str(rep), "-q",
                              *flags], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
        assert "LOADED []" in out.stderr, out.stderr
        return out.returncode, json.loads(rep.read_text())

    rc, rep = run("--rules", "retrace.,locks.,hygiene.")
    assert rc == 0 and rep["findings"] == 0 and rep["allowed"] > 0
    rc, rep = run()
    assert rc in (0, 1)
    assert set(rep["by_rule"]) <= {"names.unread"}
    assert all(f["path"].startswith("src/repro_torch/") for f in rep["all_findings"])
