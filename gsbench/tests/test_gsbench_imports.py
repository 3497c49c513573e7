"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(compared by whole top-level names: the port ``repro_torch`` begins with
``repro``), and the reference, the scene and the work counts import
nothing of the port."""
import ast
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
INDEPENDENT = ("reference", "scene", "work")


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(*sub):
    for d, _, files in os.walk(os.path.join(ROOT, "gsbench", *sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_of_the_benchmark_imports_jax_or_repro():
    for path in _sources():
        assert not _imports(path) & FORBIDDEN, path


def test_reference_scene_and_work_import_nothing_of_the_port():
    for sub in INDEPENDENT:
        for path in _sources(sub):
            assert "repro_torch" not in _imports(path), path


def test_a_whole_run_loads_no_jax_or_repro():
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r}, {os.path.join(ROOT, 'gsbench', 'tests')!r}]\n"
        "from conftest import shrink\n"
        "from gsbench.harness import load_cell, run_rank, forbidden_modules\n"
        "r = run_rank(0, 1, dict(cell=shrink(load_cell('ks4m-train-512')), seed=7, seconds=0.3, trace=True,"
        " device='cpu', t0=time.time()))\n"
        "assert r['correct'] and r['forbidden_modules'] == []\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and not top & FORBIDDEN


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from gsbench.harness import forbidden_modules

    assert forbidden_modules() == [] or "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro_torch_like" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in forbidden_modules()
