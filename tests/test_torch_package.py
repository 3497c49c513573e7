"""PyTorch port, package rules and entry points: no JAX and nothing of the
JAX package behind ``repro_torch`` or ``chip_smoke.py``; the host-side numpy
copies (volumes, isosurface, cameras, configs, metrics) equal their JAX
package originals; the serving CLI and ``chip_smoke.py`` refuse to run
without a card."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import gs_datasets as J_datasets
from repro.obs import MetricsRegistry as JaxMetricsRegistry
from repro.volume import cameras as J_cameras
from repro.volume import datasets as J_volumes
from repro.volume import isosurface as J_iso
from repro_torch.configs import gs_datasets as T_datasets
from repro_torch.launch import serve_gs as T_cli
from repro_torch.obs import MetricsRegistry
from repro_torch.serve_gs import RenderServer
from repro_torch.volume import cameras as T_cameras
from repro_torch.volume import datasets as T_volumes
from repro_torch.volume import isosurface as T_iso

from torch_port_helpers import np_

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro(\.| ))", re.M)


def _port_modules() -> list[str]:
    return sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_port_sources_never_import_jax_or_the_jax_package():
    offenders = [
        f"{p.relative_to(REPO)}: {m.group(0).strip()}"
        for p in [*PORT.rglob("*.py"), REPO / "chip_smoke.py", *REPO.glob("benchmarks/*_torch.py"),
                  *REPO.glob("examples/*_torch.py")]
        for m in _FORBIDDEN.finditer(p.read_text())
    ]
    assert not offenders, offenders


def test_importing_every_port_module_loads_no_jax():
    assert {"repro_torch.analysis.tsan", "repro_torch.obs.export", "repro_torch.obs.slo", "repro_torch.frontend.gateway",
            "repro_torch.frontend.sessions", "repro_torch.launch.frontend", "repro_torch.obs.replay",
            "repro_torch.obs.costmodel", "repro_torch.obs.autotune", "repro_torch.launch.tune",
            "repro_torch.models.moe", "repro_torch.configs.granite_3_8b", "repro_torch.configs.granite_moe_3b_a800m",
            "repro_torch.configs.moonshot_v1_16b_a3b", "repro_torch.configs.kimi_k2_1t_a32b"} <= set(_port_modules())
    code = (
        "import importlib, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'repro.')) or k == 'repro')\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


KERNEL_DIRECTIONS = ("gsproject", "gsproject_bwd", "tile_raster_fwd", "tile_raster_bwd", "slab_gather", "slab_bwd",
                     "flash_attention")


def test_only_the_kernel_library_enters_a_device_reads_its_stream_or_counts_a_launch():
    """``kernels/_lib.py`` ``call`` owns a launch's device, stream, error
    check and count: no other module of the port does any of them."""
    offenders = [
        f"{p.relative_to(REPO)}: {m.group(0)}"
        for p in PORT.rglob("*.py") if p.name != "_lib.py"
        for m in re.finditer(r"torch\.cuda\.device\(|cuda_stream|launch_count\.n\s*\+=|LaunchCount\(", p.read_text())
    ]
    assert not offenders, offenders


def test_each_kernel_direction_reports_from_one_cost_region():
    """One ``_cost.region`` per autograd Function direction, around its
    choice of device, so each kernel's count is reported once for both."""
    names = [m.group(1) for p in (PORT / "kernels").rglob("*.py")
             for m in re.finditer(r"\b_cost\.region\(\s*\"(\w+)\"", p.read_text())]
    assert sorted(names) == sorted(KERNEL_DIRECTIONS)


def test_volume_isosurface_and_cameras_equal_jax_package():
    vj, vt = J_volumes.kingsnake_like(res=20), T_volumes.kingsnake_like(res=20)
    np.testing.assert_array_equal(vt.field, vj.field)
    for a, b in zip(J_iso.extract_isosurface_points(vj, max_points=300), T_iso.extract_isosurface_points(vt, max_points=300)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(T_volumes.miranda_like(res=12).field, J_volumes.miranda_like(res=12).field)
    cj = J_cameras.orbit_cameras(5, img_h=32, img_w=48, radius=2.5)
    ct = T_cameras.orbit_cameras(5, img_h=32, img_w=48, radius=2.5)
    for f in cj._fields:
        np.testing.assert_allclose(np_(getattr(ct, f)), np.asarray(getattr(cj, f)), atol=1e-6)
    one = T_cameras.camera_slice(ct, 3)
    assert one.viewmat.shape == (4, 4)


def test_dataset_configs_equal_jax_package():
    assert T_datasets.DATASETS.keys() == J_datasets.DATASETS.keys()
    for k in T_datasets.DATASETS:
        assert vars(T_datasets.DATASETS[k]) == vars(J_datasets.DATASETS[k])
    a, b = T_datasets.paper_gs_config(512), J_datasets.paper_gs_config(512)
    assert vars(a) == vars(b)


def test_metrics_registry_copy_behaves_like_the_original():
    t, j = MetricsRegistry(), JaxMetricsRegistry()
    for reg in (t, j):
        reg.counter("server.completed").inc(2)
        for v in (1.0, 2.0, 3.0, 50.0):
            reg.histogram("server.latency_ms").observe(v)
    assert t.snapshot() == j.snapshot()


def test_serve_cli_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI serves on it instead of refusing")
    with pytest.raises(SystemExit, match="no CUDA device"):
        T_cli.main(["--smoke"])


def test_serve_cli_cpu_smoke(capsys):
    T_cli.main(["--smoke", "--device", "cpu", "--clients", "2", "--requests", "2", "--levels", "2"])
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "device=cpu" in out


def test_chip_smoke_exits_without_result_when_it_cannot_run(tmp_path):
    """Without a card (or alone, outside a checkout) it fails and prints no result."""
    env = {**os.environ, "PYTHONPATH": ""}
    runs = [[sys.executable, str(REPO / "chip_smoke.py")]] if not torch.cuda.is_available() else []
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    runs.append([sys.executable, str(alone)])
    for cmd in runs:
        out = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0, out.stdout
        assert '"ok"' not in out.stdout


def test_port_server_defaults_to_the_card():
    import inspect

    assert inspect.signature(RenderServer).parameters["device"].default == "cuda"
