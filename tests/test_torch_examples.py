"""PyTorch port, the serving examples' mirrors on the CPU:
``examples/serve_gs_quickstart_torch.py`` serves a synthetic scene to PPM
frames, and ``examples/render_novel_views_torch.py`` renders a novel orbit
from a checkpoint the port's training CLI wrote, each at 32 px (as
``tests/test_cli_drivers.py`` runs the JAX examples); and
``examples/insitu_timeseries_torch.py --smoke`` streams two timesteps into
the in situ trainer and scrubs them."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def _run(args, cwd):
    r = subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1"))
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2500:])
    return r.stdout


def _read_ppm(path: Path) -> np.ndarray:
    raw = path.read_bytes()
    magic, dims, depth, pix = raw.split(b"\n", 3)
    w, h = (int(x) for x in dims.split())
    assert magic == b"P6" and depth == b"255"
    return np.frombuffer(pix, np.uint8).reshape(h, w, 3)


def test_serve_gs_quickstart_mirror_writes_frames(tmp_path):
    out = tmp_path / "served"
    stdout = _run([str(REPO / "examples" / "serve_gs_quickstart_torch.py"), "--device", "cpu", "--res", "32",
                   "--views", "2", "--out", str(out)], tmp_path)
    files = sorted(out.iterdir())
    assert [f.name for f in files] == [f"frame_{k:03d}.ppm" for k in range(4)]
    frames = [_read_ppm(f) for f in files]
    assert all(f.shape == (32, 32, 3) for f in frames) and frames[0].max() > 0
    report = json.loads(stdout[stdout.index("{"):])
    assert report["completed"] == 4 and report["lod"]["requests_per_level"][1] > 0


def test_train_then_render_novel_views_mirror(tmp_path):
    ckpt = tmp_path / "ckpt"
    stdout = _run(["-m", "repro_torch.launch.train", "--device", "cpu", "--dataset", "kingsnake", "--volume-res",
                   "32", "--max-points", "800", "--res", "32", "--steps", "8", "--views", "4", "--batch", "2",
                   "--ckpt", str(ckpt)], tmp_path)
    assert "final-loss" in stdout
    renders = tmp_path / "renders"
    _run([str(REPO / "examples" / "render_novel_views_torch.py"), "--device", "cpu", "--ckpt", str(ckpt),
          "--res", "32", "--views", "2", "--out", str(renders)], tmp_path)
    files = sorted(renders.iterdir())
    assert [f.name for f in files] == ["novel_000.ppm", "novel_001.ppm"]
    for f in files:
        img = _read_ppm(f)
        assert img.shape == (32, 32, 3) and img.max() > 0


def test_insitu_timeseries_mirror_streams_and_scrubs(tmp_path):
    stdout = _run([str(REPO / "examples" / "insitu_timeseries_torch.py"), "--device", "cpu", "--smoke"], tmp_path)
    assert "train-step shape signatures across the sequence: 1" in stdout
    assert "[insitu] t=0 cold" in stdout and "[insitu] t=1 warm" in stdout
    frames = [line for line in stdout.splitlines() if line.strip().startswith("t=")]
    assert len(frames) == 2 and all("frame (32, 32, 3)" in line for line in frames)
