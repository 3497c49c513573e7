"""PyTorch port, the paper's tables on the CPU: the mirrors of
``benchmarks/table23_quality.py`` and ``benchmarks/table1_scaling.py``.

``table23_quality_torch.py`` runs spawned gloo ranks, worlds 1 and 2 ((1, 1)
and (2, 1) meshes), at 32 px, 600 points, 4 steps, with the JAX script's
padding and views. Its world-1 run is held to the JAX functions the JAX
script calls (``init_state``, ``make_train_step`` on a (1, 1) mesh,
``make_eval_render``, ``psnr`` / ``ssim`` / ``lpips_proxy``) on the same
ground truth: per-step losses at rtol 1e-5, the three metrics at rtol 1e-4.
Its (2, 1) run's per-step losses are held to world 1 at rtol 1e-5.

``table1_scaling_torch.py --smoke --device cpu`` runs worlds 1 and 2 and
writes the schema-2 record in the JAX file's key layout, with speedups
computed as the one-worker step over the row's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import gaussians as JG
from repro.core.config import GSConfig
from repro.core.losses import lpips_proxy, psnr, ssim
from repro.core.train import init_state, make_eval_render, make_train_step, state_shardings
from repro.data.views import ViewDataset
from repro.volume import extract_isosurface_points, kingsnake_like

REPO = Path(__file__).resolve().parents[1]
H, POINTS, STEPS, VIEWS = 32, 600, 4, 12


def _start(argv, cwd) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, *argv], cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc: subprocess.Popen) -> str:
    try:
        out = proc.communicate(timeout=240)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-4000:]
    return out


def jax_quality(cache_dir: str) -> dict:
    """The JAX script's run (``benchmarks/table23_quality.py`` SCRIPT) on
    one device at this file's size, with per-step losses."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    cfg = GSConfig(img_h=H, img_w=H, k_per_tile=192, batch_size=4, backend="ref")
    vol = kingsnake_like(res=40)
    pts, _, cols = extract_isosurface_points(vol, max_points=POINTS, seed=0)
    pad = (-pts.shape[0]) % (mesh.shape["model"] * 256)
    pts = np.concatenate([pts, np.full((pad, 3), 1e6, np.float32)])
    cols = np.concatenate([cols, np.zeros((pad, 3), np.float32)])
    g = JG.init_from_points(jnp.asarray(pts), jnp.asarray(cols), init_scale=0.05)
    g = g._replace(opacity_logit=g.opacity_logit.at[pts.shape[0] - pad:].set(-20.))
    data = ViewDataset(vol, n_views=VIEWS, img_h=H, img_w=H, cache_dir=cache_dir, n_steps_raymarch=96)
    state = jax.device_put(init_state(g), state_shardings(mesh))
    step = make_train_step(mesh, cfg)
    losses = []
    for cams, gt in data.batches(cfg.batch_size, steps=STEPS):
        state, m = step(state, cams, gt)
        losses.append(float(m["loss"]))
    ev = make_eval_render(mesh, cfg)
    ps, ss, lp = [], [], []
    for i in range(0, VIEWS, 3):
        cam, gt = data.view(i)
        img, _ = ev(state.params, cam)
        ps.append(float(psnr(img, gt)))
        ss.append(float(ssim(img, gt)))
        lp.append(float(lpips_proxy(img, gt)))
    return {"losses": losses, "psnr": float(np.mean(ps)), "ssim": float(np.mean(ss)),
            "lpips_proxy": float(np.mean(lp))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both mirrors' runs, started together, and the JAX run meanwhile:
    {"quality": (the port's rows by worker count, the JAX run),
    "table1": (its stdout, its output directory, its record's path)}. The
    quality runs share one ground truth: the JAX ray marcher writes it, the
    port's ranks read it."""
    tmp = tmp_path_factory.mktemp("tables")
    gt = str(tmp / "gt")
    ViewDataset(kingsnake_like(res=40), n_views=VIEWS, img_h=H, img_w=H, cache_dir=gt, n_steps_raymarch=96)
    quality = _start([str(REPO / "benchmarks" / "table23_quality_torch.py"), "--device", "cpu", "--workers", "1",
                      "2", "--points", str(POINTS), "--res", str(H), "--steps", str(STEPS), "--cache-dir", gt,
                      "--out", str(tmp / "q")], tmp)
    bench = tmp / "BENCH_table1.json"
    table1 = _start([str(REPO / "benchmarks" / "table1_scaling_torch.py"), "--smoke", "--device", "cpu",
                     "--out", str(tmp / "t1"), "--bench-out", str(bench)], tmp)
    want = jax_quality(gt)
    out_q, out_t1 = _finish(quality), _finish(table1)
    assert out_q.splitlines()[-1].startswith("2,")  # the table's last row
    rows = json.loads((tmp / "q" / "quality_rows.json").read_text())["rows"]
    return {"quality": ({r["workers"]: r for r in rows}, want), "table1": (out_t1, tmp / "t1", bench)}


@pytest.fixture
def quality(runs):
    return runs["quality"]


def test_table23_world_one_matches_the_jax_script(quality):
    rows, want = quality
    got = rows[1]
    assert got["mesh"] == [1, 1] and got["n_gaussians"] == 768
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert got["loss"] == got["losses"][-1]
    for k in ("psnr", "ssim", "lpips_proxy"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    # at 32 px the config bins flat, so both lists are the same lists
    assert got["valid_entries"] == got["valid_entries_flat"] > 0 and 0 < got["covered_share"] <= 1


def test_table23_data_axis_losses_match_world_one(quality):
    rows, _ = quality
    assert rows[2]["mesh"] == [2, 1]
    np.testing.assert_allclose(rows[2]["losses"], rows[1]["losses"], rtol=1e-5)
    for k in ("psnr", "ssim", "lpips_proxy"):
        np.testing.assert_allclose(rows[2][k], rows[1][k], rtol=1e-4, err_msg=k)


def test_table1_smoke_writes_the_jax_key_layout(runs):
    out, t1, bench = runs["table1"]
    assert "dataset,res,workers,mesh,gather_mode,measured_speedup_vs_1w" in out
    rec = json.loads(bench.read_text())
    assert rec["bench"] == "table1_scaling_torch" and rec["schema"] == 2
    rows = {r["case"]: r for r in json.loads((t1 / "table1_rows.json").read_text())["rows"]}
    want = {f"{d}{m}_32_{w}" for d in ("kingsnake", "miranda") for m, w in (("", "1w"), ("", "2w"), ("-params3d", "2w"))}
    assert set(rows) == want | {"kingsnake_32_1w_1pod2dp"}
    m = rec["metrics"]
    assert m["cases"] == len(rows) and m["fits_40gb"] == m["fits_80gb"] == 0  # no peak is measured on the CPU
    for case, r in rows.items():
        assert r["fits"] and r["losses_within_rtol_1e-5"] and np.isfinite(r["losses"]).all()
        assert m[f"step_s_p50.{case}"] == round(r["step_ms_p50"] / 1e3, 6)
        assert f"peak_bytes.{case}" not in m and r["peak_bytes"] == [None] * r["workers"]
        assert {"batch", "dispatch", "device"} <= r["stages_ms"].keys()
        assert "busy_share" not in r and "nccl_ms" not in r  # device metrics: not measured on the CPU
        base = rows[f"{r['dataset']}_32_1w"]
        if r["mesh"] == [1, 1]:
            assert f"speedup.{case}" not in m and r["all_gather_bytes"] == 0
        else:
            assert m[f"speedup.{case}"] == round(base["step_ms_p50"] / r["step_ms_p50"], 3)
            assert r["held_to"] == base["case"] and r["n_gaussians"] == base["n_gaussians"] == 3072
    # the computed all-gather payload: projected 11 floats a Gaussian a local view, params3d 14 once a step
    assert rows["kingsnake_32_2w"]["all_gather_bytes"] == 4 * 3072 * 11 * 4
    assert rows["kingsnake-params3d_32_2w"]["all_gather_bytes"] == 3072 * 14 * 4
