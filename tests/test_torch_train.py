"""PyTorch port, training slice: loss, optimizer, train step, densification,
ground-truth views and checkpoints against the JAX package, at small sizes
on the CPU (the port's plain versions); the training CLI through a
checkpoint to a served frame.

Tolerances, each with its reason:
- gradients: atol 2e-5 * max|g| and rtol 2e-4, the JAX package's own kernel
  test tolerance (tests/test_tile_raster_kernel.py::test_grad_allclose);
- losses and image metrics: rtol 1e-5 (float32 sums in another order);
- Adam on the same gradients: rtol 1e-5 (XLA may fuse a multiply and an
  add into one rounding, PyTorch's CPU kernels round twice);
- parameters after an Adam step: Adam's first step moves every parameter
  by lr * sign(g), so a gradient of 1e-12 in one package and -1e-12 in the
  other flips the update. Parameters are compared where |g| is above
  1e-3 * max|g| of their field, far above the gradient tolerance, so the
  two signs agree; there atol 1e-6 and rtol 1e-5.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore, save_checkpoint as jax_save
from repro.core import gaussians as JG
from repro.core import losses as JL
from repro.core import sharding as JS
from repro.core.config import GSConfig as JGSConfig
from repro.core.densify import densify_and_rebalance as jax_densify
from repro.core.train import init_state as jax_init_state
from repro.core.train import make_train_step as jax_make_train_step
from repro.core.train import shard_balance as jax_shard_balance
from repro.core.train import state_shardings
from repro.data.views import ViewDataset as JViewDataset
from repro.optim import adam as JA
from repro.optim import schedules as JSch
from repro.volume import cameras as JC
from repro.volume import datasets as JV
from repro.volume.raymarch import render_isosurface as jax_raymarch
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.core import gaussians as TG
from repro_torch.core import losses as TL
from repro_torch.core import projection as TP
from repro_torch.core import sharding as TS
from repro_torch.core.config import GSConfig
from repro_torch.core.densify import densify_and_rebalance, reset_opacity
from repro_torch.core.train import (
    init_state,
    make_batched_eval_render,
    make_train_step,
    record_shard_balance,
    shard_balance,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.data.views import ViewDataset
from repro_torch.launch import serve_gs as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.obs import MetricsRegistry, devmem
from repro_torch.optim import adam as TA
from repro_torch.optim import schedules as TSch
from repro_torch.serve_gs import stack_cameras
from repro_torch.volume import cameras as TC
from repro_torch.volume import datasets as TV
from repro_torch.volume.raymarch import render_isosurface

from torch_port_helpers import np_

RES, K, BATCH = 32, 128, 2
CFG_KW = dict(img_h=RES, img_w=RES, tile_h=16, tile_w=16, k_per_tile=K, batch_size=BATCH)


def assert_grad_close(got, want, err_msg=""):
    got, want = np_(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-8)
    np.testing.assert_allclose(got, want, atol=2e-5 * scale + 1e-10, rtol=2e-4, err_msg=err_msg)


@functools.lru_cache(maxsize=None)
def _scene(n_points=600, res=32):
    """Kingsnake isosurface points padded to a multiple of 128 (dead pads),
    as tests/test_gs_training.py sets up its training scene."""
    vol = TV.kingsnake_like(res=res)
    from repro_torch.volume.isosurface import extract_isosurface_points

    pts, _, cols = extract_isosurface_points(vol, max_points=n_points, seed=0)
    pad = (-pts.shape[0]) % 128
    pts = np.concatenate([pts, np.full((pad, 3), 1e6, np.float32)])
    cols = np.concatenate([cols, np.zeros((pad, 3), np.float32)])
    return vol, pts, cols


@functools.lru_cache(maxsize=None)
def _views(n_views=4):
    vol, _, _ = _scene()
    return ViewDataset(vol, n_views=n_views, img_h=RES, img_w=RES, n_steps_raymarch=48, device="cpu")


def _jax_state(seed=0):
    """The JAX package's initial state, with random shapes and opacities so
    every field has a gradient."""
    _, pts, cols = _scene()
    g = JG.init_from_points(jnp.asarray(pts), jnp.asarray(cols), init_scale=0.06)
    r = np.random.default_rng(seed)
    n = pts.shape[0]
    g = g._replace(
        log_scales=g.log_scales + jnp.asarray(r.normal(0, 0.2, (n, 3)), jnp.float32),
        quats=jnp.asarray(r.normal(0, 1, (n, 4)), jnp.float32),
        opacity_logit=jnp.asarray(r.normal(0.0, 1.0, (n,)), jnp.float32),
    )
    return jax_init_state(g)


@functools.lru_cache(maxsize=None)
def _jax_step():
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    return mesh, jax_make_train_step(mesh, JGSConfig(**CFG_KW))


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


# ---------------------------------------------------------------- loss


def test_ssim_l1_sums_and_losses_match_jax():
    r = np.random.default_rng(0)
    pred = r.uniform(0, 1, (2, 24, 40, 3)).astype(np.float32)
    gt = np.clip(pred + r.normal(0, 0.1, pred.shape), 0, 1).astype(np.float32)
    tp, tg = torch.tensor(pred), torch.tensor(gt)
    sums = jax.jit(lambda p, g: JS.ssim_l1_sums(p, g, None))
    for i in range(2):
        want = sums(jnp.asarray(pred[i]), jnp.asarray(gt[i]))
        got = TS.ssim_l1_sums(tp[i], tg[i])
        for a, b in zip(got, want):
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5)
    loss = jax.jit(lambda p, g: JS.distributed_gs_loss(p, g, lam=0.2))
    np.testing.assert_allclose(np_(TS.distributed_gs_loss(tp, tg, lam=0.2)),
                               np.asarray(loss(jnp.asarray(pred), jnp.asarray(gt))), rtol=1e-5)
    for name in ("l1_loss", "ssim", "dssim", "gs_loss", "psnr", "lpips_proxy"):
        np.testing.assert_allclose(np_(getattr(TL, name)(tp[0], tg[0])),
                                   np.asarray(jax.jit(getattr(JL, name))(jnp.asarray(pred[0]), jnp.asarray(gt[0]))),
                                   rtol=1e-5, err_msg=name)
    with pytest.raises(TypeError, match="mesh axis"):  # an axis of a Mesh, not a JAX axis name
        TS.ssim_l1_sums(tp[0], tg[0], "model")


def test_loss_gradient_matches_jax():
    r = np.random.default_rng(1)
    pred = r.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    gt = r.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    want = jax.grad(lambda p: JS.distributed_gs_loss(p, jnp.asarray(gt), lam=0.2))(jnp.asarray(pred))
    tp = torch.tensor(pred, requires_grad=True)
    (got,) = torch.autograd.grad(TS.distributed_gs_loss(tp, torch.tensor(gt), lam=0.2), tp)
    assert_grad_close(got, want)


# ---------------------------------------------------------------- optimizer


def test_adam_and_schedules_match_jax():
    r = np.random.default_rng(2)
    shapes = [(50, 3), (50, 3), (50, 4), (50,), (50, 1, 3)]
    params = [r.normal(size=s).astype(np.float32) for s in shapes]
    pj = JG.GaussianModel(*map(jnp.asarray, params))
    pt = TG.GaussianModel(*map(torch.tensor, params))
    sj, st = JA.adam_init(pj), TA.adam_init(pt)
    for step in range(3):
        grads = [(r.normal(size=s) * 10.0 ** r.integers(-6, 1)).astype(np.float32) for s in shapes]
        lr_j = JSch.expon_lr(jnp.int32(step * 1000), lr_init=1.6e-4, lr_final=1.6e-6, max_steps=2500)
        lr_t = TSch.expon_lr(torch.tensor(step * 1000, dtype=torch.int32), lr_init=1.6e-4, lr_final=1.6e-6,
                             max_steps=2500)
        np.testing.assert_allclose(np_(lr_t), np.asarray(lr_j), rtol=1e-6)
        lrs_j = JG.GaussianModel(lr_j * 2.0, 5e-3, 1e-3, 5e-2, 2.5e-3)
        lrs_t = TG.GaussianModel(lr_t * 2.0, 5e-3, 1e-3, 5e-2, 2.5e-3)
        pj, sj = JA.adam_update(JG.GaussianModel(*map(jnp.asarray, grads)), sj, pj, lrs_j)
        pt, st = TA.adam_update(TG.GaussianModel(*map(torch.tensor, grads)), st, pt, lrs_t)
        for name, a, b, ma, mb, va, vb in zip(TG.GaussianModel._fields, pt, pj, st.m, sj.m, st.v, sj.v):
            np.testing.assert_allclose(np_(ma), np.asarray(mb), rtol=1e-5, err_msg=name)
            np.testing.assert_allclose(np_(va), np.asarray(vb), rtol=1e-5, err_msg=name)
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5, atol=1e-7, err_msg=name)
        assert int(st.count) == int(sj.count) == step + 1
    for step in (0, 1, 17, 29_999, 30_000, 45_000):
        np.testing.assert_allclose(
            np_(TSch.expon_lr(step, lr_init=1.6e-4, lr_final=1.6e-6, max_steps=30_000)),
            np.asarray(JSch.expon_lr(jnp.int32(step), lr_init=1.6e-4, lr_final=1.6e-6, max_steps=30_000)),
            rtol=1e-6)
    assert TSch.grendel_lr_scale(4) == JSch.grendel_lr_scale(4) == 2.0


# ---------------------------------------------------------------- train step


def test_train_step_matches_jax_make_train_step():
    """One step from the same state on the same batch, then four more: the
    loss, the gradients (Adam's first moment after one step is 0.1 * g), the
    parameters above the sign-flip floor, and the densify statistics."""
    mesh, jstep = _jax_step()
    data = _views()
    sel = np.array([1, 3])
    cams_j = JC.camera_slice(JC.orbit_cameras(4, img_h=RES, img_w=RES), jnp.asarray(sel))
    gt = data.gt[sel]
    sj0 = jax.device_put(_jax_state(), state_shardings(mesh))
    sj, mj = jstep(sj0, cams_j, jnp.asarray(gt))
    tstep = make_train_step(GSConfig(**CFG_KW))
    st0 = state_from_numpy(_np_tree(sj0), "cpu")
    st, mt = tstep(st0, TP.camera_from_numpy(cams_j), torch.tensor(gt))

    np.testing.assert_allclose(np_(mt["loss"]), np.asarray(mj["loss"]), rtol=1e-5)
    for name, gt_t, gt_j, p_t, p_j, p0 in zip(TG.GaussianModel._fields, st.adam.m, sj.adam.m, st.params,
                                              sj.params, st0.params):
        g_t, g_j = np_(gt_t) / 0.1, np.asarray(gt_j) / 0.1
        assert np.isfinite(g_t).all(), name
        assert_grad_close(g_t, g_j, err_msg=name)
        above = np.abs(g_j) > 1e-3 * np.abs(g_j).max()
        assert above.any(), name
        np.testing.assert_allclose(np_(p_t)[above], np.asarray(p_j)[above], atol=1e-6, rtol=1e-5, err_msg=name)
        assert not np.array_equal(np_(p_t)[above], np_(p0)[above]), name  # the step moved them
    assert_grad_close(st.grad2d_accum, sj.grad2d_accum, err_msg="grad2d_accum")
    np.testing.assert_array_equal(np_(st.vis_count), np.asarray(sj.vis_count))
    np.testing.assert_array_equal(np_(st.max_radii), np.asarray(sj.max_radii))
    assert int(st.step) == int(sj.step) == 1 and int(st.adam.count) == 1

    # four more steps from each package's own state: the trajectories stay together
    lt, lj = [], []
    for i in range(4):
        s = np.array([(i + 2) % 4, i % 4])
        c = JC.camera_slice(JC.orbit_cameras(4, img_h=RES, img_w=RES), jnp.asarray(s))
        sj, mj = jstep(sj, c, jnp.asarray(data.gt[s]))
        st, mt = tstep(st, TP.camera_from_numpy(c), torch.tensor(data.gt[s]))
        lj.append(float(mj["loss"]))
        lt.append(float(mt["loss"]))
    np.testing.assert_allclose(lt, lj, rtol=1e-3)


def test_training_reduces_loss_and_improves_psnr():
    """The port's run of tests/test_gs_training.py's 15-step check."""
    _, pts, cols = _scene()
    cfg = GSConfig(**CFG_KW)
    g = TG.init_from_points(pts, cols, init_scale=0.06, device="cpu")
    state = init_state(g)
    step = make_train_step(cfg)
    data = _views()
    render = make_batched_eval_render(cfg)
    cam0, gt0 = data.view(0)
    with torch.no_grad():
        psnr_before = float(TL.psnr(render(state.params, stack_cameras([cam0]))[0], gt0))
    losses = []
    for cams, gt in data.batches(cfg.batch_size, steps=15):
        state, m = step(state, cams, gt)
        losses.append(float(m["loss"]))
    with torch.no_grad():
        psnr_after = float(TL.psnr(render(state.params, stack_cameras([cam0]))[0], gt0))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert psnr_after > psnr_before


def test_shard_balance_matches_jax():
    mesh, _ = _jax_step()
    sj = jax.device_put(_jax_state(3), state_shardings(mesh))
    sj = sj._replace(max_radii=jnp.asarray(np.random.default_rng(3).uniform(-1, 3, sj.params.n), jnp.float32),
                     vis_count=jnp.asarray(np.arange(sj.params.n) % 3, jnp.float32))
    want = jax_shard_balance(sj)
    got = shard_balance(state_from_numpy(_np_tree(sj), "cpu"))
    assert got == want
    reg = MetricsRegistry()
    record_shard_balance(reg, got)
    assert reg.snapshot()["train.shard_alive.s0"] == want["alive"][0]


# ---------------------------------------------------------------- densify


def test_densify_matches_jax_on_the_same_generator():
    sj = _jax_state(4)
    n = sj.params.n
    r = np.random.default_rng(4)
    sj = sj._replace(
        params=sj.params._replace(log_scales=jnp.asarray(r.uniform(-6, -2, (n, 3)), jnp.float32),
                                  opacity_logit=jnp.asarray(r.uniform(-8, 3, n), jnp.float32)),
        adam=sj.adam._replace(m=jax.tree_util.tree_map(lambda x: x + 0.5, sj.adam.m),
                              count=jnp.int32(9)),
        step=jnp.int32(9),
        grad2d_accum=jnp.asarray(r.uniform(0, 6e-4, n), jnp.float32),
        vis_count=jnp.asarray(r.integers(0, 3, n), jnp.float32),
    )
    cfg = GSConfig(**CFG_KW)
    jout, jrep = jax_densify(sj, JGSConfig(**CFG_KW), n_shards=1, rng=np.random.default_rng(11))
    tout, trep = densify_and_rebalance(state_from_numpy(_np_tree(sj), "cpu"), cfg, rng=np.random.default_rng(11))
    assert tuple(trep) == tuple(jrep)
    assert trep.n_cloned > 0 and trep.n_split > 0 and trep.n_pruned > 0
    got, want = state_to_numpy(tout), _np_tree(jout)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape
        # split children are placed with rotation matrices that each package
        # computes in float32 with its own norm: a few ulp apart
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    reset = reset_opacity(tout)
    logit = np_(reset.params.opacity_logit)
    assert (logit[np_(tout.params.opacity_logit) <= -20 + 1e-3] <= -20 + 1e-3).all()
    assert (1 / (1 + np.exp(-logit[logit > -19])) <= 0.0101).all()


# ---------------------------------------------------------------- data


def test_raymarch_matches_jax():
    """The ray marcher against the JAX package's: a pixel at a silhouette can
    flip between hit and miss on a float32 rounding of the march; at most
    1% of the pixels may differ by more than 1e-4."""
    for vj, vt in ((JV.kingsnake_like(res=32), TV.kingsnake_like(res=32)),
                   (JV.miranda_like(res=24), TV.miranda_like(res=24))):
        cj, ct = JC.orbit_cameras(3, img_h=40, img_w=40), TC.orbit_cameras(3, img_h=40, img_w=40)
        for i in range(3):
            want = np.asarray(jax_raymarch(jnp.asarray(vj.field), vj.isovalue, JC.camera_slice(cj, i),
                                           img_h=40, img_w=40, n_steps=48))
            got = np_(render_isosurface(vt.field, vt.isovalue, TC.camera_slice(ct, i), img_h=40, img_w=40,
                                        n_steps=48))
            assert got.shape == (40, 40, 3) and np.isfinite(got).all()
            d = np.abs(got - want).max(axis=-1)
            assert (d > 1e-4).mean() <= 0.01, (vj.name, i, (d > 1e-4).mean())


def test_view_dataset_shares_jax_cache_and_batch_order(tmp_path):
    vol = JV.kingsnake_like(res=16)
    jd = JViewDataset(vol, n_views=5, img_h=16, img_w=16, cache_dir=str(tmp_path), n_steps_raymarch=16, seed=3)
    td = ViewDataset(TV.kingsnake_like(res=16), n_views=5, img_h=16, img_w=16, cache_dir=str(tmp_path),
                     n_steps_raymarch=16, seed=3, device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == ["kingsnake_like_5v_16x16.npy"]
    np.testing.assert_array_equal(td.gt, jd.gt)  # read from the JAX package's cache file
    for (cj, gj), (ct, gtt) in zip(jd.batches(2, steps=7), td.batches(2, steps=7)):
        np.testing.assert_array_equal(np_(gtt), np.asarray(gj))
        np.testing.assert_allclose(np_(ct.viewmat), np.asarray(cj.viewmat), atol=1e-6)


# ---------------------------------------------------------------- checkpoints


def test_checkpoints_cross_between_packages(tmp_path):
    sj = _jax_state(5)._replace(step=jnp.int32(7))
    jax_save(str(tmp_path / "j"), 7, sj)
    like = init_state(TG.GaussianModel(*[torch.zeros(1)] * 5))
    got = restore_checkpoint(str(tmp_path / "j"), latest_step(str(tmp_path / "j")), like)
    for a, b in zip(jax.tree_util.tree_leaves(state_to_numpy(got)), jax.tree_util.tree_leaves(_np_tree(sj))):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype

    st = state_from_numpy(_np_tree(_jax_state(6)), "cpu")._replace(step=torch.tensor(3, dtype=torch.int32))
    d = save_checkpoint(str(tmp_path / "t"), 3, st)
    assert json.load(open(f"{d}/manifest.json"))["leaves"]["adam.m.sh"]["shape"] == list(st.adam.m.sh.shape)
    back = jax_restore(str(tmp_path / "t"), 3, _np_tree(_jax_state(0)))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(state_to_numpy(st))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_train_cli_checkpoint_serves_a_frame(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the CLI's ground-truth cache is relative to the working directory
    ckpt = tmp_path / "ckpt"
    train_cli.main(["--device", "cpu", "--volume-res", "24", "--max-points", "300", "--res", "32",
                    "--steps", "3", "--views", "4", "--batch", "2", "--k-per-tile", "64",
                    "--ckpt", str(ckpt), "--metrics-out", str(tmp_path / "m.json")])
    assert latest_step(str(ckpt)) == 3
    assert (tmp_path / "experiments" / "gt_cache" / "kingsnake_like_4v_32x32.npy").exists()
    snap = json.load(open(tmp_path / "m.json"))
    assert snap["train.steps"] == 3 and np.isfinite(snap["train.loss"]) and "train.psnr" in snap
    assert snap["train.devmem.max_bytes"] == 0  # no card: PyTorch keeps no CPU allocator stats

    params = serve_cli.load_params_from_ckpt(str(ckpt))
    assert params.means.shape == (512, 3)  # 300 points padded to the 256 quantum
    cfg = GSConfig(img_h=32, img_w=32, k_per_tile=64)
    cam = TC.camera_slice(TC.orbit_cameras(4, img_h=32, img_w=32), 0)
    with torch.no_grad():
        frame = make_batched_eval_render(cfg)(params, stack_cameras([cam]))[0]
    assert frame.shape == (32, 32, 3) and torch.isfinite(frame).all() and frame.max() > 0.05

    capsys.readouterr()
    serve_cli.main(["--device", "cpu", "--ckpt", str(ckpt), "--res", "32", "--clients", "2", "--requests", "2",
                    "--report", str(tmp_path / "serve.json")])
    assert json.load(open(tmp_path / "serve.json"))["completed"] == 4


def test_train_cli_refuses_what_is_not_ported():
    with pytest.raises(SystemExit, match="torchrun"):  # one process per rank: no process group here
        train_cli.main(["--device", "cpu", "--data-par", "2"])
    smp = devmem.sample()
    assert smp.source == "none" and smp.max_bytes == 0
