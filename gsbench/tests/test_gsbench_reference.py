"""The scene generator and the reference run at a tiny size on the CPU, and
the reference agrees with the port's CPU step stage by stage and over
whole runs of the harness."""
import math

import pytest
import torch

from gsbench.reference import step as RS
from gsbench.scene import FIELDS, batch_order, make_scene, make_views


@pytest.fixture
def scene(tiny):
    cell = tiny("ks4m-train-512")
    cfg = cell["config_data"]
    g, n_surface = make_scene(cfg, 20251018, "cpu")
    cams, gt = make_views(cfg, cell["traffic_data"], "cpu")
    return cell, g, n_surface, cams, gt


def test_scene_is_made_from_the_seed(scene, tiny):
    cell, g, n_surface, cams, gt = scene
    assert g["means"].shape == (3072, 3) and g["sh"].shape == (3072, 1, 3) and n_surface > 100
    assert gt.shape == (8, 64, 64, 3) and 0 < float(gt.mean()) < 1
    again, _ = make_scene(cell["config_data"], 20251018, "cpu")
    other, _ = make_scene(cell["config_data"], 2**31 + 5, "cpu")
    assert all(torch.equal(g[f], again[f]) for f in FIELDS)
    assert not torch.equal(g["means"], other["means"])
    order = batch_order(8, 2, 2**33 + 1)
    first = [next(order) for _ in range(4)]
    assert sorted(v for b in first for v in b) == list(range(8))


def _program_cam(cams, i):
    from repro_torch.core.projection import Camera

    return Camera(*[cams[f][i] for f in Camera._fields])


def test_projection_matches_the_ports(scene):
    from repro_torch.core import gaussians as G
    from repro_torch.kernels.gsproject.ref import project_ref

    cell, g, _, cams, _ = scene
    c = cell["config_data"]["raster"]
    for i in range(3):
        ref = RS.project(g, {k: cams[k][i] for k in cams}, c, RS._Arith(False))
        port = project_ref(G.GaussianModel(*[g[f] for f in FIELDS]), _program_cam(cams, i))
        live = torch.isfinite(ref[:, 9])
        torch.testing.assert_close(ref[live, :10], port[live, :10], rtol=2e-5, atol=2e-4)
        assert float((ref[:, 10] != port[:, 10]).float().mean()) < 1e-2


@pytest.mark.parametrize("binning,k", [("hier", 8), ("hier", 64), ("flat", 8)])
def test_tile_lists_and_image_match_the_ports(scene, binning, k):
    from repro_torch.core import gaussians as G
    from repro_torch.core import projection as P
    from repro_torch.core import render as R

    cell, g, _, cams, _ = scene
    gs = dict(cell["config_data"]["gs"], binning=binning, k_per_tile=k)
    c = cell["config_data"]["raster"]
    packed = P.project(G.GaussianModel(*[g[f] for f in FIELDS]), _program_cam(cams, 1))
    ps, _ = P.sort_by_depth(packed)
    idx, valid = R.bin_tiles(ps, img_h=64, img_w=64, tile_h=16, tile_w=16, k_per_tile=k, binning=binning)
    lists = RS.tile_lists(ps, 64, 64, gs, c)
    assert torch.equal(lists, torch.where(valid, idx.long(), torch.full_like(lists, -1)))
    img, _ = R.render_packed(ps, img_h=64, img_w=64, k_per_tile=k, bg=torch.zeros(3), binning=binning)
    torch.testing.assert_close(RS.composite(ps, lists, 64, gs, c, RS._Arith(False)), img, rtol=1e-5, atol=1e-6)


def test_loss_matches_the_ports(scene):
    from repro_torch.core.sharding import distributed_gs_loss

    cell, _, _, _, gt = scene
    pred = torch.clamp(gt[:2] + 0.05 * torch.randn(gt[:2].shape, generator=torch.Generator().manual_seed(3)), 0, 1)
    sums = [RS.ssim_l1_sums(pred[i], gt[i], RS._Arith(False)) for i in range(2)]
    cnt = pred.numel()
    lam = cell["config_data"]["gs"]["lambda_dssim"]
    ref = (1 - lam) * sum(float(l1) for _, l1 in sums) / cnt + lam * (1 - sum(float(s) for s, _ in sums) / cnt) / 2
    assert math.isclose(ref, float(distributed_gs_loss(pred, gt[:2], lam=lam)), rel_tol=1e-6)


@pytest.mark.parametrize("name", ["ks4m-train-512", "mir18m-train-512-x4"])
def test_reference_agrees_with_the_ports_cpu_step_in_a_whole_run(tiny, name):
    import time

    from gsbench.harness import run_rank

    cell = tiny(name)
    r = run_rank(0, 1, dict(cell=cell, seed=3_000_000_019, seconds=0.5, trace=False, device="cpu", t0=time.time(),
                            cpu_threads=2))
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["compared"]["loss_gap"]["value"] < 1e-6
