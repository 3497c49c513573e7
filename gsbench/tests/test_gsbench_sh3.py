"""The ``miranda-18m-sh3`` configuration (SH degree 3): its cell loads by
name, its file differs from ``miranda-18m.json`` only where it should, and
the port's CPU train step agrees with the reference at a tiny size with
every SH band nonzero.

The model is the cell's, grown from the seed and cut to about 3,000
Gaussians at 64 px (``conftest.shrink``); its bands above DC, which the
configuration starts at zero, are drawn from the seed here, so that the
forward's band terms count and not only their gradients. The program runs
three steps through ``GSTrainer.fit``; the reference (``gsbench/reference``)
runs the same steps on the same inputs. Tolerances, each with its reason:

- losses: rtol 1e-5, ``tests/test_torch_sh.py``'s (float32 sums in another
  order);
- the first step's gradient of every leaf, element by element, the bands
  above DC included: atol 2e-5 * max|g| and rtol 2e-4,
  ``tests/test_torch_sh.py``'s. The program's is read from Adam's first
  moment after step 1 (g = m / 0.1, from m = 0); the reference's is the sum
  of its ``view_grads`` over the step's views;
- every leaf's change after the three steps, by its norm: the cell's
  ``change_gap`` (``gsbench/harness.py`` ``gaps``). Element by element the
  change is Adam's step, whose sign flips on gradients near zero, so the
  norm is what can be held.

Dropping the top band (coefficients 9-15) in the program's input, and
keeping it in the reference's, must fail the comparison.
"""
import json
import os

import pytest
import torch

from conftest import ROOT

from gsbench.harness import Feed, gaps, gs_config, load_cell
from gsbench.reference import step as RS
from gsbench.scene import FIELDS, batch_order, make_scene, make_views

SEED = 3_300_000_017
STEPS = 3
BAND_SD = 0.2  # the bands' spread: view-dependent colour without clamping most of it away


def _configs():
    with open(os.path.join(ROOT, "gsbench", "configs", "miranda-18m.json")) as f:
        base = json.load(f)
    with open(os.path.join(ROOT, "gsbench", "configs", "miranda-18m-sh3.json")) as f:
        sh3 = json.load(f)
    return base, sh3


def test_the_config_is_miranda_18m_at_sh_degree_3():
    base, sh3 = _configs()
    assert set(base) == set(sh3)
    changed = {k for k in base if base[k] != sh3[k]}
    assert changed == {"name", "why", "source", "gs", "assumed"}
    assert {k for k in base["gs"] if base["gs"][k] != sh3["gs"][k]} == {"sh_degree"}
    assert set(base["gs"]) == set(sh3["gs"]) and sh3["gs"]["sh_degree"] == 3
    # the assumptions of miranda-18m stand; the new ones are added beside them
    assert {k: sh3["assumed"][k] for k in base["assumed"]} == base["assumed"]
    assert set(sh3["assumed"]) - set(base["assumed"]) == {"sh_schedule", "lr_sh", "sh_init", "deployment"}
    assert sh3["reduced"] == ["volume", "views", "densify"]
    assert sh3["n_gaussians"] == 18_180_000 and sh3["gs"]["k_per_tile"] == 256
    assert (sh3["gs"]["tile_h"], sh3["gs"]["tile_w"]) == (16, 16)


def test_the_cell_loads_by_name():
    cell = load_cell("mir18m-sh3-train-512")
    assert cell["config"] == "miranda-18m-sh3" and cell["config_data"]["name"] == "miranda-18m-sh3"
    assert cell["traffic"] == "train-512-b4" and cell["chips"] == 1 and cell["mesh"] is None
    assert set(cell["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
    cfg = gs_config(cell)
    assert (cfg.img_h, cfg.img_w, cfg.batch_size, cfg.sh_degree) == (512, 512, 4, 3)


def _inputs(tiny):
    cell = tiny("mir18m-sh3-train-512", k=64)  # K 64: a few hundred Gaussians reach the 64-px frames
    cfg = cell["config_data"]
    g, _ = make_scene(cfg, SEED, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    g["sh"][:, 1:] = BAND_SD * torch.randn(g["sh"][:, 1:].shape, generator=gen)
    cams, gt = make_views(cfg, cell["traffic_data"], "cpu")
    return cell, g, cams, gt


def _program(cell, g, cams, gt):
    """Three steps of the port's trainer on the CPU: losses, the first
    gradient of every leaf and the params after the last step."""
    from repro_torch.core import gaussians as G
    from repro_torch.core.projection import Camera
    from repro_torch.launch.train import GSTrainer
    from repro_torch.obs import Obs

    prog_cams = Camera(*[cams[f] for f in Camera._fields])
    tr = GSTrainer(gs_config(cell), params=G.GaussianModel(*[g[f].clone() for f in FIELDS]), device="cpu",
                   obs=Obs(trace=False), verbose=False)
    order = batch_order(cell["config_data"]["views"], cell["traffic_data"]["batch"], SEED)
    feed = Feed(prog_cams, gt, order, count=1)
    losses = tr.fit(feed, steps=1, densify=False, log_every=10**9)
    grads = [m / 0.1 for m in tr.state.adam.m]
    views = list(feed.views)
    feed = Feed(prog_cams, gt, order, count=STEPS - 1)
    losses += tr.fit(feed, steps=STEPS - 1, densify=False, log_every=10**9)
    views += feed.views
    return [float(v) for v in losses], grads, [x.detach().clone() for x in tr.state.params], views


def _reference_first_grads(cell, g, cams, gt, views):
    cfg = cell["config_data"]
    grads = {f: torch.zeros_like(g[f]) for f in FIELDS}
    cnt = float(len(views) * gt.shape[1] * gt.shape[2] * 3)
    for v in views:
        RS.view_grads(g, {k: cams[k][v] for k in cams}, gt[v], cfg["gs"], cfg["raster"], RS._Arith(False),
                      scale=1.0 / cnt, grads=grads)
    return grads


def _compare(cell, g, prog_g, cams, gt) -> list[str]:
    """What fails of the comparison of the program (run on ``prog_g``) with
    the reference (run on ``g``): an empty list when everything holds."""
    losses, grads, params, views = _program(cell, prog_g, cams, gt)
    ref = RS.train_steps(g, cams, gt, views, cell["config_data"])
    ref_grads = _reference_first_grads(cell, g, cams, gt, views[0])
    fails = []
    for i, (a, b) in enumerate(zip(losses, ref["losses"])):
        if abs(a - b) > 1e-5 * abs(b):
            fails.append(f"loss {i}: {a} against {b}")
    for f, got in zip(FIELDS, grads):
        want = ref_grads[f]
        scale = max(float(want.abs().max()), 1e-8)
        if not torch.allclose(got.double(), want.double(), atol=2e-5 * scale + 1e-10, rtol=2e-4):
            fails.append(f"first gradient of {f}: worst {float((got - want).abs().max())} of max {scale}")
    prog = {"losses": losses, "grad_norms": [float(torch.linalg.norm(x.double())) for x in grads],
            "change_norms": [float(torch.linalg.norm((p - g[f]).double())) for f, p in zip(FIELDS, params)]}
    change = gaps(prog, ref, FIELDS)["change_gap"]
    if change > cell["limits"]["change_gap"]:
        fails.append(f"change_gap {change}")
    return fails


@pytest.mark.parametrize("drop_top_band", [False, True])
def test_the_ports_cpu_step_against_the_reference_with_every_band_nonzero(tiny, drop_top_band):
    cell, g, cams, gt = _inputs(tiny)
    # the bands count: the projected colours vary with them
    cam = {k: cams[k][0] for k in cams}
    plain = RS.project(dict(g, sh=g["sh"][:, :1].contiguous()), cam, cell["config_data"]["raster"], RS._Arith(False))
    banded = RS.project(g, cam, cell["config_data"]["raster"], RS._Arith(False))
    live = torch.isfinite(banded[:, 9])
    assert float((banded[live, 6:9] - plain[live, 6:9]).abs().mean()) > 0.05
    prog_g = dict(g)
    if drop_top_band:
        prog_g["sh"] = g["sh"].clone()
        prog_g["sh"][:, 9:] = 0.0
    fails = _compare(cell, g, prog_g, cams, gt)
    if drop_top_band:
        assert fails, "the program without the top band passed the comparison"
    else:
        assert not fails, fails
