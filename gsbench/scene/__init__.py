"""The benchmark's inputs, made from a configuration and the seed.

``make_scene`` gives the padded model at the configuration's Gaussian count
and ``make_views`` the orbit cameras and their ground-truth images. Both
the program and the reference are handed these same inputs.
"""
from __future__ import annotations

import torch

from gsbench.scene.grow import FIELDS, grow
from gsbench.scene.views import batch_order, camera, orbit_cameras, raymarch
from gsbench.scene.volumes import isosurface_points, make_volume

__all__ = ["FIELDS", "batch_order", "camera", "make_scene", "make_views"]


def make_scene(config: dict, seed: int, device) -> tuple[dict, int]:
    """(model leaves in ``FIELDS`` order, surface points it grew from)."""
    vol = config["volume"]
    field = make_volume(vol, device)
    pts, cols = isosurface_points(field, vol["isovalue"], vol["extent"])
    spacing = 2.0 * vol["extent"] / (vol["res"] - 1)
    g = grow(pts, cols, n=config["n_gaussians"], spacing=spacing, sh_degree=config["gs"]["sh_degree"],
             init_opacity=config["init_opacity"], pad_to=config["pad_to"], seed=seed)
    return g, int(pts.shape[0])


def make_views(config: dict, traffic: dict, device) -> tuple[dict, torch.Tensor]:
    """(host cameras {viewmat, fx, fy, cx, cy}, ground truth (V, H, W, 3)
    on ``device``)."""
    vol, res = config["volume"], traffic["res"]
    cams = orbit_cameras(config["views"], img_h=res, img_w=res, radius=config["orbit_radius"])
    field = make_volume(vol, device)
    gt = torch.stack([raymarch(field, vol["isovalue"], camera(cams, i), img_h=res, img_w=res,
                               extent=vol["extent"], n_steps=config["raymarch_steps"])
                      for i in range(config["views"])])
    return cams, gt
