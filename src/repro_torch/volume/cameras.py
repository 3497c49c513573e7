"""Structured orbital camera rig (the paper's synthetic 448-view orbit).

Cameras are host-side float32 tensors (see ``core/projection.py``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.projection import Camera, look_at_camera


def orbit_cameras(
    n_views: int,
    *,
    img_h: int,
    img_w: int,
    radius: float = 3.0,
    fov_deg: float = 40.0,
    elev_cycles: float = 3.0,
    elev_max_deg: float = 55.0,
    target=(0.0, 0.0, 0.0),
) -> Camera:
    """Batched Camera on a spiral orbit: azimuth sweeps [0,2pi), elevation
    oscillates — the structured orbit used for isosurface capture."""
    az = np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    elev = np.deg2rad(elev_max_deg) * np.sin(elev_cycles * az)
    fx = fy = 0.5 * img_w / np.tan(np.deg2rad(fov_deg) / 2)
    cams = []
    for a, e in zip(az, elev):
        eye = np.float32(target) + radius * np.float32(
            [np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)]
        )
        cams.append(
            look_at_camera(eye, np.float32(target), [0.0, 0.0, 1.0], fx, fy, img_w / 2, img_h / 2)
        )
    return Camera(*[torch.stack([getattr(c, f) for c in cams]) for f in Camera._fields])


def camera_slice(cams: Camera, idx) -> Camera:
    return Camera(*[getattr(cams, f)[idx] for f in Camera._fields])
