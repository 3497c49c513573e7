"""Isosurface point extraction (the pipeline's ParaView-extract stand-in).

Emits one interpolated point per sign-changing voxel edge (the vertex set of
marching cubes, without the mesh topology — 3D-GS only needs points), plus
central-difference normals and Lambertian-shaded colors matching the
ground-truth raymarcher, so Gaussian color init starts near the target.
"""
from __future__ import annotations

import numpy as np

from repro_torch.volume.datasets import VolumeSpec

LIGHT_DIR = np.float32([0.4, 0.5, -0.75])
BASE_COLOR = np.float32([0.75, 0.72, 0.65])
AMBIENT = 0.25


def _normals(field: np.ndarray) -> np.ndarray:
    gx, gy, gz = np.gradient(field.astype(np.float32))
    n = np.stack([gx, gy, gz], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
    return n


def shade(normals: np.ndarray) -> np.ndarray:
    """Lambertian shade — identical math to the JAX package's volume raymarcher."""
    l = LIGHT_DIR / np.linalg.norm(LIGHT_DIR)
    lam = np.clip(-(normals @ l), 0.0, 1.0)
    return np.clip(BASE_COLOR[None] * (AMBIENT + (1 - AMBIENT) * lam[:, None]), 0.0, 1.0)


def extract_isosurface_points(
    vol: VolumeSpec, *, max_points: int | None = None, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (points (M,3), normals (M,3), colors (M,3)) on the isosurface."""
    f = vol.field - vol.isovalue
    res = f.shape[0]
    spacing = 2 * vol.extent / (res - 1)
    norms = _normals(f)

    pts_all, nrm_all = [], []
    for axis in range(3):
        a = f
        b = np.roll(f, -1, axis=axis)
        sl = [slice(None)] * 3
        sl[axis] = slice(0, res - 1)
        sl = tuple(sl)
        a, b = a[sl], b[sl]
        cross = (a * b) < 0
        idx = np.argwhere(cross)
        if idx.size == 0:
            continue
        t = a[cross] / (a[cross] - b[cross])  # interpolation along the edge
        pos = idx.astype(np.float32)
        pos[:, axis] += t
        world = pos * spacing - vol.extent
        # interpolate normals between the edge endpoints
        n0 = norms[sl][cross]
        idx2 = idx.copy()
        idx2[:, axis] += 1
        n1 = norms[tuple(idx2.T)]
        n = n0 * (1 - t[:, None]) + n1 * t[:, None]
        n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
        pts_all.append(world)
        nrm_all.append(n)

    pts = np.concatenate(pts_all, 0).astype(np.float32)
    nrm = np.concatenate(nrm_all, 0).astype(np.float32)
    if max_points is not None and pts.shape[0] > max_points:
        rng = np.random.default_rng(seed)
        keep = rng.choice(pts.shape[0], max_points, replace=False)
        pts, nrm = pts[keep], nrm[keep]
    return pts, nrm, shade(nrm)
