"""Synthetic scientific volumes standing in for the paper's datasets.

The paper uses Kingsnake (micro-CT of a snake egg clutch, ~4M isosurface
points) and Miranda (radiation-hydrodynamics mixing simulation, ~18M). We
cannot ship those; these procedural fields reproduce their *structural
character* (coiled tubular shells vs. turbulent mixing interface) at
configurable resolution so every pipeline stage runs end-to-end.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class VolumeSpec(NamedTuple):
    field: np.ndarray      # (R, R, R) float32 scalar field
    isovalue: float
    extent: float          # world-space half-extent (volume spans [-e, e]^3)
    name: str


def _grid(res: int, extent: float):
    lin = np.linspace(-extent, extent, res, dtype=np.float32)
    return np.meshgrid(lin, lin, lin, indexing="ij")


def kingsnake_like(res: int = 96, extent: float = 1.0, *, coils: float = 3.5, seed: int = 0) -> VolumeSpec:
    """Coiled-tube field: distance to a conical helix, with a shell texture.

    Isosurface = tube shell, structurally similar to the snake-egg CT scan
    (thin curved sheets, high curvature, self-occlusion).
    """
    x, y, z = _grid(res, extent)
    t = np.linspace(0, 2 * np.pi * coils, 400, dtype=np.float32)
    r_helix = 0.55 * (1.0 - 0.12 * t / t[-1])
    hx = r_helix * np.cos(t)
    hy = r_helix * np.sin(t)
    hz = np.linspace(-0.7 * extent, 0.7 * extent, t.size, dtype=np.float32)
    pts = np.stack([hx, hy, hz], 1)  # (T,3)

    # distance from every voxel to the helix polyline (chunked for memory)
    vox = np.stack([x, y, z], -1).reshape(-1, 3)
    d = np.full((vox.shape[0],), np.inf, np.float32)
    for i in range(0, pts.shape[0], 50):
        seg = pts[i : i + 50]
        dd = np.linalg.norm(vox[:, None, :] - seg[None], axis=-1).min(1)
        d = np.minimum(d, dd)
    d = d.reshape(res, res, res)
    rng = np.random.default_rng(seed)
    # gentle shell-thickness modulation so the surface is not a perfect tube
    tex = 0.015 * np.sin(7.0 * x) * np.cos(6.0 * y) * np.sin(5.0 * z)
    field = d - (0.16 + tex)
    return VolumeSpec(field.astype(np.float32), 0.0, extent, "kingsnake_like")


def miranda_like(res: int = 96, extent: float = 1.0, *, modes: int = 6, seed: int = 1) -> VolumeSpec:
    """Rayleigh-Taylor-style mixing interface: z minus a multi-mode wavy
    displacement field. Isosurface = the turbulent mixing layer (large,
    folded, sheet-like — the structural regime of Miranda)."""
    x, y, z = _grid(res, extent)
    rng = np.random.default_rng(seed)
    disp = np.zeros_like(x)
    for _ in range(modes):
        kx, ky = rng.uniform(2.0, 9.0, 2)
        ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
        amp = rng.uniform(0.04, 0.14)
        disp += amp * np.sin(kx * x + ph1) * np.cos(ky * y + ph2)
    # secondary fold structure (mushroom caps)
    disp += 0.08 * np.sin(4.0 * x) * np.sin(4.0 * y) * np.cos(3.0 * z)
    field = z - disp
    return VolumeSpec(field.astype(np.float32), 0.0, extent, "miranda_like")
