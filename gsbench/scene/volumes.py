"""The stand-in volumes and their isosurface points, made on a device.

Frozen copies of the port's ``volume/datasets.py`` (``kingsnake_like``,
``miranda_like``) and ``volume/isosurface.py``, rewritten so that the
fields and the surface are computed by PyTorch on the card. The paper's
scans (Kingsnake 110 MB, Miranda 491 MB) are not in the repository.
"""
from __future__ import annotations

import math

import numpy as np
import torch

LIGHT_DIR = (0.4, 0.5, -0.75)
BASE_COLOR = (0.75, 0.72, 0.65)
AMBIENT = 0.25


def _grid(res: int, extent: float, device):
    lin = torch.linspace(-extent, extent, res, dtype=torch.float32, device=device)
    return torch.meshgrid(lin, lin, lin, indexing="ij")


def kingsnake_like(res: int, extent: float, device, *, coils: float = 3.5) -> torch.Tensor:
    """Coiled tube: distance to a conical helix minus a textured shell radius."""
    x, y, z = _grid(res, extent, device)
    t = torch.linspace(0, 2 * math.pi * coils, 400, dtype=torch.float32, device=device)
    r_helix = 0.55 * (1.0 - 0.12 * t / t[-1])
    hz = torch.linspace(-0.7 * extent, 0.7 * extent, t.numel(), dtype=torch.float32, device=device)
    helix = torch.stack([r_helix * torch.cos(t), r_helix * torch.sin(t), hz], 1)
    vox = torch.stack([x, y, z], -1).reshape(-1, 3)
    d = torch.full((vox.shape[0],), float("inf"), dtype=torch.float32, device=device)
    for i in range(0, helix.shape[0], 50):
        seg = helix[i:i + 50]
        d = torch.minimum(d, torch.sqrt(((vox[:, None, :] - seg[None]) ** 2).sum(-1)).amin(1))
    tex = 0.015 * torch.sin(7.0 * x) * torch.cos(6.0 * y) * torch.sin(5.0 * z)
    return d.reshape(res, res, res) - (0.16 + tex)


def miranda_like(res: int, extent: float, device, *, modes: int = 6, seed: int = 1) -> torch.Tensor:
    """Mixing interface: z minus a multi-mode wavy displacement. The modes'
    30 numbers are drawn on the host as the port draws them."""
    x, y, z = _grid(res, extent, device)
    rng = np.random.default_rng(seed)
    disp = torch.zeros_like(x)
    for _ in range(modes):
        kx, ky = rng.uniform(2.0, 9.0, 2)
        ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
        amp = rng.uniform(0.04, 0.14)
        disp += float(amp) * torch.sin(float(kx) * x + float(ph1)) * torch.cos(float(ky) * y + float(ph2))
    disp += 0.08 * torch.sin(4.0 * x) * torch.sin(4.0 * y) * torch.cos(3.0 * z)
    return z - disp


VOLUMES = {"kingsnake_like": kingsnake_like, "miranda_like": miranda_like}


def make_volume(spec: dict, device) -> torch.Tensor:
    """The (R, R, R) float32 field of a configuration's ``volume`` entry."""
    return VOLUMES[spec["kind"]](spec["res"], spec["extent"], device, **spec.get("args", {}))


def shade(normals: torch.Tensor) -> torch.Tensor:
    """Lambertian shading, the ray-marcher's constants."""
    light = torch.tensor(LIGHT_DIR, dtype=torch.float32, device=normals.device)
    light = light / torch.linalg.norm(light)
    lam = torch.clamp(-(normals @ light), 0.0, 1.0)
    base = torch.tensor(BASE_COLOR, dtype=torch.float32, device=normals.device)
    return torch.clamp(base[None] * (AMBIENT + (1 - AMBIENT) * lam[:, None]), 0.0, 1.0)


def isosurface_points(field: torch.Tensor, isovalue: float, extent: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One interpolated point per sign-changing voxel edge, in row-major
    order axis by axis, with its shaded color: (points (M, 3), colors (M, 3))."""
    f = field - isovalue
    res = f.shape[0]
    spacing = 2 * extent / (res - 1)
    norms = torch.stack(torch.gradient(f), -1)
    norms = norms / (torch.linalg.norm(norms, dim=-1, keepdim=True) + 1e-12)
    pts_all, nrm_all = [], []
    for axis in range(3):
        sl = [slice(None)] * 3
        sl[axis] = slice(0, res - 1)
        sl = tuple(sl)
        a, b = f[sl], torch.roll(f, -1, dims=axis)[sl]
        cross = (a * b) < 0
        idx = torch.nonzero(cross)
        if idx.numel() == 0:
            continue
        t = a[cross] / (a[cross] - b[cross])
        pos = idx.to(torch.float32)
        pos[:, axis] += t
        n0 = norms[sl][cross]
        idx2 = idx.clone()
        idx2[:, axis] += 1
        n1 = norms[idx2[:, 0], idx2[:, 1], idx2[:, 2]]
        n = n0 * (1 - t[:, None]) + n1 * t[:, None]
        n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)
        pts_all.append(pos * spacing - extent)
        nrm_all.append(n)
    nrm = torch.cat(nrm_all)
    return torch.cat(pts_all), shade(nrm)
