"""Ground-truth isosurface renderer (ray-marched, PyTorch).

Copy of the JAX package's ``volume/raymarch.py``: the stand-in for the
ParaView renders the paper trains against. Fixed-step ray marching with
sign-change detection, bisection refinement, central-difference normals and
Lambertian shading (identical shading constants to ``isosurface.shade`` so
point-cloud color init matches the GT images). It runs on any device; on the
card it renders the training views, since that machine has no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.volume.isosurface import AMBIENT, BASE_COLOR, LIGHT_DIR

STEP_CHUNK = 16  # ray-march steps sampled per pass (bounds the temporaries)


def _trilinear(field: torch.Tensor, p: torch.Tensor, extent: float) -> torch.Tensor:
    """Sample the (R,R,R) scalar field at world points p (..., 3); clamps at the border."""
    res = field.shape[0]
    g = (p + extent) / (2 * extent) * (res - 1)
    g = torch.clamp(g, 0.0, res - 1.001)
    i0 = torch.floor(g).to(torch.int64)
    f = g - i0
    i1 = torch.clamp(i0 + 1, max=res - 1)
    flat = field.reshape(-1)

    def at(ix, iy, iz):
        return flat[(ix * res + iy) * res + iz]

    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = at(x0, y0, z0) * (1 - fx) + at(x1, y0, z0) * fx
    c10 = at(x0, y1, z0) * (1 - fx) + at(x1, y1, z0) * fx
    c01 = at(x0, y0, z1) * (1 - fx) + at(x1, y0, z1) * fx
    c11 = at(x0, y1, z1) * (1 - fx) + at(x1, y1, z1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def render_isosurface(
    vol_field,
    isovalue: float,
    cam,
    *,
    img_h: int,
    img_w: int,
    extent: float = 1.0,
    n_steps: int = 192,
    bg=(0.0, 0.0, 0.0),
) -> torch.Tensor:
    """Render one GT view, (H, W, 3) in [0,1], on the device of ``vol_field``
    (a tensor, or a numpy array for the CPU)."""
    field = torch.as_tensor(vol_field, dtype=torch.float32) - isovalue
    device = field.device
    f32 = dict(dtype=torch.float32, device=device)
    vm = torch.as_tensor(cam.viewmat).to(**f32)
    R = vm[:3, :3]
    campos = -R.T @ vm[:3, 3]
    fx, fy, cx, cy = (torch.as_tensor(v).to(**f32) for v in (cam.fx, cam.fy, cam.cx, cam.cy))

    ys, xs = torch.meshgrid(torch.arange(img_h, **f32) + 0.5, torch.arange(img_w, **f32) + 0.5, indexing="ij")
    dirs_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], -1)
    dirs = dirs_cam @ R  # cam->world (R rows are world axes of cam frame)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)

    # march from the camera through the volume's bounding sphere
    dist = torch.linalg.norm(campos)
    t0 = torch.clamp(dist - 1.9 * extent, min=0.02)
    t1 = dist + 1.9 * extent
    ts = torch.linspace(float(t0), float(t1), n_steps, **f32)

    vals = torch.empty((n_steps, img_h, img_w), **f32)
    for s in range(0, n_steps, STEP_CHUNK):
        t = ts[s : s + STEP_CHUNK, None, None, None]
        vals[s : s + STEP_CHUNK] = _trilinear(field, campos + t * dirs, extent)
    sign_change = (vals[:-1] * vals[1:]) < 0
    steps = torch.arange(n_steps - 1, device=device)[:, None, None]
    hit = sign_change.any(dim=0)
    # the first crossing step (0 where there is none, as argmax gives)
    first = torch.where(sign_change, steps, n_steps).amin(dim=0)
    first = torch.where(hit, first, torch.zeros_like(first))
    f0 = torch.gather(vals, 0, first[None])[0]

    # bisection refinement (4 rounds)
    lo = ts[first]
    hi = ts[first + 1]
    flo = f0
    for _ in range(4):
        mid = 0.5 * (lo + hi)
        fm = _trilinear(field, campos + mid[..., None] * dirs, extent)
        go_lo = (flo * fm) < 0
        hi = torch.where(go_lo, mid, hi)
        lo = torch.where(go_lo, lo, mid)
        flo = torch.where(go_lo, flo, fm)
    tt = 0.5 * (lo + hi)
    p_hit = campos + tt[..., None] * dirs

    eps = 2 * extent / field.shape[0]
    axes = torch.eye(3, **f32) * eps
    grad = torch.stack(
        [_trilinear(field, p_hit + axes[i], extent) - _trilinear(field, p_hit - axes[i], extent) for i in range(3)],
        -1,
    )
    n = grad / (torch.linalg.norm(grad, dim=-1, keepdim=True) + 1e-12)
    light = torch.as_tensor(LIGHT_DIR).to(**f32)
    light = light / torch.linalg.norm(light)
    lam = torch.clamp(-(n @ light), 0.0, 1.0)
    color = torch.as_tensor(BASE_COLOR).to(**f32) * (AMBIENT + (1 - AMBIENT) * lam[..., None])
    bg_arr = torch.as_tensor(np.asarray(bg, np.float32)).to(**f32).expand_as(color)
    return torch.clamp(torch.where(hit[..., None], color, bg_arr), 0.0, 1.0)
