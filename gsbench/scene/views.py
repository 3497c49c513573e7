"""Orbit cameras, their ground-truth images and the batch order.

Frozen copies of the port's ``volume/cameras.py`` (the spiral orbit) and
``volume/raymarch.py`` (the ray-marched isosurface the paper's ParaView
renders stand for), with the cameras as a dict of host float32 tensors so
that nothing here depends on the port's types. The images are rendered on
the card. The batch order is drawn from the seed: each epoch a new
permutation of the views, cut into batches.
"""
from __future__ import annotations

import numpy as np
import torch

from gsbench.scene.volumes import AMBIENT, BASE_COLOR, LIGHT_DIR

CAM_FIELDS = ("viewmat", "fx", "fy", "cx", "cy")
STEP_CHUNK = 16


def _look_at(eye, target, up) -> np.ndarray:
    fwd = target - eye
    fwd = fwd / (np.linalg.norm(fwd) + np.float32(1e-12))
    right = np.cross(fwd, up)
    right = right / (np.linalg.norm(right) + np.float32(1e-12))
    down = np.cross(fwd, right)  # camera +y points down (image convention)
    rot = np.stack([right, down, fwd]).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = rot
    vm[:3, 3] = -rot @ eye
    return vm


def orbit_cameras(n_views: int, *, img_h: int, img_w: int, radius: float, fov_deg: float = 40.0,
                  elev_cycles: float = 3.0, elev_max_deg: float = 55.0) -> dict:
    """Spiral orbit around the origin: azimuth sweeps [0, 2pi), elevation
    oscillates. Returns {viewmat (V, 4, 4), fx, fy, cx, cy (V,)} on the host."""
    az = np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    elev = np.deg2rad(elev_max_deg) * np.sin(elev_cycles * az)
    f = 0.5 * img_w / np.tan(np.deg2rad(fov_deg) / 2)
    target = np.zeros(3, np.float32)
    up = np.float32([0.0, 0.0, 1.0])
    vms = [_look_at(radius * np.float32([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)]), target, up)
           for a, e in zip(az, elev)]
    full = lambda v: torch.full((n_views,), float(v), dtype=torch.float32)  # noqa: E731
    return {"viewmat": torch.tensor(np.stack(vms)), "fx": full(f), "fy": full(f), "cx": full(img_w / 2),
            "cy": full(img_h / 2)}


def camera(cams: dict, i: int) -> dict:
    return {k: cams[k][i] for k in CAM_FIELDS}


def _trilinear(field: torch.Tensor, p: torch.Tensor, extent: float) -> torch.Tensor:
    res = field.shape[0]
    g = torch.clamp((p + extent) / (2 * extent) * (res - 1), 0.0, res - 1.001)
    i0 = torch.floor(g).to(torch.int64)
    f = g - i0
    i1 = torch.clamp(i0 + 1, max=res - 1)
    flat = field.reshape(-1)

    def at(ix, iy, iz):
        return flat[(ix * res + iy) * res + iz]

    x0, y0, z0 = i0.unbind(-1)
    x1, y1, z1 = i1.unbind(-1)
    fx, fy, fz = f.unbind(-1)
    c00 = at(x0, y0, z0) * (1 - fx) + at(x1, y0, z0) * fx
    c10 = at(x0, y1, z0) * (1 - fx) + at(x1, y1, z0) * fx
    c01 = at(x0, y0, z1) * (1 - fx) + at(x1, y0, z1) * fx
    c11 = at(x0, y1, z1) * (1 - fx) + at(x1, y1, z1) * fx
    return (c00 * (1 - fy) + c10 * fy) * (1 - fz) + (c01 * (1 - fy) + c11 * fy) * fz


def raymarch(field: torch.Tensor, isovalue: float, cam: dict, *, img_h: int, img_w: int, extent: float,
             n_steps: int) -> torch.Tensor:
    """One ground-truth view (H, W, 3) on the field's device: fixed steps,
    sign-change detection, 4 bisection rounds, central-difference normals,
    Lambertian shading, black background."""
    f = field - isovalue
    dev = f.device
    f32 = dict(dtype=torch.float32, device=dev)
    vm = cam["viewmat"].to(**f32)
    rot = vm[:3, :3]
    campos = -rot.T @ vm[:3, 3]
    fx, fy, cx, cy = (cam[k].to(**f32) for k in ("fx", "fy", "cx", "cy"))
    ys, xs = torch.meshgrid(torch.arange(img_h, **f32) + 0.5, torch.arange(img_w, **f32) + 0.5, indexing="ij")
    dirs = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], -1) @ rot
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    dist = torch.linalg.norm(campos)
    t0 = torch.clamp(dist - 1.9 * extent, min=0.02)
    ts = torch.linspace(float(t0), float(dist + 1.9 * extent), n_steps, **f32)
    vals = torch.empty((n_steps, img_h, img_w), **f32)
    for s in range(0, n_steps, STEP_CHUNK):
        vals[s:s + STEP_CHUNK] = _trilinear(f, campos + ts[s:s + STEP_CHUNK, None, None, None] * dirs, extent)
    sign_change = (vals[:-1] * vals[1:]) < 0
    steps = torch.arange(n_steps - 1, device=dev)[:, None, None]
    hit = sign_change.any(dim=0)
    first = torch.where(hit, torch.where(sign_change, steps, n_steps).amin(dim=0), 0)
    lo, hi = ts[first], ts[first + 1]
    flo = torch.gather(vals, 0, first[None])[0]
    for _ in range(4):
        mid = 0.5 * (lo + hi)
        fm = _trilinear(f, campos + mid[..., None] * dirs, extent)
        go_lo = (flo * fm) < 0
        hi = torch.where(go_lo, mid, hi)
        lo = torch.where(go_lo, lo, mid)
        flo = torch.where(go_lo, flo, fm)
    p_hit = campos + (0.5 * (lo + hi))[..., None] * dirs
    axes = torch.eye(3, **f32) * (2 * extent / f.shape[0])
    grad = torch.stack([_trilinear(f, p_hit + axes[i], extent) - _trilinear(f, p_hit - axes[i], extent)
                        for i in range(3)], -1)
    n = grad / (torch.linalg.norm(grad, dim=-1, keepdim=True) + 1e-12)
    light = torch.tensor(LIGHT_DIR, **f32)
    lam = torch.clamp(-(n @ (light / torch.linalg.norm(light))), 0.0, 1.0)
    color = torch.tensor(BASE_COLOR, **f32) * (AMBIENT + (1 - AMBIENT) * lam[..., None])
    return torch.clamp(torch.where(hit[..., None], color, torch.zeros_like(color)), 0.0, 1.0)


def batch_order(n_views: int, batch: int, seed: int):
    """Endless batches of view ids from the seed: each epoch one permutation
    of the views cut into batches of ``batch`` distinct views (``batch``
    divides ``n_views``), so the first ``n_views // batch`` batches hold
    every view once."""
    if n_views % batch:
        raise ValueError(f"{n_views} views do not cut into batches of {batch}")
    rng = np.random.default_rng(int(seed) & (2**63 - 1))
    while True:
        perm = rng.permutation(n_views)
        for i in range(0, n_views, batch):
            yield [int(v) for v in perm[i:i + batch]]
