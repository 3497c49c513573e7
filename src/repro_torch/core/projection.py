"""EWA projection of 3D Gaussians to screen-space splats (PyTorch).

Produces the packed splat representation that the render pipeline bins and
composites: ``PACKED_DIM`` = 11 floats per Gaussian, in the order ``MX..RAD``
of the JAX package, so packed tensors compare entry for entry across the two
packages.

``project`` dispatches by the device of the model's tensors: a CPU model
runs the plain PyTorch version (``kernels/gsproject/ref.py``), a CUDA model
the hand-written projection kernel (``kernels/gsproject/gsproject.cu``) through
``kernels/gsproject/ops.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import gaussians as G
from repro_torch.kernels.gsproject import ops as _gsproject

# Packed splat layout (dim PACKED_DIM along last axis)
MX, MY, CA, CB, CC, OP, CR, CG, CB_, DEPTH, RAD = range(11)
PACKED_DIM = 11


class Camera(NamedTuple):
    """Pinhole camera. Leaves are float32 tensors (or, in the host-side
    serving stack, numpy arrays); a leading batch dim stacks cameras.
    Cameras live on the host: the projection kernel takes their values as
    launch arguments, and the plain version moves them to the model."""

    viewmat: torch.Tensor  # (4,4) world -> camera
    fx: torch.Tensor       # ()
    fy: torch.Tensor       # ()
    cx: torch.Tensor       # ()
    cy: torch.Tensor       # ()

    @property
    def campos(self) -> torch.Tensor:
        vm = torch.as_tensor(self.viewmat)
        R = vm[:3, :3]
        t = vm[:3, 3]
        return -R.T @ t


def camera_from_numpy(cam) -> Camera:
    """The port's host camera from anything with the five ``Camera`` fields
    holding array-likes (a JAX camera, or one after ``tree_map(np.asarray)``)."""
    return Camera(*[torch.tensor(np.asarray(getattr(cam, f), np.float32)) for f in Camera._fields])


def camera_to_numpy(cam: Camera) -> Camera:
    """Host camera with float32 numpy leaves (the serving stack's key math)."""
    return Camera(*[np.asarray(torch.as_tensor(x).cpu(), np.float32) for x in cam])


def look_at_camera(eye, target, up, fx, fy, cx, cy) -> Camera:
    f32 = torch.float32
    eye = torch.as_tensor(np.asarray(eye, np.float32))
    target = torch.as_tensor(np.asarray(target, np.float32))
    up = torch.as_tensor(np.asarray(up, np.float32))
    fwd = target - eye
    fwd = fwd / (torch.linalg.norm(fwd) + 1e-12)
    right = torch.linalg.cross(fwd, up, dim=-1)
    right = right / (torch.linalg.norm(right) + 1e-12)
    down = torch.linalg.cross(fwd, right, dim=-1)  # camera +y points down (image convention)
    R = torch.stack([right, down, fwd], dim=0)  # world -> cam rows
    t = -R @ eye
    viewmat = torch.eye(4, dtype=f32)
    viewmat[:3, :3] = R
    viewmat[:3, 3] = t
    return Camera(viewmat, *[torch.tensor(float(v), dtype=f32) for v in (fx, fy, cx, cy)])


def project(
    g: G.GaussianModel,
    cam: Camera,
    *,
    near: float = 0.01,
    blur: float = 0.3,
    max_radius: float = 1e4,
) -> torch.Tensor:
    """Project all Gaussians for one camera. Returns packed splats (N, 11).

    Invalid (behind-camera) Gaussians get opacity 0, radius 0, depth +inf so a
    depth sort pushes them to the back and compositing ignores them. Runs the
    plain version on a CPU model and the projection kernel on a CUDA model.
    """
    return _gsproject.project_packed(g, cam, near=near, blur=blur, max_radius=max_radius)


def project_bounds_np(
    g,
    cam,
    idx: np.ndarray | None = None,
    *,
    near: float = 0.01,
    blur: float = 0.3,
    max_radius: float = 1e4,
    rel_pad: float = 1e-3,
    pad_px: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Conservative host-side screen bounds for a subset of Gaussians.

    Float64 numpy mirror of :func:`project`'s (mean_x, mean_y, radius) math
    — the only splat quantities tile binning looks at — for world-space
    invalidation: the serving stack maps changed Gaussians to the screen
    tiles they can touch without a device round-trip. Returns ``(mx, my,
    rad)`` with ``rad == 0`` for Gaussians the rasterizer would cull.

    Conservatism, not bit-equality, is the contract: the jitted f32 path
    rounds differently, so every radius is padded by ``rel_pad``
    (relative) plus ``pad_px`` pixels, and the near-plane cut keeps a
    slack band of splats the f32 test might admit. A Gaussian outside the
    padded bound here is guaranteed outside the rasterizer's bound.
    """
    means = np.asarray(g.means, np.float64)
    log_scales = np.asarray(g.log_scales, np.float64)
    quats = np.asarray(g.quats, np.float64)
    if idx is not None:
        sel = np.asarray(idx).reshape(-1)
        means, log_scales, quats = means[sel], log_scales[sel], quats[sel]
    vm = np.asarray(cam.viewmat, np.float64)
    R, tvec = vm[:3, :3], vm[:3, 3]
    p_cam = means @ R.T + tvec
    x, y, z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2]
    valid = z > near * (1.0 - 1e-4)  # slack: admit what f32 might admit
    zc = np.where(valid, z, 1.0)

    fx = float(np.asarray(cam.fx))
    fy = float(np.asarray(cam.fy))
    mx = fx * x / zc + float(np.asarray(cam.cx))
    my = fy * y / zc + float(np.asarray(cam.cy))

    # world covariance R S S^T R^T (gaussians.quat_to_rotmat / covariance3d)
    q = quats / (np.linalg.norm(quats, axis=-1, keepdims=True) + 1e-12)
    w, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    rot = np.empty((q.shape[0], 3, 3), np.float64)
    rot[:, 0, 0] = 1 - 2 * (qy * qy + qz * qz)
    rot[:, 0, 1] = 2 * (qx * qy - w * qz)
    rot[:, 0, 2] = 2 * (qx * qz + w * qy)
    rot[:, 1, 0] = 2 * (qx * qy + w * qz)
    rot[:, 1, 1] = 1 - 2 * (qx * qx + qz * qz)
    rot[:, 1, 2] = 2 * (qy * qz - w * qx)
    rot[:, 2, 0] = 2 * (qx * qz - w * qy)
    rot[:, 2, 1] = 2 * (qy * qz + w * qx)
    rot[:, 2, 2] = 1 - 2 * (qx * qx + qy * qy)
    RS = rot * np.exp(log_scales)[:, None, :]
    cov3d = RS @ np.swapaxes(RS, -1, -2)

    inv_z = 1.0 / zc
    J = np.zeros((means.shape[0], 2, 3), np.float64)
    J[:, 0, 0] = fx * inv_z
    J[:, 0, 2] = -fx * x * inv_z * inv_z
    J[:, 1, 1] = fy * inv_z
    J[:, 1, 2] = -fy * y * inv_z * inv_z
    JW = J @ R
    cov2d = JW @ cov3d @ np.swapaxes(JW, -1, -2)
    a = cov2d[:, 0, 0] + blur
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1] + blur
    det = np.maximum(a * c - b * b, 1e-12)
    mid = 0.5 * (a + c)
    lam1 = mid + np.sqrt(np.maximum(mid * mid - det, 0.0))
    rad = np.minimum(np.ceil(3.0 * np.sqrt(np.maximum(lam1, 0.0))), max_radius)
    rad = rad * (1.0 + rel_pad) + pad_px
    rad = np.where(valid, rad, 0.0)
    return mx, my, rad


def sort_by_depth(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Depth-sort packed splats front-to-back. Returns (sorted_packed, order).

    The sort is stable, as ``jnp.argsort`` is: ties keep index order, so the
    per-tile index lists equal the JAX package's entry for entry. The order is
    not differentiable (gradients flow through the gathered values).
    """
    order = torch.sort(packed[:, DEPTH].detach(), stable=True).indices
    return packed[order], order
