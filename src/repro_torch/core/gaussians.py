"""Gaussian primitive parameterization (PyTorch).

The model state is a named tuple of per-Gaussian parameter tensors, matching
the 3D-GS formulation (Kerbl et al. 2023) as used by the paper: means,
anisotropic scales (log-space), rotations (quaternions), opacity
(logit-space) and color (spherical-harmonic coefficients; degree 0 by
default for isosurface visualization, where color is view-independent
shading baked from the transfer function).

The fields, their order and their layouts are those of the JAX package's
``GaussianModel``, so a model crosses between the packages as five numpy
arrays (:func:`from_numpy`, :func:`to_numpy`). The serving stack also builds
models whose leaves are numpy arrays (the host-side LOD pyramid); the helpers
here that only read leaves accept either.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814


class GaussianModel(NamedTuple):
    """Per-Gaussian learnable parameters. Leading dim N is the Gaussian count."""

    means: torch.Tensor          # (N, 3) world-space centers
    log_scales: torch.Tensor     # (N, 3) log of per-axis std-dev
    quats: torch.Tensor          # (N, 4) rotation quaternion (wxyz, unnormalized)
    opacity_logit: torch.Tensor  # (N,)  sigmoid^-1 of opacity
    sh: torch.Tensor             # (N, K, 3) SH coefficients, K = (deg+1)^2

    @property
    def n(self) -> int:
        return int(self.means.shape[0])

    @property
    def sh_degree(self) -> int:
        return int(np.sqrt(self.sh.shape[1])) - 1

    def to(self, device) -> "GaussianModel":
        """The same model with every leaf a float32 tensor on ``device``."""
        return GaussianModel(*[
            (x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x)))
            .to(device=device, dtype=torch.float32).contiguous()
            for x in self
        ])


def from_numpy(params, device) -> GaussianModel:
    """The port's model from five arrays in the JAX field order.

    ``params`` is anything with the five ``GaussianModel`` fields holding
    array-likes: the JAX model after ``jax.tree_util.tree_map(np.asarray, g)``,
    or a host-side numpy model of the serving stack."""
    return GaussianModel(*[np.asarray(getattr(params, f), np.float32) for f in GaussianModel._fields]).to(device)


def to_numpy(g: GaussianModel) -> GaussianModel:
    """Host copy with float32 numpy leaves (the serving stack's host layout)."""
    return GaussianModel(*[
        x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
        for x in g
    ])


def scales(g: GaussianModel) -> torch.Tensor:
    return torch.exp(g.log_scales)


def opacities(g: GaussianModel) -> torch.Tensor:
    return torch.sigmoid(g.opacity_logit)


def init_from_points(
    points,
    colors=None,
    *,
    sh_degree: int = 0,
    init_opacity: float = 0.1,
    init_scale=None,
    device=None,
) -> GaussianModel:
    """Seed Gaussians from an isosurface point cloud (the paper's init path).

    ``init_scale`` defaults to a heuristic mean nearest-neighbor distance
    estimated from the bounding-box density. The model lands on ``device``
    (default: the device of ``points`` when it is a tensor, else the CPU).
    """
    if device is None:
        device = points.device if isinstance(points, torch.Tensor) else "cpu"
    points = torch.as_tensor(points, dtype=torch.float32).to(device)
    n = points.shape[0]
    if colors is None:
        colors = torch.full((n, 3), 0.5, dtype=torch.float32, device=device)
    colors = torch.as_tensor(colors, dtype=torch.float32).to(device)
    k = (sh_degree + 1) ** 2
    sh = torch.zeros((n, k, 3), dtype=torch.float32, device=device)
    # DC term chosen so that degree-0 eval reproduces `colors` exactly.
    sh[:, 0, :] = (colors - 0.5) / SH_C0

    if init_scale is None:
        lo = points.min(dim=0).values
        hi = points.max(dim=0).values
        vol = torch.prod(torch.clamp(hi - lo, min=1e-6))
        init_scale = torch.clamp((vol / max(n, 1)) ** (1.0 / 3.0), 1e-4, 1e2)
    init_scale = torch.as_tensor(init_scale, dtype=torch.float32).to(device)
    log_scales = torch.log(init_scale).expand(n, 3).to(torch.float32).contiguous()

    quats = torch.zeros((n, 4), dtype=torch.float32, device=device)
    quats[:, 0] = 1.0
    logit = float(np.log(init_opacity / (1 - init_opacity)))
    opacity_logit = torch.full((n,), logit, dtype=torch.float32, device=device)
    return GaussianModel(points.contiguous(), log_scales, quats, opacity_logit, sh)


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(N,4) wxyz quaternions (unnormalized) -> (N,3,3) rotation matrices."""
    q = quats / (torch.linalg.norm(quats, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [torch.stack([r00, r01, r02], -1), torch.stack([r10, r11, r12], -1), torch.stack([r20, r21, r22], -1)], -2
    )


def covariance3d(g: GaussianModel) -> torch.Tensor:
    """(N,3,3) world-space covariance R S S^T R^T."""
    R = quat_to_rotmat(g.quats)
    s = scales(g)
    RS = R * s[:, None, :]
    return RS @ RS.transpose(-1, -2)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH color for view directions.

    sh: (N, K, 3), dirs: (N, 3) unit vectors (camera->gaussian). Returns (N,3)
    in [0,1]-ish (clipped downstream). Supports degrees 0..3.
    """
    k = sh.shape[1]
    c = SH_C0 * sh[:, 0, :]
    if k > 1:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        c = c + 0.4886025119029199 * (-y * sh[:, 1, :] + z * sh[:, 2, :] - x * sh[:, 3, :])
    if k > 4:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        c = c + (
            1.0925484305920792 * xy * sh[:, 4, :]
            + -1.0925484305920792 * yz * sh[:, 5, :]
            + 0.31539156525252005 * (2.0 * zz - xx - yy) * sh[:, 6, :]
            + -1.0925484305920792 * xz * sh[:, 7, :]
            + 0.5462742152960396 * (xx - yy) * sh[:, 8, :]
        )
    if k > 9:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        xx, yy, zz = x * x, y * y, z * z
        c = c + (
            -0.5900435899266435 * y * (3 * xx - yy) * sh[:, 9, :]
            + 2.890611442640554 * x * y * z * sh[:, 10, :]
            + -0.4570457994644658 * y * (4 * zz - xx - yy) * sh[:, 11, :]
            + 0.3731763325901154 * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12, :]
            + -0.4570457994644658 * x * (4 * zz - xx - yy) * sh[:, 13, :]
            + 1.445305721320277 * z * (xx - yy) * sh[:, 14, :]
            + -0.5900435899266435 * x * (xx - 3 * yy) * sh[:, 15, :]
        )
    return c + 0.5
