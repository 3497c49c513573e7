"""Plain PyTorch version of the projection kernel: EWA projection per Gaussian.

It computes what ``gsproject.cu`` computes, with the same arithmetic in the
same order: cov3d's six unique entries as sums over the three scaled rotation
columns, folded with the two rows of J·W, then the conic, the radius, the
opacity and the color. Written elementwise (no 3x3 matrix products), one
PyTorch op per kernel operation, so that on the card the kernel (built
without FMA contraction) and this version round alike and the radius'
``ceil`` flips on no Gaussian. It agrees with the JAX package's matrix-form
projection within float32 rounding, and covers SH degrees 0..3, as the
kernel does: above degree 0 it evaluates ``eval_sh``, whose order of
products and sums the kernel follows term by term.
"""
from __future__ import annotations

import torch

from repro_torch.core import gaussians as G


def project_ref(
    g: G.GaussianModel,
    cam,
    *,
    near: float = 0.01,
    blur: float = 0.3,
    max_radius: float = 1e4,
) -> torch.Tensor:
    """(N, 11) packed splats ``MX..RAD`` for one camera, on ``g``'s device."""
    dev = g.means.device
    vm = torch.as_tensor(cam.viewmat).to(device=dev, dtype=torch.float32)
    rv = [[vm[i, j] for j in range(4)] for i in range(3)]  # rows of viewmat[:3]
    fx, fy, cx, cy = (torch.as_tensor(v).to(device=dev, dtype=torch.float32) for v in (cam.fx, cam.fy, cam.cx, cam.cy))

    mx, my_, mz = g.means[:, 0], g.means[:, 1], g.means[:, 2]
    sx = torch.exp(g.log_scales[:, 0])
    sy = torch.exp(g.log_scales[:, 1])
    sz = torch.exp(g.log_scales[:, 2])
    qw, qx, qy, qz = g.quats[:, 0], g.quats[:, 1], g.quats[:, 2], g.quats[:, 3]
    qn = torch.rsqrt(qw * qw + qx * qx + qy * qy + qz * qz + 1e-24)
    qw, qx, qy, qz = qw * qn, qx * qn, qy * qn, qz * qn

    r = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ]
    s2 = [sx * sx, sy * sy, sz * sz]
    # cov3d_ij = sum_k s_k^2 r[i][k] r[j][k]
    cov = {}
    for i in range(3):
        for j in range(i, 3):
            cov[(i, j)] = s2[0] * r[i][0] * r[j][0] + s2[1] * r[i][1] * r[j][1] + s2[2] * r[i][2] * r[j][2]

    def cov3(i, j):
        return cov[(i, j)] if i <= j else cov[(j, i)]

    # camera-space position
    x, y, z = (rv[i][0] * mx + rv[i][1] * my_ + rv[i][2] * mz + rv[i][3] for i in range(3))
    valid = z > near
    zc = torch.where(valid, z, torch.ones_like(z))
    inv_z = 1.0 / zc
    inv_z2 = inv_z * inv_z

    mean_x = fx * x * inv_z + cx
    mean_y = fy * y * inv_z + cy

    # J·W rows (2x3): jw[a][k] = J[a,:] @ Rv[:,k]
    jw0 = [fx * inv_z * rv[0][k] - fx * x * inv_z2 * rv[2][k] for k in range(3)]
    jw1 = [fy * inv_z * rv[1][k] - fy * y * inv_z2 * rv[2][k] for k in range(3)]
    v0 = [cov3(k, 0) * jw0[0] + cov3(k, 1) * jw0[1] + cov3(k, 2) * jw0[2] for k in range(3)]
    v1 = [cov3(k, 0) * jw1[0] + cov3(k, 1) * jw1[1] + cov3(k, 2) * jw1[2] for k in range(3)]
    a = jw0[0] * v0[0] + jw0[1] * v0[1] + jw0[2] * v0[2] + blur
    b = jw1[0] * v0[0] + jw1[1] * v0[1] + jw1[2] * v0[2]
    c = jw1[0] * v1[0] + jw1[1] * v1[1] + jw1[2] * v1[2] + blur

    det = torch.clamp(a * c - b * b, min=1e-12)
    inv_det = 1.0 / det
    conic_a = c * inv_det
    conic_b = -b * inv_det
    conic_c = a * inv_det
    # The radius carries no gradient (the rasterizer's backward writes zeros
    # for it), so it is computed from detached values: where mid*mid - det
    # or lam1 is exactly 0, autograd through ceil's materialised zero and
    # sqrt's infinite slope would give 0 * inf = NaN in the means' gradient.
    ad, cd, detd = a.detach(), c.detach(), det.detach()
    mid = 0.5 * (ad + cd)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - detd, min=0.0))
    radius = torch.clamp(torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0))), max=max_radius)

    opac = G.opacities(g)
    if g.sh.shape[1] == 1:
        rgb = G.SH_C0 * g.sh[:, 0, :] + 0.5
    else:
        campos = -vm[:3, :3].T @ vm[:3, 3]
        dirs = g.means - campos
        dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
        rgb = G.eval_sh(g.sh, dirs)
    rgb = torch.clamp(rgb, 0.0, 1.0)

    zero = torch.zeros_like(z)
    opac = torch.where(valid, opac, zero)
    radius = torch.where(valid, radius, zero)
    depth = torch.where(valid, z, torch.full_like(z, float("inf")))
    return torch.stack(
        [mean_x, mean_y, conic_a, conic_b, conic_c, opac, rgb[:, 0], rgb[:, 1], rgb[:, 2], depth, radius],
        dim=-1,
    )
