"""The model at the paper's Gaussian count, grown from the surface points on
a device from the seed.

A frozen copy of the port's ``configs/gs_datasets.py`` ``paper_scene`` and
``pad_dead``, rewritten to draw on the card with a ``torch.Generator`` in a
few large calls: every surface point is replicated with sub-voxel jitter up
to the count, the init scale shrinks with the replication so the surface
keeps its coverage, and scales, rotations and opacities are drawn from the
seed (random weights, as a trained model would vary). The model is padded
with dead Gaussians (far away, zero color, opacity logit -20) to a multiple
of ``pad_to``.
"""
from __future__ import annotations

import math

import torch

FIELDS = ("means", "log_scales", "quats", "opacity_logit", "sh")
SH_C0 = 0.28209479177387814
DEAD_LOGIT = -20.0
DEAD_SCALE = 1e-4


def grow(points: torch.Tensor, colors: torch.Tensor, *, n: int, spacing: float, sh_degree: int, init_opacity: float,
         pad_to: int, seed: int) -> dict:
    """The padded model as a dict of float32 leaves in ``FIELDS`` order, on
    the points' device."""
    dev = points.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & (2**63 - 1))
    f32 = dict(dtype=torch.float32, device=dev, generator=gen)
    m = points.shape[0]
    src = torch.arange(n, device=dev) % m
    means = points[src] + (torch.rand((n, 3), **f32) - 0.5) * spacing
    init_scale = 0.5 * spacing / math.sqrt(n / m)
    log_scales = math.log(init_scale) + 0.3 * torch.randn((n, 3), **f32)
    quats = torch.randn((n, 4), **f32)
    logit = math.log(init_opacity / (1 - init_opacity))
    opacity_logit = logit + 0.5 * torch.randn((n,), **f32)
    k = (sh_degree + 1) ** 2
    sh = torch.zeros((n, k, 3), dtype=torch.float32, device=dev)
    sh[:, 0, :] = (colors[src] - 0.5) / SH_C0

    pad = (-n) % pad_to
    if pad:
        means = torch.cat([means, torch.full((pad, 3), 1e6, dtype=torch.float32, device=dev)])
        log_scales = torch.cat([log_scales, torch.full((pad, 3), math.log(DEAD_SCALE), dtype=torch.float32,
                                                       device=dev)])
        dead_q = torch.zeros((pad, 4), dtype=torch.float32, device=dev)
        dead_q[:, 0] = 1.0
        quats = torch.cat([quats, dead_q])
        opacity_logit = torch.cat([opacity_logit, torch.full((pad,), DEAD_LOGIT, dtype=torch.float32, device=dev)])
        dead_sh = torch.zeros((pad, k, 3), dtype=torch.float32, device=dev)
        dead_sh[:, 0, :] = -0.5 / SH_C0
        sh = torch.cat([sh, dead_sh])
    leaves = (means, log_scales, quats, opacity_logit, sh)
    return {f: x.contiguous() for f, x in zip(FIELDS, leaves)}
