"""The distributed L1 + D-SSIM loss, one-device part (PyTorch copy of the
JAX package's ``core/sharding.py``).

The JAX package computes the loss over pixel strips spread across the
model axis, extending each strip with its neighbours' halo rows so that the
sum across workers equals single-device SAME-padded SSIM over the full
image. On one device the strip is the whole image and the halo is zero
padding; the halo exchange across ranks (``halo_exchange_rows``) comes with
the port's multi-rank slice.

The 11x11 window is applied as a depthwise convolution (``F.conv2d`` with
15 groups, one per statistic channel), VALID over the zero-padded image, as
the JAX package leaves it to XLA's convolution. On the card the convolution
must not run in TF32 (cuDNN's default for float32): the train step turns it
off around its forward and backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.losses import gaussian_window


def _ssim_l1_sums_batched(pred: torch.Tensor, gt: torch.Tensor, window_size: int = 11):
    """Per-view (ssim_map_sum, l1_sum) of (B, h, W, 3) images, each (B,)."""
    halo = window_size // 2
    stack = torch.cat([pred, gt, pred * pred, gt * gt, pred * gt], dim=-1)  # (B,h,W,15)
    # zero rows above and below (the one-device halo), zero columns (SAME)
    ext = F.pad(stack.permute(0, 3, 1, 2), (halo, halo, halo, halo))     # (B,15,h+2p,W+2p)
    w = gaussian_window(window_size, device=pred.device)
    y = F.conv2d(ext, w[None, None].expand(15, 1, window_size, window_size), groups=15)  # (B,15,h,W)
    mu0, mu1 = y[:, 0:3], y[:, 3:6]
    e00, e11, e01 = y[:, 6:9], y[:, 9:12], y[:, 12:15]
    s00 = e00 - mu0 * mu0
    s11 = e11 - mu1 * mu1
    s01 = e01 - mu0 * mu1
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu0 * mu1 + c1) * (2 * s01 + c2)) / ((mu0 * mu0 + mu1 * mu1 + c1) * (s00 + s11 + c2))
    return ssim_map.sum(dim=(1, 2, 3)), torch.abs(pred - gt).sum(dim=(1, 2, 3))


def ssim_l1_sums(
    pred: torch.Tensor,  # (h, W, 3)
    gt: torch.Tensor,    # (h, W, 3)
    axis_name: str | None = None,
    *,
    window_size: int = 11,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ssim_map_sum, l1_sum, pixel_count) of one image, SAME-padded SSIM.

    ``axis_name`` must be None: the strip halo exchange across ranks is not
    ported yet."""
    if axis_name is not None:
        raise NotImplementedError("pixel strips across ranks are not ported yet (halo_exchange_rows)")
    ssim_s, l1_s = _ssim_l1_sums_batched(pred[None], gt[None], window_size)
    return ssim_s[0], l1_s[0], torch.full((), float(pred.numel()), dtype=torch.float32, device=pred.device)


def distributed_gs_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    *,
    lam: float = 0.2,
    strip_axis: str | None = None,
    reduce_axes: tuple[str, ...] = (),
) -> torch.Tensor:
    """(1-lam)*L1 + lam*D-SSIM over a batch of views.

    ``pred``/``gt``: (B, h, W, 3). One device: no strip axis, nothing to
    reduce across ranks."""
    if strip_axis is not None or reduce_axes:
        raise NotImplementedError("the loss across ranks is not ported yet")
    ssim_s, l1_s = _ssim_l1_sums_batched(pred, gt)
    cnt = float(pred[0].numel()) * pred.shape[0]
    mean_ssim = ssim_s.sum() / cnt
    mean_l1 = l1_s.sum() / cnt
    return (1.0 - lam) * mean_l1 + lam * (1.0 - mean_ssim) / 2.0
