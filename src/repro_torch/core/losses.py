"""Training losses and image-quality metrics (PyTorch copy of the JAX
package's ``core/losses.py``).

- L1 + D-SSIM training loss with lambda=0.2 (3D-GS defaults, used by both
  Sewell et al. and the paper).
- PSNR / SSIM metrics.
- LPIPS proxy: no pretrained VGG weights offline, so a multi-scale
  gradient-magnitude perceptual distance stands in, labeled as a proxy.

Images are (H, W, C) tensors in [0, 1], as in the JAX package. The SSIM
window is a depthwise convolution (``F.conv2d``), as the JAX package leaves
it to XLA's convolution.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def gaussian_window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    """(size, size) normalized Gaussian window, float32."""
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(img0: torch.Tensor, img1: torch.Tensor, *, window_size: int = 11) -> torch.Tensor:
    """SSIM over (H,W,C) images in [0,1]. Matches the standard formulation."""
    c1, c2 = 0.01**2, 0.03**2
    win = gaussian_window(window_size, device=img0.device)[None, None]  # (1,1,k,k)

    def filt(x):
        # (H,W,C) -> (C,1,H,W), zero-padded SAME convolution per channel
        y = F.conv2d(x.permute(2, 0, 1)[:, None], win, padding=window_size // 2)
        return y[:, 0].permute(1, 2, 0)

    mu0, mu1 = filt(img0), filt(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = filt(img0 * img0) - mu00
    s11 = filt(img1 * img1) - mu11
    s01 = filt(img0 * img1) - mu01
    num = (2 * mu01 + c1) * (2 * s01 + c2)
    den = (mu00 + mu11 + c1) * (s00 + s11 + c2)
    return torch.mean(num / den)


def dssim(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    return (1.0 - ssim(img0, img1)) / 2.0


def gs_loss(pred: torch.Tensor, target: torch.Tensor, *, lam: float = 0.2) -> torch.Tensor:
    """(1-lam)*L1 + lam*D-SSIM — the 3D-GS training loss used in the paper."""
    return (1.0 - lam) * l1_loss(pred, target) + lam * dssim(pred, target)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def _grad_mag(img: torch.Tensor) -> torch.Tensor:
    g = torch.mean(img, dim=-1)
    gx = g[:, 1:] - g[:, :-1]
    gy = g[1:, :] - g[:-1, :]
    return torch.sqrt(gx[:-1, :] ** 2 + gy[:, :-1] ** 2 + 1e-12)


def lpips_proxy(img0: torch.Tensor, img1: torch.Tensor, *, scales: int = 3) -> torch.Tensor:
    """Multi-scale gradient-magnitude dissimilarity in [0,~1] (LPIPS stand-in).

    NOT LPIPS — a deterministic perceptual-distance proxy usable offline.
    Lower is better, like LPIPS; reported as `lpips_proxy` everywhere.
    """
    total = 0.0
    a, b = img0, img1
    for _ in range(scales):
        ga, gb = _grad_mag(a), _grad_mag(b)
        c = 0.0026
        sim = (2 * ga * gb + c) / (ga * ga + gb * gb + c)
        total = total + (1.0 - torch.mean(sim))
        if min(a.shape[0], a.shape[1]) >= 4:
            a = 0.25 * (a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2])
            b = 0.25 * (b[0::2, 0::2] + b[1::2, 0::2] + b[0::2, 1::2] + b[1::2, 1::2])
    return total / scales
