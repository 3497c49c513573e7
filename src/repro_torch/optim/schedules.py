"""LR schedules: 3D-GS exponential position-LR decay + Grendel batch scaling."""
from __future__ import annotations

import math

import torch


def expon_lr(step, *, lr_init: float, lr_final: float, max_steps: int, delay_mult: float = 1.0) -> torch.Tensor:
    """3D-GS exponential decay schedule for the position learning rate.

    ``step`` is an int (or 0-d int32 tensor); the result is a 0-d float32
    tensor on the step's device, computed in float32 as JAX computes it."""
    step = torch.as_tensor(step, dtype=torch.int32)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    f32 = dict(dtype=torch.float32, device=t.device)
    log_lerp = torch.exp(torch.log(torch.full((), lr_init, **f32)) * (1 - t) + torch.log(torch.full((), lr_final, **f32)) * t)
    return delay_mult * log_lerp


def grendel_lr_scale(batch_size: int) -> float:
    """Grendel-GS "independent gradients" sqrt LR scaling for batched views.

    Zhao et al. (ECCV'24) show per-view gradients on disjoint pixels are
    near-independent, so LR scales with sqrt(batch) rather than linearly.
    """
    return math.sqrt(float(batch_size))
