"""Least work of what the benchmark times, counted from shapes alone.

Frozen here so that a change to the program cannot move the yardstick:

- ``gsproject_cost``: a copy of the port's ``kernels/cost.py`` formula for
  the projection kernel (operations and bytes per Gaussian, the SH bands);
- ``step_work``: the least bytes and operations of one train step, from
  the model's size, the views a step and the image, whatever implements
  it. With P parameter floats a Gaussian, n Gaussians on the chip and B
  views a step: Adam reads parameters, gradients and both moments and
  writes parameters and moments (7 P floats a Gaussian); each view's
  projection reads P and writes 11 floats a Gaussian, and its backward
  reads P and the 11 splat gradients and writes P; each view's image
  terms write the image, read it with the ground truth for the loss and
  write its gradient. Binning and the rasterizer are not counted yet.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit: 67
TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of HBM3.
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

GSPROJECT_BYTES_PER_GAUSSIAN = (14 + 11) * 4
GSPROJECT_OPS_PER_GAUSSIAN = 130
GSPROJECT_SH_BAND_OPS = ((1, 14 + 21), (4, 15 + 30), (9, 28 + 42))
ADAM_OPS_PER_FLOAT = 12  # two moment updates, two bias corrections, sqrt, add eps, divide, step
PROJ_BWD_OPS_FACTOR = 2  # a reverse pass does at least twice the forward's arithmetic


def gsproject_cost(n: int, sh_coeffs: int = 1) -> tuple[int, int]:
    """(operations, bytes) of projecting ``n`` Gaussians with ``sh_coeffs``
    SH coefficients a channel (1, 4, 9, 16 for degrees 0-3)."""
    ops = GSPROJECT_OPS_PER_GAUSSIAN + sum(band for above, band in GSPROJECT_SH_BAND_OPS if sh_coeffs > above)
    return n * ops, n * (GSPROJECT_BYTES_PER_GAUSSIAN + 12 * (sh_coeffs - 1))


def param_floats(sh_degree: int) -> int:
    """Floats a Gaussian: mean 3, log-scale 3, quaternion 4, opacity 1, SH."""
    return 3 + 3 + 4 + 1 + 3 * (sh_degree + 1) ** 2


def step_work(n: int, views: int, pixels: int, sh_degree: int) -> tuple[int, int]:
    """(operations, bytes) one chip must at least do in a train step: ``n``
    Gaussians held there, ``views`` views projected there, ``pixels`` image
    pixels scored there."""
    p = param_floats(sh_degree)
    proj_ops, _ = gsproject_cost(n, (sh_degree + 1) ** 2)
    adam_bytes = 7 * p * 4 * n
    proj_bytes = views * 4 * (p + 11) * n
    bwd_bytes = views * 4 * (2 * p + 11) * n
    image_bytes = 4 * pixels * 3 * 4
    ops = ADAM_OPS_PER_FLOAT * p * n + views * (1 + PROJ_BWD_OPS_FACTOR) * proj_ops
    return ops, adam_bytes + proj_bytes + bwd_bytes + image_bytes


def least_ms(ops: float, nbytes: float) -> float:
    """The least time (ms) of this work on one chip: the larger bound."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
