"""The work of the port's kernels, one copy of the formulas.

``chip_smoke.py``'s bounds, the kernel micro-benchmark
(``benchmarks/raster_kernel_torch.py``) and the operation counter
(``launch/op_cost.py``) all read them from here. Each formula counts what
the kernel's function needs on these inputs, as the bounds do: each input
byte read once, each output byte written once, and the operations the
kernel's source does per unit of work.

Each direction of a kernel's autograd Function (and ``optim/adam.py``
``adam_update``, for each field's update) reports that work to the active
counter from one region, around its one choice of device:

    with cost.region("gsproject") as r:
        out = launch(...) if cuda else project_ref(...)  # the kernel or the plain version
        if r:
            r.report(*cost.gsproject_cost(n), out)

Inside a region the counter counts none of the dispatched ops (on the card
only the outputs' ``torch.empty``; on the CPU the plain version's ops), and
the kernel's own count stands for them. With no counter active, ``region``
returns one shared null region: one check, nothing else. A counter counts
only the threads whose dispatch-mode stack holds it (the one that entered
it, and autograd's device threads, which inherit that stack): a kernel that
another thread launches meanwhile (the serving paths' worker threads) opens
no region in it.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

# operation counts per unit of work, from the kernels' sources
GSPROJECT_BYTES_PER_GAUSSIAN = (14 + 11) * 4
GSPROJECT_OPS_PER_GAUSSIAN = 130  # mul/add/compare incl. 5 exp/rsqrt/sqrt, 2 divisions
# the SH color above degree 0, per Gaussian, band by band as gsproject.cu's
# eval_sh_color does it (eval_sh's `k > 1`, `k > 4`, `k > 9` tests):
# band 1: the direction (3 subtractions, the norm's 3 squares, 2 sums, sqrt
# and + eps, 3 divisions), -y, and 7 a channel; band 2: the 6 products of
# the direction, 9 for the 5 basis factors, and 10 a channel; band 3: 28
# for the 7 basis factors and 14 a channel
GSPROJECT_SH_BAND_OPS = ((1, 14 + 21), (4, 15 + 30), (9, 28 + 42))
# backward, per Gaussian (gsproject.cu gsproject_bwd_kernel): it reads the
# forward's 14 inputs and the splat's 11 gradient floats and writes the 14
# parameter gradients; the forward's geometry recomputed (~214), the
# opacity, color clamp and screen position (~32), the conic and
# determinant (22), J·W's and cov3d's gradients (96), back to the camera
# frame and the means (41), to the scales and rotation (78), the
# quaternion and its normalization (93), and the DC's 3 products
GSPROJECT_BWD_BYTES_PER_GAUSSIAN = (14 + 11 + 14) * 4
GSPROJECT_BWD_OPS_PER_GAUSSIAN = 579
# the SH color's backward above degree 0, band by band: the forward's band
# recomputed (35, 45, 70), the band's factors, their gradients s(k) and the
# direction's, the direction's own backward (band 1 only) and 3 products a
# coefficient for the SH gradient
GSPROJECT_BWD_SH_BAND_OPS = ((1, 35 + 58), (4, 45 + 93), (9, 70 + 177))
# Adam (adam/adam.cu), per float of a field: m' (2 products, a sum), v' (3
# products, a sum), the two bias corrections' divisions, sqrt, + eps, the
# rate's product, the step's division and the subtraction; p, g, m, v read
# and p', m', v' written
ADAM_OPS_PER_FLOAT = 14
ADAM_BYTES_PER_FLOAT = 7 * 4
RASTER_OPS_PER_EVAL = 24          # dx, dy, power, clamp, exp, alpha, tests, T update, 3 color FMAs
# backward, per composited (pixel, splat): the alpha recomputed (15), T by
# division, w, dw and the color grads (11), d(alpha) and B (5), d(power) and
# the five geometry grads (17), and the nine sums over the tile's pixels (9);
# it starts from the forward's t_final and n_contrib, so no forward walk
RASTER_BWD_OPS_PER_HIT = 66
RASTER_FIELDS_READ = 9            # mx, my, conic a/b/c, opacity, r, g, b (not depth, radius)
SPLAT_FIELDS = 11                 # a packed splat: the 9 above, depth, radius

# the active counters of every thread (``launch/op_cost.py`` ``OpCost``):
# empty is the one check a region costs when nothing counts
_counters: list = []


class _NullRegion:
    """The region when nothing counts: falsy, and entering it does nothing."""

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL = _NullRegion()


def region(name: str):
    """A kernel's region in the innermost counter active on this thread, or
    the null region."""
    if not _counters:
        return _NULL
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if any(mode is c for c in _counters):
            return mode.region(name)
    return _NULL


def gsproject_cost(n: int, sh_coeffs: int = 1) -> tuple[int, int]:
    """(operations, bytes) of projecting ``n`` Gaussians with ``sh_coeffs``
    SH coefficients per channel (1, 4, 9, 16 for degrees 0-3): the
    projection, the SH color's bands, and each extra coefficient's 12 bytes."""
    ops = GSPROJECT_OPS_PER_GAUSSIAN + sum(band for above, band in GSPROJECT_SH_BAND_OPS if sh_coeffs > above)
    return n * ops, n * (GSPROJECT_BYTES_PER_GAUSSIAN + 12 * (sh_coeffs - 1))


def gsproject_bwd_cost(n: int, sh_coeffs: int = 1) -> tuple[int, int]:
    """(operations, bytes) of the projection's backward for ``n`` Gaussians
    with ``sh_coeffs`` SH coefficients per channel: each extra coefficient
    reads 12 bytes and writes 12."""
    ops = GSPROJECT_BWD_OPS_PER_GAUSSIAN + sum(
        band for above, band in GSPROJECT_BWD_SH_BAND_OPS if sh_coeffs > above)
    return n * ops, n * (GSPROJECT_BWD_BYTES_PER_GAUSSIAN + 24 * (sh_coeffs - 1))


def raster_evals(valid: torch.Tensor, composited: torch.Tensor) -> int:
    """Alpha evaluations these tiles need: each pixel walks its tile's valid
    splats until the stop rule fires (one past its last composited).
    ``composited`` (T, P) is ``tile_raster/ref.py`` ``composited_counts``."""
    kv = (valid > 0.5).sum(dim=1, keepdim=True)  # lists are valid-first
    return int(torch.minimum(kv, composited + 1).sum())


def raster_bytes(valid: torch.Tensor, p: int) -> int:
    """Bytes the rasterizer must move on these lists: the (T, K) float valid
    mask, the 9 fields it reads of each valid entry, and its (T, 3, P) color
    and (T, P) transmittance outputs."""
    n_valid = int((valid > 0.5).sum())
    return valid.numel() * 4 + n_valid * RASTER_FIELDS_READ * 4 + valid.shape[0] * 4 * p * 4


def raster_bwd_bytes(valid: torch.Tensor, p: int) -> int:
    """Bytes the rasterizer backward's function must move, as the Pallas
    kernel's ``_run_bwd`` takes it: what the forward reads (valid mask, 9
    fields of each valid entry), d(rgb) (T, 3, P) and d(t_final) (T, P) read,
    and the (T, 11, K) gradient slab written. The port's own residuals
    (t_final, n_contrib) are a design choice, not part of the function."""
    n_valid = int((valid > 0.5).sum())
    t_count, k = valid.shape
    return valid.numel() * 4 + n_valid * RASTER_FIELDS_READ * 4 + t_count * 4 * p * 4 + t_count * 11 * k * 4


def raster_fwd_cost(valid: torch.Tensor, composited: torch.Tensor, p: int) -> tuple[int, int]:
    """(operations, bytes) of the rasterizer forward on these lists."""
    return raster_evals(valid, composited) * RASTER_OPS_PER_EVAL, raster_bytes(valid, p)


def raster_bwd_cost(valid: torch.Tensor, hits: int, p: int) -> tuple[int, int]:
    """(operations, bytes) of the rasterizer backward: ``hits`` composited
    (pixel, splat) pairs (``composited_counts(..., live_only=True)``)."""
    return hits * RASTER_BWD_OPS_PER_HIT, raster_bwd_bytes(valid, p)


def slab_gather_cost(t_count: int, k: int, rows: int, ordered: bool) -> tuple[int, int]:
    """(operations, bytes) of the input gather (``slab_gather.cu``): a copy,
    so no operation; each slot reads its index and writes its splat's 11
    floats into the slab, and each of the ``rows`` distinct splats the lists
    name is read once (with its entry of ``order``)."""
    return 0, t_count * k * (4 + SPLAT_FIELDS * 4) + rows * (SPLAT_FIELDS * 4 + 8 * ordered)


def slab_bwd_cost(n_valid: int, slots: int, n: int, ordered: bool) -> tuple[int, int]:
    """(operations, bytes) of the gather's transpose on these lists: one add
    per gradient field of each of the ``n_valid`` valid slots; the (T, K)
    bool valid mask read, each valid slot's index (and row of ``order``) and
    9 gradient floats read, the (n, 11) gradient written."""
    return (n_valid * RASTER_FIELDS_READ,
            slots + n_valid * (4 + 8 * ordered + RASTER_FIELDS_READ * 4) + n * SPLAT_FIELDS * 4)


def adam_cost(n: int) -> tuple[int, int]:
    """(operations, bytes) of one Adam step over a field of ``n`` floats."""
    return n * ADAM_OPS_PER_FLOAT, n * ADAM_BYTES_PER_FLOAT


def attention_pairs(s: int, skv: int, causal: bool, window, q_offset: int) -> int:
    """Unmasked (query, key) pairs of one (batch, head)."""
    pos = q_offset + np.arange(s)
    lo = np.maximum(pos - window + 1, 0) if window is not None else np.zeros_like(pos)
    hi = np.minimum(pos, skv - 1) if causal else np.full_like(pos, skv - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window=None,
                   q_offset: int = 0) -> tuple[int, int]:
    """(flops, bytes) of the attention forward: 4 x hd per unmasked (query,
    key) pair of each (batch, head), and q, k, v read and o written once."""
    b, s, h, hd = q.shape
    flops = 4 * hd * attention_pairs(s, k.shape[1], causal, window, q_offset) * b * h
    return flops, (2 * q.numel() + k.numel() + v.numel()) * q.element_size()


def bound_ms(flops: float, nbytes: float, flops_per_s: float, bytes_per_s: float) -> tuple[float, str]:
    """The least time (ms) for this work and which of the two bounds it."""
    ops_ms, bytes_ms = flops / flops_per_s * 1e3, nbytes / bytes_per_s * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"
