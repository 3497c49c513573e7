"""The projection backward kernel's share (%) of its roofline: the frozen
bound of ``gsproject_bwd_cost`` for this chip's Gaussians over the mean
device time of its ``gsproject_bwd`` launches (layer: kernels,
``kernels/gsproject``).

``gsproject_bwd_cost`` is a copy of the port's ``kernels/cost.py`` formula,
frozen here beside its reader so that a change to the program cannot move
the yardstick: per Gaussian the kernel reads the forward's 14 inputs and
the splat's 11 gradient floats and writes 14 parameter gradients, and each
SH coefficient above the first reads 12 bytes and writes 12; the
operations are the kernel source's, band by band. The bound is the larger
of the operations at 67 TFLOP/s and the bytes at 3.35 TB/s
(``gsbench/work`` ``least_ms``).
"""
from gsbench.profread import kernel_ms
from gsbench.work import least_ms

UNIT = "%"

BWD_BYTES_PER_GAUSSIAN = (14 + 11 + 14) * 4
BWD_OPS_PER_GAUSSIAN = 579
BWD_SH_BAND_OPS = ((1, 35 + 58), (4, 45 + 93), (9, 70 + 177))


def gsproject_bwd_cost(n: int, sh_coeffs: int = 1) -> tuple[int, int]:
    """(operations, bytes) of the projection's backward for ``n`` Gaussians
    with ``sh_coeffs`` SH coefficients a channel (1, 4, 9, 16)."""
    ops = BWD_OPS_PER_GAUSSIAN + sum(band for above, band in BWD_SH_BAND_OPS if sh_coeffs > above)
    return n * ops, n * (BWD_BYTES_PER_GAUSSIAN + 24 * (sh_coeffs - 1))


def read(ctx):
    ms = kernel_ms(ctx.prof, "gsproject_bwd")
    if not ms:
        return None
    return 100.0 * least_ms(*gsproject_bwd_cost(ctx.n_local, ctx.sh_coeffs)) / (sum(ms) / len(ms))
