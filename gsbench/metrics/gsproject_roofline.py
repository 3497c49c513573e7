"""The projection kernel's share (%) of its roofline: the frozen bound of
``gsbench/work`` ``gsproject_cost`` for this chip's Gaussians over the mean
device time of its ``gsproject_fwd`` launches (layer: kernels,
``kernels/gsproject``)."""
from gsbench.profread import kernel_ms
from gsbench.work import gsproject_cost, least_ms

UNIT = "%"


def read(ctx):
    ms = kernel_ms(ctx.prof, "gsproject_fwd")
    if not ms:
        return None
    return 100.0 * least_ms(*gsproject_cost(ctx.n_local, ctx.sh_coeffs)) / (sum(ms) / len(ms))
