"""Device idle ms a step that began while the host was inside the
projection's VJP: the idle gaps of the profiled steps whose start falls in
a ``gs.vjp`` range (``kernels/gsproject/ops.py`` ``Project.backward``;
layer: projection, its host side)."""
from gsbench.rangeread import idle_by_range, ranges

UNIT = "ms"


def read(ctx):
    if not ranges(ctx.prof, "gs.vjp"):
        return None
    return idle_by_range(ctx.prof).get("gs.vjp", 0.0) / ctx.steps
