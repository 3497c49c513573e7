"""Device ms a step of the kernels under the train step's ``gs.bin``
ranges: the per-tile front-most-K lists, top-k and candidate gathers
(``core/render.py`` ``bin_tiles``; layer: binning)."""
from gsbench.rangeread import range_device_ms

UNIT = "ms"


def read(ctx):
    ms = range_device_ms(ctx.prof, "gs.bin")
    return ms / ctx.steps if ms else None
