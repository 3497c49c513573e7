"""Device ms a step of the kernels under the train step's ``gs.slab_bwd``
ranges: the rasterizer input gather's transpose, one sort of the valid slab
slots and one sum of each splat's run a view
(``kernels/tile_raster/ops.py`` ``GatherSlab``; layer: rasterizer input
gather). A program without the range gives None."""
from gsbench.rangeread import range_device_ms

UNIT = "ms"


def read(ctx):
    ms = range_device_ms(ctx.prof, "gs.slab_bwd")
    return ms / ctx.steps if ms is not None else None
