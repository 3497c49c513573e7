"""Device ms a step of the kernels under the indexing backward,
``IndexBackward0``: the transposes of the depth sort's and the tile slabs'
gathers (``core/projection.py`` ``sort_by_depth``,
``kernels/tile_raster/ops.py`` ``rasterize_tiles``; layer: rasterizer input
gather)."""
from gsbench.profread import node_device_ms

UNIT = "ms"


def read(ctx):
    ms = node_device_ms(ctx.prof, "IndexBackward")
    return ms / ctx.steps if ms > 0 else None
