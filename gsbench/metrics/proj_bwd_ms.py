"""Device ms a step of the kernels under the projection's autograd node,
``ProjectBackward`` (``kernels/gsproject/ops.py`` ``Project.backward``;
layer: projection)."""
from gsbench.profread import node_device_ms

UNIT = "ms"


def read(ctx):
    ms = node_device_ms(ctx.prof, "ProjectBackward")
    return ms / ctx.steps if ms > 0 else None
