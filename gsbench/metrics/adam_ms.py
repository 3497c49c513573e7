"""Device ms a step of the kernels under the train step's ``gs.adam``
range: the densify statistics and Adam (``optim/adam.py`` ``adam_update``;
layer: optimizer)."""
from gsbench.rangeread import range_device_ms

UNIT = "ms"


def read(ctx):
    ms = range_device_ms(ctx.prof, "gs.adam")
    return ms / ctx.steps if ms else None
