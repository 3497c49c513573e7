"""Device ms a step of the kernels under the train step's ``gs.adam_sh``
range: Adam's update of the SH field alone, nested in ``gs.adam``
(``optim/adam.py`` ``adam_update``; layer: optimizer). A program without
the range gives None."""
from gsbench.rangeread import range_device_ms

UNIT = "ms"


def read(ctx):
    ms = range_device_ms(ctx.prof, "gs.adam_sh")
    return ms / ctx.steps if ms else None
