"""The whole train step's share (%) of the chip's peak: its least time
(``gsbench/work`` ``step_work``, the larger of operations at 67 TFLOP/s and
bytes at 3.35 TB/s) over the traced window's wall time a step (layer:
train step, ``core/train.py``)."""
from gsbench.work import least_ms

UNIT = "%"


def read(ctx):
    if not ctx.window_step_ms:
        return None
    return 100.0 * least_ms(*ctx.step_work) / ctx.window_step_ms
