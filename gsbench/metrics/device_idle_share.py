"""The share (%) of the traced steps' wall time in which no operation ran
on the chip: 1 - the union of the device intervals over the wall (layer:
device)."""
from gsbench.profread import device_rows, union_ms

UNIT = "%"


def read(ctx):
    rows = [(s, e) for _, s, e in device_rows(ctx.prof)]
    if not rows or ctx.wall_ms <= 0:
        return None
    return 100.0 * (1.0 - union_ms(rows) / ctx.wall_ms)
