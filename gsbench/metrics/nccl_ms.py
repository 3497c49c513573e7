"""Device ms a step in NCCL kernels on this chip, waiting for the other
ranks included: the union of their intervals (layer: collectives,
``core/sharding.py``, ``launch/mesh.py``)."""
from gsbench.profread import device_rows, is_nccl, union_ms

UNIT = "ms"


def read(ctx):
    rows = [(s, e) for name, s, e in device_rows(ctx.prof) if is_nccl(name)]
    return union_ms(rows) / ctx.steps if rows else None
