"""Host ms a step inside the projection's VJP: the sum of the trainer's
``vjp`` spans over the traced window (``kernels/gsproject/ops.py``
``Project.backward``, on the autograd thread) over the count of its
``dispatch`` spans (layer: projection)."""

UNIT = "ms"


def read(ctx):
    vjp = [t1 - t0 for name, t0, t1 in ctx.spans if name == "vjp"]
    steps = sum(1 for name, _, _ in ctx.spans if name == "dispatch")
    return 1e3 * sum(vjp) / steps if vjp and steps else None
