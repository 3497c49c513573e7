"""Host ms to enqueue one step: the mean of ``GSTrainer.fit``'s ``dispatch``
spans over the traced window (layer: trainer, ``launch/train.py``)."""

UNIT = "ms"


def read(ctx):
    spans = [t1 - t0 for name, t0, t1 in ctx.spans if name == "dispatch"]
    return 1e3 * sum(spans) / len(spans) if spans else None
