"""One reader per per-layer metric, found by ``run.py`` by its file name.

Each module has ``read(ctx) -> float | None``: the metric from the traced
run (``ctx.prof``: a ``torch.profiler`` trace of ``ctx.steps`` steps over
``ctx.wall_ms`` on this chip; ``ctx.spans``: the trainer's own
``(name, t0_s, t1_s)`` spans over the traced window; ``ctx.window_step_ms``:
that window's wall time a step; ``ctx.step_work``: the step's least
(operations, bytes) on this chip; ``ctx.n_local``, ``ctx.sh_coeffs``). A
reader that finds nothing to read returns None, and the metric is left out
of the run's line.
"""
