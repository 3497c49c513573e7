"""Faults planted in the program, to show that the comparison catches them.

``plant(name)`` patches the port in this process and returns a function
that takes the patch out again:

- ``unchanged``: the train step returns its state unchanged;
- ``half_batch``: the train step sees half of the batch, and its loss is
  the mean over that half;
- ``no_exchange``: the all-gather of the projected splats between the
  chips is left out, so each chip renders its own shard alone;
- ``altered``: every rendered image is altered by 1e-3 where the
  rasterizer produces it.

The benchmark's own runs never plant one: only ``calibrate.py`` and the
tests do.
"""
from __future__ import annotations

FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")


def _wrap_step(wrap):
    from repro_torch.launch import train as T

    orig = T.make_train_step

    def make(cfg, mesh=None):
        return wrap(orig(cfg, mesh))

    T.make_train_step = make
    return lambda: setattr(T, "make_train_step", orig)


def plant(name: str):
    if name == "unchanged":
        def wrap(step):
            def faulty(state, cams, gt):
                return state, step(state, cams, gt)[1]
            return faulty
        return _wrap_step(wrap)
    if name == "half_batch":
        def wrap(step):
            def faulty(state, cams, gt):
                h = gt.shape[0] // 2
                return step(state, type(cams)(*[x[:h] for x in cams]), gt[:h])
            return faulty
        return _wrap_step(wrap)
    if name == "no_exchange":
        from repro_torch.core import train as CT

        orig = CT.all_gather
        CT.all_gather = lambda x, axis, dim=0: x
        return lambda: setattr(CT, "all_gather", orig)
    if name == "altered":
        from repro_torch.kernels.tile_raster import ops

        orig = ops.rasterize_tiles

        def faulty(*a, **kw):
            img, tmap = orig(*a, **kw)
            return img + 1e-3, tmap

        ops.rasterize_tiles = faulty
        return lambda: setattr(ops, "rasterize_tiles", orig)
    raise ValueError(f"unknown fault {name!r}; the faults are {FAULTS}")
