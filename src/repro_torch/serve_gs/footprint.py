"""World-space change → screen-tile footprint mapping.

The serving stack caches rendered tiles per (timestep, level, pose). When a
live in-situ update rewrites a subset of Gaussian slots, only the tiles whose
screen-space footprint intersects those Gaussians' projected bounds — under
the *old or new* parameters — can change. This module computes that mapping
on the host, per cached pose, so `RenderServer.add_timestep(..., changed=...)`
can invalidate exactly the dirty tile rows itself instead of requiring
callers to hand-compute `dirty_rows`.

Conservatism contract: the bounds come from
:func:`project_bounds_np` (``core/projection.py``), a padded float64 mirror of
the jitted projection, and the row test mirrors the *inclusive* tile binning
in ``core.render.build_tile_lists``. A tile row not reported dirty is
guaranteed to composite bitwise identically; a reported row merely may have
changed. We gate on radius > 0 only — not opacity — because zero-opacity
splats still occupy top-K slots in the binned tile lists and can displace
other entries.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import gaussians as G
from repro_torch.core.projection import Camera, project_bounds_np


def changed_indices(old: G.GaussianModel, new: G.GaussianModel, *, atol: float = 0.0) -> np.ndarray:
    """Row indices where any parameter leaf differs between two models.

    ``atol`` tolerates quantization noise (e.g. int16 checkpoint deltas);
    0.0 means exact inequality. Raises ``ValueError`` on shape mismatch —
    a capacity change invalidates everything and has no per-row diff.
    """
    dirty = None
    for name in old._fields:
        a = np.asarray(getattr(old, name))
        b = np.asarray(getattr(new, name))
        if a.shape != b.shape:
            raise ValueError(
                f"changed_indices: field {name!r} shape {a.shape} != {b.shape}; "
                "models with different capacity have no per-slot diff"
            )
        d = np.abs(a.astype(np.float64) - b.astype(np.float64)) > atol
        d = d.reshape(d.shape[0], -1).any(axis=1)
        dirty = d if dirty is None else (dirty | d)
    return np.nonzero(dirty)[0]


def dirty_rows(
    params_list,
    idx: np.ndarray,
    cam: Camera,
    *,
    img_h: int,
    img_w: int,
    tile_h: int,
    pad_px: float = 1.0,
) -> frozenset[int]:
    """Tile rows whose composite can differ when Gaussians ``idx`` change.

    ``params_list`` holds the model states whose footprints matter — for an
    update that is both old and new parameters (a tile is dirty if the
    changed Gaussians touched it *before or after* the move). Rows are
    derived from the inclusive overlap test in ``build_tile_lists``:
    a splat at (my, rad) bins into row r iff ``my + rad >= r*tile_h`` and
    ``my - rad <= r*tile_h + tile_h``, i.e. rows
    ``ceil((my-rad)/tile_h) - 1 .. floor((my+rad)/tile_h)``.
    """
    tiles_y = (img_h + tile_h - 1) // tile_h
    all_rows = frozenset(range(tiles_y))
    idx = np.asarray(idx).reshape(-1)
    if idx.size == 0:
        return frozenset()
    out: set[int] = set()
    for params in params_list:
        mx, my, rad = project_bounds_np(params, cam, idx, pad_px=pad_px)
        live = (rad > 0) & (mx + rad >= 0) & (mx - rad <= img_w)
        if not live.any():
            continue
        my, rad = my[live], rad[live]
        lo = np.ceil((my - rad) / tile_h).astype(np.int64) - 1
        hi = np.floor((my + rad) / tile_h).astype(np.int64)
        on = (hi >= 0) & (lo <= tiles_y - 1)
        for a, b in zip(np.clip(lo[on], 0, tiles_y - 1), np.clip(hi[on], 0, tiles_y - 1)):
            out.update(range(int(a), int(b) + 1))
            if len(out) == tiles_y:
                return all_rows
    return frozenset(out)


def dirty_row_map(
    old: G.GaussianModel,
    new: G.GaussianModel,
    idx: np.ndarray,
    poses: dict,
    *,
    img_h: int,
    img_w: int,
    tile_h: int,
    pad_px: float = 1.0,
) -> dict:
    """Per-pose dirty rows for an old→new update of Gaussians ``idx``.

    ``poses`` maps a pose signature (the quantized-camera tuple the cache
    keys on) to its ``Camera``; the result maps each signature to the
    frozenset of dirty tile rows under that pose.
    """
    return {
        sig: dirty_rows(
            (old, new), idx, cam, img_h=img_h, img_w=img_w, tile_h=tile_h, pad_px=pad_px
        )
        for sig, cam in poses.items()
    }
