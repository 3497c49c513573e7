"""Eval-render factories of the train module (PyTorch, one device).

The serving stack renders through these: ``make_eval_render`` (one view),
``make_batched_eval_render`` (a batch of views, the serving hot path) and
``make_tile_row_render`` (one tile row of one view, the partial-render
primitive of the tile cache). Each returns a function of (params, camera)
that runs project -> depth sort -> bin -> composite on the device the
params live on: the plain PyTorch versions on the CPU, the hand-written
kernels on a CUDA device.

The JAX package runs these under ``shard_map`` over a (data, model) mesh,
with an ``all_gather`` of the projected splats over the model axis. On one
device that gather is the identity; sharded rendering comes with the port's
multi-rank slice. The train step itself comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.core import gaussians as G
from repro_torch.core import projection as P
from repro_torch.core import render as R
from repro_torch.core.config import GSConfig


class _DeviceBg:
    """The config's background color as a tensor, made once per device, so a
    render never pays a host->device copy (which synchronizes the stream)."""

    def __init__(self, bg):
        self._bg = tuple(float(c) for c in bg)
        self._on: dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = torch.tensor(self._bg, dtype=torch.float32, device=device)
        return t


def _project_sorted(params: G.GaussianModel, cam: P.Camera) -> torch.Tensor:
    packed = P.project(params, cam)
    pk_sorted, _ = P.sort_by_depth(packed)
    return pk_sorted


def _view(cams: P.Camera, i: int) -> P.Camera:
    return P.Camera(*[x[i] for x in cams])


def make_eval_render(cfg: GSConfig):
    """Eval render of one view: fn(params, cam) -> (image (H,W,3), T (H,W))."""
    bg = _DeviceBg(cfg.bg)

    def fn(params: G.GaussianModel, cam: P.Camera):
        pk_sorted = _project_sorted(params, cam)
        return R.render_packed(
            pk_sorted,
            img_h=cfg.img_h,
            img_w=cfg.img_w,
            tile_h=cfg.tile_h,
            tile_w=cfg.tile_w,
            k_per_tile=cfg.k_per_tile,
            bg=bg.on(pk_sorted.device),
            binning=cfg.binning,
        )

    return fn


def make_tile_row_render(cfg: GSConfig, *, row: int):
    """Eval render of ONE horizontal tile row of one view.

    Returned fn: (params, a single Camera) -> (cfg.tile_h, cfg.img_w, 3)
    image — the pixel rows ``[row*tile_h, (row+1)*tile_h)`` of the full-frame
    render, **bit-identical** to the same rows of
    :func:`make_batched_eval_render`'s output. The project -> depth-sort
    prefix is the full-frame computation verbatim; the row's tile lists are
    the full frame's lists for that row (``render.bin_tile_row``, which
    reproduces the full frame's superblock geometry when it bins
    hierarchically), and the compositor sees the same per-tile inputs and
    pixel coordinates through ``row_offset``. The serving tile cache rests
    on this: a cache that already holds most of a frame's tiles re-renders
    only the missing rows.
    """
    bg = _DeviceBg(cfg.bg)
    row = int(row)
    row_offset = row * cfg.tile_h

    def fn(params: G.GaussianModel, cam: P.Camera) -> torch.Tensor:
        pk_sorted = _project_sorted(params, cam)
        idx, valid = R.bin_tile_row(
            pk_sorted,
            row=row,
            img_h=cfg.img_h,
            img_w=cfg.img_w,
            tile_h=cfg.tile_h,
            tile_w=cfg.tile_w,
            k_per_tile=cfg.k_per_tile,
            binning=cfg.binning,
        )
        img, _ = R.raster_ops.rasterize_tiles(
            pk_sorted, idx, valid,
            img_h=cfg.tile_h, img_w=cfg.img_w, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            bg=bg.on(pk_sorted.device), row_offset=row_offset,
        )
        return img

    return fn


def make_batched_eval_render(cfg: GSConfig):
    """Eval render of a BATCH of views (the serving hot path).

    Returned fn: (params, cams: Camera with a leading batch dim B) ->
    (B, H, W, 3) images on the params' device. The views run one after the
    other (the JAX package's "map" mode): one view's working set at a time.
    On a CUDA device every launch is asynchronous, so the call returns while
    the batch still renders; the caller decides when to wait.
    """
    one = make_eval_render(cfg)

    def fn(params: G.GaussianModel, cams: P.Camera) -> torch.Tensor:
        b = int(cams.fx.shape[0])
        return torch.stack([one(params, _view(cams, i))[0] for i in range(b)])

    return fn
