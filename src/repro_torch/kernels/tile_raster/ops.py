"""Wrapper of the tile rasterizer: gather, dispatch by device, image layout.

``rasterize_tiles`` takes depth-sorted packed splats and per-tile index
lists. It gathers each tile's K splats (``packed[tile_idx]``), lays them out
as (T, 11, K) slabs, composites them, reshapes the (T, 3, P) output to an
(H, W, 3) image and blends the background, as the JAX package's wrapper
does. It is differentiable with respect to ``packed``: the compositor is a
``torch.autograd.Function`` (the JAX custom VJP), and the sum of each
splat's gradient across the tiles that list it is autograd of the gather.

On a CUDA device the Function runs ``tile_raster.cu``: ``composite`` forward
and ``composite_bwd`` backward. The forward also writes each pixel's
``n_contrib`` (one past its last composited slot); when autograd will need
the backward, the Function saves it with ``t_final``, and the backward
kernel starts from both instead of re-walking the forward. On the CPU it runs the plain
versions, ``ref.composite_ref`` and ``ref.composite_bwd_ref``. There is no
fallback: a CUDA tensor either runs the kernel or raises. Both directions
report their work to an active operation counter (``kernels/cost.py``
``region``) on both devices: the bounds' formulas, with the per-pixel stop
index that ``ref.composited_counts`` gives on the same inputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import cost as _cost
from repro_torch.kernels.tile_raster import ref as _ref
from repro_torch.obs import steptrace

MAX_PIXELS = 1024  # one CTA per tile: two pixels a thread forward, one backward

launch_count = _lib.LaunchCount()      # forward launches
bwd_launch_count = _lib.LaunchCount()  # backward launches


def _check(name: str, x: torch.Tensor, shape: tuple, dev: torch.device, dtype=torch.float32) -> None:
    if x.dtype != dtype or not x.is_contiguous() or x.device != dev or tuple(x.shape) != shape:
        raise ValueError(f"{name}: want contiguous {dtype} {shape} on {dev}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _geometry(splats_t: torch.Tensor, tile_h: int, tile_w: int) -> tuple[int, int, int]:
    dev = splats_t.device
    if dev.type != "cuda":
        raise ValueError(f"tile_raster kernel needs CUDA tensors, got {dev}")
    if splats_t.dim() != 3 or splats_t.shape[1] != 11:
        raise ValueError(f"splats_t must be (T, 11, K), got {tuple(splats_t.shape)}")
    t_count, _, k = splats_t.shape
    p = tile_h * tile_w
    if not 0 < p <= MAX_PIXELS:
        raise ValueError(f"tile of {tile_h}x{tile_w} pixels: the kernel takes 1..{MAX_PIXELS} pixels per tile")
    return t_count, k, p


def _fwd_cost(splats_t: torch.Tensor, valid: torch.Tensor, kw: dict) -> tuple[int, int]:
    """The forward's (operations, bytes) on these inputs (``chip_smoke.py``'s bound)."""
    composited = _ref.composited_counts(splats_t, valid, **kw)
    return _cost.raster_fwd_cost(valid, composited, kw["tile_h"] * kw["tile_w"])


def _bwd_cost(splats_t: torch.Tensor, valid: torch.Tensor, kw: dict) -> tuple[int, int]:
    """The backward's (operations, bytes) on these inputs (``chip_smoke.py``'s bound)."""
    hits = int(_ref.composited_counts(splats_t, valid, **kw, live_only=True).sum())
    return _cost.raster_bwd_cost(valid, hits, kw["tile_h"] * kw["tile_w"])


def composite(
    splats_t: torch.Tensor,  # (T, 11, K) float32
    valid: torch.Tensor,     # (T, K) float32, > 0.5 = valid
    *,
    tiles_x: int,
    tile_h: int,
    tile_w: int,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run ``tile_raster.cu``'s forward: returns raw rgb (T, 3, P), t_final
    (T, P) and n_contrib (T, P) int32, one past each pixel's last composited
    slot (the backward's residual)."""
    t_count, k, p = _geometry(splats_t, tile_h, tile_w)
    dev = splats_t.device
    _check("splats_t", splats_t, (t_count, 11, k), dev)
    _check("valid", valid, (t_count, k), dev)
    with _cost.region("tile_raster_fwd") as r:
        out = torch.empty((t_count, 3, p), dtype=torch.float32, device=dev)
        tfin = torch.empty((t_count, p), dtype=torch.float32, device=dev)
        n_contrib = torch.empty((t_count, p), dtype=torch.int32, device=dev)
        if t_count > 0:
            lib = _lib.library()
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = lib.tile_raster_fwd(
                    splats_t.data_ptr(), valid.data_ptr(), out.data_ptr(), tfin.data_ptr(),
                    n_contrib.data_ptr(), t_count, k, tiles_x, tile_h, tile_w, int(row_offset), stream,
                )
            _lib.check("tile_raster_fwd", err)
            launch_count.n += 1
        if r:
            kw = dict(tiles_x=tiles_x, tile_h=tile_h, tile_w=tile_w, row_offset=row_offset)
            r.report(*_fwd_cost(splats_t, valid, kw), out, tfin, n_contrib)
    return out, tfin, n_contrib


def composite_bwd(
    splats_t: torch.Tensor,   # (T, 11, K) float32
    valid: torch.Tensor,      # (T, K) float32
    gout: torch.Tensor,       # (T, 3, P) float32, d(raw rgb)
    gtfin: torch.Tensor,      # (T, P) float32, d(t_final)
    t_final: torch.Tensor,    # (T, P) float32, the forward's
    n_contrib: torch.Tensor,  # (T, P) int32, the forward's
    *,
    tiles_x: int,
    tile_h: int,
    tile_w: int,
    row_offset: int = 0,
) -> torch.Tensor:
    """Run ``tile_raster.cu``'s backward from the forward's residuals:
    returns d(splats_t) (T, 11, K)."""
    t_count, k, p = _geometry(splats_t, tile_h, tile_w)
    dev = splats_t.device
    for name, x, shape in (("splats_t", splats_t, (t_count, 11, k)), ("valid", valid, (t_count, k)),
                           ("gout", gout, (t_count, 3, p)), ("gtfin", gtfin, (t_count, p)),
                           ("t_final", t_final, (t_count, p))):
        _check(name, x, shape, dev)
    _check("n_contrib", n_contrib, (t_count, p), dev, torch.int32)
    with _cost.region("tile_raster_bwd") as r:
        dsplats = torch.empty((t_count, 11, k), dtype=torch.float32, device=dev)
        if t_count > 0:
            lib = _lib.library()
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = lib.tile_raster_bwd(
                    splats_t.data_ptr(), valid.data_ptr(), gout.data_ptr(), gtfin.data_ptr(), t_final.data_ptr(),
                    n_contrib.data_ptr(), dsplats.data_ptr(), t_count, k, tiles_x, tile_h, tile_w, int(row_offset),
                    stream,
                )
            _lib.check("tile_raster_bwd", err)
            bwd_launch_count.n += 1
        if r:
            kw = dict(tiles_x=tiles_x, tile_h=tile_h, tile_w=tile_w, row_offset=row_offset)
            r.report(*_bwd_cost(splats_t, valid, kw), dsplats)
    return dsplats


def occupancy(tile_h: int, tile_w: int) -> tuple[int, int, int, int]:
    """(forward CTAs per SM, backward CTAs per SM, forward threads per CTA,
    backward threads per CTA) at this tile size, from CUDA's occupancy
    calculator."""
    out = (ctypes.c_int * 4)()
    _lib.check("tile_raster_occupancy", _lib.library().tile_raster_occupancy(tile_h, tile_w, out))
    return tuple(out)


class Composite(torch.autograd.Function):
    """The tile compositor with its hand-written backward (the JAX package's
    ``make_composite`` custom VJP). Differentiable in ``splats_t`` only:
    ``valid`` gets no gradient."""

    @staticmethod
    def forward(ctx, splats_t, valid, tiles_x: int, tile_h: int, tile_w: int, row_offset: int):
        kw = dict(tiles_x=tiles_x, tile_h=tile_h, tile_w=tile_w, row_offset=row_offset)
        ctx.kw = kw
        ctx.trace = steptrace.pin()  # the backward's span joins this step's tree
        if splats_t.device.type != "cuda":
            ctx.save_for_backward(splats_t, valid)
            with _cost.region("tile_raster_fwd") as r:
                out, tfin = _ref.composite_ref(splats_t, valid, **kw)
                if r:
                    r.report(*_fwd_cost(splats_t, valid, kw), out, tfin)
            return out, tfin
        out, tfin, n_contrib = composite(splats_t, valid, **kw)
        if ctx.needs_input_grad[0]:  # serving keeps no residual
            ctx.save_for_backward(splats_t, valid, tfin, n_contrib)
        return out, tfin

    @staticmethod
    def backward(ctx, gout, gtfin):
        # an output that got no gradient arrives as zeros (autograd
        # materializes them by default)
        tc, view = ctx.trace
        with steptrace.record(tc, "raster_bwd", view):
            splats_t, valid, *res = ctx.saved_tensors
            gout, gtfin = gout.contiguous(), gtfin.contiguous()
            if splats_t.device.type == "cuda":
                d = composite_bwd(splats_t, valid, gout, gtfin, *res, **ctx.kw)
            else:
                with _cost.region("tile_raster_bwd") as r:
                    d = _ref.composite_bwd_ref(splats_t, valid, gout, gtfin, **ctx.kw)
                    if r:
                        r.report(*_bwd_cost(splats_t, valid, ctx.kw), d)
        return d, None, None, None, None, None


def rasterize_tiles(
    packed: torch.Tensor,      # (N, 11) depth-sorted packed splats
    tile_idx: torch.Tensor,    # (T, K) int
    tile_valid: torch.Tensor,  # (T, K) bool
    *,
    img_h: int,
    img_w: int,
    tile_h: int,
    tile_w: int,
    bg,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rasterize to ((H,W,3) image, (H,W) transmittance)."""
    tiles_y = img_h // tile_h
    tiles_x = img_w // tile_w
    # autograd of this gather sums each splat's per-tile gradients
    tile_splats = packed[tile_idx.long()]                    # (T,K,11)
    splats_t = tile_splats.transpose(1, 2).contiguous()      # (T,11,K)
    raw, tfin = Composite.apply(
        splats_t.to(torch.float32), tile_valid.to(torch.float32).contiguous(),
        tiles_x, tile_h, tile_w, int(row_offset),
    )
    # (T,3,P) -> (H,W,3)
    img = (
        raw.reshape(tiles_y, tiles_x, 3, tile_h, tile_w)
        .permute(0, 3, 1, 4, 2)
        .reshape(img_h, img_w, 3)
    )
    tmap = tfin.reshape(tiles_y, tiles_x, tile_h, tile_w).permute(0, 2, 1, 3).reshape(img_h, img_w)
    # callers on the hot path pass bg already on the device: a host->device
    # copy here would synchronize the stream once per frame
    bg = torch.as_tensor(bg, dtype=torch.float32).to(packed.device)
    img = img + tmap[..., None] * bg
    return img, tmap
