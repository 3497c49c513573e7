"""Wrapper of the tile rasterizer: gather, dispatch by device, image layout.

``rasterize_tiles`` takes packed splats and per-tile index lists into their
depth order. It gathers each tile's K splats into a (T, 11, K) slab
(``GatherSlab``), composites the slabs, reshapes the (T, 3, P) output to an
(H, W, 3) image and blends the background, as the JAX package's wrapper
does. It is differentiable with respect to ``packed``: the compositor is a
``torch.autograd.Function`` (the JAX custom VJP), and so is the gather,
whose backward sums each splat's gradient across the tiles that list it.

On a CUDA device the compositor runs ``tile_raster.cu``: ``composite``
forward and ``composite_bwd`` backward. The forward also writes each pixel's
``n_contrib`` (one past its last composited slot); when autograd will need
the backward, the Function saves it with ``t_final``, and the backward
kernel starts from both instead of re-walking the forward. The gather runs
``slab_gather.cu``: ``gather_slab`` forward, straight from the unsorted
splats through ``order`` where the caller passes it, and ``gather_slab_bwd``
backward, a deterministic transpose over the valid slots only. On the CPU
both run their plain versions (``ref.py``). There is no fallback: a CUDA
tensor either runs the kernel or raises. Each direction of ``Composite``
and ``GatherSlab`` opens one operation-counter region (``kernels/cost.py``
``region``) around its choice of device and reports from it on both: the
bounds' formulas, with the per-pixel stop index that
``ref.composited_counts`` gives on the same inputs. The four launchers
only check, allocate and launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import cost as _cost
from repro_torch.kernels.tile_raster import ref as _ref
from repro_torch.obs import steptrace

MAX_PIXELS = 1024  # one CTA per tile: two pixels a thread forward, one backward

launch_count = _lib.launches("tile_raster_fwd")
bwd_launch_count = _lib.launches("tile_raster_bwd")
slab_launch_count = _lib.launches("slab_gather_fwd")  # input gathers
slab_bwd_launch_count = _lib.launches("slab_bwd")  # input gather transposes (one call: keys, sort, sums)


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
    _lib.check_tensor("splats_t", splats_t, (t_count, 11, k), dev)
    _lib.check_tensor("valid", valid, (t_count, k), dev)
    out = torch.empty((t_count, 3, p), dtype=torch.float32, device=dev)
    tfin = torch.empty((t_count, p), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((t_count, p), dtype=torch.int32, device=dev)
    if t_count > 0:
        _lib.call("tile_raster_fwd", dev, splats_t.data_ptr(), valid.data_ptr(), out.data_ptr(), tfin.data_ptr(),
                  n_contrib.data_ptr(), t_count, k, tiles_x, tile_h, tile_w, int(row_offset))
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
        _lib.check_tensor(name, x, shape, dev)
    _lib.check_tensor("n_contrib", n_contrib, (t_count, p), dev, torch.int32)
    dsplats = torch.empty((t_count, 11, k), dtype=torch.float32, device=dev)
    if t_count > 0:
        _lib.call("tile_raster_bwd", dev, splats_t.data_ptr(), valid.data_ptr(), gout.data_ptr(), gtfin.data_ptr(),
                  t_final.data_ptr(), n_contrib.data_ptr(), dsplats.data_ptr(), t_count, k, tiles_x, tile_h, tile_w,
                  int(row_offset))
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
        with _cost.region("tile_raster_fwd") as r:
            if splats_t.device.type == "cuda":
                out, tfin, n_contrib = composite(splats_t, valid, **kw)
                res = (tfin, n_contrib)  # the CUDA backward starts from both
            else:
                out, tfin = _ref.composite_ref(splats_t, valid, **kw)
                res = ()
            if r:
                r.report(*_fwd_cost(splats_t, valid, kw), out, tfin, *res)
        if ctx.needs_input_grad[0]:  # serving keeps no residual
            ctx.save_for_backward(splats_t, valid, *res)
        return out, tfin

    @staticmethod
    def backward(ctx, gout, gtfin):
        # an output that got no gradient arrives as zeros (autograd
        # materializes them by default)
        tc, view = ctx.trace
        with steptrace.record(tc, "raster_bwd", view):
            splats_t, valid, *res = ctx.saved_tensors
            gout, gtfin = gout.contiguous(), gtfin.contiguous()
            with _cost.region("tile_raster_bwd") as r:
                if splats_t.device.type == "cuda":
                    d = composite_bwd(splats_t, valid, gout, gtfin, *res, **ctx.kw)
                else:
                    d = _ref.composite_bwd_ref(splats_t, valid, gout, gtfin, **ctx.kw)
                if r:
                    r.report(*_bwd_cost(splats_t, valid, ctx.kw), d)
        return d, None, None, None, None, None


def _check_lists(dev: torch.device, n: int, tile_idx: torch.Tensor, order) -> tuple[int, int]:
    """(T, K) of the lists, after the checks ``slab_gather.cu`` relies on."""
    if dev.type != "cuda":
        raise ValueError(f"slab_gather kernel needs CUDA tensors, got {dev}")
    if tile_idx.dim() != 2:
        raise ValueError(f"tile_idx must be (T, K), got {tuple(tile_idx.shape)}")
    t_count, k = tile_idx.shape
    _lib.check_tensor("tile_idx", tile_idx, (t_count, k), dev, torch.int32)
    if order is not None:
        _lib.check_tensor("order", order, (n,), dev, torch.int64)
    if t_count * k * _cost.RASTER_FIELDS_READ >= 2**31 or n >= 2**31 - 1:
        raise ValueError(f"{t_count} x {k} slots over {n} rows: the kernel indexes slots and rows with 32 bits")
    return t_count, k


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def gather_slab(packed: torch.Tensor, tile_idx: torch.Tensor, order: torch.Tensor | None = None) -> torch.Tensor:
    """Run ``slab_gather.cu``'s forward: the (T, 11, K) slab whose slot (t, k)
    holds row ``order[tile_idx[t, k]]`` of ``packed`` (N, 11) float32, or
    row ``tile_idx[t, k]`` without ``order``; ``tile_idx`` (T, K) int32,
    ``order`` (N,) int64."""
    dev, n = packed.device, packed.shape[0]
    t_count, k = _check_lists(dev, n, tile_idx, order)
    _lib.check_tensor("packed", packed, (n, 11), dev)
    slab = torch.empty((t_count, 11, k), dtype=torch.float32, device=dev)
    if t_count * k > 0:
        _lib.call("slab_gather_fwd", dev, packed.data_ptr(), _ptr(order), tile_idx.data_ptr(), slab.data_ptr(),
                  t_count, k)
    return slab


def _report_slab_gather(r, tile_idx: torch.Tensor, order, slab: torch.Tensor) -> None:
    """The gather's work (counts the distinct rows on the device: only inside
    an active region)."""
    t_count, k = tile_idx.shape
    rows = int(torch.unique(tile_idx).numel())
    r.report(*_cost.slab_gather_cost(t_count, k, rows, order is not None), slab)


def _report_slab_bwd(r, valid: torch.Tensor, n: int, ordered: bool, dpacked: torch.Tensor) -> None:
    """The transpose's work and the slots it summed, against all T*K (reads
    the valid count from the device: only inside an active region)."""
    n_valid = int(valid.sum())
    r.report(*_cost.slab_bwd_cost(n_valid, valid.numel(), n, ordered), dpacked, scattered=n_valid,
             slots=valid.numel())


def gather_slab_bwd(dslab: torch.Tensor, valid: torch.Tensor, tile_idx: torch.Tensor, order: torch.Tensor | None,
                    n: int) -> torch.Tensor:
    """Run ``slab_gather.cu``'s backward: d(packed) (n, 11) from d(slab)
    (T, 11, K), each row the sum of the valid slots that list it (through
    ``order`` where given), in ascending slot order; ``valid`` (T, K) bool.
    Deterministic, no atomics, no host synchronisation; the padding slots
    are never read past their valid flag."""
    dev = dslab.device
    t_count, k = _check_lists(dev, n, tile_idx, order)
    _lib.check_tensor("dslab", dslab, (t_count, 11, k), dev)
    _lib.check_tensor("valid", valid, (t_count, k), dev, torch.bool)
    dpacked = torch.zeros((n, 11), dtype=torch.float32, device=dev)
    if t_count * k > 0:
        nbytes = (ctypes.c_longlong * 1)()
        _lib.check("slab_bwd_scratch_bytes", _lib.library().slab_bwd_scratch_bytes(t_count * k, n, nbytes))
        scratch = torch.empty((nbytes[0],), dtype=torch.uint8, device=dev)
        _lib.call("slab_bwd", dev, dslab.data_ptr(), valid.data_ptr(), tile_idx.data_ptr(), _ptr(order),
                  dpacked.data_ptr(), scratch.data_ptr(), nbytes[0], t_count, k, n)
    return dpacked


class GatherSlab(torch.autograd.Function):
    """The rasterizer's input gather: (T, 11, K) slabs of the splats each
    tile lists, from ``packed`` through ``order`` where given. Differentiable
    in ``packed`` only; its backward sums the valid slots alone (the
    compositor's gradient is exactly 0 in every padding slot)."""

    @staticmethod
    def forward(ctx, packed, tile_idx, valid, order):
        ctx.trace = steptrace.pin()  # the backward's span joins this step's tree
        ctx.n = packed.shape[0]
        if ctx.needs_input_grad[0]:  # serving keeps no residual
            ctx.save_for_backward(tile_idx, valid, order)
        with _cost.region("slab_gather") as r:
            if packed.device.type == "cuda":
                slab = gather_slab(packed, tile_idx, order)
            else:
                slab = _ref.gather_slab_ref(packed, tile_idx, order)
            if r:
                _report_slab_gather(r, tile_idx, order, slab)
        return slab

    @staticmethod
    def backward(ctx, dslab):
        tc, view = ctx.trace
        with steptrace.record(tc, "slab_bwd", view):
            tile_idx, valid, order = ctx.saved_tensors
            dslab = dslab.contiguous()
            with _cost.region("slab_bwd") as r:
                if dslab.device.type == "cuda":
                    d = gather_slab_bwd(dslab, valid, tile_idx, order, ctx.n)
                else:
                    d = _ref.gather_slab_bwd_ref(dslab, tile_idx, order, ctx.n)
                if r:
                    _report_slab_bwd(r, valid, ctx.n, order is not None, d)
        return d, None, None, None


def rasterize_tiles(
    packed: torch.Tensor,      # (N, 11) packed splats, depth-sorted unless ``order`` is given
    tile_idx: torch.Tensor,    # (T, K) int
    tile_valid: torch.Tensor,  # (T, K) bool
    *,
    img_h: int,
    img_w: int,
    tile_h: int,
    tile_w: int,
    bg,
    row_offset: int = 0,
    order: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rasterize to ((H,W,3) image, (H,W) transmittance).

    ``tile_idx`` indexes the depth-sorted splats: ``packed`` itself, or,
    with ``order`` (the depth sort's permutation, ``sort_by_depth``'s
    second result), ``packed[order]``; the gradient then reaches the
    unsorted ``packed`` with no permutation node in between."""
    tiles_y = img_h // tile_h
    tiles_x = img_w // tile_w
    splats_t = GatherSlab.apply(packed, tile_idx.to(torch.int32).contiguous(),
                                tile_valid.to(torch.bool).contiguous(), order)  # (T,11,K)
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
