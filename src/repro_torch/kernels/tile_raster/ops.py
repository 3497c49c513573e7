"""Wrapper of the tile rasterizer: gather, dispatch by device, image layout.

``rasterize_tiles`` takes depth-sorted packed splats and per-tile index
lists. On the CPU it runs the plain version (``ref.rasterize_tiles_ref``).
On a CUDA device it gathers each tile's K splats (``packed[tile_idx]``),
lays them out as (T, 11, K) slabs, runs ``tile_raster.cu`` (``composite``),
reshapes its (T, 3, P) output to an (H, W, 3) image and blends the
background, as the JAX package's wrapper does. There is no fallback: a CUDA
tensor either runs the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.tile_raster import ref as _ref

MAX_PIXELS = 1024  # one thread per pixel of a tile, one CTA per tile

launch_count = _lib.LaunchCount()


def composite(
    splats_t: torch.Tensor,  # (T, 11, K) float32
    valid: torch.Tensor,     # (T, K) float32, > 0.5 = valid
    *,
    tiles_x: int,
    tile_h: int,
    tile_w: int,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``tile_raster.cu``: returns raw rgb (T, 3, P) and t_final (T, P)."""
    dev = splats_t.device
    if dev.type != "cuda":
        raise ValueError(f"tile_raster kernel needs CUDA tensors, got {dev}")
    if splats_t.dim() != 3 or splats_t.shape[1] != 11:
        raise ValueError(f"splats_t must be (T, 11, K), got {tuple(splats_t.shape)}")
    t_count, _, k = splats_t.shape
    p = tile_h * tile_w
    if not 0 < p <= MAX_PIXELS:
        raise ValueError(f"tile of {tile_h}x{tile_w} pixels: the kernel takes 1..{MAX_PIXELS} pixels per tile")
    for name, x, shape in (("splats_t", splats_t, (t_count, 11, k)), ("valid", valid, (t_count, k))):
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != dev or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want contiguous float32 {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    out = torch.empty((t_count, 3, p), dtype=torch.float32, device=dev)
    tfin = torch.empty((t_count, p), dtype=torch.float32, device=dev)
    if t_count == 0:
        return out, tfin
    lib = _lib.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tile_raster_fwd(
            splats_t.data_ptr(), valid.data_ptr(), out.data_ptr(), tfin.data_ptr(),
            t_count, k, tiles_x, tile_h, tile_w, int(row_offset), stream,
        )
    _lib.check("tile_raster_fwd", err)
    launch_count.n += 1
    return out, tfin


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
    if packed.device.type != "cuda":
        return _ref.rasterize_tiles_ref(
            packed, tile_idx, tile_valid, img_h, img_w, tile_h, tile_w, bg, row_offset
        )
    tiles_y = img_h // tile_h
    tiles_x = img_w // tile_w
    tile_splats = packed[tile_idx.long()]                    # (T,K,11)
    splats_t = tile_splats.transpose(1, 2).contiguous()      # (T,11,K)
    raw, tfin = composite(
        splats_t.to(torch.float32), tile_valid.to(torch.float32).contiguous(),
        tiles_x=tiles_x, tile_h=tile_h, tile_w=tile_w, row_offset=row_offset,
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
