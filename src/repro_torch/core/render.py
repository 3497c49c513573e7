"""Render pipeline: project -> sort -> tile-bin -> composite (PyTorch).

Tile binning keeps the fixed-capacity semantics of the JAX package: every
tile keeps the front-most K splats whose bounding circle overlaps it (the K
smallest depth-sorted indices), found with a memory-bounded running top-K
scan over chunks of splats. The lists are the K smallest overlapping
indices whatever the chunking, so the chunk size is only a memory knob: by
default it is sized so one chunk's (tiles x chunk) overlap test stays near
``OVERLAP_BUDGET`` elements, which on the card turns the thousands of scan
steps of a 4M-splat frame into a handful. ``idx``/``valid`` equal the JAX
package's entry for entry, including the padding entries.
"""
from __future__ import annotations

import torch

from repro_torch.core import gaussians as G
from repro_torch.core import projection as P
from repro_torch.kernels.tile_raster import ops as raster_ops

BIG_IDX = torch.iinfo(torch.int32).max
OVERLAP_BUDGET = 1 << 24  # (tiles x chunk) elements per scan step


def _chunk_for(t_count: int, chunk: int | None) -> int:
    if chunk is not None:
        return int(chunk)
    return max(OVERLAP_BUDGET // max(t_count, 1), 1024)


def build_tile_lists(
    packed_sorted: torch.Tensor,  # (N, 11) depth-sorted splats
    *,
    img_h: int,
    img_w: int,
    tile_h: int = 16,
    tile_w: int = 16,
    k_per_tile: int = 256,
    chunk: int | None = None,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile front-most-K overlapping splat lists.

    Overlap test: splat bounding circle (mean, radius) vs tile rectangle.
    Because input is depth-sorted, the K smallest overlapping indices are the
    K front-most splats — exactly what front-to-back compositing needs.

    ``row_offset`` shifts tile origins vertically: a strip render passes its
    strip's first image row.

    Returns (idx (T,K) int32 clamped to valid range, valid (T,K) bool).
    """
    dev = packed_sorted.device
    n = packed_sorted.shape[0]
    tiles_y = img_h // tile_h
    tiles_x = img_w // tile_w
    t_count = tiles_y * tiles_x

    tids = torch.arange(t_count, device=dev)
    tx0 = ((tids % tiles_x) * tile_w).to(torch.float32)[:, None]
    ty0 = ((tids // tiles_x) * tile_h + row_offset).to(torch.float32)[:, None]
    tx1 = tx0 + tile_w
    ty1 = ty0 + tile_h

    chunk = _chunk_for(t_count, chunk)
    best = torch.full((t_count, k_per_tile), BIG_IDX, dtype=torch.int32, device=dev)
    for sl in range(0, n, chunk):
        part = packed_sorted[sl : sl + chunk]
        cmx, cmy, crad = part[:, P.MX][None], part[:, P.MY][None], part[:, P.RAD][None]
        overlap = (
            (cmx + crad >= tx0)
            & (cmx - crad <= tx1)
            & (cmy + crad >= ty0)
            & (cmy - crad <= ty1)
            & (crad > 0)
        )  # (T, chunk)
        ids = torch.arange(sl, sl + part.shape[0], dtype=torch.int32, device=dev)[None]
        cand = torch.where(overlap, ids, torch.full_like(ids, BIG_IDX))
        best = torch.topk(torch.cat([best, cand], dim=1), k_per_tile, dim=1, largest=False, sorted=True).values
    valid = best != BIG_IDX
    idx = torch.where(valid, best, torch.zeros_like(best))
    return idx, valid


def build_tile_lists_hier(
    packed_sorted: torch.Tensor,
    *,
    img_h: int,
    img_w: int,
    tile_h: int = 16,
    tile_w: int = 16,
    k_per_tile: int = 256,
    block: int = 8,
    k_block_mult: int = 4,
    chunk: int | None = None,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level tile binning.

    Level 1 bins splats into coarse (block x block)-tile superblocks; level 2
    tests each tile only against its block's K1 = k_block_mult*K front
    candidates. A splat overlapping a tile always overlaps its block, so while
    no superblock holds more than K1 overlapping splats the result equals
    flat binning. The JAX package's per-block ``vmap`` is a batch dimension
    over blocks here.
    """
    dev = packed_sorted.device
    tiles_y = img_h // tile_h
    tiles_x = img_w // tile_w
    by = max(min(block, tiles_y), 1)
    bx = max(min(block, tiles_x), 1)
    if tiles_y % by or tiles_x % bx:
        raise ValueError(f"{tiles_y}x{tiles_x} tiles do not split into {by}x{bx} superblocks")
    k1 = k_per_tile * k_block_mult

    idx1, valid1 = build_tile_lists(
        packed_sorted,
        img_h=img_h,
        img_w=img_w,
        tile_h=tile_h * by,
        tile_w=tile_w * bx,
        k_per_tile=k1,
        chunk=chunk,
        row_offset=row_offset,
    )  # (Tb, K1) ascending (= front-to-back) within each block
    blocks_x = tiles_x // bx
    blocks_y = tiles_y // by
    n_blocks = idx1.shape[0]
    cand = packed_sorted[idx1.long()]  # (Tb, K1, 11)
    inf = torch.full_like(cand[..., P.MX], float("inf"))
    cand_mx = torch.where(valid1, cand[..., P.MX], inf)[:, None, :]
    cand_my = torch.where(valid1, cand[..., P.MY], inf)[:, None, :]
    cand_rad = torch.where(valid1, cand[..., P.RAD], torch.zeros_like(inf))[:, None, :]

    # tile rectangles of every block: (Tb, by*bx, 1)
    bid = torch.arange(n_blocks, device=dev)[:, None]
    t_local = torch.arange(by * bx, device=dev)[None, :]
    ty = (bid // blocks_x) * by + t_local // bx
    tx = (bid % blocks_x) * bx + t_local % bx
    x0 = (tx * tile_w).to(torch.float32)[..., None]
    y0 = (ty * tile_h + row_offset).to(torch.float32)[..., None]
    overlap = (
        (cand_mx + cand_rad >= x0)
        & (cand_mx - cand_rad <= x0 + tile_w)
        & (cand_my + cand_rad >= y0)
        & (cand_my - cand_rad <= y0 + tile_h)
        & (cand_rad > 0)
    )  # (Tb, tiles_in_block, K1)
    pos = torch.arange(k1, dtype=torch.int32, device=dev).expand_as(overlap)
    score = torch.where(overlap, pos, torch.full_like(pos, k1))
    sel = torch.topk(score, k_per_tile, dim=2, largest=False, sorted=True).values  # front-most K
    ok = sel < k1
    sel = torch.where(ok, sel, torch.zeros_like(sel))
    gidx = torch.gather(idx1[:, None, :].expand(-1, by * bx, -1), 2, sel.long())
    # reorder (block-major) -> row-major flat tile order
    tile_idx = (
        gidx.reshape(blocks_y, blocks_x, by, bx, k_per_tile)
        .permute(0, 2, 1, 3, 4)
        .reshape(tiles_y * tiles_x, k_per_tile)
    )
    tile_valid = (
        ok.reshape(blocks_y, blocks_x, by, bx, k_per_tile)
        .permute(0, 2, 1, 3, 4)
        .reshape(tiles_y * tiles_x, k_per_tile)
    )
    return tile_idx, tile_valid


def resolve_binning(binning: str, n_tiles: int) -> str:
    """"auto" -> "hier" at 256 tiles or more, else "flat"."""
    if binning == "auto":
        return "hier" if n_tiles >= 256 else "flat"
    if binning not in ("flat", "hier"):
        raise ValueError(f"unknown binning {binning!r}")
    return binning


def bin_tiles(
    packed_sorted: torch.Tensor,
    *,
    img_h: int,
    img_w: int,
    tile_h: int,
    tile_w: int,
    k_per_tile: int,
    binning: str = "auto",
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    tiles = (img_h // tile_h) * (img_w // tile_w)
    fn = build_tile_lists_hier if resolve_binning(binning, tiles) == "hier" else build_tile_lists
    return fn(
        packed_sorted, img_h=img_h, img_w=img_w, tile_h=tile_h, tile_w=tile_w,
        k_per_tile=k_per_tile, row_offset=row_offset,
    )


def bin_tile_row(
    packed_sorted: torch.Tensor,
    *,
    row: int,
    img_h: int,
    img_w: int,
    tile_h: int,
    tile_w: int,
    k_per_tile: int,
    binning: str = "auto",
    block: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The lists of ONE tile row, equal entry for entry to that row of the
    full (img_h, img_w) frame's lists, whatever the full frame's binning.

    Flat lists of a tile depend only on the tile's rectangle, so a flat
    frame's row is a one-row flat binning at ``row_offset``. Hierarchical
    lists also depend on the tile's superblock (its K1 front candidates), so
    a hier frame's row re-bins the band of tile rows that forms its row of
    superblocks, at the band's ``row_offset``, and keeps the row. Binning a
    strip flat against a hier frame, as the JAX package's strip renderer
    does, is equal only while no superblock overflows K1 candidates; at the
    paper's scale (millions of splats, 512 px) they do."""
    tiles_y, tiles_x = img_h // tile_h, img_w // tile_w
    if resolve_binning(binning, tiles_y * tiles_x) == "flat":
        return build_tile_lists(
            packed_sorted, img_h=tile_h, img_w=img_w, tile_h=tile_h, tile_w=tile_w,
            k_per_tile=k_per_tile, row_offset=row * tile_h,
        )
    by = max(min(block, tiles_y), 1)
    r0 = (row // by) * by
    idx, valid = build_tile_lists_hier(
        packed_sorted, img_h=by * tile_h, img_w=img_w, tile_h=tile_h, tile_w=tile_w,
        k_per_tile=k_per_tile, block=block, row_offset=r0 * tile_h,
    )
    keep = slice((row - r0) * tiles_x, (row - r0 + 1) * tiles_x)
    return idx[keep], valid[keep]


def render_packed(
    packed_sorted: torch.Tensor,
    *,
    img_h: int,
    img_w: int,
    tile_h: int = 16,
    tile_w: int = 16,
    k_per_tile: int = 256,
    bg=None,
    row_offset: int = 0,
    binning: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rasterize depth-sorted packed splats to an (img_h, img_w, 3) image."""
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=packed_sorted.device)
    idx, valid = bin_tiles(
        packed_sorted, img_h=img_h, img_w=img_w, tile_h=tile_h, tile_w=tile_w,
        k_per_tile=k_per_tile, binning=binning, row_offset=row_offset,
    )
    return raster_ops.rasterize_tiles(
        packed_sorted, idx, valid, img_h=img_h, img_w=img_w, tile_h=tile_h, tile_w=tile_w,
        bg=bg, row_offset=row_offset,
    )


def render(
    g: G.GaussianModel,
    cam: P.Camera,
    *,
    img_h: int,
    img_w: int,
    tile_h: int = 16,
    tile_w: int = 16,
    k_per_tile: int = 256,
    bg=None,
    binning: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """End-to-end single-device render of a GaussianModel from one camera."""
    packed = P.project(g, cam)
    packed_sorted, _ = P.sort_by_depth(packed)
    return render_packed(
        packed_sorted, img_h=img_h, img_w=img_w, tile_h=tile_h, tile_w=tile_w,
        k_per_tile=k_per_tile, bg=bg, binning=binning,
    )
