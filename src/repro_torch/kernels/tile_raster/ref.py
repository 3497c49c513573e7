"""Plain PyTorch version of the tile rasterizer (forward and backward).

The canonical compositing math, as in the JAX package's oracle: alpha clamp
at 0.99, splats with alpha < 1/255 skipped, and the CUDA 3D-GS stop rule (a
splat is composited only while the transmittance after it stays >= 1e-4).
``tile_raster.cu`` computes the same function per pixel with a running
product; this version takes the cumulative product over the K axis at once.

``composite_bwd_ref`` is the compositor's vector-Jacobian product on the
kernel's layout, written out as the JAX package's Pallas ``_bwd_kernel``
writes it (the reverse exclusive sum ``B``, then d(alpha), then d(power)),
with that kernel's strict gradient masks: none through the alpha clamp
(``alpha_raw < 0.99``) nor through ``min(power, 0)`` (``power < 0``).
Autograd of ``composite_ref`` agrees with it except exactly at those ties,
where ``torch.clamp`` passes the gradient.

``gather_slab_ref`` is the input gather, (T, 11, K) slabs of the splats each
tile lists, and ``gather_slab_bwd_ref`` its transpose: autograd of the same
gathers (PyTorch's ``index_put`` with ``accumulate=True``), the oracle of
``slab_gather.cu``.

Tiles are composited one tile row at a time: a strip render (one tile row
with ``row_offset``) then runs the very same tensor ops, at the very same
shapes, as the matching row of a full frame. That is what keeps the CPU
strips bitwise equal to full-frame rows: PyTorch's CPU kernels may round a
transcendental differently in the vector body and the scalar tail of a
loop, and where the tail falls depends on the tensor's size.
"""
from __future__ import annotations

import torch

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4

# packed splat fields (core/projection.py's MX..RAD order)
_MX, _MY, _CA, _CB, _CC, _OP, _CR, _CB_, _RAD = 0, 1, 2, 3, 4, 5, 6, 8, 10


def _alpha_and_trans(splats, valid, pix_x, pix_y) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked alpha (T,K,P) and the transmittance after each splat (T,K,P)."""
    mx = splats[:, :, _MX, None]
    my = splats[:, :, _MY, None]
    ca = splats[:, :, _CA, None]
    cb = splats[:, :, _CB, None]
    cc = splats[:, :, _CC, None]
    op = splats[:, :, _OP, None]

    dx = pix_x[:, None, :] - mx  # (T,K,P)
    dy = pix_y[:, None, :] - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = op * torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.clamp(alpha, max=ALPHA_MAX)
    live = valid[:, :, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    return alpha, torch.cumprod(1.0 - alpha, dim=1)               # T after splat k


def compose_tiles(
    splats: torch.Tensor,  # (T, K, 11) packed splats, front-to-back per tile
    valid: torch.Tensor,   # (T, K) bool
    pix_x: torch.Tensor,   # (T, P) pixel center x coords
    pix_y: torch.Tensor,   # (T, P) pixel center y coords
) -> tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back alpha compositing of K splats over P pixels, per tile.

    Returns (raw rgb (T, P, 3) without background, transmittance (T, P)).
    """
    alpha, t_incl = _alpha_and_trans(splats, valid, pix_x, pix_y)
    rgb = splats[:, :, _CR : _CB_ + 1]  # (T,K,3)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
    # CUDA rasterizer stop rule: splat k only composited if T would stay >= eps
    alive = t_incl >= T_EPS
    w = torch.where(alive, alpha * t_excl, torch.zeros_like(alpha))  # (T,K,P)
    # transmittance after the last composited splat (1.0 if none composited;
    # t_incl is non-increasing so the min over alive entries is the last one)
    t_final = torch.where(alive, t_incl, torch.ones_like(t_incl)).amin(dim=1)
    out = torch.bmm(w.transpose(1, 2), rgb)                         # (T,P,3)
    return out, t_final


def compose_tile(tile_splats, valid, pix_x, pix_y, bg) -> tuple[torch.Tensor, torch.Tensor]:
    """One tile: (K,11) splats over (P,) pixels. Returns (rgb (P,3), T (P,))."""
    raw, t = compose_tiles(tile_splats[None], valid[None], pix_x[None], pix_y[None])
    bg = torch.as_tensor(bg, dtype=raw.dtype).to(raw.device)
    return raw[0] + t[0, :, None] * bg, t[0]


def tile_pixel_coords(tile_ids, tiles_x, tile_h, tile_w, row_offset=0):
    """Pixel-center coords (T, P) of flat row-major tile ids (T,)."""
    ty = tile_ids // tiles_x
    tx = tile_ids % tiles_x
    yy, xx = torch.meshgrid(
        torch.arange(tile_h, device=tile_ids.device), torch.arange(tile_w, device=tile_ids.device), indexing="ij"
    )
    ys = ty[:, None] * tile_h + row_offset + yy.reshape(1, -1)
    xs = tx[:, None] * tile_w + xx.reshape(1, -1)
    return xs.to(torch.float32) + 0.5, ys.to(torch.float32) + 0.5


def _by_tile_row(fn, splats, vmask, px, py, tiles_x: int) -> list:
    """``fn`` over one tile row of tiles at a time (see the module docstring)."""
    return [
        fn(splats[r0 : r0 + tiles_x].contiguous(), vmask[r0 : r0 + tiles_x], px[r0 : r0 + tiles_x], py[r0 : r0 + tiles_x])
        for r0 in range(0, splats.shape[0], tiles_x)
    ]


def composite_ref(
    splats_t: torch.Tensor,  # (T, 11, K) per-tile splat slabs (the kernel's input)
    valid: torch.Tensor,     # (T, K) float, > 0.5 = valid
    *,
    tiles_x: int,
    tile_h: int,
    tile_w: int,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function on the kernel's layout: returns raw rgb (T,3,P)
    and t_final (T,P)."""
    tids = torch.arange(splats_t.shape[0], device=splats_t.device)
    px, py = tile_pixel_coords(tids, tiles_x, tile_h, tile_w, row_offset)
    parts = _by_tile_row(compose_tiles, splats_t.transpose(1, 2), valid > 0.5, px, py, tiles_x)
    return torch.cat([o for o, _ in parts]).transpose(1, 2), torch.cat([t for _, t in parts])


def composited_counts(
    splats_t: torch.Tensor, valid: torch.Tensor, *, tiles_x: int, tile_h: int, tile_w: int, row_offset: int = 0,
    live_only: bool = False,
) -> torch.Tensor:
    """Per pixel (T, P), how many slots pass the stop rule: the kernel's
    front-to-back walk evaluates these and at most one more valid splat.
    With ``live_only``, only the splats actually composited (alpha >= 1/255),
    which is the backward's per-splat work. (Work accounting for the kernels'
    bounds; same layout as ``composite_ref``.)"""
    tids = torch.arange(splats_t.shape[0], device=splats_t.device)
    px, py = tile_pixel_coords(tids, tiles_x, tile_h, tile_w, row_offset)

    def count(splats, vmask, x, y):
        alpha, t_incl = _alpha_and_trans(splats, vmask, x, y)
        alive = t_incl >= T_EPS
        return (alive & (alpha > 0) if live_only else alive).sum(dim=1)

    return torch.cat(_by_tile_row(count, splats_t.transpose(1, 2), valid > 0.5, px, py, tiles_x))


def contrib_counts(
    splats_t: torch.Tensor, valid: torch.Tensor, *, tiles_x: int, tile_h: int, tile_w: int, row_offset: int = 0,
) -> torch.Tensor:
    """Per pixel (T, P) int32, one past the last slot composited (alive and
    alpha > 0), 0 where none is: the forward kernel's ``n_contrib``, which
    the backward kernel starts from (same layout as ``composite_ref``)."""
    tids = torch.arange(splats_t.shape[0], device=splats_t.device)
    px, py = tile_pixel_coords(tids, tiles_x, tile_h, tile_w, row_offset)

    def last(splats, vmask, x, y):
        alpha, t_incl = _alpha_and_trans(splats, vmask, x, y)
        slot = torch.arange(1, alpha.shape[1] + 1, device=alpha.device)[None, :, None]
        return torch.where((t_incl >= T_EPS) & (alpha > 0), slot, 0).amax(dim=1).to(torch.int32)

    return torch.cat(_by_tile_row(last, splats_t.transpose(1, 2), valid > 0.5, px, py, tiles_x))


def _compose_tiles_bwd(splats, vmask, pix_x, pix_y, gout, gtfin) -> torch.Tensor:
    """VJP of ``compose_tiles`` per tile, with the Pallas kernel's masks.

    splats (T,K,11), vmask (T,K) bool, pix_x/pix_y (T,P), gout (T,P,3) and
    gtfin (T,P). Returns d(splats) (T,11,K); depth and radius rows are 0."""
    mx = splats[:, :, _MX, None]
    my = splats[:, :, _MY, None]
    ca = splats[:, :, _CA, None]
    cb = splats[:, :, _CB, None]
    cc = splats[:, :, _CC, None]
    op = splats[:, :, _OP, None]
    rgb = splats[:, :, _CR : _CB_ + 1]  # (T,K,3)

    # the forward, recomputed op for op as _alpha_and_trans computes it
    dx = pix_x[:, None, :] - mx  # (T,K,P)
    dy = pix_y[:, None, :] - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    e = torch.exp(torch.clamp(power, max=0.0))
    alpha_raw = op * e
    alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
    live = vmask[:, :, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    zero = torch.zeros_like(alpha)
    alpha = torch.where(live, alpha, zero)
    t_incl = torch.cumprod(1.0 - alpha, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
    alive = t_incl >= T_EPS
    w = torch.where(alive, alpha * t_excl, zero)
    t_final = torch.where(alive, t_incl, torch.ones_like(t_incl)).amin(dim=1)  # (T,P)

    # out = sum_k rgb_k w_k: d rgb = w . gout, d w = rgb . gout (alive only)
    drgb = torch.bmm(w, gout)                                          # (T,K,3)
    dw = torch.where(alive, torch.bmm(rgb, gout.transpose(1, 2)), zero)  # (T,K,P)
    # B[k] = sum_{j>k} dw_j w_j + gtfin * t_final: a reverse exclusive sum
    rev = torch.flip(torch.cumsum(torch.flip(dw * w, dims=(1,)), dim=1), dims=(1,))
    b = torch.cat([rev[:, 1:], torch.zeros_like(rev[:, :1])], dim=1) + (gtfin * t_final)[:, None, :]
    dalpha = torch.where(alive, dw * t_excl - b / (1.0 - alpha), zero)
    # through the clamp and the masks: no gradient where alpha_raw >= 0.99
    dalpha_raw = torch.where(live & (alpha_raw < ALPHA_MAX), dalpha, zero)
    dop = (dalpha_raw * e).sum(dim=2)
    dpower = torch.where(power < 0.0, dalpha_raw * op * e, zero)
    dca = (dpower * (-0.5 * dx * dx)).sum(dim=2)
    dcb = (dpower * (-dx * dy)).sum(dim=2)
    dcc = (dpower * (-0.5 * dy * dy)).sum(dim=2)
    dmx = -(dpower * (-ca * dx - cb * dy)).sum(dim=2)
    dmy = -(dpower * (-cc * dy - cb * dx)).sum(dim=2)
    zk = torch.zeros_like(dop)
    return torch.stack([dmx, dmy, dca, dcb, dcc, dop, drgb[..., 0], drgb[..., 1], drgb[..., 2], zk, zk], dim=1)


def composite_bwd_ref(
    splats_t: torch.Tensor,  # (T, 11, K)
    valid: torch.Tensor,     # (T, K) float, > 0.5 = valid
    gout: torch.Tensor,      # (T, 3, P) d(raw rgb)
    gtfin: torch.Tensor,     # (T, P) d(t_final)
    *,
    tiles_x: int,
    tile_h: int,
    tile_w: int,
    row_offset: int = 0,
) -> torch.Tensor:
    """The backward kernel's function on its layout: d(splats_t) (T, 11, K).

    One tile row at a time, like ``composite_ref``, which also bounds the
    (tiles, K, P) temporaries of a large frame."""
    tids = torch.arange(splats_t.shape[0], device=splats_t.device)
    px, py = tile_pixel_coords(tids, tiles_x, tile_h, tile_w, row_offset)
    splats, vmask, g = splats_t.transpose(1, 2), valid > 0.5, gout.transpose(1, 2)
    return torch.cat([
        _compose_tiles_bwd(splats[r : r + tiles_x].contiguous(), vmask[r : r + tiles_x], px[r : r + tiles_x],
                           py[r : r + tiles_x], g[r : r + tiles_x], gtfin[r : r + tiles_x])
        for r in range(0, splats_t.shape[0], tiles_x)
    ])


def gather_slab_ref(packed: torch.Tensor, tile_idx: torch.Tensor, order: torch.Tensor | None = None) -> torch.Tensor:
    """(T, 11, K) slab: slot (t, k) holds row ``tile_idx[t, k]`` of the
    depth-sorted splats, ``packed[order]`` (``packed`` itself without
    ``order``)."""
    sorted_ = packed if order is None else packed[order]
    return sorted_[tile_idx.long()].transpose(1, 2).contiguous()


def gather_slab_bwd_ref(dslab: torch.Tensor, tile_idx: torch.Tensor, order: torch.Tensor | None, n: int) -> torch.Tensor:
    """d(packed) (n, 11) from d(slab) (T, 11, K): autograd of
    :func:`gather_slab_ref`, each row the sum of the slots that list it."""
    with torch.enable_grad():
        packed = torch.zeros((n, dslab.shape[1]), dtype=dslab.dtype, device=dslab.device, requires_grad=True)
        return torch.autograd.grad(gather_slab_ref(packed, tile_idx, order), packed, dslab)[0]


def rasterize_naive(packed: torch.Tensor, img_h: int, img_w: int, bg, chunk: int = 4096):
    """Untiled golden oracle: every splat vs every pixel (front-to-back).

    Used for quality tests and to validate the tile-list builder (a tiled
    render with sufficient K must match this).
    """
    dev = packed.device
    ys, xs = torch.meshgrid(
        torch.arange(img_h, device=dev, dtype=torch.float32) + 0.5,
        torch.arange(img_w, device=dev, dtype=torch.float32) + 0.5,
        indexing="ij",
    )
    px, py = xs.reshape(-1), ys.reshape(-1)
    valid = packed[:, _RAD] > 0
    rgb, trans = [], []
    for s in range(0, px.shape[0], chunk):
        o, t = compose_tile(packed, valid, px[s : s + chunk], py[s : s + chunk], bg)
        rgb.append(o)
        trans.append(t)
    return torch.cat(rgb).reshape(img_h, img_w, 3), torch.cat(trans).reshape(img_h, img_w)
