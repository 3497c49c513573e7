"""Plain PyTorch reference of the 3D-GS train step the benchmark times.

It follows the configuration's semantics from the benchmark's own inputs
(the model, the cameras, the ground truth and the batch order from
``gsbench/scene``) and imports nothing of the program:

- EWA projection in matrix form (rotation from the normalized quaternion,
  covariance R S S^T R^T, the Jacobian of the pinhole projection), the
  radius 3 sigma of the larger eigenvalue rounded up, SH color of degrees
  0-3;
- a stable depth sort, then per tile the front-most K splats whose bounding
  circle meets the tile, binned in two levels where the configuration
  asks for hierarchical binning (superblocks keep their front-most
  ``k_block_mult`` x K candidates, tiles pick from those);
- front-to-back compositing with the alpha clamp, the 1/255 skip and the
  1e-4 transmittance stop, its gradient through autograd with the
  gradient masks of the configuration's compositor (none through the
  clamp, none where the exponent is not negative), in blocks of whole tile
  rows (``BLOCK_TILES``): the image first without a graph, then each
  block again with its graph and its share of the image's gradient;
- (1 - lambda) L1 + lambda D-SSIM over the batch, the 11 x 11 Gaussian
  window applied separably with zero padding;
- Adam with eps 1e-15, a learning rate per field, the exponential decay of
  the means' rate and the square-root batch scaling.

Every product of two tensors (the camera transform, the covariances, the
compositing sum, the SSIM window) goes through ``_Arith.mm`` / ``conv``,
which with ``tf32=True`` rounds both operands to TF32 first: the control
that a check must fail. TF32 stays off in PyTorch itself.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FIELDS = ("means", "log_scales", "quats", "opacity_logit", "sh")
CHUNK = 1 << 21  # Gaussians a projection pass takes at once (bounds the temporaries)
# tiles a compositing pass takes at once: its saved (tiles, K, 256) tensors
# hold ~3.5 GB at K 256, where a 2048-px frame's 16,384 tiles would hold ~57 GB
BLOCK_TILES = 1024
SH_C0 = 0.28209479177387814


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    bias = ((i >> 13) & 1) + 0x0FFF
    return ((i + bias) & -8192).view(torch.float32)


class _Arith:
    """The reference's products: float32, or float32 with TF32 operands."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def _r(self, x):
        # the products see TF32 operands; their gradients pass straight through
        return x + (tf32_round(x.detach()) - x.detach()) if self.tf32 else x

    def mm(self, a, b):
        return torch.matmul(self._r(a), self._r(b))

    def conv(self, x, w, **kw):
        return F.conv2d(self._r(x), self._r(w), **kw)


def _rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _sh_color(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH color of degrees 0-3 (the 3D-GS basis), + 0.5."""
    k = sh.shape[1]
    c = SH_C0 * sh[:, 0]
    if k > 1:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        c = c + 0.4886025119029199 * (-y * sh[:, 1] + z * sh[:, 2] - x * sh[:, 3])
    if k > 4:
        xx, yy, zz = x * x, y * y, z * z
        c = c + (1.0925484305920792 * x * y * sh[:, 4] - 1.0925484305920792 * y * z * sh[:, 5]
                 + 0.31539156525252005 * (2 * zz - xx - yy) * sh[:, 6] - 1.0925484305920792 * x * z * sh[:, 7]
                 + 0.5462742152960396 * (xx - yy) * sh[:, 8])
    if k > 9:
        c = c + (-0.5900435899266435 * y * (3 * xx - yy) * sh[:, 9] + 2.890611442640554 * x * y * z * sh[:, 10]
                 - 0.4570457994644658 * y * (4 * zz - xx - yy) * sh[:, 11]
                 + 0.3731763325901154 * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
                 - 0.4570457994644658 * x * (4 * zz - xx - yy) * sh[:, 13]
                 + 1.445305721320277 * z * (xx - yy) * sh[:, 14] - 0.5900435899266435 * x * (xx - 3 * yy) * sh[:, 15])
    return c + 0.5


def project(p: dict, cam: dict, c: dict, ar: _Arith) -> torch.Tensor:
    """(n, 11) splats: mean x, y, conic a, b, c, opacity, r, g, b, depth,
    radius. Behind the near plane: opacity 0, radius 0, depth +inf."""
    dev = p["means"].device
    vm = cam["viewmat"].to(device=dev, dtype=torch.float32)
    rv, tv = vm[:3, :3], vm[:3, 3]
    fx, fy, cx, cy = (float(cam[k]) for k in ("fx", "fy", "cx", "cy"))
    rot = _rotmat(p["quats"]) * torch.exp(p["log_scales"])[:, None, :]
    cov3 = ar.mm(rot, rot.transpose(1, 2))
    pc = ar.mm(p["means"], rv.T) + tv
    x, y, z = pc.unbind(-1)
    valid = z > c["near"]
    zc = torch.where(valid, z, torch.ones_like(z))
    zero = torch.zeros_like(zc)
    jac = torch.stack([torch.stack([fx / zc, zero, -fx * x / (zc * zc)], -1),
                       torch.stack([zero, fy / zc, -fy * y / (zc * zc)], -1)], -2)
    jw = ar.mm(jac, rv.expand(zc.shape[0], 3, 3))
    cov2 = ar.mm(ar.mm(jw, cov3), jw.transpose(1, 2))
    a = cov2[:, 0, 0] + c["blur"]
    b = cov2[:, 0, 1]
    cc = cov2[:, 1, 1] + c["blur"]
    det = torch.clamp(a * cc - b * b, min=1e-12)
    with torch.no_grad():
        mid = 0.5 * (a + cc)
        lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
        radius = torch.clamp(torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0))), max=c["max_radius"])
    if p["sh"].shape[1] == 1:
        rgb = SH_C0 * p["sh"][:, 0] + 0.5
    else:
        campos = -rv.T @ tv
        d = p["means"] - campos
        rgb = _sh_color(p["sh"], d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12))
    rgb = torch.clamp(rgb, 0.0, 1.0)
    opac = torch.where(valid, torch.sigmoid(p["opacity_logit"]), zero)
    return torch.stack([fx * x / zc + cx, fy * y / zc + cy, cc / det, -b / det, a / det, opac,
                        rgb[:, 0], rgb[:, 1], rgb[:, 2],
                        torch.where(valid, z, torch.full_like(z, math.inf)),
                        torch.where(valid, radius, zero)], -1)


def _meets(ps: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, w: float, h: float) -> torch.Tensor:
    """(rects, n) whether each splat's bounding circle meets each rectangle
    [x0, x0 + w] x [y0, y0 + h] (edges included); radius 0 meets nothing."""
    mx, my, r = ps[:, 0][None], ps[:, 1][None], ps[:, 10][None]
    x0, y0 = x0[:, None], y0[:, None]
    return (mx + r >= x0) & (mx - r <= x0 + w) & (my + r >= y0) & (my - r <= y0 + h) & (r > 0)


def _first_k(mask: torch.Tensor, k: int, ids: torch.Tensor | None = None) -> torch.Tensor:
    """Per row of ``mask`` (..., n), the first ``k`` columns that are set, or
    the entries of ``ids`` (shaped like ``mask``) there: (..., k), -1 where a
    row has fewer."""
    rank = torch.cumsum(mask, dim=-1, dtype=torch.int32) - 1
    where = torch.nonzero(mask & (rank < k), as_tuple=True)
    out = torch.full(mask.shape[:-1] + (k,), -1, dtype=torch.int64, device=mask.device)
    out[where[:-1] + (rank[where].long(),)] = where[-1] if ids is None else ids[where]
    return out


def tile_lists(ps: torch.Tensor, img_h: int, img_w: int, gs: dict, c: dict) -> torch.Tensor:
    """(tiles, K) front-most splat indices of each tile in row-major tile
    order, -1 where a tile has fewer than K. ``ps`` is depth-sorted."""
    th, tw, k = gs["tile_h"], gs["tile_w"], gs["k_per_tile"]
    ty, tx = img_h // th, img_w // tw
    f32 = dict(dtype=torch.float32, device=ps.device)
    hier = gs["binning"] == "hier" or (gs["binning"] == "auto" and ty * tx >= 256)
    if not hier:
        t = torch.arange(ty * tx, device=ps.device)
        lists = [_first_k(_meets(ps, (t[s:s + 64] % tx * tw).to(**f32), (t[s:s + 64] // tx * th).to(**f32), tw, th),
                          k) for s in range(0, ty * tx, 64)]
        return torch.cat(lists)
    by, bx = max(min(c["superblock"], ty), 1), max(min(c["superblock"], tx), 1)
    nby, nbx = ty // by, tx // bx
    b = torch.arange(nby * nbx, device=ps.device)
    cand = _first_k(_meets(ps, (b % nbx * bx * tw).to(**f32), (b // nbx * by * th).to(**f32), bx * tw, by * th),
                    k * c["k_block_mult"])                                      # (blocks, K1)
    cs = ps[cand.clamp(min=0)]                                                   # (blocks, K1, 11)
    cs = torch.where((cand >= 0)[..., None], cs, torch.zeros_like(cs))          # radius 0: meets nothing
    j = torch.arange(by * bx, device=ps.device)
    tile_x = (b[:, None] % nbx * bx + j[None] % bx) * tw                        # (blocks, by*bx)
    tile_y = (b[:, None] // nbx * by + j[None] // bx) * th
    mx, my, r = (cs[..., i][:, None, :] for i in (0, 1, 10))                    # (blocks, 1, K1)
    x0, y0 = tile_x.to(**f32)[..., None], tile_y.to(**f32)[..., None]
    meets = (mx + r >= x0) & (mx - r <= x0 + tw) & (my + r >= y0) & (my - r <= y0 + th) & (r > 0)
    lists = _first_k(meets, k, cand[:, None, :].expand_as(meets))               # (blocks, by*bx, K)
    return lists.reshape(nby, nbx, by, bx, k).permute(0, 2, 1, 3, 4).reshape(ty * tx, k)


def composite(ps: torch.Tensor, lists: torch.Tensor, img_w: int, gs: dict, c: dict, ar: _Arith, *,
              t0: int = 0) -> torch.Tensor:
    """(rows, W, 3) band of the image of depth-sorted splats ``ps`` over the
    lists of whole tile rows, the first of them tile ``t0`` (row-major); the
    whole (H, W, 3) image when ``lists`` holds every tile."""
    th, tw = gs["tile_h"], gs["tile_w"]
    tx = img_w // tw
    t = torch.arange(t0, t0 + lists.shape[0], device=ps.device)
    yy, xx = torch.meshgrid(torch.arange(th, device=ps.device), torch.arange(tw, device=ps.device), indexing="ij")
    px = ((t % tx)[:, None] * tw + xx.reshape(1, -1)).to(torch.float32) + 0.5   # (T, P)
    py = ((t // tx)[:, None] * th + yy.reshape(1, -1)).to(torch.float32) + 0.5
    valid = lists >= 0
    sp = ps[lists.clamp(min=0)]                                                   # (T, K, 11)
    dx = px[:, None, :] - sp[..., 0:1]
    dy = py[:, None, :] - sp[..., 1:2]
    power = -0.5 * (sp[..., 2:3] * dx * dx + sp[..., 4:5] * dy * dy) - sp[..., 3:4] * dx * dy
    raw = sp[..., 5:6] * torch.exp(torch.where(power < 0, power, torch.zeros_like(power)))
    alpha = torch.where(raw < c["alpha_max"], raw, torch.full_like(raw, c["alpha_max"]))
    live = valid[..., None] & (power <= 0) & (alpha >= c["alpha_min"])
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    t_incl = torch.cumprod(1.0 - alpha, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
    alive = t_incl >= c["t_eps"]
    w = torch.where(alive, alpha * t_excl, torch.zeros_like(alpha))
    t_final = torch.where(alive, t_incl, torch.ones_like(t_incl)).amin(dim=1)   # (T, P)
    rgb = ar.mm(w.transpose(1, 2), sp[..., 6:9])                                  # (T, P, 3)
    bg = torch.tensor(gs["bg"], dtype=torch.float32, device=ps.device)
    rgb = rgb + t_final[..., None] * bg
    rows = lists.shape[0] // tx
    return rgb.reshape(rows, tx, th, tw, 3).permute(0, 2, 1, 3, 4).reshape(rows * th, img_w, 3)


def tile_blocks(img_h: int, img_w: int, gs: dict) -> list[tuple[int, int]]:
    """(first tile, tile count) of each block that one compositing pass
    takes: as many whole tile rows as ``BLOCK_TILES`` tiles hold, at least
    one, so a frame of ``BLOCK_TILES`` tiles or fewer is one block."""
    tx, ty = img_w // gs["tile_w"], img_h // gs["tile_h"]
    rows = max(1, min(ty, BLOCK_TILES // tx))
    return [(r * tx, min(rows, ty - r) * tx) for r in range(0, ty, rows)]


def ssim_l1_sums(img: torch.Tensor, gt: torch.Tensor, ar: _Arith, size: int = 11, sigma: float = 1.5):
    """(sum of the SSIM map, sum of |img - gt|) over an (H, W, 3) pair."""
    x = torch.arange(size, dtype=torch.float32, device=img.device) - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2 * sigma * sigma))
    g = g / g.sum()
    st = torch.cat([img, gt, img * img, gt * gt, img * gt], -1).permute(2, 0, 1)[None]  # (1, 15, H, W)
    half = size // 2
    st = ar.conv(st, g.reshape(1, 1, 1, size).expand(15, 1, 1, size), padding=(0, half), groups=15)
    st = ar.conv(st, g.reshape(1, 1, size, 1).expand(15, 1, size, 1), padding=(half, 0), groups=15)[0]
    mu0, mu1, e00, e11, e01 = st[0:3], st[3:6], st[6:9], st[9:12], st[12:15]
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    smap = ((2 * mu0 * mu1 + c1) * (2 * (e01 - mu0 * mu1) + c2)) / (
        (mu0 * mu0 + mu1 * mu1 + c1) * (e00 - mu0 * mu0 + e11 - mu1 * mu1 + c2))
    return smap.sum(), torch.abs(img - gt).sum()


def _project_all(p: dict, cam: dict, c: dict, ar: _Arith) -> torch.Tensor:
    n = p["means"].shape[0]
    with torch.no_grad():
        return torch.cat([project({f: p[f][s:s + CHUNK] for f in FIELDS}, cam, c, ar) for s in range(0, n, CHUNK)])


def view_grads(p: dict, cam: dict, gt: torch.Tensor, gs: dict, c: dict, ar: _Arith, *, scale: float,
               grads: dict) -> tuple[float, float]:
    """Add ``scale`` x d(- lambda/2 ssim_sum + (1 - lambda) l1_sum) of one
    view into ``grads``; return its (ssim_sum, l1_sum)."""
    img_h, img_w = gt.shape[0], gt.shape[1]
    packed = _project_all(p, cam, c, ar)
    order = torch.sort(packed[:, 9], stable=True).indices
    ps = packed[order].requires_grad_()
    lists = tile_lists(ps.detach(), img_h, img_w, gs, c)
    blocks = tile_blocks(img_h, img_w, gs)
    # the image without a graph, then d(loss)/d(image); each block's
    # compositing again with its graph, its share of d(loss)/d(ps) taken
    # before the next block's is built (the tiles composite independently)
    with torch.no_grad():
        img = torch.cat([composite(ps, lists[t0:t0 + n], img_w, gs, c, ar, t0=t0) for t0, n in blocks])
    img.requires_grad_()
    ssim_s, l1_s = ssim_l1_sums(img, gt, ar)
    lam = gs["lambda_dssim"]
    (d_img,) = torch.autograd.grad(scale * ((1 - lam) * l1_s - 0.5 * lam * ssim_s), img)
    g_sorted = None
    th, tx = gs["tile_h"], img_w // gs["tile_w"]
    for t0, n in blocks:
        band = composite(ps, lists[t0:t0 + n], img_w, gs, c, ar, t0=t0)
        r0 = t0 // tx * th
        (g,) = torch.autograd.grad(band, ps, d_img[r0:r0 + band.shape[0]])
        g_sorted = g if g_sorted is None else g_sorted + g
    g_packed = torch.empty_like(g_sorted)
    g_packed[order] = g_sorted
    n = packed.shape[0]
    for s in range(0, n, CHUNK):
        leaves = {f: p[f][s:s + CHUNK].detach().requires_grad_() for f in FIELDS}
        with torch.enable_grad():
            out = project(leaves, cam, c, ar)
            got = torch.autograd.grad(out, [leaves[f] for f in FIELDS], g_packed[s:s + CHUNK], allow_unused=True)
        for f, gf in zip(FIELDS, got):
            if gf is not None:
                grads[f][s:s + CHUNK] += gf
    return float(ssim_s.detach()), float(l1_s.detach())


def train_steps(params: dict, cams: dict, gt: torch.Tensor, batches: list, config: dict, *, tf32: bool = False) -> dict:
    """Run ``len(batches)`` reference train steps from ``params`` (left
    untouched). Returns each step's loss, every leaf's gradient norm at the
    first step and every leaf's change after the last, as floats."""
    gs, c = config["gs"], config["raster"]
    ar = _Arith(tf32)
    p = {f: params[f].detach().clone() for f in FIELDS}
    m = {f: torch.zeros_like(p[f]) for f in FIELDS}
    v = {f: torch.zeros_like(p[f]) for f in FIELDS}
    b1, b2, eps = c["adam_b1"], c["adam_b2"], c["adam_eps"]
    lam = gs["lambda_dssim"]
    losses, grad_norms = [], None
    for step, views in enumerate(batches):
        cnt = float(len(views) * gt.shape[1] * gt.shape[2] * 3)
        grads = {f: torch.zeros_like(p[f]) for f in FIELDS}
        ssim_tot = l1_tot = 0.0
        for vi in views:
            cam = {k: cams[k][vi] for k in cams}
            s, l1 = view_grads(p, cam, gt[vi], gs, c, ar, scale=1.0 / cnt, grads=grads)
            ssim_tot += s
            l1_tot += l1
        losses.append((1 - lam) * l1_tot / cnt + lam * (1 - ssim_tot / cnt) / 2)
        if grad_norms is None:
            grad_norms = {f: float(torch.linalg.norm(grads[f].double())) for f in FIELDS}
        t = min(max(step / gs["max_steps"], 0.0), 1.0)
        lr_means = math.exp(math.log(gs["lr_means_init"]) * (1 - t) + math.log(gs["lr_means_final"]) * t)
        scale = math.sqrt(len(views)) if gs["grendel_sqrt_lr_scaling"] else 1.0
        lrs = {"means": lr_means, "log_scales": gs["lr_scales"], "quats": gs["lr_quats"],
               "opacity_logit": gs["lr_opacity"], "sh": gs["lr_sh"]}
        bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
        for f in FIELDS:
            m[f] = b1 * m[f] + (1 - b1) * grads[f]
            v[f] = b2 * v[f] + (1 - b2) * grads[f] * grads[f]
            p[f] = p[f] - lrs[f] * scale * (m[f] / bc1) / (torch.sqrt(v[f] / bc2) + eps)
        del grads
    change = {f: float(torch.linalg.norm((p[f] - params[f]).double())) for f in FIELDS}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
