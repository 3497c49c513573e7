"""PyTorch port, rasterizer backward: the plain version of the backward kernel
(``composite_bwd_ref``) against the JAX package's Pallas ``_bwd_kernel`` run
in interpret mode, against autograd of the port's own forward, and against a
step-by-step emulation of the CUDA kernel's per-pixel algorithm; the whole
render's gradient against ``jax.grad`` of the JAX render; the forward
kernel's ``n_contrib`` residual (its emulation) against what the plain
version implies. The CUDA kernel itself is held to ``composite_bwd_ref`` in
tests/test_torch_gpu.py, on the card.

Gradient tolerance: atol 2e-5 * max|g| and rtol 2e-4, the JAX package's own
(tests/test_tile_raster_kernel.py::test_grad_allclose).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import render as JR
from repro.core.losses import gs_loss as jax_gs_loss
from repro.kernels.tile_raster.tile_raster import make_composite
from repro_torch.core import gaussians as TG
from repro_torch.core import render as TR
from repro_torch.core.losses import gs_loss
from repro_torch.kernels.tile_raster import ops as tr_ops
from repro_torch.kernels.tile_raster import ref as tr_ref

from conftest import make_cam, make_scene
from test_torch_raster import _sequential_composite
from torch_port_helpers import np_, to_port


def assert_grad_close(got, want, err_msg=""):
    got, want = np_(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-8)
    np.testing.assert_allclose(got, want, atol=2e-5 * scale + 1e-10, rtol=2e-4, err_msg=err_msg)


def _slabs(seed, t_count, k, tiles_x, th, tw, row_offset):
    """Per-tile splat slabs that overlap their tiles (some opacities reach
    the 0.99 clamp), a ragged valid mask, and random cotangents."""
    r = np.random.default_rng(seed)
    s = np.zeros((t_count, 11, k), np.float32)
    ty, tx = np.arange(t_count) // tiles_x, np.arange(t_count) % tiles_x
    s[:, 0] = tx[:, None] * tw + r.uniform(-4, tw + 4, (t_count, k))
    s[:, 1] = ty[:, None] * th + row_offset + r.uniform(-4, th + 4, (t_count, k))
    s[:, 2] = r.uniform(0.02, 0.3, (t_count, k))
    s[:, 3] = r.uniform(-0.02, 0.02, (t_count, k))
    s[:, 4] = r.uniform(0.02, 0.3, (t_count, k))
    s[:, 5] = r.uniform(0.05, 1.0, (t_count, k))
    s[:, 6:9] = r.uniform(0, 1, (t_count, 3, k))
    s[:, 9] = r.uniform(1, 5, (t_count, k))  # depth, radius: carry no gradient
    s[:, 10] = 8.0
    valid = (r.uniform(size=(t_count, k)) < 0.85).astype(np.float32)
    valid[t_count // 2:, k // 3:] = 0.0
    valid[-1] = 0.0  # an empty tile
    p = th * tw
    gout = r.normal(size=(t_count, 3, p)).astype(np.float32)
    gtfin = r.normal(size=(t_count, p)).astype(np.float32)
    return s, valid, gout, gtfin


@functools.lru_cache(maxsize=None)
def _jax_composite_vjp(tiles_x, th, tw, row_offset):
    comp = make_composite(tiles_x, th, tw, row_offset, interpret=True)

    def vjp(s, valid, gout, gtfin):
        _, back = jax.vjp(lambda x: comp(x, valid), s)
        return back((gout, gtfin))[0]

    return jax.jit(vjp)


# (seed, tiles, K, tiles_x, tile_h, tile_w, row_offset)
CASES = [
    (0, 8, 64, 4, 16, 16, 0),
    (1, 6, 96, 3, 16, 16, 48),   # a strip's row offset
    (2, 4, 128, 2, 8, 16, 0),    # 128-pixel tiles
    (3, 4, 32, 2, 16, 32, 16),   # 512-pixel tiles
]


@pytest.mark.parametrize("seed,t_count,k,tiles_x,th,tw,row_offset", CASES)
def test_composite_bwd_ref_matches_pallas_bwd_kernel(seed, t_count, k, tiles_x, th, tw, row_offset):
    s, valid, gout, gtfin = _slabs(seed, t_count, k, tiles_x, th, tw, row_offset)
    want = _jax_composite_vjp(tiles_x, th, tw, row_offset)(*map(jnp.asarray, (s, valid, gout, gtfin)))
    got = tr_ref.composite_bwd_ref(*map(torch.tensor, (s, valid, gout, gtfin)),
                                   tiles_x=tiles_x, tile_h=th, tile_w=tw, row_offset=row_offset)
    assert got.shape == (t_count, 11, k)
    assert_grad_close(got, want)
    assert not got[:, 9:].any()      # depth and radius
    assert not got[-1].any()         # the empty tile


@pytest.mark.parametrize("seed,t_count,k,tiles_x,th,tw,row_offset", CASES[:2])
def test_autograd_of_composite_ref_matches_composite_bwd_ref(seed, t_count, k, tiles_x, th, tw, row_offset):
    """Autograd of the plain forward and the explicit backward agree: the
    random inputs hit no exact tie at the clamp (alpha_raw == 0.99) or at
    power == 0, where torch.clamp passes a gradient the kernel masks."""
    s, valid, gout, gtfin = _slabs(seed, t_count, k, tiles_x, th, tw, row_offset)
    kw = dict(tiles_x=tiles_x, tile_h=th, tile_w=tw, row_offset=row_offset)
    st = torch.tensor(s, requires_grad=True)
    out, tfin = tr_ref.composite_ref(st, torch.tensor(valid), **kw)
    (auto,) = torch.autograd.grad((out * torch.tensor(gout)).sum() + (tfin * torch.tensor(gtfin)).sum(), st)
    explicit = tr_ref.composite_bwd_ref(*map(torch.tensor, (s, valid, gout, gtfin)), **kw)
    assert_grad_close(auto, explicit)


BWD_PIX = 1  # tile_raster.cu's kBwdPix: pixels a thread in the backward


def _kernel_algorithm(s, valid, gout, gtfin, tfin, n_contrib, tiles_x, th, tw, row_offset):
    """tile_raster.cu's backward, step by step in float32 numpy, vectorized
    over (tile, pixel). Each pixel starts from the forward's t_final and
    n_contrib and walks back to the front: T before each splat is T after it
    times 1/(1 - alpha), B is the running sum. (The kernel evaluates each
    chunk's alphas ahead of the chains: the same values.) Then the sums in the
    kernel's order: each thread adds its BWD_PIX pixels (p, then p + threads,
    ...), each warp its 32 lanes in order, then the warps in order."""
    f32 = np.float32
    t_count, _, k = s.shape
    p = th * tw
    n_thr = ((p + BWD_PIX - 1) // BWD_PIX + 31) // 32 * 32
    pid = np.arange(p)
    tid = np.arange(t_count)
    px = ((tid[:, None] % tiles_x) * tw + pid[None] % tw).astype(f32) + f32(0.5)
    py = ((tid[:, None] // tiles_x) * th + row_offset + pid[None] // tw).astype(f32) + f32(0.5)
    gr, gg, gb = gout[:, 0], gout[:, 1], gout[:, 2]
    t_cur, bsum = tfin.copy(), gtfin * tfin
    d = np.zeros((t_count, 11, k), f32)
    for j in range(k - 1, -1, -1):
        dx = px - s[:, 0, j, None]
        dy = py - s[:, 1, j, None]
        power = f32(-0.5) * (s[:, 2, j, None] * dx * dx + s[:, 4, j, None] * dy * dy) - s[:, 3, j, None] * dx * dy
        e = np.exp(np.minimum(power, f32(0)))
        alpha_raw = s[:, 5, j, None] * e
        alpha = np.minimum(alpha_raw, f32(0.99))
        hit = (valid[:, j, None] > 0.5) & (j < n_contrib) & (power <= 0) & (alpha >= f32(1 / 255))
        rcp = f32(1) / (f32(1) - alpha)
        t_excl = t_cur * rcp
        w = alpha * t_excl
        dw = s[:, 6, j, None] * gr + s[:, 7, j, None] * gg + s[:, 8, j, None] * gb
        dalpha = dw * t_excl - bsum * rcp
        bsum = np.where(hit, bsum + dw * w, bsum)
        t_cur = np.where(hit, t_excl, t_cur)
        g = np.zeros((9, t_count, BWD_PIX * n_thr), f32)
        g[6, :, :p], g[7, :, :p], g[8, :, :p] = gr * w, gg * w, gb * w
        g[5, :, :p] = dalpha * e
        dpower = dalpha * s[:, 5, j, None] * e
        g[2, :, :p] = dpower * (f32(-0.5) * dx * dx)
        g[3, :, :p] = dpower * (-dx * dy)
        g[4, :, :p] = dpower * (f32(-0.5) * dy * dy)
        g[0, :, :p] = -(dpower * (-s[:, 2, j, None] * dx - s[:, 3, j, None] * dy))
        g[1, :, :p] = -(dpower * (-s[:, 4, j, None] * dy - s[:, 3, j, None] * dx))
        unclamped = hit & (alpha_raw < f32(0.99))
        g[6:, :, :p] = np.where(hit, g[6:, :, :p], 0)
        g[5, :, :p] = np.where(unclamped, g[5, :, :p], 0)
        g[:5, :, :p] = np.where(unclamped & (power < 0), g[:5, :, :p], 0)
        lanes = g[:, :, :n_thr]
        for h in range(1, BWD_PIX):
            lanes = lanes + g[:, :, h * n_thr:(h + 1) * n_thr]
        lanes = lanes.reshape(9, t_count, n_thr // 32, 32)
        per_warp = lanes[..., 0]
        for lane in range(1, 32):
            per_warp = per_warp + lanes[..., lane]
        acc = np.zeros((9, t_count), f32)
        for wi in range(n_thr // 32):
            acc = acc + per_warp[:, :, wi]
        d[:, :9, j] = acc.T
    return d


@pytest.mark.parametrize("seed,t_count,k,tiles_x,th,tw,row_offset", [CASES[0], CASES[1], CASES[3]])
def test_kernel_algorithm_matches_composite_bwd_ref(seed, t_count, k, tiles_x, th, tw, row_offset):
    s, valid, gout, gtfin = _slabs(seed, t_count, k, tiles_x, th, tw, row_offset)
    s[:, 5, :8] = 1.0  # opaque front splats: the stop rule fires in many pixels
    kw = dict(tiles_x=tiles_x, tile_h=th, tile_w=tw, row_offset=row_offset)
    _, tfin, n_contrib = _sequential_composite(s, valid, **kw)  # the forward kernel's residuals
    got = _kernel_algorithm(s, valid, gout, gtfin, tfin, n_contrib, tiles_x, th, tw, row_offset)
    want = tr_ref.composite_bwd_ref(*map(torch.tensor, (s, valid, gout, gtfin)), **kw)
    assert_grad_close(got, want)


@pytest.mark.parametrize("seed,t_count,k,tiles_x,th,tw,row_offset", [CASES[0], CASES[1]])
def test_forward_algorithm_n_contrib_matches_plain(seed, t_count, k, tiles_x, th, tw, row_offset):
    """The forward kernel's n_contrib (its emulation) is what the plain
    version implies: the last slot that is alive (T after it >= eps) with
    alpha > 0, plus one; 0 where no splat is composited."""
    s, valid, _, _ = _slabs(seed, t_count, k, tiles_x, th, tw, row_offset)
    s[:, 5, :8] = 1.0  # opaque front splats: the stop rule fires in many pixels
    kw = dict(tiles_x=tiles_x, tile_h=th, tile_w=tw, row_offset=row_offset)
    _, _, got = _sequential_composite(s, valid, **kw)
    st, vt = torch.tensor(s), torch.tensor(valid)
    px, py = tr_ref.tile_pixel_coords(torch.arange(t_count), tiles_x, th, tw, row_offset)
    alpha, t_incl = tr_ref._alpha_and_trans(st.transpose(1, 2), vt > 0.5, px, py)
    took = (t_incl >= tr_ref.T_EPS) & (alpha > 0)                      # (T, K, P)
    slot = torch.arange(1, k + 1)[None, :, None]
    want = torch.where(took, slot, 0).amax(dim=1)
    assert (want == 0).any() and (want > 0).any() and (want < k).any()
    np.testing.assert_array_equal(got, np_(want))
    np.testing.assert_array_equal(np_(tr_ref.contrib_counts(st, vt, **kw)), np_(want))


def test_composite_function_gives_valid_no_gradient_and_needs_cuda_for_the_kernel():
    s, valid, gout, gtfin = _slabs(5, 4, 32, 2, 16, 16, 0)
    st, vt = torch.tensor(s, requires_grad=True), torch.tensor(valid, requires_grad=True)
    out, tfin = tr_ops.Composite.apply(st, vt, 2, 16, 16, 0)
    before = (tr_ops.launch_count.n, tr_ops.bwd_launch_count.n)
    ds, dv = torch.autograd.grad(out.sum() + tfin.sum(), [st, vt], allow_unused=True)
    assert dv is None and ds.shape == st.shape
    assert (tr_ops.launch_count.n, tr_ops.bwd_launch_count.n) == before  # CPU: plain versions
    # the kernel wrapper itself takes CUDA tensors only: no plain fallback
    tfin, n_contrib = tfin.detach(), torch.zeros(tfin.shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tr_ops.composite_bwd(*map(torch.tensor, (s, valid, gout, gtfin)), tfin, n_contrib, tiles_x=2, tile_h=16,
                             tile_w=16)


@functools.lru_cache(maxsize=None)
def _jax_render_grad(h, w, k, backend, bg):
    def loss(g, cam, target):
        img, t = JR.render(g, cam, img_h=h, img_w=w, tile_h=16, tile_w=16, k_per_tile=k,
                           bg=jnp.asarray(bg, jnp.float32), backend=backend)
        return jax_gs_loss(img, target) + jnp.mean(t)

    return jax.jit(jax.grad(loss))


@pytest.mark.parametrize("n,h,w,k,backend,bg", [
    (200, 64, 64, 128, "pallas", (0.2, 0.4, 0.6)),  # non-black background: the t_final term
    (64, 32, 32, 64, "ref", (0.0, 0.0, 0.0)),
])
def test_render_gradient_wrt_params_matches_jax(n, h, w, k, backend, bg):
    g = make_scene(n, seed=n + 1)
    cam = make_cam(h, w)
    target = np.random.default_rng(n).uniform(0, 1, (h, w, 3)).astype(np.float32)
    want = _jax_render_grad(h, w, k, backend, bg)(g, cam, jnp.asarray(target))

    gp, camp = to_port(g, cam)
    leaves = [x.requires_grad_() for x in gp]
    img, t = TR.render(TG.GaussianModel(*leaves), camp, img_h=h, img_w=w, k_per_tile=k, bg=torch.tensor(bg))
    got = torch.autograd.grad(gs_loss(img, torch.tensor(target)) + t.mean(), leaves)
    for name, a, b in zip(TG.GaussianModel._fields, got, want):
        assert torch.isfinite(a).all(), name
        assert_grad_close(a, b, err_msg=name)
