"""PyTorch port, binning and compositing: tile lists (flat and hierarchical,
with row offsets) equal to the JAX package's entry for entry; the port's
rasterizer (plain version on the CPU) against the JAX oracle and the JAX
Pallas rasterizer in interpret mode over the JAX kernel tests' shape sweep;
the CUDA kernel's per-pixel algorithm (a sequential loop with early exit)
against the plain version. The kernel itself is held to the plain version
in tests/test_torch_gpu.py, on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projection as JP
from repro.core import render as JR
from repro.kernels.tile_raster.ref import rasterize_naive as jax_rasterize_naive
from repro_torch.core import projection as TP
from repro_torch.core import render as TR
from repro_torch.kernels.tile_raster import ops as tr_ops
from repro_torch.kernels.tile_raster import ref as tr_ref

from conftest import make_cam, make_scene
from torch_port_helpers import jax_render, np_, to_port

# tests/test_tile_raster_kernel.py's sweep and forward tolerance
SWEEP = [
    # (n_gauss, H, W, tile_h, tile_w, K)
    (64, 32, 32, 16, 16, 64),
    (200, 64, 64, 16, 16, 128),
    (200, 48, 96, 16, 32, 256),
    (500, 64, 64, 8, 16, 512),
    (37, 32, 32, 16, 16, 64),   # K > N
]
ATOL, RTOL = 3e-6, 1e-5
jax_project_sorted = jax.jit(lambda g, cam: JP.sort_by_depth(JP.project(g, cam))[0])


def _sorted_pair(n, h, w, seed=None):
    """The same depth-sorted packed splats for both packages (JAX-made)."""
    g = make_scene(n, seed=n if seed is None else seed)
    packed = jax_project_sorted(g, make_cam(h, w))
    return packed, torch.tensor(np.asarray(packed))


def _assert_lists_equal(got, want):
    np.testing.assert_array_equal(np_(got[1]), np.asarray(want[1]))  # valid
    np.testing.assert_array_equal(np_(got[0]), np.asarray(want[0]))  # idx, padding entries too


@pytest.mark.parametrize("n,h,w,th,tw,k", [SWEEP[0], SWEEP[3], SWEEP[4]])
def test_flat_lists_equal_jax(n, h, w, th, tw, k):
    pj, pt = _sorted_pair(n, h, w)
    for row_offset in (0, 16):
        kw = dict(img_h=h, img_w=w, tile_h=th, tile_w=tw, k_per_tile=k, row_offset=row_offset)
        want = JR.build_tile_lists(pj, **kw)
        _assert_lists_equal(TR.build_tile_lists(pt, chunk=64, **kw), want)  # chunking is a memory knob only
        _assert_lists_equal(TR.build_tile_lists(pt, **kw), want)


@pytest.mark.parametrize(
    "n,h,w,k,block,mult,row_offset",
    [
        (400, 128, 128, 128, 4, 4, 0),   # adequate K1: equals flat
        (900, 128, 128, 32, 4, 1, 0),    # saturated superblocks: differs from flat
        (900, 128, 128, 32, 4, 1, 32),
        (300, 64, 128, 64, 8, 4, 0),     # rectangular, block clamps to the tile grid
    ],
)
def test_hier_lists_equal_jax(n, h, w, k, block, mult, row_offset):
    pj, pt = _sorted_pair(n, h, w)
    kw = dict(img_h=h, img_w=w, tile_h=16, tile_w=16, k_per_tile=k, block=block,
              k_block_mult=mult, row_offset=row_offset)
    _assert_lists_equal(TR.build_tile_lists_hier(pt, **kw), JR.build_tile_lists_hier(pj, **kw))


def test_tile_row_lists_equal_full_frame_rows_under_saturation():
    """A strip's lists equal its row of the full frame's lists even when
    superblocks overflow K1 — where binning the strip flat (the JAX strip
    renderer's choice) does not."""
    _, pt = _sorted_pair(2000, 128, 128, seed=21)
    kw = dict(img_h=128, img_w=128, tile_h=16, tile_w=16, k_per_tile=8)
    idx, valid = TR.build_tile_lists_hier(pt, block=4, **kw)
    flat_differs = False
    for row in range(8):
        ri, rv = TR.bin_tile_row(pt, row=row, binning="hier", block=4, **kw)
        rows = slice(row * 8, (row + 1) * 8)
        np.testing.assert_array_equal(np_(rv), np_(valid[rows]))
        np.testing.assert_array_equal(np_(ri), np_(idx[rows]))
        fi, fv = TR.bin_tile_row(pt, row=row, binning="flat", **kw)
        flat_differs |= not torch.equal(torch.where(fv, fi, -1), torch.where(valid[rows], idx[rows], -1))
    assert flat_differs  # the case the superblock-band strip binning exists for


@pytest.mark.parametrize("n,h,w,th,tw,k", SWEEP)
def test_render_matches_jax_ref_and_pallas(n, h, w, th, tw, k):
    g = make_scene(n, seed=n)
    cam = make_cam(h, w)
    gt, ct = to_port(g, cam)
    img, t = TR.render(gt, ct, img_h=h, img_w=w, tile_h=th, tile_w=tw, k_per_tile=k)
    for backend in ("ref", "pallas"):
        img_j, t_j = jax_render(g, cam, img_h=h, img_w=w, tile_h=th, tile_w=tw, k_per_tile=k, backend=backend)
        np.testing.assert_allclose(np_(img), np.asarray(img_j), atol=ATOL, rtol=RTOL, err_msg=backend)
        np.testing.assert_allclose(np_(t), np.asarray(t_j), atol=ATOL, rtol=RTOL, err_msg=backend)
    assert img.dtype == torch.float32 and bool(torch.isfinite(img).all())


@pytest.mark.parametrize("binning", ["flat", "hier"])
def test_render_packed_binning_modes_match_jax(binning):
    pj, pt = _sorted_pair(300, 64, 128, seed=3)
    bg = (0.1, 0.2, 0.3)
    kw = dict(img_h=64, img_w=128, k_per_tile=128, binning=binning, row_offset=0)
    img_j, t_j = jax.jit(lambda p: JR.render_packed(p, bg=jnp.asarray(bg), **kw))(pj)
    img_t, t_t = TR.render_packed(pt, bg=torch.tensor(bg), **kw)
    np.testing.assert_allclose(np_(img_t), np.asarray(img_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np_(t_t), np.asarray(t_j), atol=ATOL, rtol=RTOL)


def test_rasterize_naive_matches_jax_and_tiled_with_full_capacity():
    n, h, w = 150, 64, 64
    g = make_scene(n, seed=7)
    gt, ct = to_port(g, make_cam(h, w))
    pt, _ = TP.sort_by_depth(TP.project(gt, ct))
    img_n, t_n = tr_ref.rasterize_naive(pt, h, w, (0.0, 0.0, 0.0), chunk=1024)
    pj = jnp.asarray(np_(pt))
    img_j, t_j = jax_rasterize_naive(pj, h, w, jnp.zeros(3), chunk=1024)
    np.testing.assert_allclose(np_(img_n), np.asarray(img_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np_(t_n), np.asarray(t_j), atol=ATOL, rtol=RTOL)
    img_t, _ = TR.render_packed(pt, img_h=h, img_w=w, k_per_tile=256)
    np.testing.assert_allclose(np_(img_t), np_(img_n), atol=1e-6)


def test_background_blend():
    g = make_scene(4, seed=9)
    g = g._replace(opacity_logit=jnp.full((4,), -20.0))
    gt, ct = to_port(g, make_cam(32, 32))
    img, t = TR.render(gt, ct, img_h=32, img_w=32, k_per_tile=64, bg=(0.2, 0.4, 0.6))
    np.testing.assert_allclose(np_(img), np.broadcast_to([0.2, 0.4, 0.6], (32, 32, 3)), atol=1e-6)
    np.testing.assert_allclose(np_(t), 1.0, atol=1e-6)


def test_pinned_property_example_matches_jax():
    """The JAX render-property test's failing example (n=103, seed=1,
    opacity logit 3.0, then +1): the port renders what the reference
    renders, stop rule included, whether or not transmittance is monotone."""
    for opac in (3.0, 4.0):
        g = make_scene(103, seed=1)
        g = g._replace(opacity_logit=jnp.full((103,), opac, jnp.float32))
        cam = make_cam(32, 32)
        gt, ct = to_port(g, cam)
        img, t = TR.render(gt, ct, img_h=32, img_w=32, tile_h=16, tile_w=16, k_per_tile=128)
        img_j, t_j = jax_render(g, cam, img_h=32, img_w=32, tile_h=16, tile_w=16, k_per_tile=128)
        np.testing.assert_allclose(np_(img), np.asarray(img_j), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(np_(t), np.asarray(t_j), atol=ATOL, rtol=RTOL)


def _sequential_composite(splats_t, valid, *, tiles_x, tile_h, tile_w, row_offset):
    """The CUDA kernel's algorithm, written as its per-pixel loop in numpy
    float32: front to back, running T, stop before T would fall below eps."""
    s, v = np_(splats_t), np_(valid)
    t_count, _, k = s.shape
    p = tile_h * tile_w
    out = np.zeros((t_count, 3, p), np.float32)
    tfin = np.ones((t_count, p), np.float32)
    f32 = np.float32
    for ti in range(t_count):
        ty, tx = divmod(ti, tiles_x)
        for pi in range(p):
            yy, xx = divmod(pi, tile_w)
            px = f32(tx * tile_w + xx) + f32(0.5)
            py = f32(ty * tile_h + row_offset + yy) + f32(0.5)
            trans, c = f32(1.0), np.zeros(3, np.float32)
            for i in range(k):
                if not v[ti, i] > 0.5:
                    continue
                mx, my, ca, cb, cc, op = s[ti, :6, i]
                dx, dy = px - mx, py - my
                power = f32(-0.5) * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
                alpha = min(op * f32(np.exp(min(power, f32(0.0)))), f32(tr_ref.ALPHA_MAX))
                if not (power <= 0 and alpha >= f32(tr_ref.ALPHA_MIN)):
                    continue
                t_next = trans * (f32(1.0) - alpha)
                if t_next < f32(tr_ref.T_EPS):
                    break
                c += alpha * trans * s[ti, 6:9, i]
                trans = t_next
            out[ti, :, pi] = c
            tfin[ti, pi] = trans
    return out, tfin


@pytest.mark.parametrize("row_offset", [0, 8])
def test_kernel_algorithm_matches_plain_version(row_offset):
    """Opaque overlapping splats so the stop rule fires inside the list."""
    r = np.random.default_rng(5)
    t_count, k, tiles_x, th, tw = 4, 48, 2, 8, 8
    splats = np.zeros((t_count, 11, k), np.float32)
    splats[:, 0] = r.uniform(0, tiles_x * tw, (t_count, k))
    splats[:, 1] = r.uniform(row_offset, row_offset + 2 * th, (t_count, k))
    splats[:, 2] = r.uniform(0.02, 0.3, (t_count, k))
    splats[:, 3] = r.uniform(-0.01, 0.01, (t_count, k))
    splats[:, 4] = r.uniform(0.02, 0.3, (t_count, k))
    splats[:, 5] = r.uniform(0.3, 0.99, (t_count, k))
    splats[:, 6:9] = r.uniform(0, 1, (t_count, 3, k))
    valid = (r.uniform(size=(t_count, k)) < 0.9).astype(np.float32)
    valid[2:, 3:] = 0.0  # sparse tiles: most pixels there never reach the stop rule
    kw = dict(tiles_x=tiles_x, tile_h=th, tile_w=tw, row_offset=row_offset)
    out_p, t_p = tr_ref.composite_ref(torch.as_tensor(splats), torch.as_tensor(valid), **kw)
    out_s, t_s = _sequential_composite(splats, valid, **kw)
    assert (t_s < 1e-3).any() and (t_s > 0.5).any()  # some pixels stopped early, some did not
    np.testing.assert_allclose(np_(out_p), out_s, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np_(t_p), t_s, atol=1e-5, rtol=1e-4)


def test_cpu_tensors_never_reach_the_kernel():
    pj, pt = _sorted_pair(64, 32, 32)
    idx, valid = TR.build_tile_lists(pt, img_h=32, img_w=32, k_per_tile=64)
    before = tr_ops.launch_count.n
    tr_ops.rasterize_tiles(pt, idx, valid, img_h=32, img_w=32, tile_h=16, tile_w=16, bg=(0.0, 0.0, 0.0))
    assert tr_ops.launch_count.n == before
    slab = pt[idx.long()].transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        tr_ops.composite(slab, valid.float(), tiles_x=2, tile_h=16, tile_w=16)
