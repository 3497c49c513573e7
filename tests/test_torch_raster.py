"""PyTorch port, binning and compositing: tile lists (flat and hierarchical,
with row offsets) equal to the JAX package's entry for entry; the port's
rasterizer (plain version on the CPU) against the JAX oracle and the JAX
Pallas rasterizer in interpret mode over the JAX kernel tests' shape sweep;
the CUDA kernel's per-pixel algorithm (chunks of splats evaluated ahead of a
sequential transmittance chain with early exit) against the plain version; the
input gather's plain path bitwise the autograd of the two gathers it replaced,
and its CUDA transpose's algorithm (valid slots only, a stable sort, run sums)
bitwise the slot-order sum over every slot. The kernels themselves are held to
the plain versions in tests/test_torch_gpu.py, on the card."""
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


KERNEL_CHUNK = 8  # tile_raster.cu's kChunk: splats evaluated ahead of the chain


def _sequential_composite(splats_t, valid, *, tiles_x, tile_h, tile_w, row_offset):
    """The CUDA forward kernel's algorithm in float32 numpy, vectorized over
    (tile, pixel): the list in chunks of KERNEL_CHUNK splats; for each chunk,
    every splat's alpha first, with no branch (a dead splat gets alpha 0),
    then the chain in list order: T * (1 - alpha), the stop rule (a live
    splat is composited iff T after it stays >= eps), the colour and T as
    selects.
    Returns (rgb (T,3,P), t_final (T,P), n_contrib (T,P): one past the last
    composited slot with alpha > 0)."""
    s, v = np_(splats_t), np_(valid)
    f32 = np.float32
    t_count, _, k = s.shape
    pid, tid = np.arange(tile_h * tile_w), np.arange(t_count)
    px = ((tid[:, None] % tiles_x) * tile_w + pid[None] % tile_w).astype(f32) + f32(0.5)
    py = ((tid[:, None] // tiles_x) * tile_h + row_offset + pid[None] // tile_w).astype(f32) + f32(0.5)
    trans = np.ones(px.shape, f32)
    rgb = np.zeros((3, *px.shape), f32)
    n_contrib = np.zeros(px.shape, np.int32)
    done = np.zeros(px.shape, bool)
    for c0 in range(0, k, KERNEL_CHUNK):
        ahead = []
        for i in range(c0, min(c0 + KERNEL_CHUNK, k)):
            mx, my, ca, cb, cc, op = (s[:, f, i, None] for f in range(6))
            dx, dy = px - mx, py - my
            power = f32(-0.5) * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            alpha = np.minimum(op * np.exp(np.minimum(power, f32(0.0))), f32(tr_ref.ALPHA_MAX))
            live = (v[:, i, None] > 0.5) & (power <= 0) & (alpha >= f32(tr_ref.ALPHA_MIN))
            ahead.append((i, np.where(live, alpha, f32(0.0))))
        for i, alpha in ahead:
            t_next = trans * (f32(1.0) - alpha)
            take = ~done & (alpha > 0) & (t_next >= f32(tr_ref.T_EPS))
            done |= ~(t_next >= f32(tr_ref.T_EPS))
            w = alpha * trans
            rgb = np.where(take, rgb + w * s[:, 6:9, i, None].transpose(1, 0, 2), rgb)
            trans = np.where(take, t_next, trans)
            n_contrib = np.where(take, i + 1, n_contrib)
    return rgb.transpose(1, 0, 2), trans, n_contrib


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
    out_s, t_s, nc_s = _sequential_composite(splats, valid, **kw)
    assert (t_s < 1e-3).any() and (t_s > 0.5).any()  # some pixels stopped early, some did not
    np.testing.assert_allclose(np_(out_p), out_s, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np_(t_p), t_s, atol=ATOL, rtol=RTOL)
    want_nc = tr_ref.contrib_counts(torch.as_tensor(splats), torch.as_tensor(valid), **kw)
    np.testing.assert_array_equal(nc_s, np_(want_nc))


def test_cpu_tensors_never_reach_the_kernel():
    pj, pt = _sorted_pair(64, 32, 32)
    idx, valid = TR.build_tile_lists(pt, img_h=32, img_w=32, k_per_tile=64)
    before = (tr_ops.launch_count.n, tr_ops.slab_launch_count.n, tr_ops.slab_bwd_launch_count.n)
    leaf = pt.clone().requires_grad_()
    img, _ = tr_ops.rasterize_tiles(leaf, idx, valid, img_h=32, img_w=32, tile_h=16, tile_w=16, bg=(0.0, 0.0, 0.0))
    img.sum().backward()
    assert (tr_ops.launch_count.n, tr_ops.slab_launch_count.n, tr_ops.slab_bwd_launch_count.n) == before
    slab = pt[idx.long()].transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        tr_ops.composite(slab, valid.float(), tiles_x=2, tile_h=16, tile_w=16)
    with pytest.raises(ValueError, match="CUDA"):
        tr_ops.gather_slab(pt, idx)
    with pytest.raises(ValueError, match="CUDA"):
        tr_ops.gather_slab_bwd(slab, valid, idx, None, pt.shape[0])


def _parent_gather_grad(packed, idx, valid, order, kw):
    """d(packed) of a loss through the rasterizer as the port built it before
    the input gather was a Function: autograd of ``packed[order][idx]`` and
    its transpose copy (``index_put(accumulate=True)`` backward)."""
    leaf = packed.detach().clone().requires_grad_()
    sorted_ = leaf if order is None else leaf[order]
    splats_t = sorted_[idx.long()].transpose(1, 2).contiguous()
    raw, tfin = tr_ops.Composite.apply(splats_t, valid.float().contiguous(), kw["img_w"] // 16, 16, 16,
                                       kw.get("row_offset", 0))
    (raw.square().sum() + tfin.sum()).backward()
    return leaf.grad, splats_t.detach()


@pytest.mark.parametrize("binning,row_offset", [("flat", 0), ("hier", 0), ("hier", 32)])
@pytest.mark.parametrize("through_order", [False, True])
def test_input_gather_gradient_is_the_plain_autograd(binning, row_offset, through_order):
    """The plain path of ``GatherSlab`` (the CPU's): its slab and d(packed)
    equal, bit for bit, autograd of the two gathers the rasterizer wrapper
    ran before it was a Function, from the sorted splats or from the unsorted
    ones through the depth order. One torch thread: the CPU's accumulate
    sums a row's duplicates in a thread-dependent order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_input_gather_gradient(binning, row_offset, through_order)
    finally:
        torch.set_num_threads(threads)


def _check_input_gather_gradient(binning, row_offset, through_order):
    pj, pt = _sorted_pair(300, 64, 64, seed=23)
    unsorted = pt[torch.randperm(pt.shape[0], generator=torch.Generator().manual_seed(23))]
    sorted_, order = TP.sort_by_depth(unsorted)
    kw = dict(img_h=64, img_w=64, tile_h=16, tile_w=16, k_per_tile=64, row_offset=row_offset)
    idx, valid = TR.bin_tiles(sorted_, **kw, binning=binning)
    assert not bool(valid.all()) and bool(valid.any())  # padding and valid slots both
    src, order_ = (unsorted, order) if through_order else (sorted_, None)
    leaf = src.clone().requires_grad_()
    slab = tr_ops.GatherSlab.apply(leaf, idx, valid, order_)
    raw, tfin = tr_ops.Composite.apply(slab, valid.float().contiguous(), 4, 16, 16, row_offset)
    (raw.square().sum() + tfin.sum()).backward()
    want, want_slab = _parent_gather_grad(src, idx, valid, order_, kw)
    assert torch.equal(slab.detach(), want_slab)
    assert torch.equal(leaf.grad, want)
    assert bool((leaf.grad[:, 9:] == 0).all()) and bool(leaf.grad.abs().sum() > 0)


def _valid_run_sums(dslab, valid, idx, order, n):
    """``slab_gather.cu``'s backward in numpy: keys (the row of each valid
    slot, n for padding), a stable sort, each run summed in float32 in slot
    order from 0; depth and radius left 0."""
    rows = idx.long() if order is None else order[idx.long()]
    keys = torch.where(valid, rows, torch.full_like(rows, n)).reshape(-1).numpy()
    pos = np.argsort(keys, kind="stable")
    g = dslab.permute(0, 2, 1).reshape(-1, 11).numpy()  # (T*K, 11), slot order
    out = np.zeros((n, 11), np.float32)
    runs = {}
    for j in pos:
        if keys[j] < n:
            runs.setdefault(int(keys[j]), []).append(int(j))
    for r, slots in runs.items():
        assert slots == sorted(slots)  # the stable sort keeps slot order
        acc = np.zeros(9, np.float32)
        for j in slots:
            acc = (acc + g[j, :9]).astype(np.float32)
        out[r, :9] = acc
    return torch.from_numpy(out), max(len(v) for v in runs.values())


def _slot_order_fold(dslab, keys, n):
    """Every slot's gradient added into row ``keys[slot]`` in ascending slot
    order from 0, in float32 (what PyTorch's CUDA accumulate computes after
    its stable sort); key n drops a slot."""
    out = np.zeros((n + 1, 11), np.float32)
    np.add.at(out, keys.reshape(-1).numpy(), dslab.permute(0, 2, 1).reshape(-1, 11).numpy())
    return torch.from_numpy(out[:n])


@pytest.mark.parametrize("binning", ["flat", "hier"])
def test_transpose_over_valid_slots_equals_the_sum_with_padding(binning):
    """The CUDA transpose's algorithm (``_valid_run_sums``) against the
    slot-order sum over every slot, padding included, as the CUDA autograd
    of the gathers takes it: the compositor's backward gives the padding
    exact zeros, so dropping them changes no bit, while the padding makes one
    row's run far longer than any run of valid slots. The CPU's autograd
    sums in another order: equal to float32 rounding."""
    pj, pt = _sorted_pair(300, 64, 128, seed=29)
    n = pt.shape[0]
    unsorted = pt[torch.randperm(n, generator=torch.Generator().manual_seed(29))]
    sorted_, order = TP.sort_by_depth(unsorted)
    kw = dict(img_h=64, img_w=128, tile_h=16, tile_w=16, k_per_tile=128)
    idx, valid = TR.bin_tiles(sorted_, **kw, binning=binning)
    slab = tr_ref.gather_slab_ref(unsorted, idx, order)
    vf = valid.float().contiguous()
    out, tfin = tr_ref.composite_ref(slab, vf, tiles_x=8, tile_h=16, tile_w=16)
    dslab = tr_ref.composite_bwd_ref(slab, vf, 2 * out, torch.ones_like(tfin), tiles_x=8, tile_h=16, tile_w=16)
    assert bool((dslab.permute(0, 2, 1)[~valid] == 0).all())  # padding: exact zeros
    rows = order[idx.long()]
    got, longest = _valid_run_sums(dslab, valid, idx, order, n)
    assert torch.equal(got, _slot_order_fold(dslab, rows, n))
    assert torch.equal(got, _slot_order_fold(dslab, torch.where(valid, rows, torch.full_like(rows, n)), n))
    scale = float(got.abs().max())
    np.testing.assert_allclose(np_(got), np_(tr_ref.gather_slab_bwd_ref(dslab, idx, order, n)), rtol=1e-5,
                               atol=1e-6 * scale)
    assert longest < int(torch.bincount(rows.reshape(-1)).max())
