"""The reference composites in blocks of whole tile rows
(``reference/step.py`` ``BLOCK_TILES``): at one block its gradients are
bitwise those of compositing the whole frame in one graph; at a frame of
several blocks they agree to 1e-6 of each leaf's norm; and a block's saved
tensors stay under a bound set by the block's size, not the frame's."""
import pytest
import torch

from gsbench.reference import step as RS
from gsbench.scene import FIELDS, make_scene, make_views

SEED = 3_400_000_041
SAVED_FLOATS_A_SLOT = 14  # measured 13.11 distinct float32s a (tile, K slot, pixel)


def _whole_frame_view_grads(p, cam, gt, gs, c, ar, *, scale, grads):
    """The reference's view step compositing the whole frame in one graph."""
    img_h, img_w = gt.shape[0], gt.shape[1]
    packed = RS._project_all(p, cam, c, ar)
    order = torch.sort(packed[:, 9], stable=True).indices
    ps = packed[order].requires_grad_()
    lists = RS.tile_lists(ps.detach(), img_h, img_w, gs, c)
    img = RS.composite(ps, lists, img_w, gs, c, ar)
    ssim_s, l1_s = RS.ssim_l1_sums(img, gt, ar)
    lam = gs["lambda_dssim"]
    (g_sorted,) = torch.autograd.grad(scale * ((1 - lam) * l1_s - 0.5 * lam * ssim_s), ps)
    g_packed = torch.empty_like(g_sorted)
    g_packed[order] = g_sorted
    leaves = {f: p[f].detach().requires_grad_() for f in FIELDS}
    out = RS.project(leaves, cam, c, ar)
    got = torch.autograd.grad(out, [leaves[f] for f in FIELDS], g_packed, allow_unused=True)
    for f, gf in zip(FIELDS, got):
        if gf is not None:
            grads[f] += gf
    return float(ssim_s.detach()), float(l1_s.detach())


@pytest.fixture
def one_thread():
    # the CPU's index_put with accumulate sums duplicates in a thread-dependent order
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(tiny, res):
    cell = tiny("ks4m-train-2048", res=res)
    cfg = cell["config_data"]
    g, _ = make_scene(cfg, SEED, "cpu")
    cams, gt = make_views(cfg, cell["traffic_data"], "cpu")
    return cfg, g, cams, gt


def _both(cfg, g, cams, gt, views, tf32=False):
    gs, c, ar = cfg["gs"], cfg["raster"], RS._Arith(tf32)
    out = []
    for fn in (RS.view_grads, _whole_frame_view_grads):
        grads = {f: torch.zeros_like(g[f]) for f in FIELDS}
        sums = [fn(g, {k: cams[k][v] for k in cams}, gt[v], gs, c, ar, scale=1e-3, grads=grads) for v in views]
        out.append((sums, grads))
    return out


@pytest.mark.parametrize("tf32", [False, True])
def test_one_block_is_bitwise_the_whole_frame(tiny, one_thread, tf32):
    cfg, g, cams, gt = _inputs(tiny, 64)
    assert RS.tile_blocks(64, 64, cfg["gs"]) == [(0, 16)]
    assert RS.tile_blocks(512, 512, cfg["gs"]) == [(0, 1024)]  # every 512-px cell: one block
    (sums, grads), (sums_w, grads_w) = _both(cfg, g, cams, gt, [0, 3], tf32)
    assert sums == sums_w
    for f in FIELDS:
        assert torch.equal(grads[f], grads_w[f]), f


def test_several_blocks_agree_with_the_whole_frame(tiny, monkeypatch):
    cfg, g, cams, gt = _inputs(tiny, 256)
    monkeypatch.setattr(RS, "BLOCK_TILES", 64)
    assert RS.tile_blocks(256, 256, cfg["gs"]) == [(0, 64), (64, 64), (128, 64), (192, 64)]
    # 13 tiles a row: 4 rows a block, 1 row left
    assert RS.tile_blocks(272, 208, cfg["gs"]) == [(0, 52), (52, 52), (104, 52), (156, 52), (208, 13)]
    (sums, grads), (sums_w, grads_w) = _both(cfg, g, cams, gt, [1, 6])
    for (s, l1), (s_w, l1_w) in zip(sums, sums_w):
        assert s == pytest.approx(s_w, rel=1e-6) and l1 == pytest.approx(l1_w, rel=1e-6)
    for f in FIELDS:
        ref = float(torch.linalg.norm(grads_w[f].double()))
        assert ref > 0, f
        assert float(torch.linalg.norm((grads[f] - grads_w[f]).double())) <= 1e-6 * ref, f


def test_a_blocks_saved_tensors_are_bounded_by_its_size(tiny, monkeypatch):
    """Saved tensors counted by distinct storage, as autograd keeps them: a
    block of 1,024 tiles at K 256 holds 14 x 4 B x 1,024 x 256 x 256 =
    3.76 GB or less, where the 2048-px frame in one graph held ~57 GB."""
    cfg, g, cams, gt = _inputs(tiny, 256)
    monkeypatch.setattr(RS, "BLOCK_TILES", 64)
    k, pixels = cfg["gs"]["k_per_tile"], cfg["gs"]["tile_h"] * cfg["gs"]["tile_w"]
    calls, composite = [], RS.composite

    def counted(ps, lists, *a, **kw):
        seen = {}

        def pack(t):
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = composite(ps, lists, *a, **kw)
        calls.append((lists.shape[0], sum(seen.values()), ps.untyped_storage().nbytes()))
        return out

    monkeypatch.setattr(RS, "composite", counted)
    grads = {f: torch.zeros_like(g[f]) for f in FIELDS}
    RS.view_grads(g, {kk: cams[kk][2] for kk in cams}, gt[2], cfg["gs"], cfg["raster"], RS._Arith(False), scale=1.0,
                  grads=grads)
    with_graph = [(n, b, ps_b) for n, b, ps_b in calls if b > 0]
    assert [n for n, _, _ in calls] == [64] * 8 and len(with_graph) == 4  # no graph, then a graph a block
    for n, b, ps_b in with_graph:
        assert b <= SAVED_FLOATS_A_SLOT * 4 * n * k * pixels + ps_b
    calls.clear()
    monkeypatch.setattr(RS, "BLOCK_TILES", 1024)
    RS.view_grads(g, {kk: cams[kk][2] for kk in cams}, gt[2], cfg["gs"], cfg["raster"], RS._Arith(False), scale=1.0,
                  grads=grads)
    whole = max(b for _, b, _ in calls)
    assert whole >= 3.9 * max(b for _, b, _ in with_graph)
