"""PyTorch port, on the card: each hand-written CUDA kernel against its plain
PyTorch version, the serving path through the forward kernels (in process
and through the network frontend's gateway), a train
step through the three splatting kernels against the same step on the CPU,
the sharded train step on a world-1 NCCL mesh bitwise against the
one-device step (and across cards where there are two or more), the mesh
render server on a world-1 NCCL mesh (and on (2, 1) across cards) bitwise
against the one-device server, the LM prefill step through the
attention kernel against the CPU (the dense decoders, the SSM hybrid,
xLSTM, whisper and the VLM; the kernel at head width 112 too),
``moe_apply`` and a remat train step
(dense and MoE) against the CPU, and a small in situ run (the warm-start
trainer over two timesteps) against the CPU and, on a world-1 NCCL mesh,
bitwise against one device.

Every test here needs a CUDA device and skips without one (the decision is
made inside the ``cuda_device`` fixture, so every xdist worker collects the
same tests). The machine with the card has no JAX, so this file imports
only torch, numpy and the port, and makes its inputs with numpy from a seed;
the JAX parity of the plain versions is held by the other
``tests/test_torch_*.py`` files on a CPU host. Run it on the card with

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import gaussians as G
from repro_torch.core import projection as P
from repro_torch.core import render as R
from repro_torch.core.config import GSConfig
from repro_torch.core.densify import densify_and_rebalance
from repro_torch.core.train import (
    init_state,
    make_batched_eval_render,
    make_tile_row_render,
    make_train_step,
    shard_state,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.configs import get_arch
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gsproject import ops as gp_ops
from repro_torch.kernels.gsproject.ref import project_ref
from repro_torch.kernels.tile_raster import ops as tr_ops
from repro_torch.kernels.tile_raster.ref import composite_bwd_ref, composite_ref, composited_counts, contrib_counts
from repro_torch.launch.mesh import init_ranks, make_gs_mesh
from repro_torch.models import api, lm, moe
from repro_torch.models.params import tree_to
from repro_torch.serve_gs import RenderServer, make_clients, run_load, stack_cameras
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(2)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda", 0)


def _scene(n, seed, spread=0.5, scale=0.05):
    """numpy-made host model (the conftest scene's recipe, without JAX)."""
    r = np.random.default_rng(seed)
    pts = r.normal(0, spread, (n, 3)).astype(np.float32)
    cols = r.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    g = G.to_numpy(G.init_from_points(pts, cols, init_scale=scale, device="cpu"))
    return g._replace(
        log_scales=(g.log_scales + r.normal(0, 0.3, (n, 3))).astype(np.float32),
        quats=r.normal(0, 1, (n, 4)).astype(np.float32),
        opacity_logit=r.normal(0.5, 0.5, (n,)).astype(np.float32),
    )


def _cam(h, w, dist=3.0):
    f = w * 1.2
    return P.look_at_camera([0, 0, -dist], [0, 0, 0], [0, 1, 0], f, f, w / 2, h / 2)


def _assert_packed_close(got, want, atol=2e-5, rtol=2e-5):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, rtol=rtol)


def test_kernel_library_builds_and_loads(cuda_device):
    build = _lib.build_library()
    assert build.path.exists()
    lib = _lib.library()
    assert lib.gsproject_fwd and lib.tile_raster_fwd and lib.tile_raster_bwd and lib.flash_attention_fwd
    assert lib.slab_gather_fwd and lib.slab_bwd and lib.slab_bwd_scratch_bytes
    fwd_ctas, bwd_ctas, fwd_threads, bwd_threads = tr_ops.occupancy(16, 16)
    assert (fwd_threads, bwd_threads) == (128, 256)  # two pixels a thread forward, one backward
    assert fwd_ctas >= 4 and bwd_ctas >= 4


@pytest.mark.parametrize("n", [1000, 4096, 100_003])
def test_gsproject_kernel_matches_plain(cuda_device, n):
    g = G.from_numpy(_scene(n, seed=n, spread=1.5), cuda_device)
    cam = _cam(64, 64, dist=2.0)
    before = gp_ops.launch_count.n
    got = P.project(g, cam)
    torch.cuda.synchronize()
    assert gp_ops.launch_count.n == before + 1
    _assert_packed_close(got, project_ref(g, cam))
    _assert_packed_close(got, project_ref(G.from_numpy(_scene(n, seed=n, spread=1.5), "cpu"), cam))


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("n", [1000, 100_003])
def test_gsproject_kernel_matches_plain_at_higher_sh(cuda_device, degree, n):
    """SH degrees 1-3: every field of the kernel's rows against the plain
    version on the card, and the view-dependent colors against the plain
    version on the CPU too (the radius' ceil may flip across devices, whose
    exp and sqrt round differently); two launches bitwise equal."""
    g = _scene(n, seed=n + degree, spread=1.5)
    g = g._replace(sh=np.random.default_rng(degree).normal(0, 0.5, (n, (degree + 1) ** 2, 3)).astype(np.float32))
    gd = G.from_numpy(g, cuda_device)
    cam = _cam(64, 64, dist=2.0)
    before = gp_ops.launch_count.n
    got = P.project(gd, cam)
    again = P.project(gd, cam)
    torch.cuda.synchronize()
    assert gp_ops.launch_count.n == before + 2
    assert torch.equal(got, again)
    _assert_packed_close(got, project_ref(gd, cam))
    _assert_packed_close(got[:, P.CR:P.CB_ + 1], project_ref(G.from_numpy(g, "cpu"), cam)[:, P.CR:P.CB_ + 1])


def _det2d(g, cam, blur: float, near: float = 0.01) -> torch.Tensor:
    """Each Gaussian's 2D covariance determinant before the projection's
    clamp at 1e-12, in float64 on the CPU (matrix form)."""
    g = G.GaussianModel(*[x.detach().cpu().double() for x in g])
    vm = torch.as_tensor(cam.viewmat, dtype=torch.float64)
    p = g.means @ vm[:3, :3].T + vm[:3, 3]
    z = torch.where(p[:, 2] > near, p[:, 2], torch.ones_like(p[:, 2]))
    fx, fy, zero = float(cam.fx), float(cam.fy), torch.zeros_like(z)
    j = torch.stack([torch.stack([fx / z, zero, -fx * p[:, 0] / z**2], -1),
                     torch.stack([zero, fy / z, -fy * p[:, 1] / z**2], -1)], 1)
    jw = j @ vm[:3, :3]
    return torch.linalg.det(jw @ G.covariance3d(g) @ jw.transpose(1, 2) + blur * torch.eye(2, dtype=torch.float64))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1000, 100_003])
def test_gsproject_backward_kernel_matches_plain_vjp(cuda_device, degree, n):
    """The backward kernel's five gradients against ``torch.autograd.grad``
    of ``project_ref`` on the card, for a random (N, 11) splat gradient
    nonzero in every column (depth and radius too), on a scene with
    Gaussians behind the near plane, colors outside [0, 1] before the clamp
    and, at blur 0, tiny anisotropic Gaussians whose 2D determinant hits
    the clamp at 1e-12; the training path's blur 0.3 too. Two launches are
    bitwise equal, and each call counts one launch."""
    r = np.random.default_rng(degree)
    host = _scene(n, seed=n + degree, spread=1.5)
    log_scales = host.log_scales.copy()
    log_scales[: n // 20] = r.normal(-20.0, 1.0, (n // 20, 3))
    host = host._replace(log_scales=log_scales.astype(np.float32),
                         sh=r.normal(0, 1.0, (n, (degree + 1) ** 2, 3)).astype(np.float32))
    g = G.from_numpy(host, cuda_device)
    cam = _cam(64, 64, dist=2.0)
    gpacked = torch.tensor(r.normal(0, 1, (n, 11)), dtype=torch.float32, device=cuda_device)
    for blur in (0.3, 0.0):
        leaves = [x.detach().clone().requires_grad_() for x in g]
        packed = P.project(G.GaussianModel(*leaves), cam, blur=blur)
        colors = packed[:, P.CR:P.CB_ + 1]
        assert (~torch.isfinite(packed[:, P.DEPTH])).any() and ((colors == 0) | (colors == 1)).any()
        assert (_det2d(g, cam, blur) < 1e-12).any() == (blur == 0.0)
        before = gp_ops.bwd_launch_count.n
        got = torch.autograd.grad(packed, leaves, gpacked)
        again = gp_ops.launch_bwd(G.GaussianModel(*leaves), gp_ops.cam_vector(cam), gpacked, blur=blur)
        torch.cuda.synchronize()
        assert gp_ops.bwd_launch_count.n == before + 2
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        plain = [x.detach().clone().requires_grad_() for x in g]
        want = torch.autograd.grad(project_ref(G.GaussianModel(*plain), cam, blur=blur), plain, gpacked)
        for name, a, b in zip(G.GaussianModel._fields, got, want):
            assert a.shape == b.shape and torch.isfinite(a).all(), name
            scale = float(b.abs().max())
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=2e-5 * scale, rtol=2e-4,
                                       err_msg=f"{name}, blur {blur}")


def test_gsproject_kernel_refuses_higher_sh(cuda_device):
    g = _scene(64, seed=3)
    g = g._replace(sh=np.zeros((64, 25, 3), np.float32))
    with pytest.raises(NotImplementedError, match="SH degree 4"):
        P.project(G.from_numpy(g, cuda_device), _cam(32, 32))


# the rasterizer forward's tolerance: the JAX package's own
# (tests/test_tile_raster_kernel.py), on every pixel and channel
RASTER_ATOL, RASTER_RTOL = 3e-6, 1e-5
# the JAX rasterizer tests' shape sweep: (n_gauss, H, W, tile_h, tile_w, K)
SWEEP = [
    (64, 32, 32, 16, 16, 64),
    (200, 64, 64, 16, 16, 128),
    (200, 48, 96, 16, 32, 256),
    (500, 64, 64, 8, 16, 512),
    (37, 32, 32, 16, 16, 64),
]


@pytest.mark.parametrize("n,h,w,th,tw,k", SWEEP)
def test_tile_raster_kernel_matches_plain(cuda_device, n, h, w, th, tw, k):
    host = _scene(n, seed=n)
    cam = _cam(h, w)
    kw = dict(img_h=h, img_w=w, tile_h=th, tile_w=tw, k_per_tile=k)
    before = tr_ops.launch_count.n
    img, t = R.render(G.from_numpy(host, cuda_device), cam, **kw)
    torch.cuda.synchronize()
    assert tr_ops.launch_count.n == before + 1
    img_c, t_c = R.render(G.from_numpy(host, "cpu"), cam, **kw)
    np.testing.assert_allclose(img.cpu().numpy(), img_c.numpy(), atol=RASTER_ATOL, rtol=RASTER_RTOL)
    np.testing.assert_allclose(t.cpu().numpy(), t_c.numpy(), atol=RASTER_ATOL, rtol=RASTER_RTOL)


@pytest.mark.parametrize("row_offset", [0, 48])
def test_composite_kernel_matches_plain_on_random_slabs(cuda_device, row_offset):
    r = np.random.default_rng(row_offset)
    t_count, k, tiles_x, th, tw = 8, 300, 4, 16, 16
    s = np.zeros((t_count, 11, k), np.float32)
    s[:, 0] = r.uniform(0, tiles_x * tw, (t_count, k))
    s[:, 1] = r.uniform(row_offset, row_offset + 2 * th, (t_count, k))
    s[:, 2] = r.uniform(0.01, 0.2, (t_count, k))
    s[:, 3] = r.uniform(-0.01, 0.01, (t_count, k))
    s[:, 4] = r.uniform(0.01, 0.2, (t_count, k))
    s[:, 5] = r.uniform(0.05, 0.99, (t_count, k))
    s[:, 6:9] = r.uniform(0, 1, (t_count, 3, k))
    valid = (r.uniform(size=(t_count, k)) < 0.8).astype(np.float32)
    valid[4:, 5:] = 0.0
    valid[6] = 0.0            # an empty tile: nothing staged or walked
    valid[7, :-1] = 0.0       # only the last slot valid: the walk spans the whole list
    kw = dict(tiles_x=tiles_x, tile_h=th, tile_w=tw, row_offset=row_offset)
    st, vt = torch.tensor(s, device=cuda_device), torch.tensor(valid, device=cuda_device)
    out_k, t_k, _ = tr_ops.composite(st, vt, **kw)
    out_p, t_p = composite_ref(st, vt, **kw)
    np.testing.assert_allclose(out_k.cpu().numpy(), out_p.cpu().numpy(), atol=RASTER_ATOL, rtol=RASTER_RTOL)
    np.testing.assert_allclose(t_k.cpu().numpy(), t_p.cpu().numpy(), atol=RASTER_ATOL, rtol=RASTER_RTOL)


def test_strip_bitwise_equals_full_frame_on_card(cuda_device):
    g = G.from_numpy(_scene(20_000, seed=5, scale=0.02), cuda_device)
    cfg = GSConfig(img_h=256, img_w=256, k_per_tile=64)  # 256 tiles: hierarchical binning
    cam = _cam(256, 256, dist=2.5)
    full = make_batched_eval_render(cfg)(g, stack_cameras([cam]))[0]
    for row in (0, 7, 15):
        strip = make_tile_row_render(cfg, row=row)(g, cam)
        assert torch.equal(strip, full[row * 16 : (row + 1) * 16])


def test_server_on_card_goes_through_both_kernels(cuda_device):
    host = _scene(2000, seed=1, scale=0.03)
    cfg = GSConfig(img_h=64, img_w=64, k_per_tile=64)
    before = (gp_ops.launch_count.n, tr_ops.launch_count.n)
    frames = {}
    for dev in (cuda_device, "cpu"):
        with RenderServer(host, cfg, device=dev, n_levels=2, frames_capacity=64) as s:
            rep = run_load(s, make_clients(3, n_views=6, img_h=64, img_w=64, radius_spread=1.0),
                           requests_per_client=2)
            assert rep["completed"] == 6
            frames[str(dev)] = [s.frames[k] for k in sorted(s.frames)]
    assert gp_ops.launch_count.n > before[0] and tr_ops.launch_count.n > before[1]
    for a, b in zip(frames[str(cuda_device)], frames["cpu"]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


def test_gateway_on_card_serves_the_in_process_frames_through_both_kernels(cuda_device):
    """The frontend over TCP with the shared server on the card (the engine
    driven from the gateway's render thread): a static stream and a
    two-step timeline, tiles8 negotiated; every frame bitwise
    ``quantize_rgb8`` of the in-process card frame, nothing shed or failed,
    and both forward kernels launched during the network run."""
    from repro_torch.frontend import FrontendClient, Gateway, GatewayThread, SessionManager, quantize_rgb8
    from repro_torch.launch.frontend import synthetic_timeline

    host = _scene(2000, seed=1, scale=0.03)
    timeline = synthetic_timeline(G.from_numpy(host, "cpu"), 2)
    cfg = GSConfig(img_h=64, img_w=64, k_per_tile=64)
    kw = dict(n_levels=1, max_batch=4, store_frames=False)
    mgr = SessionManager(cfg, device=cuda_device, **kw)
    mgr.register_static("static", host)
    mgr.register_timeline("timeline", timeline)
    mgr.warmup()
    cams = [_cam(64, 64, dist=2.0 + 0.25 * i) for i in range(3)]
    before = (gp_ops.launch_count.n, tr_ops.launch_count.n)
    with GatewayThread(Gateway(mgr, port=0)) as gt:
        with FrontendClient("127.0.0.1", gt.port, timeout=60.0) as cl:
            got = {"static": [cl.render("static", c) for c in cams],
                   "timeline": [cl.render("timeline", c, timestep=1) for c in cams]}
            stats = cl.stats()["gateway"]
    launches = (gp_ops.launch_count.n - before[0], tr_ops.launch_count.n - before[1])
    assert launches[0] > 0 and launches[1] > 0, launches
    assert stats["frames_sent"] == 6 and stats["shed"] == 0
    assert stats["protocol_errors"] == stats["request_errors"] == stats["engine_errors"] == 0
    for name, params in (("static", host), ("timeline", timeline[1])):
        with RenderServer(params, cfg, device=cuda_device, **kw) as srv:
            futs = [srv.submit(c) for c in cams]
            srv.run()
            for a, f in zip(got[name], futs):
                np.testing.assert_array_equal(a, quantize_rgb8(f.result()))


def _bwd_inputs(seed, t_count, k, tiles_x, th, tw, row_offset):
    """Random slabs that overlap their tiles, and random cotangents."""
    r = np.random.default_rng(seed)
    s = np.zeros((t_count, 11, k), np.float32)
    ty, tx = np.arange(t_count) // tiles_x, np.arange(t_count) % tiles_x
    s[:, 0] = tx[:, None] * tw + r.uniform(-4, tw + 4, (t_count, k))
    s[:, 1] = ty[:, None] * th + row_offset + r.uniform(-4, th + 4, (t_count, k))
    s[:, 2] = r.uniform(0.02, 0.3, (t_count, k))
    s[:, 3] = r.uniform(-0.02, 0.02, (t_count, k))
    s[:, 4] = r.uniform(0.02, 0.3, (t_count, k))
    s[:, 5] = r.uniform(0.05, 1.0, (t_count, k))  # some reach the 0.99 clamp
    s[:, 6:9] = r.uniform(0, 1, (t_count, 3, k))
    valid = (r.uniform(size=(t_count, k)) < 0.85).astype(np.float32)
    valid[t_count // 2:, k // 3:] = 0.0
    valid[-1] = 0.0  # an empty tile
    p = th * tw
    gout = r.normal(size=(t_count, 3, p)).astype(np.float32)
    gtfin = r.normal(size=(t_count, p)).astype(np.float32)
    return s, valid, gout, gtfin


# (tiles, K, tiles_x, tile_h, tile_w, row_offset): the main path's 16x16
# tiles, tiles of 512 and 1,024 pixels (the slots go in chunks of 128 and 64),
# a tile of 35 pixels (a part-filled last warp), and a strip's row offset
BWD_CASES = [
    (8, 300, 4, 16, 16, 0),
    (8, 256, 4, 16, 16, 48),
    (6, 200, 3, 16, 32, 0),
    (4, 160, 2, 32, 32, 0),
    (6, 96, 3, 5, 7, 10),
]


@pytest.mark.parametrize("t_count,k,tiles_x,th,tw,row_offset", BWD_CASES)
def test_composite_bwd_kernel_matches_plain(cuda_device, t_count, k, tiles_x, th, tw, row_offset):
    s, valid, gout, gtfin = _bwd_inputs(t_count + k, t_count, k, tiles_x, th, tw, row_offset)
    kw = dict(tiles_x=tiles_x, tile_h=th, tile_w=tw, row_offset=row_offset)
    args = [torch.tensor(x, device=cuda_device) for x in (s, valid, gout, gtfin)]
    _, tfin, n_contrib = tr_ops.composite(args[0], args[1], **kw)  # the forward's residuals
    before = tr_ops.bwd_launch_count.n
    got = tr_ops.composite_bwd(*args, tfin, n_contrib, **kw)
    torch.cuda.synchronize()
    assert tr_ops.bwd_launch_count.n == before + 1
    want = composite_bwd_ref(*args, **kw)
    want_cpu = composite_bwd_ref(*[torch.tensor(x) for x in (s, valid, gout, gtfin)], **kw)
    scale = float(want.abs().max())
    # the reference's own gradient tolerance (tests/test_tile_raster_kernel.py)
    for w in (want.cpu().numpy(), want_cpu.numpy()):
        np.testing.assert_allclose(got.cpu().numpy(), w, atol=2e-5 * scale, rtol=2e-4)
    assert not got[:, 9:].any()
    assert got[-1].abs().max() == 0  # the empty tile
    again = tr_ops.composite_bwd(*args, tfin, n_contrib, **kw)
    assert torch.equal(again, got)  # no atomics: the slab is deterministic


def _dense_slab(seed, tiles_x, tiles_y, th, tw, k, row_offset=0):
    """The view an isosurface fills, at a test's size: every slot valid, each
    mean inside its tile, footprints (sigma 10-20 px) that cover the tile,
    opacities 0.02-0.08 (a 16x16 tile's median pixel composites ~216 splats
    before the 1e-4 stop), and random cotangents."""
    r = np.random.default_rng(seed)
    t_count = tiles_x * tiles_y
    ty, tx = np.arange(t_count) // tiles_x, np.arange(t_count) % tiles_x
    s = np.zeros((t_count, 11, k), np.float32)
    s[:, 0] = tx[:, None] * tw + r.uniform(0, tw, (t_count, k))
    s[:, 1] = ty[:, None] * th + row_offset + r.uniform(0, th, (t_count, k))
    sx, sy = r.uniform(10, 20, (t_count, k)), r.uniform(10, 20, (t_count, k))
    s[:, 2] = 1 / (sx * sx)
    s[:, 3] = r.uniform(-0.3, 0.3, (t_count, k)) / (sx * sy)
    s[:, 4] = 1 / (sy * sy)
    s[:, 5] = r.uniform(0.02, 0.08, (t_count, k))
    s[:, 6:9] = r.uniform(0, 1, (t_count, 3, k))
    s[:, 9] = np.arange(k) + 1.0
    s[:, 10] = 3 * np.maximum(sx, sy)
    p = th * tw
    gout = r.normal(size=(t_count, 3, p)).astype(np.float32)
    gtfin = r.normal(size=(t_count, p)).astype(np.float32)
    return s, np.ones((t_count, k), np.float32), gout, gtfin


# (tile_h, tile_w, K): the paper config's 16x16 tiles at its K, 8x8 and
# 32x32 (1,024 pixels, the most a CTA takes), 5x7 (35 pixels, not a multiple
# of 32), and a K that is not a multiple of 4 (cp.async staging instead of
# bulk copies)
DENSE_CASES = [(16, 16, 256), (8, 8, 256), (32, 32, 256), (5, 7, 256), (16, 16, 150)]


@pytest.mark.parametrize("th,tw,k", DENSE_CASES)
def test_tile_raster_kernels_on_a_dense_slab(cuda_device, th, tw, k):
    """Both kernels on tiles whose every slot is valid: the forward at the
    North star's tolerance on every pixel, its n_contrib equal to the plain
    version's, the backward fed the forward's residuals at the gradient
    tolerance, and two launches of each bitwise equal."""
    s, valid, gout, gtfin = _dense_slab(th * tw + k, 2, 2, th, tw, k)
    kw = dict(tiles_x=2, tile_h=th, tile_w=tw, row_offset=0)
    st, vt, go, gt = (torch.tensor(x, device=cuda_device) for x in (s, valid, gout, gtfin))
    out, tfin, n_contrib = tr_ops.composite(st, vt, **kw)
    out_p, t_p = composite_ref(st, vt, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), out_p.cpu().numpy(), atol=RASTER_ATOL, rtol=RASTER_RTOL)
    np.testing.assert_allclose(tfin.cpu().numpy(), t_p.cpu().numpy(), atol=RASTER_ATOL, rtol=RASTER_RTOL)
    assert torch.equal(n_contrib, contrib_counts(st, vt, **kw))
    if (th, tw) == (16, 16):  # dense indeed: the median pixel composites more than half the list
        assert float(composited_counts(st, vt, **kw).float().median()) >= k / 2
    again = tr_ops.composite(st, vt, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, (out, tfin, n_contrib)))
    got = tr_ops.composite_bwd(st, vt, go, gt, tfin, n_contrib, **kw)
    want = composite_bwd_ref(st, vt, go, gt, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5 * float(want.abs().max()),
                               rtol=2e-4)
    assert not got[:, 9:].any()
    assert torch.equal(tr_ops.composite_bwd(st, vt, go, gt, tfin, n_contrib, **kw), got)


@pytest.mark.parametrize("k", [256, 150])
def test_dead_and_invalid_splats_never_reach_the_output(cuda_device, k):
    """The kernels evaluate a chunk of splats ahead of the transmittance
    chain: a dead splat (valid, but alpha < 1/255) or an invalid slot must
    leave T, the colour and every gradient as they are whatever its fields
    hold. NaN in those fields gives the same bits as zeros there; the lists
    end at ragged slots (the last batch's chunk then runs past its copy)."""
    s, valid, gout, gtfin = _dense_slab(11 + k, 2, 2, 16, 16, k)
    valid[0, 129:] = 0.0  # ragged ends: 129, 130, 131 and 133 valid slots
    valid[1, 130:] = 0.0
    valid[2, 131:] = 0.0
    valid[3, 133:] = 0.0
    r = np.random.default_rng(k)
    invalid = r.uniform(size=valid.shape) < 0.1
    valid[invalid] = 0.0
    dead = (r.uniform(size=valid.shape) < 0.1) & (valid > 0.5)
    s[:, 5][dead] = 1e-4  # opacity: alpha < 1/255 everywhere
    clean, poisoned = s.copy(), s.copy()
    clean[:, 6:9][np.broadcast_to(dead[:, None], clean[:, 6:9].shape)] = 0.0
    poisoned[:, 6:9][np.broadcast_to(dead[:, None], s[:, 6:9].shape)] = np.nan
    poisoned[:, :9][np.broadcast_to((valid < 0.5)[:, None], s[:, :9].shape)] = np.nan
    kw = dict(tiles_x=2, tile_h=16, tile_w=16, row_offset=0)
    vt, go, gt = (torch.tensor(x, device=cuda_device) for x in (valid, gout, gtfin))
    sc, sp = torch.tensor(clean, device=cuda_device), torch.tensor(poisoned, device=cuda_device)
    want = tr_ops.composite(sc, vt, **kw)
    got = tr_ops.composite(sp, vt, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    out_p, t_p = composite_ref(sc, vt, **kw)
    np.testing.assert_allclose(want[0].cpu().numpy(), out_p.cpu().numpy(), atol=RASTER_ATOL, rtol=RASTER_RTOL)
    np.testing.assert_allclose(want[1].cpu().numpy(), t_p.cpu().numpy(), atol=RASTER_ATOL, rtol=RASTER_RTOL)
    d_clean = tr_ops.composite_bwd(sc, vt, go, gt, *want[1:], **kw)
    assert torch.equal(tr_ops.composite_bwd(sp, vt, go, gt, *want[1:], **kw), d_clean)
    d_ref = composite_bwd_ref(sc, vt, go, gt, **kw)
    np.testing.assert_allclose(d_clean.cpu().numpy(), d_ref.cpu().numpy(), atol=2e-5 * float(d_ref.abs().max()),
                               rtol=2e-4)


@pytest.mark.parametrize("th,tw,k", [(16, 16, 256), (5, 7, 150)])
def test_strip_rows_bitwise_equal_frame_rows_on_the_kernel(cuda_device, th, tw, k):
    """Each tile row rendered alone (row_offset != 0) is bitwise equal to the
    same rows of the frame, n_contrib included."""
    tiles_x, tiles_y = 3, 4
    s, valid, _, _ = _dense_slab(7, tiles_x, tiles_y, th, tw, k)
    valid[5, k // 2:] = 0.0  # a ragged list
    st, vt = torch.tensor(s, device=cuda_device), torch.tensor(valid, device=cuda_device)
    frame = tr_ops.composite(st, vt, tiles_x=tiles_x, tile_h=th, tile_w=tw)
    for r in range(tiles_y):
        rows = slice(r * tiles_x, (r + 1) * tiles_x)
        strip = tr_ops.composite(st[rows].contiguous(), vt[rows].contiguous(), tiles_x=tiles_x, tile_h=th, tile_w=tw,
                                 row_offset=r * th)
        for a, b in zip(strip, frame):
            assert torch.equal(a, b[rows])


def test_rasterize_tiles_gradient_on_card_matches_cpu(cuda_device):
    host = _scene(300, seed=11)
    cam = _cam(64, 64)
    kw = dict(img_h=64, img_w=64, tile_h=16, tile_w=16, k_per_tile=128)
    target = np.random.default_rng(0).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        packed = P.sort_by_depth(P.project(G.from_numpy(host, dev), cam))[0].detach().requires_grad_()
        img, t = R.render_packed(packed, bg=torch.tensor([0.2, 0.4, 0.6], device=dev), **kw)
        loss = (img - torch.tensor(target, device=dev)).abs().mean() + t.mean()
        grads[dev.type] = torch.autograd.grad(loss, packed)[0].cpu().numpy()
    scale = np.abs(grads["cpu"]).max()
    np.testing.assert_allclose(grads["cuda"], grads["cpu"], atol=2e-5 * scale, rtol=2e-4)


# ---------------------------------------------------------------- the rasterizer input gather and its transpose
def _synthetic_lists(seed, n, t_count, k, share, pad):
    """Tile lists as binning makes them: each tile's valid rows first and
    ascending, a share of the K slots valid (tile 0 empty, tile 1 full), the
    padding on row 0 (``pad="zero"``: flat binning, an empty superblock) or
    on the tile's first candidate (``"first"``)."""
    r = np.random.default_rng(seed)
    counts = r.binomial(k, share, t_count)
    counts[0], counts[1] = 0, k
    rows = np.sort(r.integers(0, n, (t_count, k)), axis=1)
    valid = np.arange(k)[None] < counts[:, None]
    idx = np.where(valid, rows, 0 if pad == "zero" else rows[:, :1])
    return torch.tensor(idx, dtype=torch.int32), torch.tensor(valid)


def _binned_lists(dev, n, res, binning, row_offset=0, center=(0.0, 0.0)):
    """Real lists of a small scene (depth-sorted, binned as the train step
    bins), its unsorted splats and their depth order."""
    host = _scene(n, seed=n, spread=0.15)
    host = host._replace(means=(host.means + np.array([*center, 0.0], np.float32)).astype(np.float32))
    packed = P.project(G.from_numpy(host, dev), _cam(res, res)).detach()
    sorted_, order = P.sort_by_depth(packed)
    idx, valid = R.bin_tiles(sorted_, img_h=res, img_w=res, tile_h=16, tile_w=16, k_per_tile=64, binning=binning,
                             row_offset=row_offset)
    return packed, order, idx, valid


def _slab_cotangent(seed, valid, dev):
    """d(slab) as the compositor's backward leaves it: 0 in every padding
    slot and in depth and radius."""
    t_count, k = valid.shape
    g = torch.tensor(np.random.default_rng(seed).normal(size=(t_count, 11, k)), dtype=torch.float32, device=dev)
    g[:, 9:] = 0.0
    return g * valid[:, None, :].to(dev)


def _slab_case(name, dev):
    if name.startswith("synthetic"):
        _, n, t_count, share, pad = name.split("-")
        n, t_count = int(n), int(t_count)
        idx, valid = _synthetic_lists(n, n, t_count, 256, float(share), pad)
        gen = torch.Generator(device=dev).manual_seed(n)
        packed = torch.randn((n, 11), device=dev, generator=gen)
        return packed, torch.randperm(n, device=dev, generator=gen), idx.to(dev), valid.to(dev)
    binning, res, row_offset, cx = name.split("-")
    return _binned_lists(dev, 3001, int(res), binning, int(row_offset), (float(cx), 0.0))


# flat and hierarchical binning, a strip's row offset, superblocks with no
# splat (the scene moved aside), synthetic lists with empty and full tiles,
# padding on row 0 and long valid runs (N = 1,000), and the 2048-px shape
# (16,384 x 256 slots over 4,000,037 rows)
SLAB_CASES = ["flat-128-0-0", "hier-256-0-0", "hier-256-64-0", "hier-256-0-0.8", "synthetic-1000-64-0.3-zero",
              "synthetic-100003-1024-0.05-first", "synthetic-4000037-16384-0.05-first"]


@pytest.mark.parametrize("case", SLAB_CASES)
def test_slab_gather_and_its_transpose_are_bitwise_the_autograd_of_the_gathers(cuda_device, case):
    """The input gather's slab is bitwise ``packed[order][idx]`` laid out
    (T, 11, K), and its transpose's d(packed) is ``torch.equal`` to autograd
    of those gathers (PyTorch's sort-based accumulate, padding included), with
    and without ``order``; two runs are bitwise equal, and the backward never
    waits on the host."""
    packed, order, idx, valid = _slab_case(case, cuda_device)
    if case == "hier-256-0-0.8":  # the scene aside: whole superblocks list nothing, their padding on row 0
        empty = ~valid.any(dim=1)
        assert bool(empty.any()) and bool((idx[empty] == 0).all())
    assert bool(valid.any()) and not bool(valid.all())
    n = packed.shape[0]
    dslab = _slab_cotangent(7, valid, cuda_device)
    for order_ in (order, None):
        leaf = packed.clone().requires_grad_()
        want_slab = (leaf if order_ is None else leaf[order_])[idx.long()].transpose(1, 2).contiguous()
        (want,) = torch.autograd.grad(want_slab, leaf, dslab)
        before = (tr_ops.slab_launch_count.n, tr_ops.slab_bwd_launch_count.n)
        leaf2 = packed.clone().requires_grad_()
        slab = tr_ops.GatherSlab.apply(leaf2, idx, valid, order_)
        assert torch.equal(slab, want_slab.detach())
        torch.cuda.set_sync_debug_mode("error")
        try:
            (got,) = torch.autograd.grad(slab, leaf2, dslab, retain_graph=True)
            (again,) = torch.autograd.grad(slab, leaf2, dslab)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert (tr_ops.slab_launch_count.n, tr_ops.slab_bwd_launch_count.n) == (before[0] + 1, before[1] + 2)
        assert torch.equal(got, want), (got - want).abs().max()
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        assert bool((got[:, 9:] == 0).all()) and got.shape == (n, 11)


def test_slab_transpose_never_reads_the_padding(cuda_device):
    """The padding slots' gradient is never read and their rows never
    looked up: NaN there and indices far out of range change nothing. The
    source sums with no atomics."""
    import pathlib
    import re

    packed, order, idx, valid = _slab_case("synthetic-100003-1024-0.05-first", cuda_device)
    n = packed.shape[0]
    dslab = _slab_cotangent(11, valid, cuda_device)
    want = tr_ops.gather_slab_bwd(dslab, valid, idx, order, n)
    pad = ~valid[:, None, :].expand_as(dslab)
    poisoned = tr_ops.gather_slab_bwd(dslab.masked_fill(pad, float("nan")), valid,
                                      idx.masked_fill(~valid, 2**31 - 1), order, n)
    assert torch.equal(poisoned, want) and bool(torch.isfinite(want).all())
    src = pathlib.Path(tr_ops.__file__).with_name("slab_gather.cu").read_text()
    assert not re.search(r"\batomic\w*\s*\(", src)  # no atomicAdd, atomicCAS, ... call


def test_rasterize_tiles_gradient_through_the_order_is_bitwise_the_two_gathers(cuda_device):
    """``rasterize_tiles`` from the unsorted splats through the depth order,
    on the card: image and d(packed) bitwise those of the two autograd
    gathers, ``packed[order][idx]``, into the same compositor."""
    packed, order, idx, valid = _binned_lists(cuda_device, 3001, 256, "hier")
    kw = dict(img_h=256, img_w=256, tile_h=16, tile_w=16, bg=torch.tensor([0.2, 0.4, 0.6], device=cuda_device))
    target = torch.rand((256, 256, 3), device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(1))
    leaf = packed.clone().requires_grad_()
    img, t = tr_ops.rasterize_tiles(leaf, idx, valid, order=order, **kw)
    (got,) = torch.autograd.grad((img - target).abs().mean() + t.mean(), leaf)
    leaf2 = packed.clone().requires_grad_()
    splats_t = leaf2[order][idx.long()].transpose(1, 2).contiguous()
    raw, tfin = tr_ops.Composite.apply(splats_t, valid.float().contiguous(), 16, 16, 16, 0)
    img2 = raw.reshape(16, 16, 3, 16, 16).permute(0, 3, 1, 4, 2).reshape(256, 256, 3)
    t2 = tfin.reshape(16, 16, 16, 16).permute(0, 2, 1, 3).reshape(256, 256)
    img2 = img2 + t2[..., None] * kw["bg"]
    (want,) = torch.autograd.grad((img2 - target).abs().mean() + t2.mean(), leaf2)
    assert torch.equal(img, img2) and torch.equal(t, t2)
    assert torch.equal(got, want) and bool(got.abs().sum() > 0)


def test_train_step_on_card_runs_no_index_backward(cuda_device):
    """The train step's backward on the card: no ``IndexBackward0`` node and
    no ``indexing_backward_kernel``; the transpose is one ``slab_bwd`` a
    view, inside its ``gs.slab_bwd`` range."""
    from torch.profiler import ProfilerActivity, profile

    host = _scene(3000, seed=4, scale=0.03)
    cfg = GSConfig(img_h=64, img_w=64, k_per_tile=64, batch_size=2, bg=(0.1, 0.2, 0.3))
    cams = stack_cameras([_cam(64, 64), _cam(64, 64, dist=2.5)])
    gt = torch.tensor(np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32), device=cuda_device)
    step, state = make_train_step(cfg), init_state(G.from_numpy(host, cuda_device))
    step(state, cams, gt)
    before = tr_ops.slab_bwd_launch_count.n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, m = step(state, cams, gt)
        float(m["loss"])
    names = {e.name for e in prof.events()}
    assert tr_ops.slab_bwd_launch_count.n == before + 2 and "gs.slab_bwd" in names
    assert "IndexBackward0" not in names and not [x for x in names if "indexing_backward" in x]


def test_train_step_on_card_matches_cpu(cuda_device):
    """One train step through the three kernels against the same step on the
    CPU (the plain versions): loss, gradients (Adam's first moment after one
    step is 0.1 * g) and the densify statistics."""
    host = _scene(3000, seed=4, scale=0.03)
    cfg = GSConfig(img_h=64, img_w=64, k_per_tile=64, batch_size=2, bg=(0.1, 0.2, 0.3))
    cams = stack_cameras([_cam(64, 64), _cam(64, 64, dist=2.5)])
    gt = np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        counts = (gp_ops.launch_count.n, gp_ops.bwd_launch_count.n, tr_ops.launch_count.n,
                  tr_ops.bwd_launch_count.n)
        state, m = make_train_step(cfg)(init_state(G.from_numpy(host, dev)), cams, torch.tensor(gt, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (gp_ops.launch_count.n, gp_ops.bwd_launch_count.n, tr_ops.launch_count.n,
                    tr_ops.bwd_launch_count.n) == tuple(c + 2 for c in counts)
        out[dev.type] = (float(m["loss"]), [x.cpu().numpy() for x in state.adam.m],
                         [x.cpu().numpy() for x in (state.grad2d_accum, state.vis_count, state.max_radii)])
    (l_k, m_k, st_k), (l_c, m_c, st_c) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(l_k, l_c, rtol=1e-5)
    for a, b in zip(m_k, m_c):
        assert np.isfinite(a).all()
        scale = np.abs(b).max() / 0.1
        np.testing.assert_allclose(a / 0.1, b / 0.1, atol=2e-5 * scale, rtol=2e-4)
    np.testing.assert_allclose(st_k[0], st_c[0], atol=2e-5 * np.abs(st_c[0]).max(), rtol=2e-4)
    np.testing.assert_array_equal(st_k[1], st_c[1])
    np.testing.assert_array_equal(st_k[2], st_c[2])


def test_train_step_after_densify_on_card_matches_cpu(cuda_device):
    """A densify round that clones, splits and prunes, then one train step on
    the card against the same on the CPU: the resized parameters and Adam
    moments, the padding, the regrown probe and the fresh statistics all go
    through the three kernels. The round starts from one real CPU step; its
    gradient statistics are then drawn from a seed around the threshold, a
    few Gaussians are made transparent, and the scene extent puts the
    clone/split boundary at the median size, so that the round does all
    three. Both devices densify the same numbers with the same generator.
    The step's gradient is read back from Adam's first moment,
    g = (m' - 0.9 m) / 0.1."""
    host = _scene(3000, seed=6, scale=0.03)
    cfg = GSConfig(img_h=64, img_w=64, k_per_tile=64, batch_size=2, bg=(0.1, 0.2, 0.3))
    cams = stack_cameras([_cam(64, 64), _cam(64, 64, dist=2.5)])
    gt = np.random.default_rng(6).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    step = make_train_step(cfg)
    pre, _ = step(init_state(G.from_numpy(host, "cpu")), cams, torch.tensor(gt))
    h = state_to_numpy(pre)
    n = h.params.means.shape[0]
    r = np.random.default_rng(6)
    logit = h.params.opacity_logit.copy()
    logit[r.random(n) < 0.05] = -8.0
    h = h._replace(params=h.params._replace(opacity_logit=logit),
                   grad2d_accum=(h.vis_count * r.uniform(0, 2 * cfg.densify_grad_thresh, n)).astype(np.float32))
    extent = float(np.median(np.exp(h.params.log_scales).max(axis=1))) / cfg.densify_scale_thresh
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        st, rep = densify_and_rebalance(state_from_numpy(h, dev), cfg, scene_extent=extent,
                                        rng=np.random.default_rng(7))
        m_old = [x.cpu().numpy() for x in st.adam.m]
        counts = (gp_ops.launch_count.n, tr_ops.launch_count.n, tr_ops.bwd_launch_count.n)
        st2, m = step(st, cams, torch.tensor(gt, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (gp_ops.launch_count.n, tr_ops.launch_count.n, tr_ops.bwd_launch_count.n) == tuple(
                c + 2 for c in counts)
        assert st2.params.n == rep.n_padded
        grads = [(x.cpu().numpy() - 0.9 * mo) / 0.1 for x, mo in zip(st2.adam.m, m_old)]
        out.append((rep, float(m["loss"]), grads,
                    [x.cpu().numpy() for x in (st2.grad2d_accum, st2.vis_count, st2.max_radii)]))
    (rep_k, l_k, g_k, st_k), (rep_c, l_c, g_c, st_c) = out
    assert rep_k == rep_c
    assert rep_c.n_cloned > 0 and rep_c.n_split > 0 and rep_c.n_pruned > 0
    assert rep_c.n_padded != n
    np.testing.assert_allclose(l_k, l_c, rtol=1e-5)
    for a, b in zip(g_k, g_c):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=2e-5 * np.abs(b).max(), rtol=2e-4)
    np.testing.assert_allclose(st_k[0], st_c[0], atol=2e-5 * np.abs(st_c[0]).max(), rtol=2e-4)
    np.testing.assert_array_equal(st_k[1], st_c[1])
    np.testing.assert_array_equal(st_k[2], st_c[2])


class _SameBatch:
    """The views object ``GSTrainer.fit`` reads: one batch every step."""

    def __init__(self, cams, gt):
        self.cams, self.gt = cams, gt

    def batches(self, batch_size, *, steps):
        for _ in range(steps):
            yield self.cams, self.gt


def test_trainer_step_at_sh_degree_3_on_card_matches_cpu(cuda_device):
    """One ``GSTrainer`` step at SH degree 3 (the published colour model,
    16 coefficients a channel) with every band nonzero, on the card through
    both projection kernels at degree 3, against the same step on the CPU:
    the loss, and the SH field's gradient (Adam's first moment after one
    step is 0.1 * g), the bands above DC included."""
    from repro_torch.launch.train import GSTrainer

    host = _scene(3000, seed=9, scale=0.03)
    r = np.random.default_rng(9)
    sh = np.concatenate([host.sh, 0.2 * r.normal(0, 1, (3000, 15, 3))], axis=1).astype(np.float32)
    host = host._replace(sh=sh)
    cfg = GSConfig(img_h=64, img_w=64, k_per_tile=64, batch_size=2, bg=(0.1, 0.2, 0.3), sh_degree=3)
    cams = stack_cameras([_cam(64, 64), _cam(64, 64, dist=2.5)])
    gt = np.random.default_rng(9).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        tr = GSTrainer(cfg, params=G.from_numpy(host, dev), device=dev, verbose=False)
        assert tr.state.params.sh.shape == (3000, 16, 3)
        counts = (gp_ops.launch_count.n, gp_ops.bwd_launch_count.n)
        losses = tr.fit(_SameBatch(cams, torch.tensor(gt, device=dev)), steps=1, densify=False)
        if dev.type == "cuda":
            assert (gp_ops.launch_count.n, gp_ops.bwd_launch_count.n) == tuple(c + 2 for c in counts)
        out[dev.type] = (losses[0], tr.state.adam.m.sh.cpu().numpy() / 0.1)
    (l_k, g_k), (l_c, g_c) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(l_k, l_c, rtol=1e-5)
    assert np.isfinite(g_k).all() and np.abs(g_c[:, 1:]).max() > 1e-6
    scale = np.abs(g_c).max()
    np.testing.assert_allclose(g_k, g_c, atol=2e-5 * scale, rtol=2e-4)
    np.testing.assert_allclose(g_k[:, 9:], g_c[:, 9:], atol=2e-5 * np.abs(g_c[:, 9:]).max(), rtol=2e-4)


def _adam_state(dev, n: int, coeffs: int, count: int, seed: int):
    """Parameters, gradients and Adam state (after ``count - 1`` steps) of
    ``n`` Gaussians with ``coeffs`` SH coefficients a channel, from a seed."""
    from repro_torch.optim.adam import AdamState

    r = np.random.default_rng(seed)
    shapes = ((n, 3), (n, 3), (n, 4), (n,), (n, coeffs, 3))

    def draw(scale, positive=False):
        return G.GaussianModel(*[torch.tensor((np.abs if positive else np.asarray)(r.normal(0, scale, s)),
                                              dtype=torch.float32, device=dev) for s in shapes])

    state = AdamState(draw(1e-3), draw(1e-6, positive=True), torch.full((), count - 1, dtype=torch.int32, device=dev))
    return draw(1.0), draw(1e-3), state


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("lr_kind", ["float", "schedule"])
@pytest.mark.parametrize("count", [1, 7])
@pytest.mark.parametrize("n,coeffs", [(1003, 1), (100_003, 16)])
def test_adam_kernel_is_bitwise_the_plain_update(cuda_device, n, coeffs, count, lr_kind, packed):
    """``adam_update`` on the card, one ``adam.cu`` launch a field, against
    the plain update (``adam_ref``) on the same card tensors, field by
    field: p', m' and v' bitwise. The SH-0 fields and an (N, 16, 3) SH
    field, N not a multiple of 4 (the last block only part full); steps 1
    and 7; the rates as floats or as the schedule's 0-d device tensor; the
    gradients as tensors of their own or as ``pack_pytree``'s split views
    of one vector, whose offsets are not 16-byte aligned.
    The inputs stay bitwise untouched, and each call launches 5 times."""
    from repro_torch.kernels.adam import ops as adam_ops
    from repro_torch.kernels.adam.ref import adam_ref
    from repro_torch.optim.adam import adam_update
    from repro_torch.optim.schedules import expon_lr
    from repro_torch.utils.tree import pack_pytree

    params, grads, state = _adam_state(cuda_device, n, coeffs, count, seed=count + coeffs)
    if packed:
        flat, unpack = pack_pytree(grads)
        grads = unpack(flat)
        assert grads.log_scales.data_ptr() % 16 and grads.sh.data_ptr() % 16
    lr_pos = expon_lr(torch.full((), count * 100, dtype=torch.int32, device=cuda_device), lr_init=1.6e-4,
                      lr_final=1.6e-6, max_steps=30_000)
    rates = (2.0, 1e-2, 2e-3, 0.1, 5e-3)
    lrs = G.GaussianModel(*(rates if lr_kind == "float" else [lr_pos * x for x in rates]))
    inputs = [params, grads, state.m, state.v, [state.count], [x for x in lrs if torch.is_tensor(x)]]
    before = [[x.clone() for x in tree] for tree in inputs]
    launches = adam_ops.launch_count.n
    new_p, new_state = adam_update(grads, state, params, lrs)
    torch.cuda.synchronize()
    assert adam_ops.launch_count.n == launches + 5
    for tree, was in zip(inputs, before):
        assert all(torch.equal(a, b) for a, b in zip(tree, was))
    assert int(new_state.count) == count
    c = torch.full((), count, dtype=torch.float32, device=cuda_device)
    bc1 = 1.0 - torch.pow(torch.full((), 0.9, dtype=torch.float32, device=cuda_device), c)
    bc2 = 1.0 - torch.pow(torch.full((), 0.999, dtype=torch.float32, device=cuda_device), c)
    for i, f in enumerate(G.GaussianModel._fields):
        want = adam_ref(params[i], grads[i], state.m[i], state.v[i], bc1, bc2, lrs[i], b1=0.9, b2=0.999, eps=1e-15)
        for name, got, w in zip(("p", "m", "v"), (new_p[i], new_state.m[i], new_state.v[i]), want):
            assert got.shape == w.shape and torch.equal(got, w), (f, name, int((got != w).sum()))


def test_trainer_two_sh3_steps_with_the_adam_kernel_equal_the_plain_update(cuda_device, monkeypatch):
    """Two ``GSTrainer`` steps at SH degree 3 on the card, once through the
    Adam kernel (10 launches) and once with the plain update in its place:
    the same losses and the same state, bitwise: parameters, moments,
    count and densify statistics."""
    from repro_torch.kernels.adam import ops as adam_ops
    from repro_torch.kernels.adam.ref import adam_ref
    from repro_torch.launch.train import GSTrainer

    host = _scene(3000, seed=11, scale=0.03)
    r = np.random.default_rng(11)
    host = host._replace(sh=np.concatenate([host.sh, 0.2 * r.normal(0, 1, (3000, 15, 3))], axis=1).astype(np.float32))
    cfg = GSConfig(img_h=64, img_w=64, k_per_tile=64, batch_size=2, bg=(0.1, 0.2, 0.3), sh_degree=3)
    batch = _SameBatch(stack_cameras([_cam(64, 64), _cam(64, 64, dist=2.5)]),
                       torch.tensor(r.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32), device=cuda_device))
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(adam_ops, "launch", adam_ref)
        tr = GSTrainer(cfg, params=G.from_numpy(host, cuda_device), device=cuda_device, verbose=False)
        launches = adam_ops.launch_count.n
        losses = tr.fit(batch, steps=2, densify=False)
        torch.cuda.synchronize()
        assert adam_ops.launch_count.n == launches + (0 if plain else 10)
        st = tr.state
        runs.append((losses, [*st.params, *st.adam.m, *st.adam.v, st.adam.count, st.step, st.grad2d_accum,
                              st.vis_count, st.max_radii]))
    (l_k, s_k), (l_p, s_p) = runs
    assert l_k == l_p and len(l_k) == 2
    assert all(torch.equal(a, b) for a, b in zip(s_k, s_p))


@pytest.fixture(scope="module")
def nccl_world_one(tmp_path_factory):
    """A world-1 NCCL process group in this process (through a file store)
    and the (1, 1) mesh over it; destroyed after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs only on the card")
    dev = torch.device("cuda", 0)
    init_ranks(dev, init_method=f"file://{tmp_path_factory.mktemp('nccl')}/store", rank=0, world_size=1,
               timeout_s=300)
    yield make_gs_mesh(1, 1, device=dev)
    torch.distributed.destroy_process_group()


def _ranks_scene():
    """A small training scene as numpy: model, two cameras and their images."""
    host = _scene(4096, seed=6, scale=0.03)
    cams = stack_cameras([_cam(64, 64), _cam(64, 64, dist=2.5)])
    gt = np.random.default_rng(6).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    return host, cams, gt


@pytest.mark.parametrize("mode", ["projected", "params3d"])
def test_sharded_step_at_world_one_over_nccl_is_bitwise_the_one_device_step(nccl_world_one, mode):
    """Three steps of the sharded step on a world-1 NCCL mesh (the gathers,
    reduce-scatters and all-reduces are real NCCL calls over groups of one;
    one model rank renders no strips) against ``make_train_step(cfg)`` with no
    mesh, from the same state: losses, parameters, Adam moments and the
    densify statistics bit for bit."""
    mesh = nccl_world_one
    host, cams, gt = _ranks_scene()
    cfg = GSConfig(img_h=64, img_w=64, k_per_tile=64, batch_size=2, gather_mode=mode, bg=(0.1, 0.2, 0.3))
    gt_d = torch.tensor(gt, device=mesh.device)
    one, st_one = make_train_step(cfg), init_state(G.from_numpy(host, mesh.device))
    step, st = make_train_step(cfg, mesh), shard_state(init_state(G.from_numpy(host, mesh.device)), mesh)
    for _ in range(3):
        st_one, m_one = one(st_one, cams, gt_d)
        st, m = step(st, cams, gt_d)
        assert float(m["loss"]) == float(m_one["loss"])
    for a, b in zip(tree_leaves(st), tree_leaves(st_one)):
        assert torch.equal(a, b)


def test_sharded_step_across_cards_over_nccl_matches_world_one(cuda_device, tmp_path):
    """(1, n) over NCCL with one rank per card, three projected steps from
    the same state: the losses within rtol 1e-5 of the one-device step's
    (the pixel strips sum the loss in another order)."""
    import torch_ranks as TR

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more CUDA devices for ranks across cards, found {n}")
    n = 4 if n >= 4 else 2  # 64 px in 16-px tiles splits into 2 or 4 strips
    host, cams, gt = _ranks_scene()
    cfg = dict(img_h=64, img_w=64, k_per_tile=64, batch_size=2, gather_mode="projected", bg=(0.1, 0.2, 0.3))
    inputs = {f"a.state.params.{f}": getattr(host, f) for f in host._fields}
    z = {k: np.zeros_like(v) for k, v in inputs.items()}
    inputs.update({k.replace("params", "adam.m"): v for k, v in z.items()})
    inputs.update({k.replace("params", "adam.v"): v for k, v in z.items()})
    inputs.update({"a.state.adam.count": np.int32(0), "a.state.step": np.int32(0), "a.gt": gt,
                   **{f"a.state.{k}": np.zeros(host.means.shape[0], np.float32)
                      for k in ("grad2d_accum", "vis_count", "max_radii")},
                   **{f"a.cams.{f}": np.asarray(x) for f, x in zip(cams._fields, cams)}})
    ranks = TR.spawn([dict(kind="train", name="r", mesh=[1, n], cfg=cfg, inputs="a.", steps=3)], n, inputs,
                     tmp_path, device="cuda")
    one, st = make_train_step(GSConfig(**cfg)), init_state(G.from_numpy(host, cuda_device))
    want = []
    for _ in range(3):
        st, m = one(st, cams, torch.tensor(gt, device=cuda_device))
        want.append(float(m["loss"]))
    for r in ranks:
        np.testing.assert_allclose(r["r/losses"], want, rtol=1e-5)

def _serve_inputs() -> dict:
    """The serve scenario's inputs (``tests/torch_ranks.serve_scenario``) as
    numpy: 4,096 Gaussians, their update (the two top Gaussians nudged),
    four near and two far orbit views (LOD levels 0 and 1)."""
    from repro_torch.volume.cameras import orbit_cameras

    host = _scene(4096, seed=8, scale=0.03)
    means = host.means.copy()
    changed = np.argsort(-means[:, 1])[:2]
    means[changed, 0] += 0.01
    out = {"s.changed": changed}
    for f in host._fields:
        out[f"s.params.{f}"] = getattr(host, f)
        out[f"s.new.{f}"] = means if f == "means" else getattr(host, f)
    near = orbit_cameras(4, img_h=64, img_w=64, radius=3.0)
    far = orbit_cameras(2, img_h=64, img_w=64, radius=12.0)
    for f in near._fields:
        out[f"s.cams.{f}"] = np.concatenate([np.asarray(getattr(near, f)), np.asarray(getattr(far, f))])
    return out


SERVE_CFG = dict(img_h=64, img_w=64, k_per_tile=64)
SERVE_KW = dict(n_levels=2, max_batch=4, pipeline_depth=2)


def _serve_one_device(dev, inputs) -> dict:
    import torch_ranks as TR

    with RenderServer(TR._model(inputs, "s.params."), GSConfig(**SERVE_CFG), device=dev, **SERVE_KW) as srv:
        return TR.serve_scenario(srv, inputs, "s.")


def test_mesh_server_at_world_one_over_nccl_is_bitwise_the_one_device_server(nccl_world_one):
    """``RenderServer(mesh=(1, 1))`` over NCCL (the level broadcast, the
    model and data all-gathers over groups of one, the gloo descriptors)
    serves batched misses, cache hits, partial-hit strips and the rows
    ``add_timestep(changed=...)`` dirties bit for bit as the one-device
    server on the card, through both forward kernels."""
    import torch_ranks as TR

    mesh = nccl_world_one
    inputs = _serve_inputs()
    want = _serve_one_device(mesh.device, inputs)
    before = (gp_ops.launch_count.n, tr_ops.launch_count.n)
    with RenderServer(TR._model(inputs, "s.params."), GSConfig(**SERVE_CFG), mesh=mesh, **SERVE_KW) as srv:
        got = TR.serve_scenario(srv, inputs, "s.")
        assert srv.report()["mesh"]["control_sends"] > 0
    assert gp_ops.launch_count.n > before[0] and tr_ops.launch_count.n > before[1]
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got["counts"][2] >= 2  # partial hits went through strips


def test_mesh_server_across_cards_over_nccl_is_bitwise_the_one_device_server(cuda_device, tmp_path):
    """(2, 1) over NCCL with one rank per card: each micro-batch's views
    split over the two data ranks, and the frames equal the one-device
    server's bit for bit."""
    import torch_ranks as TR

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more CUDA devices for serving across cards, found {n}")
    inputs = _serve_inputs()
    want = _serve_one_device(cuda_device, inputs)
    ranks = TR.spawn([dict(kind="serve", name="s", mesh=[2, 1], cfg=SERVE_CFG, server=SERVE_KW, inputs="s.")], 2,
                     inputs, tmp_path, device="cuda")
    assert int(ranks[1]["s/followed"]) == 1
    for k, v in want.items():
        if k != "buckets":  # multiples of the data axis on the mesh
            np.testing.assert_array_equal(ranks[0][f"s/{k}"], v, err_msg=k)
    np.testing.assert_array_equal(ranks[0]["s/buckets"], [2, 4])


# the JAX flash-attention kernel test's sweep, (B, S, Skv, H, Hkv, hd, causal,
# window), with q_offset = Skv - S; then Skv 9000, where the JAX wrapper
# falls back to its oracle and the CUDA kernel still runs; a Gemma3-style
# 1024-key window at hd 128; a ragged long case (S 100 over Skv 9000, q_offset
# 8900) at hd 128; a ragged batch of two, where rows past S must not reach
# the next batch element (the bf16 kernel's tensor maps bound each one)
FLASH_CASES = [
    (2, 128, 128, 4, 4, 64, True, None),
    (1, 256, 256, 4, 2, 32, True, None),
    (2, 128, 128, 2, 2, 64, True, 32),
    (1, 64, 128, 2, 2, 32, True, None),
    (1, 128, 128, 4, 1, 64, False, None),
    (1, 100, 100, 2, 2, 64, True, None),
    (1, 64, 9000, 1, 1, 32, True, None),
    (1, 2048, 2048, 4, 2, 128, True, 1024),
    (1, 100, 9000, 2, 1, 128, True, None),
    (2, 300, 300, 2, 1, 128, True, None),
    (4, 1, 1500, 6, 6, 64, False, None),  # whisper-tiny's cross-attention at a serve step
]
# float32 (the CUDA-core kernel): the JAX kernel test's tolerance; bfloat16
# (the tensor-core kernel): one bf16 step is up to 2^-7 relative, and the
# kernel rounds P to bf16 before P V
FLASH_TOLS = [(torch.float32, 2e-5, 2e-4), (torch.bfloat16, 1e-2, 1.6e-2)]


def _qkv(b, s, skv, h, hkv, hd, seed, device, dtype=torch.float32):
    r = np.random.default_rng(seed)
    return [torch.tensor(r.normal(size=shape).astype(np.float32), device=device).to(dtype)
            for shape in ((b, s, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd))]


@pytest.mark.parametrize("dtype,atol,rtol", FLASH_TOLS)
@pytest.mark.parametrize("b,s,skv,h,hkv,hd,causal,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda_device, b, s, skv, h, hkv, hd, causal, window, dtype, atol, rtol):
    q, k, v = _qkv(b, s, skv, h, hkv, hd, s + skv, cuda_device, dtype)
    kw = dict(causal=causal, window=window, q_offset=skv - s)
    before = fa_ops.launch_count.n
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.launch_count.n == before + 1
    assert got.dtype == dtype
    want = attention_ref(q, k, v, **kw)
    want_cpu = attention_ref(*[x.cpu() for x in (q, k, v)], **kw)
    for w in (want.float().cpu().numpy(), want_cpu.float().numpy()):
        np.testing.assert_allclose(got.float().cpu().numpy(), w, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype,atol,rtol", FLASH_TOLS)
def test_flash_attention_kernel_matches_plain_at_the_model_shape(cuda_device, dtype, atol, rtol):
    """Qwen3-0.6B's prefill shape: B 4, S = Skv 4096, 16 query and 8 KV heads,
    hd 128, causal."""
    q, k, v = _qkv(4, 4096, 4096, 16, 8, 128, 1, cuda_device, dtype)
    got = fa_ops.flash_attention(q, k, v)
    want = attention_ref(q, k, v)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol, rtol=rtol)
    assert torch.equal(fa_ops.flash_attention(q, k, v), got)  # no atomics: two launches bitwise equal


def test_flash_attention_bf16_kernel_refuses_a_misaligned_base_pointer(cuda_device):
    """The bfloat16 kernel reads through TMA, whose tensor maps need a
    16-byte-aligned base: a contiguous view one element into its storage is
    refused, and the same values at an aligned base run."""
    q, k, v = _qkv(1, 64, 64, 2, 2, 64, 3, cuda_device, torch.bfloat16)
    buf = torch.empty(q.numel() + 1, device=cuda_device, dtype=torch.bfloat16)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa_ops.flash_attention(shifted, k, v)
    got = fa_ops.flash_attention(shifted.clone(), k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(), attention_ref(q, k, v).float().cpu().numpy(),
                               atol=1e-2, rtol=1.6e-2)


def test_flash_attention_gradient_on_card_matches_plain(cuda_device):
    """The autograd.Function (kernel forward, the plain version's VJP
    backward) against autograd through the plain version, with GQA and a
    window."""
    q, k, v = _qkv(2, 96, 160, 4, 2, 64, 7, cuda_device)
    gout = torch.randn(q.shape, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(0))
    kw = dict(causal=True, window=48, q_offset=64)
    grads = []
    for fn in (fa_ops.flash_attention, attention_ref):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, **kw), leaves, gout))
    for a, b_ in zip(*grads):
        np.testing.assert_allclose(a.cpu().numpy(), b_.cpu().numpy(), atol=2e-5 * float(b_.abs().max()), rtol=2e-4)


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _qkv(1, 16, 16, 2, 2, 48, 0, cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, k, v)
    q, k, v = _qkv(1, 16, 16, 2, 2, 32, 0, cuda_device)
    with pytest.raises(ValueError, match="no unmasked key"):
        fa_ops.flash_attention(q, k, v, q_offset=-4)


# head width 112 (zamba2-7b's shared attention): key tails (Skv 1,500 and
# 100 are not multiples of the key block), causal and not, GQA 32/32 and 8/2
HD112_CASES = [
    (1, 256, 1500, 8, 2, False),
    (2, 100, 100, 8, 2, True),
    (1, 128, 1500, 32, 32, True),
    (1, 1500, 1500, 32, 32, False),
]


@pytest.mark.parametrize("dtype,atol,rtol", FLASH_TOLS)
@pytest.mark.parametrize("b,s,skv,h,hkv,causal", HD112_CASES)
def test_flash_attention_hd112_matches_plain(cuda_device, b, s, skv, h, hkv, causal, dtype, atol, rtol):
    """The hd-112 instances (their tensor maps declare 112 columns of a
    128-wide tile) against the plain version; two launches bitwise equal."""
    q, k, v = _qkv(b, s, skv, h, hkv, 112, s + skv + h, cuda_device, dtype)
    kw = dict(causal=causal, q_offset=skv - s if causal else 0)
    before = fa_ops.launch_count.n
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.launch_count.n == before + 1 and got.dtype == dtype
    want = attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol, rtol=rtol)
    assert torch.equal(fa_ops.flash_attention(q, k, v, **kw), got)


def test_flash_attention_hd112_gradient_on_card_matches_plain(cuda_device):
    q, k, v = _qkv(2, 96, 160, 8, 2, 112, 11, cuda_device)
    gout = torch.randn(q.shape, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(1))
    grads = []
    for fn in (fa_ops.flash_attention, attention_ref):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, causal=True, q_offset=64), leaves, gout))
    for a, b_ in zip(*grads):
        np.testing.assert_allclose(a.cpu().numpy(), b_.cpu().numpy(), atol=2e-5 * float(b_.abs().max()), rtol=2e-4)


def _family_batch(cfg, b, s, seed):
    """A prefill batch of ``cfg``'s family from numpy: token ids; whisper's
    audio frames; the VLM's merged embeddings and (t, h, w) positions."""
    r = np.random.default_rng(seed)
    if cfg.arch_type == "vlm":
        return {"embeds": torch.from_numpy(r.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)),
                "positions3": torch.from_numpy(r.integers(0, s, (b, s, 3)).astype(np.int32))}
    batch = {"tokens": torch.from_numpy(r.integers(0, cfg.vocab, (b, s)))}
    if cfg.arch_type == "whisper":
        batch["audio_embeds"] = torch.from_numpy(r.normal(0, 1, (b, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch,launches", [("zamba2-7b", 4), ("xlstm-350m", 0), ("whisper-tiny", 6),
                                           ("qwen2-vl-72b", 2)])
def test_family_smoke_prefill_on_card_matches_cpu(cuda_device, arch, launches, monkeypatch):
    """The smoke config's prefill (float32) of the SSM hybrid, xLSTM,
    whisper and VLM families on the card against the CPU at the LM parity
    tests' tolerance, 70 tokens (not a whole number of 64-token chunks);
    the attention kernel launched once per attention call (zamba: 2 double
    units of 2 shared blocks; whisper: encoder, decoder and cross). cuDNN's
    TF32 is off for the mamba conv, as chip_smoke.py sets it."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = get_arch(arch).smoke_config()
    params = lm.init_params(cfg, seed=0, device="cpu")
    batch = _family_batch(cfg, 2, 70, 1)
    step = api.make_prefill_step(cfg)
    want = step(params, batch)
    before = fa_ops.launch_count.n
    got = step(tree_to(params, cuda_device), {k: v.to(cuda_device) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert fa_ops.launch_count.n == before + launches
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-27b"])
def test_smoke_prefill_on_card_matches_cpu(cuda_device, arch):
    """The smoke config's prefill step (float32, 2 layers) through the
    attention kernel on the card against the plain versions on the CPU, at
    the LM parity tests' tolerance; one kernel launch per layer."""
    cfg = get_arch(arch).smoke_config()
    params = lm.init_params(cfg, seed=0, device="cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 48)))
    step = api.make_prefill_step(cfg)
    want = step(params, {"tokens": toks})
    card = tree_to(params, cuda_device)
    before = fa_ops.launch_count.n
    got = step(card, {"tokens": toks.to(cuda_device)})
    torch.cuda.synchronize()
    assert fa_ops.launch_count.n == before + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)



@pytest.mark.parametrize("zero_router", [False, True])
def test_moe_apply_on_card_matches_cpu(cuda_device, zero_router):
    """``moe_apply`` at the granite-moe smoke config (float32, capacity 1.0,
    so pairs drop) with the torch ops on the card against the CPU: the
    output, the aux losses and the same dropped share. With the router
    zeroed every gate ties: the card keeps the lower expert ids, as
    ``jax.lax.top_k`` does."""
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m").smoke_config(), capacity_factor=1.0)
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, 64, cfg.d_model)).astype(np.float32))
    if zero_router:
        params["router"].zero_()
    want, want_aux = moe.moe_apply(params, cfg, x)
    got, got_aux = moe.moe_apply(tree_to(params, cuda_device), cfg, x.to(cuda_device))
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5 * float(want.abs().max()), rtol=0)
    assert float(got_aux["drop_frac"]) == float(want_aux["drop_frac"]) > 0
    for key in ("lb_loss", "router_z"):
        np.testing.assert_allclose(float(got_aux[key]), float(want_aux[key]), rtol=1e-5)
    if zero_router:
        logits = x.to(cuda_device) @ params["router"].to(cuda_device)
        idx = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True)[1][..., :cfg.top_k]
        assert (idx.cpu() == torch.arange(cfg.top_k)).all()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_train_step_on_card_matches_cpu_and_recomputes_attention(cuda_device, arch):
    """One ``make_train_step`` at the smoke config (float32, remat on) on the
    card against the CPU: the loss at rtol 1e-5, the gradient (read from
    AdamW's first moment, g = m / 0.1) at atol 2e-5·max|g|, rtol 2e-4;
    the attention kernel launches twice per layer, the forward and the
    remat recompute."""
    cfg = get_arch(arch).smoke_config()
    assert cfg.remat
    r = np.random.default_rng(2)
    batch = {k: torch.from_numpy(r.integers(0, cfg.vocab, (2, 64))) for k in ("tokens", "labels")}
    step = api.make_train_step(cfg)
    res = {}
    for dev in (torch.device("cpu"), cuda_device):
        p = tree_to(lm.init_params(cfg, seed=0, device="cpu"), dev)  # the step updates its parameters in place
        before = fa_ops.launch_count.n
        _, opt, m = step(p, api.adamw_init(p), {k: v.to(dev) for k, v in batch.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert fa_ops.launch_count.n - before == 2 * cfg.n_layers
        res[dev.type] = (float(m["loss"]), [x.cpu() / 0.1 for x in tree_leaves(opt["m"])])
    (l_c, g_c), (l_k, g_k) = res["cpu"], res["cuda"]
    np.testing.assert_allclose(l_k, l_c, rtol=1e-5)
    for a, b_ in zip(g_k, g_c):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=2e-5 * float(b_.abs().max()), rtol=2e-4)



INSITU_CFG = dict(img_h=32, img_w=32, batch_size=2, k_per_tile=128, max_steps=10, densify_from=10**9,
                  opacity_reset_interval=10**9)
INSITU_KW = dict(cold_steps=3, warm_steps=2, n_views=4, max_points=600, n_steps_raymarch=32, init_scale=0.06, seed=0)


def test_insitu_run_on_card_matches_cpu(cuda_device, tmp_path):
    """The small in situ run (miranda at res 32, 32 px, K 128, batch 2, 2
    timesteps of 3 cold and 2 warm steps) on the card and on the CPU path,
    on the card's ray-marched ground truth (cached, so both train on the same
    images): the first step's loss within rtol 1e-5, every step's within
    rtol 1e-3 (the multi-step tolerance of the CPU parity tests), the same
    reseeded slots, one shape signature, and the card's run through the
    kernels (2 launches of each splatting kernel per step, plus the eval
    views' forwards)."""
    from repro_torch.insitu import InsituTrainer
    from repro_torch.volume.timevary import synthetic_stream

    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        counts = (gp_ops.launch_count.n, tr_ops.launch_count.n, tr_ops.bwd_launch_count.n)
        tr = InsituTrainer(GSConfig(**INSITU_CFG), device=dev, gt_cache_dir=str(tmp_path), **INSITU_KW)
        reports = tr.run(synthetic_stream("miranda", 2, res=32, t1=0.15))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            steps = sum(r.steps for r in reports)
            assert (gp_ops.launch_count.n - counts[0], tr_ops.launch_count.n - counts[1],
                    tr_ops.bwd_launch_count.n - counts[2]) == (2 * steps + 4, 2 * steps + 4, 2 * steps)
        runs[dev.type] = tr
    card, cpu = runs["cuda"], runs["cpu"]
    assert card.n_traces == cpu.n_traces == 1
    np.testing.assert_allclose(card.step_losses[0], cpu.step_losses[0], rtol=1e-5)
    np.testing.assert_allclose(card.step_losses, cpu.step_losses, rtol=1e-3)
    assert [s.tolist() for s in card.reseed_log] == [s.tolist() for s in cpu.reseed_log]
    assert card.reseed_log[0].size > 0


def test_insitu_trainer_at_world_one_over_nccl_is_bitwise_one_device(nccl_world_one):
    """``InsituTrainer`` on a world-1 NCCL mesh (every rank gathers the full
    state to reseed it and keeps its shard) against the one-device trainer
    over the same stream: losses, reseeded slots and the final state bit for
    bit."""
    from repro_torch.insitu import InsituTrainer
    from repro_torch.volume.timevary import synthetic_stream

    mesh = nccl_world_one
    out = []
    for m in (None, mesh):
        tr = InsituTrainer(GSConfig(**INSITU_CFG), m, device=mesh.device, **INSITU_KW)
        tr.run(synthetic_stream("miranda", 2, res=32, t1=0.15))
        out.append(tr)
    one, w1 = out
    assert one.step_losses == w1.step_losses
    assert [s.tolist() for s in one.reseed_log] == [s.tolist() for s in w1.reseed_log]
    for a, b in zip(tree_leaves(one.state), tree_leaves(w1.state)):
        assert torch.equal(a, b)


def test_table1_one_worker_row_at_the_paper_scale(cuda_device, tmp_path):
    """``benchmarks/table1_scaling_torch.py`` at one worker: Kingsnake's 4M
    Gaussians at 512 px, 3 steps (1 warm-up) on the card: finite losses, 4
    launches of each splatting kernel a step and none of attention, a peak
    under 80 GB."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(repo / "benchmarks" / "table1_scaling_torch.py"), "--workers", "1",
                          "--datasets", "kingsnake", "--res", "512", "--warmup", "1", "--steps", "2",
                          "--out", str(tmp_path)], cwd=tmp_path, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=str(repo / "src")))
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    (row,) = json.loads((tmp_path / "table1_rows.json").read_text())["rows"]
    assert row["case"] == "kingsnake_512_1w" and row["fits"] and row["n_gaussians"] == 4_000_768
    assert len(row["losses"]) == 3 and np.isfinite(row["losses"]).all()
    assert row["launches"] == {"gsproject": 12, "tile_raster_fwd": 12, "tile_raster_bwd": 12, "flash_attention": 0}
    assert 0 < max(row["peak_bytes"]) < 80e9 and row["fits_80gb"]
    assert 0 < row["device_busy_ms"] and row["nccl_ms"] == 0 and 0 < row["busy_share"] <= 1


# ---------------------------------------------------------------- the operation counter and the micro-benchmark
def _count_diff(a: dict, b: dict) -> list:
    out = [k for k in ("flops", "bytes", "coll_total_moved_bytes") if a[k] != b[k]]
    for op in set(a["by_op"]) | set(b["by_op"]):
        x, y = a["by_op"].get(op, {}), b["by_op"].get(op, {})
        if (x.get("flops", 0.0), x.get("bytes", 0.0)) != (y.get("flops", 0.0), y.get("bytes", 0.0)):
            out.append((op, x, y))
    return out


def test_op_cost_of_a_train_step_is_the_same_on_card_and_cpu(cuda_device):
    """The same small train step counted on both devices: the same ops run
    (the kernels' regions hide their plain versions on the CPU and report
    the bounds' formulas on both), so flops, bytes and every op's share are
    equal, and the backward that autograd runs on its device thread on the
    card is counted there too."""
    from repro_torch.launch.op_cost import OpCost

    host = _scene(3000, seed=4, scale=0.03)
    cfg = GSConfig(img_h=64, img_w=64, k_per_tile=64, batch_size=2, bg=(0.1, 0.2, 0.3))
    cams = stack_cameras([_cam(64, 64), _cam(64, 64, dist=2.5)])
    gt = np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    counts = []
    for dev in (cuda_device, torch.device("cpu")):
        state, gt_d = init_state(G.from_numpy(host, dev)), torch.tensor(gt, device=dev)
        with OpCost() as c:
            _, m = make_train_step(cfg)(state, cams, gt_d)
            float(m["loss"])
        counts.append(c.result())
    card, cpu = counts
    assert card["by_op"]["tile_raster_bwd"]["count"] == 2 and card["by_op"]["convolution_backward"]["count"] == 1
    assert card["by_op"]["gsproject_bwd"]["count"] == 2
    # the input gather's transpose: the same work and the same slots summed of all T*K
    assert card["by_op"]["slab_gather"]["count"] == card["by_op"]["slab_bwd"]["count"] == 2
    for key in ("scattered", "slots"):
        assert card["by_op"]["slab_bwd"][key] == cpu["by_op"]["slab_bwd"][key]
    assert 0 < card["by_op"]["slab_bwd"]["scattered"] <= card["by_op"]["slab_bwd"]["slots"] == 2 * 16 * 64
    assert card["transfer_bytes"] == 0 and cpu["transfer_bytes"] == 0  # the camera rides in the launches
    assert not _count_diff(card, cpu), _count_diff(card, cpu)[:10]


def test_op_cost_of_an_sh_train_step_is_the_same_on_card_and_cpu(cuda_device):
    """The same small train step at SH degree 3 counted on both devices: the
    projection's region reports the SH bands' work on both, every op equal."""
    from repro_torch.launch.op_cost import OpCost

    host = _scene(3000, seed=5, scale=0.03)
    host = host._replace(sh=np.concatenate(
        [host.sh, np.random.default_rng(5).normal(0, 0.1, (3000, 15, 3)).astype(np.float32)], axis=1))
    cfg = GSConfig(img_h=64, img_w=64, k_per_tile=64, batch_size=2, bg=(0.1, 0.2, 0.3), sh_degree=3)
    cams = stack_cameras([_cam(64, 64), _cam(64, 64, dist=2.5)])
    gt = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    counts = []
    for dev in (cuda_device, torch.device("cpu")):
        state, gt_d = init_state(G.from_numpy(host, dev)), torch.tensor(gt, device=dev)
        with OpCost() as c:
            _, m = make_train_step(cfg)(state, cams, gt_d)
            float(m["loss"])
        counts.append(c.result())
    card, cpu = counts
    assert card["by_op"]["gsproject"]["count"] == 2
    assert card["by_op"]["gsproject"]["bytes"] == 2 * 3000 * 280
    assert not _count_diff(card, cpu), _count_diff(card, cpu)[:10]


def test_op_cost_of_an_attention_call_is_the_same_on_card_and_cpu(cuda_device):
    from repro_torch.kernels import cost as kcost
    from repro_torch.launch.op_cost import OpCost

    q, k, v = _qkv(2, 96, 160, 4, 2, 64, 7, cuda_device)
    counts = []
    for dev in (cuda_device, torch.device("cpu")):
        leaves = [x.to(dev).detach().requires_grad_() for x in (q, k, v)]
        with OpCost() as c:
            out = fa_ops.flash_attention(*leaves, causal=True, window=48, q_offset=64)
            out.square().sum().backward()
        counts.append(c.result())
    assert not _count_diff(*counts), _count_diff(*counts)[:10]
    want = kcost.attention_cost(q, k, v, causal=True, window=48, q_offset=64)
    assert (counts[0]["by_op"]["flash_attention"]["flops"], counts[0]["by_op"]["flash_attention"]["bytes"]) == want
    assert counts[0]["by_op"]["bmm"]["count"] > 0  # the plain VJP, op by op


def test_raster_kernel_micro_benchmark_cuda_rows(cuda_device):
    """``benchmarks/raster_kernel_torch.py``'s cuda rows: CUDA-event device
    time of the hand kernels at the JAX file's shapes, with the H100 bound."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "benchmarks"))
    import raster_kernel_torch as rk

    before = (tr_ops.launch_count.n, fa_ops.launch_count.n)
    rows = rk.rows("cuda", ("cuda",)) + rk.flash_rows("cuda", ("cuda",))
    assert [r[0] for r in rows] == ["raster_cuda_500g_64px", "raster_cuda_2000g_128px",
                                    "flashattn_cuda_512s_4h_64d", "flashattn_cuda_1024s_8h_128d"]
    assert all(us > 0 and derived.startswith("h100_bound_us=") for _, us, derived in rows)
    assert tr_ops.launch_count.n > before[0] and fa_ops.launch_count.n > before[1]
