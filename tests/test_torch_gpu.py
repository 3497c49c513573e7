"""PyTorch port, on the card: each hand-written CUDA kernel against its plain
PyTorch version, and the serving path through both kernels.

Every test here needs a CUDA device and skips without one (the decision is
made inside the ``cuda_device`` fixture, so every xdist worker collects the
same tests). The machine with the card has no JAX, so this file imports
only torch, numpy and the port, and makes its inputs with numpy from a seed;
the JAX parity of the plain versions is held by the other
``tests/test_torch_*.py`` files on a CPU host. Run it on the card with

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import gaussians as G
from repro_torch.core import projection as P
from repro_torch.core import render as R
from repro_torch.core.config import GSConfig
from repro_torch.core.train import make_batched_eval_render, make_tile_row_render
from repro_torch.kernels import _lib
from repro_torch.kernels.gsproject import ops as gp_ops
from repro_torch.kernels.gsproject.ref import project_ref
from repro_torch.kernels.tile_raster import ops as tr_ops
from repro_torch.kernels.tile_raster.ref import composite_ref
from repro_torch.serve_gs import RenderServer, make_clients, run_load, stack_cameras

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
    assert lib.gsproject_fwd and lib.tile_raster_fwd


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


def test_gsproject_kernel_refuses_higher_sh(cuda_device):
    g = _scene(64, seed=3)
    g = g._replace(sh=np.zeros((64, 4, 3), np.float32))
    with pytest.raises(NotImplementedError, match="SH degree 0"):
        P.project(G.from_numpy(g, cuda_device), _cam(32, 32))


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
    np.testing.assert_allclose(img.cpu().numpy(), img_c.numpy(), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(t.cpu().numpy(), t_c.numpy(), atol=1e-5, rtol=1e-4)


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
    out_k, t_k = tr_ops.composite(st, vt, **kw)
    out_p, t_p = composite_ref(st, vt, **kw)
    np.testing.assert_allclose(out_k.cpu().numpy(), out_p.cpu().numpy(), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(t_k.cpu().numpy(), t_p.cpu().numpy(), atol=1e-5, rtol=1e-4)


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
