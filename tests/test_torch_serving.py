"""PyTorch port, eval renders and serving: the port's eval-render factories
against the JAX package's on a 1x1 mesh; strip renders bitwise equal to the
port's own full frame (and only allclose to the JAX strips); the port's
RenderServer at 32 px (tile cache vs whole frame, depth 1 vs depth 2,
dedup, partial hits, close) and against the JAX server end to end."""
import jax
import numpy as np
import pytest
import torch

from repro.core.config import GSConfig as JGSConfig
from repro.core.train import make_batched_eval_render as jax_batched
from repro.core.train import make_tile_row_render as jax_strip
from repro.serve_gs import RenderServer as JaxRenderServer
from repro.serve_gs import build_lod_pyramid as jax_build_lod_pyramid
from repro.serve_gs import make_clients as jax_make_clients
from repro.serve_gs import stack_cameras as jax_stack_cameras
from repro_torch.core.config import GSConfig
from repro_torch.core.projection import camera_from_numpy
from repro_torch.core.train import make_batched_eval_render, make_eval_render, make_tile_row_render
from repro_torch.kernels.gsproject import ops as gp_ops
from repro_torch.kernels.tile_raster import ops as tr_ops
from repro_torch.serve_gs import RenderServer, build_lod_pyramid, make_clients, run_load, stack_cameras

from conftest import make_cam, make_scene
from torch_port_helpers import np_, to_port

H = W = 32
ATOL, RTOL = 3e-6, 1e-5


def _server(g=None, **kw):
    g = g if g is not None else make_scene(n=256, scale=0.06)
    cfg = GSConfig(img_h=H, img_w=W, k_per_tile=64)
    kw.setdefault("n_levels", 1)
    kw.setdefault("max_batch", 4)
    return RenderServer(jax.tree_util.tree_map(np.asarray, g), cfg, device="cpu", **kw)


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def test_batched_eval_render_matches_jax():
    g = make_scene(300, seed=3, scale=0.06)
    cfg = GSConfig(img_h=48, img_w=64, k_per_tile=64)
    cams_j = jax_stack_cameras([make_cam(48, 64, dist=d) for d in (2.5, 3.0)])
    gt = to_port(g)
    got = make_batched_eval_render(cfg)(gt, camera_from_numpy(cams_j))
    want = jax_batched(_mesh(), JGSConfig(img_h=48, img_w=64, k_per_tile=64))(g, cams_j)
    assert got.shape == (2, 48, 64, 3)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=ATOL, rtol=RTOL)
    img, t = make_eval_render(cfg)(gt, camera_from_numpy(make_cam(48, 64, dist=2.5)))
    np.testing.assert_array_equal(np_(img), np_(got[0]))
    assert t.shape == (48, 64)


@pytest.mark.parametrize("row", [0, 1])
def test_strip_bitwise_equals_own_full_frame_and_close_to_jax(row):
    g = make_scene(256, seed=4, scale=0.06)
    cam = make_cam(H, W)
    cfg = GSConfig(img_h=H, img_w=W, k_per_tile=64)
    gt, ct = to_port(g, cam)
    full = make_batched_eval_render(cfg)(gt, stack_cameras([ct]))[0]
    strip = make_tile_row_render(cfg, row=row)(gt, ct)
    rows = slice(row * cfg.tile_h, (row + 1) * cfg.tile_h)
    assert strip.shape == (cfg.tile_h, W, 3)
    assert torch.equal(strip, full[rows])  # bitwise: the tile cache rests on it
    want = jax_strip(_mesh(), JGSConfig(img_h=H, img_w=W, k_per_tile=64), row=row)(g, cam)
    np.testing.assert_allclose(np_(strip), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_strip_bitwise_equals_hier_frame_with_saturated_superblocks():
    """Full frames bin hierarchically; under superblock overflow a strip is
    still bitwise equal to its rows (the strip re-bins its superblock band)."""
    g = make_scene(3000, seed=6, scale=0.05)
    cfg = GSConfig(img_h=128, img_w=128, tile_h=8, tile_w=8, k_per_tile=8, binning="hier")
    cam = camera_from_numpy(make_cam(128, 128, dist=2.5))
    gt = to_port(g)
    full = make_eval_render(cfg)(gt, cam)[0]
    for row in (0, 9, 15):
        strip = make_tile_row_render(cfg, row=row)(gt, cam)
        assert torch.equal(strip, full[row * 8 : (row + 1) * 8])


@pytest.mark.parametrize("depth", [1, 2])
def test_tile_server_bitwise_equals_whole_frame_server(depth):
    g = make_scene(n=256, scale=0.06)
    frames = {}
    for tile in (True, False):
        s = _server(g, tile_cache=tile, pipeline_depth=depth, n_levels=2, frames_capacity=64)
        futs = []
        for c in make_clients(3, n_views=6, img_h=H, img_w=W, radius_spread=1.0):
            for _ in range(4):
                futs.append(s.submit(c.next_camera(), client_id=c.client_id))
        s.run()
        frames[tile] = [f.result() for f in futs]
    for a, b in zip(frames[True], frames[False]):
        np.testing.assert_array_equal(a, b)


def test_depth1_and_depth2_serve_identical_frames():
    out = {}
    for depth in (1, 2):
        s = _server(pipeline_depth=depth, cache_capacity=0)
        futs = [s.submit(c.next_camera()) for c in make_clients(4, n_views=8, img_h=H, img_w=W)
                for _ in range(2)]
        s.run()
        out[depth] = [f.result() for f in futs]
        assert s.report()["pipeline"]["max_in_flight"] <= depth
    for a, b in zip(out[1], out[2]):
        np.testing.assert_array_equal(a, b)


def test_in_flight_dedup_renders_once():
    s = _server(pipeline_depth=2, cache_capacity=0)
    cam = make_cam(H, W)
    futs = [s.submit(camera_from_numpy(cam), client_id=c) for c in range(4)]
    assert s.batcher.pending == 1
    assert s.run() == 4
    rep = s.report()
    assert rep["render"]["calls"] == 1 and rep["pipeline"]["deduped"] == 3
    assert all(f.result() is futs[0].result() for f in futs)


def test_partial_hit_renders_only_missing_rows():
    s = _server(n_levels=1)
    cam = camera_from_numpy(make_cam(H, W))
    first = s.submit(cam).result()
    s.invalidate(0, rows={1})
    fut = s.submit(cam)
    assert s.partial_hits == 1
    again = fut.result()
    assert s.rows_rendered == 1 and s.strip_traces == 1
    np.testing.assert_array_equal(again, first)


def test_close_fails_queued_and_retires_in_flight():
    s = _server(pipeline_depth=2, cache_capacity=0)
    cams = [c.next_camera() for c in make_clients(4, n_views=8, img_h=H, img_w=W)]
    futs = [s.submit(c) for c in cams]
    s.step()  # dispatches up to depth 2 batches, retires one
    failed = s.close()
    done = [f for f in futs if f.done() and f._error is None]
    assert failed == len(futs) - len(done)
    for f in futs:
        if f in done:
            assert f.result().shape == (H, W, 3)
        else:
            with pytest.raises(RuntimeError, match="closed"):
                f.result()
    with pytest.raises(RuntimeError, match="closed"):
        s.submit(cams[0])
    assert s.close() == 0 and s.closed


def test_lod_pyramid_equals_jax():
    g = jax.tree_util.tree_map(np.asarray, make_scene(n=700, seed=5))
    a = jax_build_lod_pyramid(g, n_levels=3, keep_ratio=0.5, pad_quantum=64)
    b = build_lod_pyramid(g, n_levels=3, keep_ratio=0.5, pad_quantum=64)
    assert a.live_counts == b.live_counts and a.scene_extent == b.scene_extent
    for la, lb in zip(a.levels, b.levels):
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


def test_server_matches_jax_server_end_to_end():
    """The slice as a whole: same scene, same client fleet, same requests
    through both servers; frames agree request for request."""
    g = make_scene(n=256, scale=0.06, seed=12)
    kw = dict(n_levels=2, max_batch=4, pipeline_depth=2, frames_capacity=64)
    jsrv = JaxRenderServer(g, JGSConfig(img_h=H, img_w=W, k_per_tile=64), **kw)
    tsrv = _server(g, **kw)
    jc = jax_make_clients(3, n_views=6, img_h=H, img_w=W, radius_spread=1.0)
    tc = make_clients(3, n_views=6, img_h=H, img_w=W, radius_spread=1.0)
    launches = (gp_ops.launch_count.n, tr_ops.launch_count.n)
    jrep = run_load(jsrv, jc, requests_per_client=3)
    trep = run_load(tsrv, tc, requests_per_client=3)
    assert trep["completed"] == jrep["completed"] == 9
    assert trep["lod"]["requests_per_level"] == jrep["lod"]["requests_per_level"]
    assert trep["cache"]["hits"] == jrep["cache"]["hits"]
    for rid_j, rid_t in zip(sorted(jsrv.frames), sorted(tsrv.frames)):
        np.testing.assert_allclose(tsrv.frames[rid_t], jsrv.frames[rid_j], atol=ATOL, rtol=RTOL)
    assert (gp_ops.launch_count.n, tr_ops.launch_count.n) == launches  # CPU: plain versions only


def test_add_timestep_changed_rerenders_only_dirty_rows():
    g = make_scene(n=256, scale=0.03, seed=13)
    s = _server(g, n_levels=1)
    cam = camera_from_numpy(make_cam(H, W))
    s.submit(cam).result()
    gn = jax.tree_util.tree_map(np.array, g)
    means = gn.means.copy()
    top = np.argsort(-means[:, 1])[:2]  # nudge two Gaussians
    means[top, 0] += 0.01
    new = gn._replace(means=means)
    s.add_timestep(0, new, changed=top)
    fut = s.submit(cam)
    frame = fut.result()
    fresh = _server(new, n_levels=1).submit(cam).result()
    np.testing.assert_array_equal(frame, fresh)
    assert s.rows_rendered <= s.tiles_y


def test_cuda_server_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: RenderServer(device='cuda') serves instead of refusing")
    with pytest.raises(RuntimeError, match="CUDA"):
        RenderServer(jax.tree_util.tree_map(np.asarray, make_scene(n=64)), GSConfig(img_h=H, img_w=W))
