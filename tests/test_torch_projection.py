"""PyTorch port, Gaussians and projection: the port's ``project`` (plain
version on the CPU) against the JAX package's projection and its Pallas
projection kernel in interpret mode; depth sort order; converters; the
numpy bounds mirror; the kernel wrapper's layout. The CUDA kernel itself is
held to its plain version in tests/test_torch_gpu.py, on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gaussians as JG
from repro.core import projection as JP
from repro.kernels.gsproject.ops import project_packed as jax_project_packed
from repro_torch.core import gaussians as TG
from repro_torch.core import projection as TP
from repro_torch.kernels import _lib
from repro_torch.kernels.gsproject import ops as gp_ops
from repro_torch.kernels.gsproject.ref import project_ref

from conftest import make_cam, make_scene
from torch_port_helpers import np_, to_port

ATOL = RTOL = 2e-5  # tests/test_gsproject_kernel.py's tolerance
jax_project = jax.jit(JP.project)  # one compile per shape instead of op-by-op dispatch
SWEEP = [(64, 32, 32), (700, 64, 64), (1500, 48, 96), (1024, 64, 64)]


def _assert_packed_close(got, want):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()  # inf depth pattern identical
    np.testing.assert_array_equal(got[~finite], want[~finite])
    np.testing.assert_allclose(got[finite], want[finite], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n,h,w", SWEEP)
def test_project_matches_jax(n, h, w):
    g = make_scene(n, seed=n)
    cam = make_cam(h, w)
    gt, ct = to_port(g, cam)
    _assert_packed_close(TP.project(gt, ct), jax_project(g, cam))


@pytest.mark.parametrize("n,h,w", SWEEP)
def test_project_matches_jax_pallas_interpret(n, h, w):
    """The JAX projection kernel (interpret mode) computes the port's function."""
    g = make_scene(n, seed=n)
    cam = make_cam(h, w)
    gt, ct = to_port(g, cam)
    _assert_packed_close(gp_ops.project_packed(gt, ct), jax_project_packed(g, cam, backend="pallas"))


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_project_higher_sh_degrees_match_jax(degree):
    n = 300
    g = make_scene(n, seed=11 + degree)
    k = (degree + 1) ** 2
    sh = np.random.default_rng(degree).normal(0, 0.5, (n, k, 3)).astype(np.float32)
    g = g._replace(sh=jnp.asarray(sh))
    cam = make_cam(48, 64)
    gt, ct = to_port(g, cam)
    _assert_packed_close(TP.project(gt, ct), jax_project(g, cam))


def test_behind_camera_rows_are_dead():
    """Gaussians behind the near plane: opacity 0, radius 0, depth +inf."""
    g = make_scene(200, seed=5, spread=2.5)
    cam = make_cam(32, 32, dist=1.0)
    gt, ct = to_port(g, cam)
    got = np_(TP.project(gt, ct))
    want = np.asarray(jax_project(g, cam))
    behind = ~np.isfinite(want[:, JP.DEPTH])
    assert behind.any() and (~behind).any()
    assert (got[behind, JP.OP] == 0).all() and (got[behind, JP.RAD] == 0).all()
    assert np.isinf(got[behind, JP.DEPTH]).all()
    _assert_packed_close(got, want)


def test_sort_by_depth_order_equals_jax_with_ties():
    """Stable sort: tied depths (and the +inf tail) keep index order, as
    jnp.argsort does, so tile lists match entry for entry."""
    r = np.random.default_rng(3)
    packed = r.normal(0, 1, (500, 11)).astype(np.float32)
    packed[:, JP.DEPTH] = r.integers(0, 20, 500).astype(np.float32)  # many ties
    packed[r.choice(500, 40, replace=False), JP.DEPTH] = np.inf
    sj, oj = JP.sort_by_depth(jnp.asarray(packed))
    st, ot = TP.sort_by_depth(torch.as_tensor(packed))
    np.testing.assert_array_equal(np_(ot), np.asarray(oj))
    np.testing.assert_array_equal(np_(st), np.asarray(sj))


def test_model_and_camera_converters_roundtrip():
    g = make_scene(64, seed=2)
    cam = make_cam(32, 48)
    gt, ct = to_port(g, cam)
    for name, a, b in zip(JG.GaussianModel._fields, g, TG.to_numpy(gt)):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)
    for name in JP.Camera._fields:
        np.testing.assert_array_equal(np_(getattr(ct, name)), np.asarray(getattr(cam, name)))
    np.testing.assert_allclose(np_(ct.campos), np.asarray(cam.campos), atol=1e-6)
    assert gt.n == 64 and gt.sh_degree == 0 and gt.means.device.type == "cpu"


def test_look_at_camera_matches_jax():
    args = ([0.3, -2.0, 1.5], [0.1, 0.0, -0.2], [0, 0, 1], 70.0, 71.0, 32.0, 24.0)
    cj = JP.look_at_camera(*args)
    ct = TP.look_at_camera(*args)
    for name in JP.Camera._fields:
        np.testing.assert_allclose(np_(getattr(ct, name)), np.asarray(getattr(cj, name)), atol=1e-6)


@pytest.mark.parametrize("init_scale", [None, 0.05])
def test_init_from_points_matches_jax(init_scale):
    r = np.random.default_rng(7)
    pts = r.normal(0, 0.5, (300, 3)).astype(np.float32)
    cols = r.uniform(0.1, 0.9, (300, 3)).astype(np.float32)
    gj = JG.init_from_points(jnp.asarray(pts), jnp.asarray(cols), init_scale=init_scale)
    gt = TG.init_from_points(pts, cols, init_scale=init_scale, device="cpu")
    for name, a, b in zip(JG.GaussianModel._fields, gj, gt):
        np.testing.assert_allclose(np_(b), np.asarray(a), atol=1e-6, rtol=1e-6, err_msg=name)


def test_matrix_helpers_match_jax():
    """quat_to_rotmat / covariance3d / eval_sh (the plain projection's helpers)."""
    g = make_scene(128, seed=9)
    sh = np.random.default_rng(9).normal(0, 0.5, (128, 16, 3)).astype(np.float32)
    dirs = np.random.default_rng(10).normal(0, 1, (128, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    gt = to_port(g)
    np.testing.assert_allclose(np_(TG.quat_to_rotmat(gt.quats)), np.asarray(JG.quat_to_rotmat(g.quats)), atol=1e-6)
    np.testing.assert_allclose(np_(TG.covariance3d(gt)), np.asarray(JG.covariance3d(g)), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(
        np_(TG.eval_sh(torch.as_tensor(sh), torch.as_tensor(dirs))),
        np.asarray(JG.eval_sh(jnp.asarray(sh), jnp.asarray(dirs))), atol=1e-5,
    )


def test_project_bounds_np_equals_jax():
    """The float64 numpy mirror is a copy: identical bounds, bit for bit."""
    g = make_scene(300, seed=4)
    cam = make_cam(64, 64)
    gn = jax.tree_util.tree_map(np.asarray, g)
    idx = np.arange(0, 300, 3)
    for got, want in zip(TP.project_bounds_np(gn, TP.camera_from_numpy(cam), idx),
                         JP.project_bounds_np(gn, cam, idx)):
        np.testing.assert_array_equal(got, want)


def test_kernel_layout_matches_jax_wrapper():
    """The kernel's inputs: the 32-float camera vector laid out as the JAX
    wrapper lays it out, and the model's own tensors, which the port builds
    in the layout the kernel reads (contiguous float32 rows, no copy)."""
    n = 1500
    g = make_scene(n, seed=8)
    cam = make_cam(48, 96)
    gt, ct = to_port(g, cam)
    for x, cols in ((gt.means, (3,)), (gt.log_scales, (3,)), (gt.quats, (4,)), (gt.opacity_logit, ()),
                    (gt.sh, (1, 3))):
        assert x.dtype == torch.float32 and x.is_contiguous() and tuple(x.shape) == (n,) + cols
    np.testing.assert_array_equal(np_(gt.sh[:, 0, :]), np.asarray(g.sh[:, 0, :]))
    want = np.concatenate([
        np.asarray(cam.viewmat).reshape(-1),
        np.asarray([cam.fx, cam.fy, cam.cx, cam.cy], np.float32),
        np.asarray([0.01], np.float32),
        np.asarray(cam.campos),
        np.zeros(8, np.float32),
    ]).astype(np.float32)
    np.testing.assert_allclose(gp_ops.cam_vector(ct), want, atol=1e-6)


def test_cpu_path_runs_plain_version_and_counts_nothing():
    """A CPU model never reaches the kernel: no launch is counted, and the
    kernel's own entry refuses CPU tensors instead of computing on them."""
    g = make_scene(64, seed=1)
    cam = make_cam(32, 32)
    gt, ct = to_port(g, cam)
    before = gp_ops.launch_count.n
    np.testing.assert_array_equal(np_(gp_ops.project_packed(gt, ct)), np_(project_ref(gt, ct)))
    assert gp_ops.launch_count.n == before
    with pytest.raises(ValueError, match="CUDA"):
        gp_ops.launch(gt, gp_ops.cam_vector(ct))


def test_kernel_build_names_missing_toolchain(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib.find_nvcc()
