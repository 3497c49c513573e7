"""PyTorch port, spherical-harmonic colors in training: the port's train step
against the JAX package's ``make_train_step`` on a (1, 1) mesh at SH degrees
2 and 3, on tests/test_sh_colors.py's view-dependent scene (256 Gaussians,
32 px, two opposing cameras with different target tints), on the CPU (the
port's plain versions; the projection kernel's SH evaluation is held to the
same plain version on the card by tests/test_torch_gpu.py).

Each port step starts from the JAX state before the same step (carried
over as numpy), so the comparison holds step by step and Adam's sign flips
on near-zero gradients (tests/test_torch_train.py) cannot compound.
Tolerances, each with its reason:
- losses: rtol 1e-5 (float32 sums in another order);
- gradients of every leaf, the bands above DC included: atol 2e-5 * max|g|
  and rtol 2e-4, tests/test_torch_train.py's (the JAX kernel test's). They
  are read from Adam's first moment, g = (m' - 0.9 m) / 0.1, with the same
  m on both sides.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gaussians as JG
from repro.core import projection as JP
from repro.core.config import GSConfig as JGSConfig
from repro.core.train import init_state as jax_init_state
from repro.core.train import make_train_step as jax_make_train_step
from repro.core.train import state_shardings
from repro_torch.core import projection as TP
from repro_torch.core.config import GSConfig
from repro_torch.core.train import make_train_step, state_from_numpy

from torch_port_helpers import np_

N, RES = 256, 32
CFG_KW = dict(img_h=RES, img_w=RES, k_per_tile=128, batch_size=2)


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _scene(degree: int):
    """tests/test_sh_colors.py's scene at ``degree``: the JAX initial state,
    the two cameras and their tinted targets."""
    pts = np.random.default_rng(1).normal(0, 0.3, (N, 3)).astype(np.float32)
    g = JG.init_from_points(jnp.asarray(pts), sh_degree=degree, init_scale=0.06)
    assert g.sh.shape == (N, (degree + 1) ** 2, 3)
    cams = JP.Camera(*[jnp.stack(x) for x in zip(
        *[JP.look_at_camera(e, [0, 0, 0], [0, 1, 0], 40.0, 40.0, 16.0, 16.0) for e in ([0, 0, -3.0], [0, 0, 3.0])]
    )])
    gt = jnp.stack([
        jnp.full((RES, RES, 3), 0.8).at[..., 2].set(0.1),   # reddish from front
        jnp.full((RES, RES, 3), 0.2).at[..., 2].set(0.9),   # bluish from behind
    ])
    return jax_init_state(g), cams, gt


@functools.lru_cache(maxsize=None)
def _jax_step(degree: int):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    return mesh, jax_make_train_step(mesh, JGSConfig(**CFG_KW, sh_degree=degree))


def _assert_grad_close(got, want, err_msg=""):
    scale = max(float(np.abs(want).max()), 1e-8)
    np.testing.assert_allclose(got, want, atol=2e-5 * scale + 1e-10, rtol=2e-4, err_msg=err_msg)


def _steps_match(degree: int, steps: int):
    """``steps`` steps of the JAX package; before each, the port steps from
    the same state. Returns the max |g| of the bands above DC per step."""
    mesh, jstep = _jax_step(degree)
    tstep = make_train_step(GSConfig(**CFG_KW, sh_degree=degree))
    sj, cams_j, gt = _scene(degree)
    sj = jax.device_put(sj, state_shardings(mesh))
    cams_t, gt_t = TP.camera_from_numpy(cams_j), torch.tensor(np.asarray(gt))
    sh_grads = []
    for i in range(steps):
        before = _np_tree(sj)
        st, mt = tstep(state_from_numpy(before, "cpu"), cams_t, gt_t)
        sj, mj = jstep(sj, cams_j, gt)
        np.testing.assert_allclose(np_(mt["loss"]), np.asarray(mj["loss"]), rtol=1e-5, err_msg=f"step {i}")
        for name, m0, m_t, m_j in zip(JG.GaussianModel._fields, before.adam.m, st.adam.m, sj.adam.m):
            m0 = np.asarray(m0, np.float64)
            g_t = (np_(m_t).astype(np.float64) - 0.9 * m0) / 0.1
            g_j = (np.asarray(m_j, np.float64) - 0.9 * m0) / 0.1
            assert np.isfinite(g_t).all(), (name, i)
            _assert_grad_close(g_t, g_j, err_msg=f"{name}, step {i}")
            if name == "sh":
                sh_grads.append(float(np.abs(g_j[:, 1:]).max()))
                _assert_grad_close(g_t[:, 1:], g_j[:, 1:], err_msg=f"sh bands above DC, step {i}")
    return sh_grads


def test_sh_degree_2_train_steps_match_jax():
    """Three steps at SH degree 2: the bands above DC get a gradient from the
    first step (they are 0 at init) and are nonzero, view-dependent color,
    from the second on."""
    sh_grads = _steps_match(2, 3)
    assert all(g > 1e-6 for g in sh_grads), sh_grads


def test_sh_degree_3_train_step_matches_jax():
    sh_grads = _steps_match(3, 1)
    assert sh_grads[0] > 1e-6, sh_grads


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_sh_projection_at_nonzero_bands_matches_jax(degree):
    """The projection's colors with every band nonzero (random from the
    seed), which training only reaches after a step: the port's plain
    version against the JAX projection on the scene's two cameras."""
    sj, cams_j, _ = _scene(degree)
    k = (degree + 1) ** 2
    sh = np.random.default_rng(degree).normal(0, 0.3, (N, k, 3)).astype(np.float32)
    g = sj.params._replace(sh=jnp.asarray(sh))
    gt_ = state_from_numpy(_np_tree(sj._replace(params=g)), "cpu").params
    for v in range(2):
        cam = jax.tree_util.tree_map(lambda x: x[v], cams_j)
        got = np_(TP.project(gt_, TP.camera_from_numpy(cam)))
        want = np.asarray(jax.jit(JP.project)(g, cam))
        fin = np.isfinite(want)
        assert (np.isfinite(got) == fin).all()
        np.testing.assert_allclose(got[fin], want[fin], atol=2e-5, rtol=2e-5)
        assert np.ptp(want[:, JP.CR:JP.CB_ + 1]) > 0.1  # the bands make the colors vary
