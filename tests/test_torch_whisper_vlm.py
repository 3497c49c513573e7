"""PyTorch port, whisper and the VLM vs the JAX package, and the configs of
every architecture: ``apply_mrope`` (Qwen2-VL's M-RoPE), whisper-tiny (the
encoder, the decoder with its cross-attention, the zeroed cross cache) and
qwen2-vl-72b (merged embeddings and position triples) at the smoke configs
in float32, with weights from the JAX package's ``lm.init_params`` through
``params_from_jax``, inputs from numpy seeds and the JAX side
``jax.jit``ed; then each of the ten configs and ``configs/common.py``'s
input, cache and parameter specs against the JAX package's, at every shape
of ``SHAPES``.

Tolerances: ``apply_mrope`` at atol 1e-5 x max |out| and its gradient at
the North star's atol 2e-5 x max |g|, rtol 2e-4; the models as
``tests/test_torch_lm.py`` and ``test_torch_lm_train.py`` hold the dense
ones (logits atol 1e-4, rtol 1e-4, greedy ids equal, loss rtol 1e-5, train
steps through ``check_train_steps``); configs and specs exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import common as J_common
from repro.configs import get_arch as j_get_arch
from repro.models import api as J_api
from repro.models import common as J_C
from repro.models import lm as J_lm
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs import common as T_common
from repro_torch.launch import serve as T_cli
from repro_torch.models import api, lm
from repro_torch.models import common as C
from repro_torch.models.params import params_from_jax

from torch_port_helpers import (
    check_train_steps,
    close_grad,
    jax_serve_steps,
    lm_batch,
    np_,
    port_serve_steps,
    tree_shapes,
)

ATOL, RTOL = 1e-4, 1e-4
ARCHS = ["whisper-tiny", "qwen2-vl-72b"]


@pytest.mark.parametrize("sections,theta", [((8, 12, 12), 1_000_000.0), ((16, 24, 24), 10_000.0)])
def test_apply_mrope_and_its_gradient_match_jax(sections, theta):
    hd = 2 * sum(sections)
    r = np.random.default_rng(hd)
    x = r.normal(0, 1, (2, 37, 3, hd)).astype(np.float32)
    pos = T_common.vlm_positions3(2, 37, n_text=9, grid=(3, 5))
    pos[1] = r.integers(0, 4000, (37, 3))  # positions far apart, as long contexts reach
    g = r.normal(0, 1, x.shape).astype(np.float32)

    def jf(x_):
        return J_C.apply_mrope(x_, jnp.asarray(pos), theta, sections)

    want, vjp = jax.vjp(jax.jit(jf), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = C.apply_mrope(xt, torch.from_numpy(pos), theta, sections)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-5 * float(np.abs(want).max()), rtol=0)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    close_grad(np_(gx), np.asarray(vjp(jnp.asarray(g))[0]), "d/dx")


def test_vlm_positions3_is_a_text_run_then_an_image_grid():
    pos = T_common.vlm_positions3(1, 12, n_text=3, grid=(2, 3))[0]
    np.testing.assert_array_equal(pos[:3], [[0, 0, 0], [1, 1, 1], [2, 2, 2]])
    np.testing.assert_array_equal(pos[3:9], [[3, 3, 3], [3, 3, 4], [3, 3, 5], [3, 4, 3], [3, 4, 4], [3, 4, 5]])
    np.testing.assert_array_equal(pos[9:], [[6, 6, 6], [7, 7, 7], [8, 8, 8]])


def _model(arch, seed=0):
    jcfg, tcfg = j_get_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    jp = J_lm.init_params(jcfg, jax.random.key(seed))
    return jcfg, tcfg, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_cache_layout_match_jax(arch):
    """The trees key for key, shape and dtype; whisper's cross cache is
    zeros, as the JAX package leaves it."""
    jcfg, tcfg = j_get_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    jp = jax.eval_shape(lambda: J_lm.init_params(jcfg, jax.random.key(0)))
    assert tree_shapes(lm.init_params(tcfg, seed=0, device="cpu")) == tree_shapes(jp)
    tc = api.init_cache(tcfg, 2, 40, device="cpu")
    assert tree_shapes(tc) == tree_shapes(jax.eval_shape(lambda: J_api.init_cache(jcfg, 2, 40)))
    if arch == "whisper-tiny":
        assert all(not x.any() for x in tc["cross_k"] + tc["cross_v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_loss_match_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    jb, tb = lm_batch(jcfg, 2, 70, seed=1)
    want = np.asarray(jax.jit(J_api.make_prefill_step(jcfg))(jp, jb))
    got = np_(api.make_prefill_step(tcfg)(tp, tb))
    assert got.shape == want.shape == (2, 1, jcfg.vocab)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    loss = jax.jit(lambda p, b: J_api.compute_loss(jcfg, p, b))(jp, jb)
    np.testing.assert_allclose(float(api.compute_loss(tcfg, tp, tb)), float(loss), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_jax(arch):
    """8 prompt tokens stepped through the decode cache, then 4 greedy
    tokens, as the serving CLI runs them (whisper against its zeroed
    cross cache; the VLM with M-RoPE at the token's position); and the CLI
    itself on the CPU."""
    jcfg, tcfg, jp, tp = _model(arch, seed=1)
    prompt = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    j_logits, j_ids = jax_serve_steps(jax.jit(J_api.make_serve_step(jcfg)),
                                      lambda b, n: J_api.init_cache(jcfg, b, n), jp, prompt, 4, 12)
    t_logits, t_ids = port_serve_steps(api.make_serve_step(tcfg), api.init_cache(tcfg, 2, 12, device="cpu"), tp,
                                       prompt, 4)
    for step, (got, want) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=f"step {step}")
    np.testing.assert_array_equal(t_ids, j_ids)
    res = T_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert res["ids"].shape == (2, 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    jcfg, tcfg = j_get_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    jb, tb = lm_batch(jcfg, 2, 40, seed=2)
    check_train_steps(jcfg, tcfg, jb, tb, steps=1, lr=3e-4)


# --------------------------------------------- every config and its specs
@pytest.mark.parametrize("aid", J_ARCH_IDS)
def test_config_equals_jax_package(aid):
    jm, tm = j_get_arch(aid), get_arch(aid)
    assert tm.SKIP_SHAPES == jm.SKIP_SHAPES
    for name in ("config", "smoke_config"):
        jc, tc = getattr(jm, name)(), getattr(tm, name)()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tc.param_count(), tc.active_param_count(), tc.hd) == (jc.param_count(), jc.active_param_count(), jc.hd)
    assert ARCH_IDS == J_ARCH_IDS


def _spec_shapes(tree):
    """tree_shapes for either package's stand-ins (ShapeDtypeStruct or meta tensors)."""
    if isinstance(tree, dict):
        return {k: _spec_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_spec_shapes(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
    return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")


@pytest.mark.parametrize("aid", J_ARCH_IDS)
def test_specs_equal_jax_for_every_shape(aid):
    """The counterpart of ``tests/test_substrates.py``'s input-spec test at
    full size: every shape's batch specs, decode specs (the cache at its
    depth) and the parameter specs, shape and dtype equal to the JAX
    package's, all on the ``meta`` device (nothing allocated)."""
    cfg = get_arch(aid).config()
    jcfg = j_get_arch(aid).config()
    assert T_common.SHAPES == {k: T_common.ShapeCase(*v) for k, v in J_common.SHAPES.items()}
    for name, shape in T_common.SHAPES.items():
        got = _spec_shapes(T_common.lm_batch_specs(cfg, shape))
        assert got == _spec_shapes(J_common.lm_batch_specs(jcfg, J_common.SHAPES[name])), name
        assert all(s[0][0] == shape.global_batch for s in got.values())
        if shape.kind == "decode":
            specs = T_common.decode_specs(cfg, shape)
            # the position is a host value (an int32 CPU scalar at the cache's
            # last slot), so the serve step runs on the stand-ins
            pos = specs.pop("pos")
            assert pos.device.type == "cpu" and int(pos) == shape.seq_len - 1
            got = {**_spec_shapes(specs), "pos": (tuple(pos.shape), str(pos.dtype).removeprefix("torch."))}
            assert got == _spec_shapes(J_common.decode_specs(jcfg, J_common.SHAPES[name])), name
    assert _spec_shapes(T_common.params_specs(cfg)) == _spec_shapes(J_common.params_specs(jcfg))
