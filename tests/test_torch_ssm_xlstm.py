"""PyTorch port, the recurrent families vs the JAX package: the Mamba2 (SSD)
block of ``models/ssm.py``, the mLSTM and sLSTM blocks of
``models/xlstm.py``, and the zamba2-7b hybrid and xlstm-350m assembled, at
the smoke configs in float32. Block weights come from the JAX initializers,
model weights from the JAX package's ``lm.init_params``, both through
``params_from_jax``; inputs from numpy seeds; the JAX side is ``jax.jit``ed.

Tolerances:
- block outputs and decode states at atol 1e-5 x max |out| (float32; the
  packages' products sum in different orders);
- gradients at the North star's atol 2e-5 x max |g|, rtol 2e-4, over 70
  tokens, which is not a whole number of 64-token chunks, so the padded
  chunk (SSD's zeros, the mLSTM's forget-gate log -1e4) is in the graph;
- the port's own chunked-equals-recurrent properties at the JAX tests'
  atol 2e-4, rtol 2e-3, and the decode-equals-prefix-forward one at its
  5e-3;
- models as ``tests/test_torch_lm.py`` and ``test_torch_lm_train.py`` hold
  the dense ones: logits at atol 1e-4, rtol 1e-4, greedy ids equal, the
  loss at rtol 1e-5, train steps through ``check_train_steps``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import api as J_api
from repro.models import lm as J_lm
from repro.models import ssm as J_ssm
from repro.models import xlstm as J_xl
from repro_torch.configs import get_arch
from repro_torch.launch import serve as T_cli
from repro_torch.models import api, lm
from repro_torch.models import common as C
from repro_torch.models import ssm as T_ssm
from repro_torch.models import xlstm as T_xl
from repro_torch.models.params import params_from_jax

from torch_port_helpers import (
    check_train_steps,
    close_grad,
    flat_tree,
    jax_serve_steps,
    lm_batch,
    np_,
    port_serve_steps,
    tree_shapes,
)

ATOL, RTOL = 1e-4, 1e-4
SEQ = 70  # not a whole number of 64-token chunks
ARCHS = ["zamba2-7b", "xlstm-350m"]


def _block_cfg(name):
    return j_get_arch("zamba2_7b" if name == "mamba2" else "xlstm_350m").smoke_config()


# name -> (JAX init, train, cache init, decode; the port's train, cache init, decode)
BLOCKS = {
    "mamba2": (J_ssm.mamba2_init, J_ssm.mamba2_train, lambda c, b: J_ssm.mamba2_cache_init(c, b, jnp.float32),
               J_ssm.mamba2_decode, T_ssm.mamba2_train,
               lambda c, b: T_ssm.mamba2_cache_init(c, b, torch.float32, "cpu"), T_ssm.mamba2_decode),
    "mlstm": (J_xl.mlstm_init, J_xl.mlstm_train, J_xl.mlstm_cache_init, J_xl.mlstm_decode, T_xl.mlstm_train,
              lambda c, b: T_xl.mlstm_cache_init(c, b, "cpu"), T_xl.mlstm_decode),
    "slstm": (J_xl.slstm_init, J_xl.slstm_train, J_xl.slstm_cache_init, J_xl.slstm_decode, T_xl.slstm_train,
              lambda c, b: T_xl.slstm_cache_init(c, b, "cpu"), T_xl.slstm_decode),
}


def _block(name, seed=0):
    cfg = _block_cfg(name)
    jp = BLOCKS[name][0](jax.random.key(seed), cfg, jnp.float32)
    return cfg, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _x(cfg, b, s, seed):
    return (np.random.default_rng(seed).normal(0, 1, (b, s, cfg.d_model)) * 0.5).astype(np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(want).max()), rtol=0, err_msg=what)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_train_matches_jax(name):
    cfg, jp, tp = _block(name)
    x = _x(cfg, 2, SEQ, 1)
    want = np.asarray(jax.jit(lambda p, x_: BLOCKS[name][1](p, cfg, x_))(jp, jnp.asarray(x)))
    got = np_(BLOCKS[name][4](tp, cfg, torch.from_numpy(x)))
    assert got.shape == want.shape == x.shape
    _close(got, want)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_gradients_match_jax(name):
    """d(sum(out * g))/d(every weight and the input)."""
    cfg, jp, tp = _block(name, seed=2)
    x = _x(cfg, 2, SEQ, 3)
    g = np.random.default_rng(4).normal(0, 1, x.shape).astype(np.float32)

    def jloss(p, x_):
        return jnp.sum(BLOCKS[name][1](p, cfg, x_) * jnp.asarray(g))

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.requires_grad_() for k, v in tp.items() if not isinstance(v, dict)}
    leaves.update({f"{k}/scale": v["scale"].requires_grad_() for k, v in tp.items() if isinstance(v, dict)})
    xt = torch.from_numpy(x).requires_grad_()
    out = BLOCKS[name][4](tp, cfg, xt)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)), [xt, *leaves.values()])
    close_grad(np_(grads[0]), np.asarray(jgx), "d/dx")
    want = flat_tree(jgp)
    for key, got in zip(leaves, grads[1:]):
        close_grad(np_(got), want[tuple(key.split("/"))], f"d/d{key}")
    assert len(want) == len(leaves)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_decode_matches_jax(name):
    """Six decode steps from a fresh cache: each step's output and the final
    cache; the port writes its cache in place and returns it."""
    cfg, jp, tp = _block(name, seed=5)
    xs = _x(cfg, 2, 6, 6)
    jdec = jax.jit(lambda p, x_, c: BLOCKS[name][3](p, cfg, x_, c))
    jc, tc = BLOCKS[name][2](cfg, 2), BLOCKS[name][5](cfg, 2)
    for t in range(6):
        want, jc = jdec(jp, jnp.asarray(xs[:, t:t + 1]), jc)
        got, tc2 = BLOCKS[name][6](tp, cfg, torch.from_numpy(xs[:, t:t + 1]), tc)
        assert tc2 is tc
        _close(np_(got), np.asarray(want), f"step {t}")
    jflat, tflat = flat_tree(jc), flat_tree(tc)
    assert jflat.keys() == tflat.keys()
    for key in jflat:
        _close(tflat[key], jflat[key], f"cache {key}")


# --------------------------------------------- the JAX package's own properties, on the port
def _port_block(name, cfg, seed):
    init = {"mamba2": T_ssm.mamba2_init, "mlstm": T_xl.mlstm_init, "slstm": T_xl.slstm_init}[name]
    return init(torch.Generator().manual_seed(seed), cfg, torch.float32)


@pytest.mark.parametrize("name,cfg_kw,s", [
    ("mamba2", dict(d_model=64, ssm_heads=4, ssm_state=8), 96),
    ("mlstm", dict(d_model=64, n_heads=2, n_kv_heads=2), 80),
    ("slstm", dict(d_model=64, n_heads=2, n_kv_heads=2), 24),
])
def test_chunked_equals_recurrent(name, cfg_kw, s):
    """``tests/test_ssm_xlstm.py``'s three properties: the chunked (or
    scanned) train form equals the step-by-step decode form."""
    cfg = dataclasses.replace(_block_cfg(name), **cfg_kw)
    p = _port_block(name, cfg, 0)
    x = torch.from_numpy(_x(cfg, 2, s, 0))
    y_par = BLOCKS[name][4](p, cfg, x)
    cache = BLOCKS[name][5](cfg, 2)
    ys = [BLOCKS[name][6](p, cfg, x[:, t:t + 1], cache)[0] for t in range(s)]
    np.testing.assert_allclose(np_(y_par), np_(torch.cat(ys, 1)), atol=2e-4, rtol=2e-3)


def test_decode_matches_prefix_forward_ssm():
    """``tests/test_arch_smoke.py``'s property for the mamba family: the
    zamba prompt forward's logits equal the decode cache stepped through
    the same tokens."""
    cfg = get_arch("zamba2_7b").smoke_config()
    params = lm.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (1, 6)))
    x = C.embed_lookup(params["embed"], toks)
    with torch.no_grad():
        h = lm.backbone_train(cfg, params, x, torch.arange(6)[None])
    full = np_(C.lm_logits(params["embed"], h))
    cache = api.init_cache(cfg, 1, 6, device="cpu")
    serve = api.make_serve_step(cfg)
    outs = [np_(serve(params, cache, toks[:, t:t + 1], t)[0][0, 0]) for t in range(6)]
    np.testing.assert_allclose(np.stack(outs), full[0], atol=5e-3, rtol=5e-3)


# --------------------------------------------- the assembled models
def _model(arch, seed=0):
    jcfg, tcfg = j_get_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    jp = J_lm.init_params(jcfg, jax.random.key(seed))
    return jcfg, tcfg, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_cache_layout_match_jax(arch):
    jcfg, tcfg = j_get_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    jp = jax.eval_shape(lambda: J_lm.init_params(jcfg, jax.random.key(0)))
    assert tree_shapes(lm.init_params(tcfg, seed=0, device="cpu")) == tree_shapes(jp)
    jc = jax.eval_shape(lambda: J_api.init_cache(jcfg, 2, 40))
    assert tree_shapes(api.init_cache(tcfg, 2, 40, device="cpu")) == tree_shapes(jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_loss_match_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    jb, tb = lm_batch(jcfg, 2, SEQ, seed=1)
    want = np.asarray(jax.jit(J_api.make_prefill_step(jcfg))(jp, jb))
    got = np_(api.make_prefill_step(tcfg)(tp, tb))
    assert got.shape == want.shape == (2, 1, jcfg.vocab)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    loss = jax.jit(lambda p, b: J_api.compute_loss(jcfg, p, b))(jp, jb)
    np.testing.assert_allclose(float(api.compute_loss(tcfg, tp, tb)), float(loss), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_jax(arch):
    """8 prompt tokens stepped through the decode cache, then 4 greedy
    tokens, as the serving CLI runs them; and the CLI itself on the CPU."""
    jcfg, tcfg, jp, tp = _model(arch, seed=1)
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
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
    jb, tb = lm_batch(jcfg, 2, SEQ, seed=2)
    check_train_steps(jcfg, tcfg, jb, tb, steps=1, lr=3e-4)


@pytest.mark.parametrize("n_layers", [1, 5])
def test_zamba_remainder_layers_match_jax(n_layers):
    """zamba at period 1 with remainder layers: 1 layer has no double unit
    (zero-length stacks, as the JAX package's vmap over no keys gives) and
    one remainder mamba layer followed by shared block A; 5 layers have 2
    double units and that remainder. Layouts, prefill and serve steps
    against the JAX package."""
    jcfg = dataclasses.replace(j_get_arch("zamba2_7b").smoke_config(), n_layers=n_layers)
    tcfg = dataclasses.replace(get_arch("zamba2_7b").smoke_config(), n_layers=n_layers)
    jp = J_lm.init_params(jcfg, jax.random.key(3))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert tree_shapes(lm.init_params(tcfg, seed=0, device="cpu")) == tree_shapes(jp)
    assert tree_shapes(api.init_cache(tcfg, 2, 12, device="cpu")) == tree_shapes(
        jax.eval_shape(lambda: J_api.init_cache(jcfg, 2, 12)))
    jb, tb = lm_batch(jcfg, 2, SEQ, seed=4)
    want = np.asarray(jax.jit(J_api.make_prefill_step(jcfg))(jp, jb))
    np.testing.assert_allclose(np_(api.make_prefill_step(tcfg)(tp, tb)), want, atol=ATOL, rtol=RTOL)
    prompt = np.random.default_rng(9).integers(0, jcfg.vocab, (2, 6)).astype(np.int32)
    j_logits, j_ids = jax_serve_steps(jax.jit(J_api.make_serve_step(jcfg)),
                                      lambda b, n: J_api.init_cache(jcfg, b, n), jp, prompt, 3, 12)
    t_logits, t_ids = port_serve_steps(api.make_serve_step(tcfg), api.init_cache(tcfg, 2, 12, device="cpu"), tp,
                                       prompt, 3)
    for step, (got, w) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_allclose(got, w, atol=ATOL, rtol=RTOL, err_msg=f"step {step}")
    np.testing.assert_array_equal(t_ids, j_ids)
