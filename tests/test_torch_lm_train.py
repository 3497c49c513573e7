"""PyTorch port, LM training vs the JAX package: ``chunked_ce_loss``,
``adamw_update``, ``make_train_step`` and remat, at the smoke configs in
float32 (2 layers). Weights come from the JAX package's ``lm.init_params``
through ``params_from_jax``; tokens, labels and the other inputs from numpy
seeds; the JAX side is ``jax.jit``ed.

Tolerances:
- losses at rtol 1e-5;
- gradients at the North star's atol 2e-5·max|g| and rtol 2e-4 (max over
  the leaf); a train step's gradients are read back from AdamW's first
  moment, g_t = (m_t - 0.9 m_{t-1}) / 0.1, on both sides;
- AdamW's moments after each step likewise;
- ``adamw_update`` alone (the same gradients on both sides): float32
  parameters at atol 1e-6·max|p|, rtol 1e-6, bfloat16 parameters within
  one bfloat16 step (2^-8 relative), moments at atol 1e-6·max, rtol 1e-5
  (XLA and torch round the moment sums differently in the last bit, and a
  moment that cancels to near zero keeps that absolute error);
- parameters after each train step, both packages starting the step from
  the same state: the update held to the North star's atol 2e-5·max|du|
  and rtol 2e-4, plus the gradient tolerance carried through AdamW (twice
  its first order term), plus one float32 step of the parameter (its own
  rounding). AdamW divides g by sqrt(v) + 1e-8, so an entry whose
  gradient sits at the float32 noise floor (a few per 10^5) moves by up to
  2·lr on a last-bit difference of its gradient; chained over steps, such
  moves feed the next gradients, so the parameters are compared step by
  step, and the chained runs by their losses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import api as J_api
from repro.models import common as J_C
from repro.models import lm as J_lm
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import api, lm
from repro_torch.models import common as C
from repro_torch.models.params import params_from_jax, tree_leaves

from torch_port_helpers import check_train_steps, lm_batch, np_
from torch_port_helpers import close_grad as _close_grad
from torch_port_helpers import flat_tree as _flat

TRAIN_ARCHS = ["qwen3-0.6b", "gemma3-27b", "granite-3-8b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b"]
LR, STEPS = 3e-4, 3


def _batch(cfg, b, s, seed):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = r.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -1  # ignored positions
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()})


@pytest.mark.parametrize("s,chunk,z_loss", [(32, 16, 0.0), (40, 16, 0.0), (40, 16, 0.1), (24, 512, 0.1)])
def test_chunked_ce_loss_value_and_gradient_match_jax(s, chunk, z_loss):
    """Whole chunks and a padded last chunk (40 over 16), labels with -1,
    the z-loss term off and on; gradients for the hidden states and the
    embedding."""
    r = np.random.default_rng(s)
    x = r.normal(0, 1, (2, s, 64)).astype(np.float32)
    emb = (r.normal(0, 0.02, (300, 64)) * 10).astype(np.float32)
    labels = r.integers(0, 300, (2, s)).astype(np.int32)
    labels[1, ::3] = -1

    def jloss(x_, e_):
        return J_C.chunked_ce_loss({"embedding": e_}, x_, jnp.asarray(labels), chunk=chunk, z_loss=z_loss)

    want, (gx_w, ge_w) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(emb))
    xt, et = torch.from_numpy(x).requires_grad_(), torch.from_numpy(emb).requires_grad_()
    got = C.chunked_ce_loss({"embedding": et}, xt, torch.from_numpy(labels).long(), chunk=chunk, z_loss=z_loss)
    gx, ge = torch.autograd.grad(got, (xt, et))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _close_grad(np_(gx), np.asarray(gx_w), "d/dx")
    _close_grad(np_(ge), np.asarray(ge_w), "d/d(embedding)")
    with torch.no_grad():  # the no-grad path computes the same value
        again = C.chunked_ce_loss({"embedding": et}, xt, torch.from_numpy(labels).long(), chunk=chunk, z_loss=z_loss)
    assert float(again) == float(got.detach())


def test_adamw_update_matches_jax_on_float32_and_bfloat16_leaves():
    r = np.random.default_rng(0)
    tree = {"w": r.normal(0, 1, (64, 32)).astype(np.float32),
            "layers": [{"b": r.normal(0, 1, (100,)).astype(ml_dtypes.bfloat16)}]}
    grads = [{"w": r.normal(0, 1e-3, (64, 32)).astype(np.float32),
              "layers": [{"b": r.normal(0, 1e-3, (100,)).astype(ml_dtypes.bfloat16)}]} for _ in range(3)]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jo = J_api.adamw_init(jp)
    tp = params_from_jax(tree, "cpu")
    to = api.adamw_init(tp)
    upd = jax.jit(J_api.adamw_update)
    for g in grads:
        jp, jo = upd(jp, jax.tree_util.tree_map(jnp.asarray, g), jo)
        tp, to = api.adamw_update(tp, params_from_jax(g, "cpu"), to)
    assert int(to["count"]) == int(jo["count"]) == 3 and to["count"].dtype == torch.int32
    w_t, w_j = np_(tp["w"]), np.asarray(jp["w"])
    np.testing.assert_allclose(w_t, w_j, atol=1e-6 * float(np.abs(w_j).max()), rtol=1e-6)
    b_t, b_j = tp["layers"][0]["b"], np.asarray(jp["layers"][0]["b"]).astype(np.float32)
    assert b_t.dtype == torch.bfloat16
    np.testing.assert_allclose(np_(b_t.float()), b_j, rtol=2.0**-8, atol=0)
    for key in ("m", "v"):
        assert all(x.dtype == torch.float32 for x in tree_leaves(to[key]))
        got, want = _flat(to[key]), _flat(jo[key])
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=1e-5, atol=1e-6 * np.abs(want[path]).max(),
                                       err_msg=f"{key} {path}")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_jax(arch):
    """Three steps of ``make_train_step`` on the same batch. Chained on each
    side: the losses. Step by step, the port started from the JAX state
    before each step: the loss, the gradient (read from the first moment),
    both moments, and the parameters after the step (the gradient tolerance
    carried through AdamW, ``torch_port_helpers.adamw_carried_tol``)."""
    jcfg, tcfg = j_get_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    jb, tb = _batch(jcfg, 2, 40, seed=1)
    check_train_steps(jcfg, tcfg, jb, tb, steps=STEPS, lr=LR)


def test_remat_on_and_off_give_equal_gradients_and_recompute_attention(monkeypatch):
    """``cfg.remat`` changes memory, not values: the gradients are bitwise
    equal with it on and off. With it on, each stacked unit's forward runs
    again in the backward, so the attention wrapper runs twice per layer."""
    calls = []
    real = fa_ops.attention_ref
    monkeypatch.setattr(fa_ops, "attention_ref", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke_config(), n_layers=3)
    params = lm.init_params(cfg, seed=0, device="cpu")
    _, tb = _batch(cfg, 2, 24, seed=2)
    grads, n_fwd = [], []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        calls.clear()
        loss = api.compute_loss(c, params, tb)
        fwd = len(calls)
        grads.append(torch.autograd.grad(loss, leaves))
        n_fwd.append((fwd, len(calls) - fwd))
        for p in leaves:
            p.requires_grad_(False)
    # (forward calls, backward calls): the backward of the autograd.Function
    # recomputes the plain version once per layer in both modes
    assert n_fwd == [(3, 3 + 3), (3, 3)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_compute_loss_refuses_the_unported_families():
    """No family is refused any more (the name is kept from when whisper's
    and the VLM's losses raised): their ``compute_loss`` at the smoke
    configs equals the JAX package's at rtol 1e-5, whisper from audio
    frames and tokens, the VLM from merged embeddings and M-RoPE triples."""
    for arch in ("whisper-tiny", "qwen2-vl-72b"):
        jcfg, tcfg = j_get_arch(arch).smoke_config(), get_arch(arch).smoke_config()
        jp = J_lm.init_params(jcfg, jax.random.key(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        jb, tb = lm_batch(jcfg, 2, 40, seed=3)
        want = jax.jit(lambda p, b: J_api.compute_loss(jcfg, p, b))(jp, jb)
        np.testing.assert_allclose(float(api.compute_loss(tcfg, tp, tb)), float(want), rtol=1e-5, err_msg=arch)
