"""PyTorch port, the MoE family vs the JAX package: ``moe_apply`` (top-k
router, sort-based capacity dispatch, combine, shared experts, aux
losses), its gradients, the MoE and granite-3-8b configs, parameter
layouts and crossing, and the MoE decoders' prefill and greedy decode, at
the smoke configs in float32. Weights come from the JAX package's
initializers through ``params_from_jax``; inputs from numpy seeds; the JAX
side is ``jax.jit``ed.

The port is held to the JAX ``moe_apply`` itself, not to a dense sum over
experts (``tests/test_moe.py::test_dispatch_matches_dense_reference``,
which the JAX function misses by float32 summation order).

Tolerances: ``moe_apply`` outputs at atol 1e-5·max|out|; ``drop_frac``
equal; ``lb_loss`` and ``router_z`` at rtol 1e-6; gradients at the North
star's atol 2e-5·max|g| and rtol 2e-4; logits at atol 1e-4, rtol 1e-4 and
greedy ids equal (as ``tests/test_torch_lm.py``).
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
from repro.models import moe as J_moe
from repro_torch.configs import get_arch
from repro_torch.launch import serve as T_cli
from repro_torch.models import api, lm, moe
from repro_torch.models.params import params_from_jax

from test_torch_lm import _jax_serve, _port_serve, _shapes, _tokens
from torch_port_helpers import np_

NEW_ARCHS = ["granite-3-8b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"]
MOE_ARCHS = NEW_ARCHS[1:]
ATOL, RTOL = 1e-4, 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _spy_dispatch(monkeypatch) -> list:
    """Record ``moe.dispatch``'s (order, dest, keep) at each MoE call."""
    got, real = [], moe.dispatch

    def spy(*args):
        got.append(real(*args))
        return got[-1]

    monkeypatch.setattr(moe, "dispatch", spy)
    return got


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_jax_package(arch):
    jm, tm = j_get_arch(arch), get_arch(arch)
    for name in ("config", "smoke_config"):
        jc, tc = getattr(jm, name)(), getattr(tm, name)()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tc.param_count(), tc.active_param_count(), tc.hd) == (jc.param_count(), jc.active_param_count(), jc.hd)
    assert tm.SKIP_SHAPES == jm.SKIP_SHAPES


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_params_and_cache_layout_match_jax(arch):
    jcfg, tcfg = j_get_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    tp = lm.init_params(tcfg, seed=0, device="cpu")
    assert _shapes(tp) == _shapes(_np_tree(J_lm.init_params(jcfg, jax.random.key(0))))
    assert _shapes(api.init_cache(tcfg, 2, 40, device="cpu")) == _shapes(_np_tree(J_api.init_cache(jcfg, 2, 40)))
    if tcfg.is_moe:
        layer = tp["units"]["slot0"]["moe"]
        assert layer["router"].dtype == torch.float32
        assert ("shared" in layer) == bool(tcfg.n_shared_experts)


def test_params_from_jax_carries_the_moe_leaves_bitwise():
    """bfloat16 experts beside the float32 router, key for key."""
    jcfg = dataclasses.replace(j_get_arch("moonshot-v1-16b-a3b").smoke_config(), dtype="bfloat16")
    jp = _np_tree(J_lm.init_params(jcfg, jax.random.key(1)))
    tp = params_from_jax(jp, device="cpu")
    jm, tm = jp["units"]["slot0"]["moe"], tp["units"]["slot0"]["moe"]
    assert set(tm) == set(jm) == {"router", "wi", "wg", "wo", "shared"}
    assert tm["router"].dtype == torch.float32 and tm["wi"].dtype == torch.bfloat16
    np.testing.assert_array_equal(np_(tm["router"]), jm["router"])
    for key in ("wi", "wg", "wo"):
        np.testing.assert_array_equal(np_(tm[key].view(torch.int16)), jm[key].view(np.int16))
    np.testing.assert_array_equal(np_(tm["shared"]["wo"].view(torch.int16)), jm["shared"]["wo"].view(np.int16))


# (arch, batch, seq, capacity factor, router zeroed): capacity that drops
# (1.0) and that does not (8.0), the decode fold (s 1, b 4), shared experts,
# and a zeroed router (every gate equal: ties go to the lower expert id)
MOE_CASES = [
    ("granite-moe-3b-a800m", 2, 16, 1.0, False),
    ("granite-moe-3b-a800m", 2, 16, 8.0, False),
    ("granite-moe-3b-a800m", 4, 1, 1.25, False),
    ("moonshot-v1-16b-a3b", 2, 16, 1.0, False),
    ("granite-moe-3b-a800m", 2, 8, 1.0, True),
]


def _moe_case(arch, b, s, cf, zero_router, seed=0):
    cfg = dataclasses.replace(j_get_arch(arch).smoke_config(), capacity_factor=cf)
    jp = J_moe.moe_init(jax.random.key(seed), cfg, jnp.float32)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    x = np.random.default_rng(seed + 1).normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    return cfg, jp, params_from_jax(_np_tree(jp), device="cpu"), x


@pytest.mark.parametrize("arch,b,s,cf,zero_router", MOE_CASES)
def test_moe_apply_matches_jax(arch, b, s, cf, zero_router, monkeypatch):
    cfg, jp, tp, x = _moe_case(arch, b, s, cf, zero_router)
    j_out, j_aux = jax.jit(lambda p, x_: J_moe.moe_apply(p, cfg, x_))(jp, jnp.asarray(x))
    rec = _spy_dispatch(monkeypatch)
    t_out, t_aux = moe.moe_apply(tp, cfg, torch.from_numpy(x))
    assert len(rec) == 1 and set(t_aux) == set(j_aux)
    cap = int((max(s, b if s == 1 else 1) * cfg.top_k / cfg.n_experts) * cf) + 1
    _, dest, keep = rec[0]
    assert torch.equal(dest == cfg.n_experts * cap, ~keep)  # every dropped pair, and only those, to the dummy row
    assert float(1.0 - keep.float().mean()) == float(t_aux["drop_frac"])
    want = np.asarray(j_out)
    np.testing.assert_allclose(np_(t_out), want, atol=1e-5 * np.abs(want).max(), rtol=0)
    assert float(t_aux["drop_frac"]) == float(j_aux["drop_frac"])
    for key in ("lb_loss", "router_z"):
        np.testing.assert_allclose(float(t_aux[key]), float(j_aux[key]), rtol=1e-6, err_msg=key)
    if cf == 8.0:
        assert float(t_aux["drop_frac"]) == 0.0
    elif cf == 1.0 and not zero_router:
        assert float(t_aux["drop_frac"]) > 0.0  # the case exercises the capacity drop


@pytest.mark.parametrize("arch,b,s,cf,zero_router", MOE_CASES[:4])
def test_moe_gradients_match_jax(arch, b, s, cf, zero_router):
    """d/d(router, experts, shared experts, x) of a weighted sum of the
    output plus the two aux losses."""
    cfg, jp, tp, x = _moe_case(arch, b, s, cf, zero_router)
    w = np.random.default_rng(7).normal(0, 1, x.shape).astype(np.float32)

    def j_loss(p, x_):
        out, aux = J_moe.moe_apply(p, cfg, x_)
        return jnp.sum(out * w) + aux["lb_loss"] + aux["router_z"]

    jg_p, jg_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {("x",): torch.from_numpy(x)}
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            flat[path] = t

    walk(tp, ())
    leaves.update(flat)
    for t in leaves.values():
        t.requires_grad_(True)
    out, aux = moe.moe_apply(tp, cfg, leaves[("x",)])
    loss = torch.sum(out * torch.from_numpy(w)) + aux["lb_loss"] + aux["router_z"]
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    want = {("x",): np.asarray(jg_x)}
    for path in flat:
        node = jg_p
        for k in path:
            node = node[k]
        want[path] = np.asarray(node)
    for path, g in grads.items():
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(np_(g), want[path], atol=2e-5 * scale, rtol=2e-4, err_msg=str(path))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_step_matches_jax(arch, monkeypatch):
    jcfg, tcfg = j_get_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    jp = J_lm.init_params(jcfg, jax.random.key(0))
    tp = params_from_jax(_np_tree(jp), device="cpu")
    toks = _tokens(2, 48, jcfg.vocab, seed=1)
    want = np.asarray(jax.jit(J_api.make_prefill_step(jcfg))(jp, {"tokens": jnp.asarray(toks)}))
    rec = _spy_dispatch(monkeypatch)
    got = np_(api.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks).long()}))
    assert got.shape == want.shape == (2, 1, jcfg.vocab)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert len(rec) == (tcfg.n_layers if tcfg.is_moe else 0)  # one dispatch per MoE layer


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_steps_and_greedy_ids_match_jax(arch):
    """8 prompt tokens stepped through the decode cache (the decode fold:
    s 1, b 2 is one dispatch group), then 4 greedy tokens."""
    jcfg, tcfg = j_get_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    jp = J_lm.init_params(jcfg, jax.random.key(0))
    tp = params_from_jax(_np_tree(jp), device="cpu")
    prompt = _tokens(2, 8, jcfg.vocab, seed=8)
    j_logits, j_ids = _jax_serve(jcfg, jp, prompt, 4, 12)
    t_logits, t_ids = _port_serve(tcfg, tp, prompt, 4, 12)
    for step, (got, want) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=f"step {step}")
    np.testing.assert_array_equal(t_ids, j_ids)


def test_serve_cli_serves_an_moe_arch_on_the_cpu(monkeypatch):
    rec = _spy_dispatch(monkeypatch)
    res = T_cli.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--device", "cpu", "--batch", "4",
                      "--prompt-len", "4", "--gen", "3"])
    assert res["ids"].shape == (4, 3) and res["prompt"].shape == (4, 4)
    cfg = get_arch("granite-moe-3b-a800m").smoke_config()
    assert len(rec) == cfg.n_layers * (4 + 2)  # every serve step, every layer
