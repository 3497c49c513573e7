"""PyTorch port, LM substrate vs the JAX package: the dense decoders'
configs, parameter layout, prefill step and serve (decode) step, at the
smoke configs of Qwen3-0.6B (qk-norm, GQA, global attention, stacked
``units``) and Gemma3 (``"LG"``: a sliding-window layer with its ring-buffer
cache and a global one, ``flat_layers``), float32, 2 layers. Weights come
from the JAX package's ``lm.init_params`` through ``params_from_jax``;
tokens from numpy seeds.

Tolerances: logits at atol 1e-4, rtol 1e-4 (float32 through two layers;
the packages' matrix products sum in different orders, and the measured
gap is ~1e-6); greedy ids equal.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import api as J_api
from repro.models import lm as J_lm
from repro_torch.configs import get_arch
from repro_torch.launch import serve as T_cli
from repro_torch.models import api, lm
from repro_torch.models.params import params_from_jax

from torch_port_helpers import np_

REPO = Path(__file__).resolve().parents[1]
ATOL, RTOL = 1e-4, 1e-4
ARCHS = ["qwen3-0.6b", "gemma3-27b"]


def _cfgs(arch):
    return j_get_arch(arch).smoke_config(), get_arch(arch).smoke_config()


def _params(jcfg, seed=0):
    jp = J_lm.init_params(jcfg, jax.random.key(seed))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _shapes(tree):
    """Nested structure with leaves replaced by (shape, dtype name)."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_configs_equal_jax_package(arch):
    jm, tm = j_get_arch(arch), get_arch(arch)
    for name in ("config", "smoke_config"):
        jc, tc = getattr(jm, name)(), getattr(tm, name)()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tc.param_count(), tc.hd) == (jc.param_count(), jc.hd)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_layout_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = J_lm.init_params(jcfg, jax.random.key(0))
    tp = lm.init_params(tcfg, seed=0, device="cpu")
    assert _shapes(tp) == _shapes(jax.tree_util.tree_map(np.asarray, jp))
    assert ("units" in tp) == (arch == "qwen3-0.6b")
    jc = J_api.init_cache(jcfg, 2, 40)
    tc = api.init_cache(tcfg, 2, 40, device="cpu")
    assert _shapes(tc) == _shapes(jax.tree_util.tree_map(np.asarray, jc))


def test_params_from_jax_keeps_keys_and_bfloat16_bits():
    jcfg = dataclasses.replace(j_get_arch("qwen3-0.6b").smoke_config(), dtype="bfloat16")
    jp = J_lm.init_params(jcfg, jax.random.key(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    j_leaves = jax.tree_util.tree_leaves_with_path(jp)
    t_flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            t_flat[path] = t

    walk(tp, ())
    assert len(t_flat) == len(j_leaves)
    for path, leaf in j_leaves:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        got = t_flat[key]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(np_(got.view(torch.int16)), np.asarray(leaf).view(np.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax(arch):
    """48 tokens: past the Gemma smoke config's 32-token window."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    toks = _tokens(2, 48, jcfg.vocab, seed=1)
    want = np.asarray(jax.jit(J_api.make_prefill_step(jcfg))(jp, {"tokens": jnp.asarray(toks)}))
    got = np_(api.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks).long()}))
    assert got.shape == want.shape == (2, 1, jcfg.vocab)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _jax_serve(jcfg, jp, prompt, gen, cache_len):
    serve = jax.jit(J_api.make_serve_step(jcfg))
    cache = J_api.init_cache(jcfg, prompt.shape[0], cache_len)
    logits_all, ids = [], []
    toks = None
    for t in range(prompt.shape[1] + gen - 1):
        inp = jnp.asarray(prompt[:, t:t + 1]) if t < prompt.shape[1] else toks
        logits, cache = serve(jp, cache, inp, jnp.asarray(t, jnp.int32))
        logits_all.append(np.asarray(logits))
        if t >= prompt.shape[1] - 1:
            toks = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            ids.append(np.asarray(toks[:, 0]))
    return logits_all, np.stack(ids, 1)


def _port_serve(tcfg, tp, prompt, gen, cache_len):
    serve = api.make_serve_step(tcfg)
    cache = api.init_cache(tcfg, prompt.shape[0], cache_len, device="cpu")
    logits_all, ids = [], []
    toks = None
    for t in range(prompt.shape[1] + gen - 1):
        inp = torch.from_numpy(prompt[:, t:t + 1]).long() if t < prompt.shape[1] else toks
        logits, cache = serve(tp, cache, inp, t)
        logits_all.append(np_(logits))
        if t >= prompt.shape[1] - 1:
            toks = torch.argmax(logits[:, -1:], dim=-1)
            ids.append(np_(toks[:, 0]))
    return logits_all, np.stack(ids, 1)


@pytest.mark.parametrize("arch,prompt_len", [("qwen3-0.6b", 8), ("gemma3-27b", 8), ("gemma3-27b", 40)])
def test_serve_steps_match_jax(arch, prompt_len):
    """8 prompt tokens stepped through the decode cache, then 4 greedy
    tokens; with 40 prompt tokens the Gemma local layer's 32-slot ring
    buffer wraps and its window masks."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    prompt = _tokens(2, prompt_len, jcfg.vocab, seed=prompt_len)
    cache_len = prompt_len + 4
    j_logits, j_ids = _jax_serve(jcfg, jp, prompt, 4, cache_len)
    t_logits, t_ids = _port_serve(tcfg, tp, prompt, 4, cache_len)
    assert len(j_logits) == len(t_logits) == prompt_len + 3
    for step, (got, want) in enumerate(zip(t_logits, j_logits)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=f"step {step}")
    np.testing.assert_array_equal(t_ids, j_ids)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_own_serve_steps(arch):
    """The prompt forward (chunked attention) and the decode cache stepped
    through the same prompt (plain decode attention) give the same
    last-position logits."""
    _, tcfg = _cfgs(arch)
    tp = lm.init_params(tcfg, seed=3, device="cpu")
    prompt = _tokens(2, 40, tcfg.vocab, seed=4)
    pre = np_(api.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(prompt).long()}))
    logits, _ = _port_serve(tcfg, tp, prompt, 1, 40)
    np.testing.assert_allclose(logits[-1], pre, atol=ATOL, rtol=RTOL)


def test_serve_cli_cpu_smoke():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-0.6b", "--smoke",
                          "--device", "cpu"], env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "qwen3-0.6b: 2L d=256 (dense); batch=4 cache=48"
    assert lines[1] == "generated ids:"
    assert "ms (32 steps), decode" in lines[-1] and lines[-1].endswith("ms/token")


def test_serve_cli_returns_its_ids_and_refuses_without_card():
    res = T_cli.main(["--arch", "gemma3-27b", "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                      "--gen", "3"])
    assert res["ids"].shape == (2, 3) and res["prompt"].shape == (2, 4)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI serves on it instead of refusing")
    with pytest.raises(SystemExit, match="no CUDA device"):
        T_cli.main(["--smoke"])


def test_get_arch_aliases_and_unported_archs():
    """Every architecture of the JAX registry resolves in the port, by its id
    and its dash form (the name is kept from when four of them raised);
    an unknown id still raises ``KeyError`` and an unknown layer kind
    ``ValueError``, as in the JAX package."""
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro_torch.configs import ARCH_IDS

    assert ARCH_IDS == J_ARCH_IDS and len(ARCH_IDS) == 10
    for aid in ARCH_IDS:
        for alias in (aid, aid.replace("_", "-")):
            assert get_arch(alias).__name__ == f"repro_torch.configs.{aid}"
    for alias in ("qwen3-0.6b", "qwen3_0.6b"):
        assert get_arch(alias).__name__ == "repro_torch.configs.qwen3_0_6b"
    with pytest.raises(KeyError, match="no-such-arch"):
        get_arch("no-such-arch")
    qwen = get_arch("qwen3-0.6b").smoke_config()
    with pytest.raises(ValueError, match="attn_sparse"):
        lm._layer_init(qwen, "attn_sparse", torch.Generator(), torch.float32)
    with pytest.raises(ValueError, match="attn_sparse"):
        lm._layer_train(qwen, "attn_sparse", {}, torch.zeros(1, 1, qwen.d_model), None)
