"""Shared pieces of the PyTorch-port parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed (``conftest.make_scene`` /
``make_cam``), go through the JAX package as JAX arrays and through the port
as numpy -> torch, and the outputs come back as numpy. The tests that need
the card live in ``tests/test_torch_gpu.py``, which imports no JAX (the
machine with the card has none).
"""
import functools

import jax
import numpy as np
import torch

from repro.core import render as JR
from repro_torch.core import gaussians as TG
from repro_torch.core import projection as TP

# six xdist workers share the host: keep each worker's torch pool small
torch.set_num_threads(2)


def to_port(g, cam=None, device="cpu"):
    """JAX model (and camera) -> the port's, via numpy."""
    gp = TG.from_numpy(jax.tree_util.tree_map(np.asarray, g), device)
    if cam is None:
        return gp
    return gp, TP.camera_from_numpy(cam)


@functools.lru_cache(maxsize=None)
def _jitted_render(static: tuple):
    return jax.jit(functools.partial(JR.render, **dict(static)))


def jax_render(g, cam, **static):
    """The JAX package's ``render``, jitted once per static configuration
    (its eager form dispatches op by op, several times slower on the CPU)."""
    return _jitted_render(tuple(sorted(static.items())))(g, cam)


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------- LM parity
def lm_batch(cfg, b, s, seed):
    """A batch of ``cfg``'s family made with numpy, as (JAX batch, port
    batch), key for key ``configs/common.py``'s ``lm_batch_specs``: token
    ids (int64 on the port's side, torch's index type), whisper's audio
    frames, the VLM's merged embeddings and M-RoPE triples (a text run and
    one image's grid), and labels, the first five of row 0 ignored (-1)."""
    from repro_torch.configs.common import ShapeCase, lm_batch_specs, vlm_positions3

    r = np.random.default_rng(seed)
    out = {}
    for key, spec in lm_batch_specs(cfg, ShapeCase(s, b, "train")).items():
        if key == "positions3":
            out[key] = vlm_positions3(b, s, n_text=s // 4, grid=(4, 6))
        elif spec.dtype == torch.int32:
            out[key] = r.integers(0, cfg.vocab, spec.shape).astype(np.int32)
        else:
            out[key] = r.normal(0, 1, spec.shape).astype(np.float32)
    out["labels"][0, :5] = -1
    jb = {k: jax.numpy.asarray(v) for k, v in out.items()}
    tb = {k: torch.from_numpy(v).long() if k in ("tokens", "labels") else torch.from_numpy(v) for k, v in out.items()}
    return jb, tb


def jax_serve_steps(serve, init_cache, params, prompt, gen, cache_len):
    """``prompt`` (B, P) stepped through a JAX serve step, then ``gen - 1``
    greedy tokens: (every step's logits, the greedy ids (B, gen))."""
    cache = init_cache(prompt.shape[0], cache_len)
    logits_all, ids, toks = [], [], None
    for t in range(prompt.shape[1] + gen - 1):
        inp = jax.numpy.asarray(prompt[:, t:t + 1]) if t < prompt.shape[1] else toks
        logits, cache = serve(params, cache, inp, jax.numpy.asarray(t, jax.numpy.int32))
        logits_all.append(np.asarray(logits))
        if t >= prompt.shape[1] - 1:
            toks = jax.numpy.argmax(logits[:, -1:], axis=-1).astype(jax.numpy.int32)
            ids.append(np.asarray(toks[:, 0]))
    return logits_all, np.stack(ids, 1)


def port_serve_steps(serve, cache, params, prompt, gen):
    """The same through the port's serve step and its (in place) cache."""
    logits_all, ids, toks = [], [], None
    for t in range(prompt.shape[1] + gen - 1):
        inp = torch.from_numpy(prompt[:, t:t + 1]).long() if t < prompt.shape[1] else toks
        logits, cache = serve(params, cache, inp, t)
        logits_all.append(np_(logits))
        if t >= prompt.shape[1] - 1:
            toks = torch.argmax(logits[:, -1:], dim=-1)
            ids.append(np_(toks[:, 0]))
    return logits_all, np.stack(ids, 1)


def tree_shapes(tree):
    """Nested structure with leaves replaced by (shape, dtype name)."""
    if isinstance(tree, dict):
        return {k: tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_shapes(v) for v in tree]
    return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")


def flat_tree(tree, path=()) -> dict:
    """{path: float32 numpy leaf} of a nested dict/list tree of either package."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in flat_tree(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in flat_tree(t, path + (i,)).items()}
    # a copy: the port's train step updates its tensors in place
    return {path: np.array(np_(tree.float()) if isinstance(tree, torch.Tensor) else np.asarray(tree), np.float32)}


def close_grad(got, want, what):
    """The North star's gradient tolerance: atol 2e-5 x max |g|, rtol 2e-4."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=2e-4, err_msg=what)


B1, B2 = 0.9, 0.95  # AdamW's moment decays in both packages


def adamw_carried_tol(du, g, m, v, t, lr):
    """Per-entry tolerance on AdamW's step t, whose reference update is
    ``du``: the North star's on the update, plus how far the update moves
    when the gradient moves within the North star's tolerance, that
    tolerance times |d(update)/dg| at the reference's state (first order,
    doubled)."""
    eps = 1e-8
    tau = 2e-5 * np.abs(g).max() + 2e-4 * np.abs(g)
    c1, c2 = 1 - B1**t, 1 - B2**t
    mhat, rv = m / c1, np.sqrt(v / c2)
    with np.errstate(divide="ignore", invalid="ignore"):
        dv = np.where(rv > 0, np.abs(mhat) * (1 - B2) * np.abs(g) / (c2 * rv * (rv + eps) ** 2), 0.0)
    dudg = (1 - B1) / (c1 * (rv + eps)) + dv
    return 2e-5 * np.abs(du).max() + 2e-4 * np.abs(du) + 2 * lr * dudg * tau


def check_train_steps(jcfg, tcfg, jb, tb, *, steps: int, lr: float, seed: int = 0):
    """``steps`` of ``make_train_step`` on the same batch in both packages.
    Chained on each side: the losses (rtol 1e-5). Step by step, the port
    started from the JAX state before each step: the loss, the gradient
    (read from the first moment, g_t = (m_t - 0.9 m_{t-1}) / 0.1), both
    moments, and the parameters after the step (the gradient tolerance
    carried through AdamW, ``adamw_carried_tol``, plus one float32 step of
    the parameter)."""
    from repro.models import api as J_api
    from repro.models import lm as J_lm
    from repro_torch.models import api
    from repro_torch.models.params import params_from_jax

    jp = J_lm.init_params(jcfg, jax.random.key(seed))
    to_port = lambda tree: params_from_jax(jax.tree_util.tree_map(np.asarray, tree), device="cpu")  # noqa: E731
    chained_p = to_port(jp)
    jstep, jo = jax.jit(J_api.make_train_step(jcfg, lr=lr)), J_api.adamw_init(jp)
    tstep = api.make_train_step(tcfg, lr=lr)
    chained_o = api.adamw_init(chained_p)
    for t in range(1, steps + 1):
        tp, tp_o = tstep(to_port(jp), to_port(jo), tb)[:2]
        m_prev, p_prev = flat_tree(jo["m"]), flat_tree(jp)
        jp, jo, jm = jstep(jp, jo, jb)
        chained_p, chained_o, tm = tstep(chained_p, chained_o, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5, err_msg=f"chained loss, step {t}")
        got = {k: flat_tree(tree) for k, tree in (("p", tp), ("m", tp_o["m"]), ("v", tp_o["v"]))}
        want = {k: flat_tree(tree) for k, tree in (("p", jp), ("m", jo["m"]), ("v", jo["v"]))}
        assert got["p"].keys() == want["p"].keys() == m_prev.keys()
        for path in want["p"]:
            g_t = (got["m"][path] - B1 * m_prev[path]) / (1 - B1)
            g_j = (want["m"][path] - B1 * m_prev[path]) / (1 - B1)
            close_grad(g_t, g_j, f"gradient {path}, step {t}")
            for key in ("m", "v"):
                close_grad(got[key][path], want[key][path], f"AdamW {key} {path}, step {t}")
            du = want["p"][path] - p_prev[path]
            tol = adamw_carried_tol(du, g_j, want["m"][path], want["v"][path], t, lr)
            d = np.abs(got["p"][path] - want["p"][path])
            tol = tol + np.spacing(np.abs(want["p"][path]))  # the stored parameter's own rounding
            assert (d <= tol).all(), f"parameter {path}, step {t}: {int((d > tol).sum())} entries outside"
