"""Model assembly of every architecture family (PyTorch port of
``models/lm.py``).

A model is an embedding and a stack of layers. Parameters are nested
dictionaries with the JAX pytree's layout and keys: a homogeneous run of
layers is stacked with a leading layer dim under ``units/slot<i>`` (the JAX
package scans over it; here a Python loop indexes it), a heterogeneous
pattern that repeats once lives in ``flat_layers``, and the remainder of a
pattern in ``rem_layers``. Layer kinds: attention (``attn_global``,
``attn_local`` with a ring-buffer cache) with a SwiGLU or Mixture-of-Experts
feed-forward (``models/moe.py``), and the recurrent kinds ``mamba``
(``models/ssm.py``), ``mlstm`` and ``slstm`` (``models/xlstm.py``).

Zamba2 stacks its mamba layers as double units ``units/{a,b}`` of shape
(n_double, period, ...), each half followed by one of two shared attention
blocks (``shared_attn``), then applies its remainder layers flat. Whisper
adds an encoder (``enc_layers``, ``enc_norm``) and a cross-attention per
decoder layer (``cross_layers``); the VLM passes M-RoPE position triples to
its attention. When ``cfg.remat`` is set and grad is on, each stacked unit
(a zamba double unit) is recomputed in the backward
(``torch.utils.checkpoint``), as the JAX package wraps its scanned unit in
``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as C
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.config import ModelConfig

ATTN_KINDS = ("attn_global", "attn_local")
# the recurrent kinds, each under its own key: init, train and decode
_RECURRENT = {
    "mamba": (SSM.mamba2_init, SSM.mamba2_train, SSM.mamba2_decode),
    "mlstm": (XL.mlstm_init, XL.mlstm_train, XL.mlstm_decode),
    "slstm": (XL.slstm_init, XL.slstm_train, XL.slstm_decode),
}


def _kind_check(kind: str) -> None:
    if kind not in ATTN_KINDS and kind not in _RECURRENT:
        raise ValueError(kind)


# ------------------------------------------------------------ block defs
def _layer_init(cfg: ModelConfig, kind: str, gen: torch.Generator, dtype):
    _kind_check(kind)
    d = cfg.d_model
    p = {"ln1": C.rmsnorm_init(d, dtype, gen.device)}
    if kind in _RECURRENT:
        p[kind] = _RECURRENT[kind][0](gen, cfg, dtype)
        return p
    p["attn"] = C.attn_init(gen, cfg, dtype)
    p["ln2"] = C.rmsnorm_init(d, dtype, gen.device)
    if cfg.is_moe:
        p["moe"] = MOE.moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = C.mlp_init(gen, d, cfg.d_ff, dtype)
    return p


def _window(cfg: ModelConfig, kind: str):
    return cfg.sliding_window if kind == "attn_local" else None


def _ffn(cfg: ModelConfig, p, y):
    """The feed-forward half of a layer; the MoE aux losses are dropped, as
    the JAX package drops them."""
    if cfg.is_moe:
        return MOE.moe_apply(p["moe"], cfg, y)[0]
    return C.mlp(p["mlp"], y)


def _layer_train(cfg: ModelConfig, kind: str, p, x, positions, mrope_positions=None):
    _kind_check(kind)
    h = C.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind in _RECURRENT:
        return x + _RECURRENT[kind][1](p[kind], cfg, h)
    x = x + C.attention_train(p["attn"], cfg, h, positions, window=_window(cfg, kind),
                              mrope_positions=mrope_positions)
    return x + _ffn(cfg, p, C.rmsnorm(p["ln2"], x, cfg.norm_eps))


def _layer_decode(cfg: ModelConfig, kind: str, p, x, cache, pos: int, mrope_positions=None):
    """cache: per-layer dict, updated in place. Returns (x, cache)."""
    _kind_check(kind)
    h = C.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind in _RECURRENT:
        y, cache = _RECURRENT[kind][2](p[kind], cfg, h, cache)
        return x + y, cache
    h, ck, cv = C.attention_decode(p["attn"], cfg, h, cache["k"], cache["v"], pos, window=_window(cfg, kind),
                                   mrope_positions=mrope_positions)
    x = x + h
    return x + _ffn(cfg, p, C.rmsnorm(p["ln2"], x, cfg.norm_eps)), {"k": ck, "v": cv}


def _layer_cache_init(cfg: ModelConfig, kind: str, batch: int, cache_len: int, dtype, device):
    _kind_check(kind)
    if kind == "mamba":
        return SSM.mamba2_cache_init(cfg, batch, dtype, device)
    if kind == "mlstm":
        return XL.mlstm_cache_init(cfg, batch, device)
    if kind == "slstm":
        return XL.slstm_cache_init(cfg, batch, device)
    window = _window(cfg, kind)
    length = min(cache_len, window) if window else cache_len
    shape = (batch, length, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


# ------------------------------------------------------------ pattern plan
PATTERN_KINDS = {"L": "attn_local", "G": "attn_global", "M": "mlstm", "S": "slstm", "D": "mamba"}


def layer_plan(cfg: ModelConfig) -> tuple[list[str], int, list[str]]:
    """Returns (unit kinds, n_units, remainder kinds)."""
    if cfg.arch_type == "xlstm":
        pattern = [PATTERN_KINDS[c] for c in cfg.xlstm_pattern]
    elif cfg.arch_type == "zamba":
        # scanned double-units of 2*attn_every mamba layers (+2 shared attn)
        period = max(cfg.attn_every, 1)
        n_double = cfg.n_layers // (2 * period)
        rem = ["mamba"] * (cfg.n_layers - n_double * 2 * period)
        return ["mamba"] * (2 * period), n_double, rem
    elif cfg.layer_pattern:
        pattern = [PATTERN_KINDS[c] for c in cfg.layer_pattern]
    else:
        pattern = ["attn_global"]
    n_units = cfg.n_layers // len(pattern)
    rem = [pattern[i] for i in range(cfg.n_layers - n_units * len(pattern))]
    return pattern, n_units, rem


def uses_units(cfg: ModelConfig) -> bool:
    """Whether the layers are stacked under ``units`` (the JAX package scans
    them) rather than listed in ``flat_layers``; zamba's double units are
    stacked whenever ``cfg.scan_layers`` is set (``init_params``)."""
    return cfg.scan_layers and layer_plan(cfg)[1] > 1


# ------------------------------------------------------------ init
class _MetaGenerator(torch.Generator):
    """A CPU generator whose draws land on the ``meta`` device: shapes and
    dtypes only, nothing allocated (``configs/common.py`` ``params_specs``)."""

    @property
    def device(self):
        return torch.device("meta")


def _stack(trees: list):
    """Stack a list of equally shaped parameter trees along a new leading dim."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stacked(make, count: int):
    """``count`` trees from ``make()`` stacked; with none, a zero-length stack
    of its shapes (the JAX package's vmap over no keys)."""
    if count == 0:
        return _stack_none(make())
    return _stack([make() for _ in range(count)])


def _stack_none(tree):
    if isinstance(tree, dict):
        return {k: _stack_none(v) for k, v in tree.items()}
    return tree[None][:0]


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed``, drawn on ``device``, in the JAX
    package's layout, distributions and dtype (the values differ: the two
    packages' generators differ). ``device="meta"`` gives the shapes and
    dtypes alone."""
    dtype = C.dtype_of(cfg)
    if torch.device(device).type == "meta":
        gen = _MetaGenerator()
        gen.manual_seed(seed)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
    unit, n_units, rem = layer_plan(cfg)
    params: dict[str, Any] = {
        "embed": C.embed_init(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": C.rmsnorm_init(cfg.d_model, dtype, gen.device),
    }
    if cfg.arch_type == "zamba" and cfg.scan_layers:
        params["units"] = zamba_init_units(cfg, gen, dtype)
    elif uses_units(cfg):
        params["units"] = {
            f"slot{i}": _stacked(lambda kind=kind: _layer_init(cfg, kind, gen, dtype), n_units)
            for i, kind in enumerate(unit)
        }
    else:
        params["flat_layers"] = [_layer_init(cfg, unit[i % len(unit)], gen, dtype) for i in range(n_units * len(unit))]
    params["rem_layers"] = [_layer_init(cfg, k, gen, dtype) for k in rem]

    if cfg.arch_type == "zamba":
        params["shared_attn"] = [_layer_init(cfg, "attn_global", gen, dtype) for _ in range(2)]
    if cfg.arch_type == "whisper":
        params["enc_layers"] = [_layer_init(cfg, "attn_global", gen, dtype) for _ in range(cfg.n_enc_layers)]
        params["enc_norm"] = C.rmsnorm_init(cfg.d_model, dtype, gen.device)
        params["cross_layers"] = [
            {"ln": C.rmsnorm_init(cfg.d_model, dtype, gen.device), "attn": C.attn_init(gen, cfg, dtype)}
            for _ in range(cfg.n_layers)
        ]
    return params


def zamba_init_units(cfg: ModelConfig, gen: torch.Generator, dtype) -> dict:
    """Stacked params for the zamba double units: ``a`` and ``b``, each
    (n_double, period, ...)."""
    period = max(cfg.attn_every, 1)
    n_double = cfg.n_layers // (2 * period)

    def half():
        return _stacked(lambda: _stacked(lambda: _layer_init(cfg, "mamba", gen, dtype), period), n_double)

    return {"a": half(), "b": half()}


def unbind_units(tree, n: int) -> list:
    """The ``n`` layers of a stacked parameter or cache tree, as views (a
    decode step writes its caches through them). Under autograd one
    ``unbind`` stacks the layers' gradients once, where indexing layer by
    layer would write a zeroed gradient of the whole stack for each."""
    if isinstance(tree, dict):
        parts = {k: unbind_units(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


# ------------------------------------------------------------ forward (train, prompt)
def _unit_forward(cfg: ModelConfig, unit: list, unit_params: dict, x, positions, mrope_positions):
    for i, kind in enumerate(unit):
        x = _layer_train(cfg, kind, unit_params[f"slot{i}"], x, positions, mrope_positions)
    return x


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward under ``cfg.remat`` with grad on."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def backbone_train(cfg: ModelConfig, params, x, positions, mrope_positions=None):
    """Run the decoder stack on embeddings x (B,S,d). With ``cfg.remat`` and
    grad on, each stacked unit keeps only its input for the backward and is
    recomputed there."""
    if cfg.arch_type == "zamba":
        return _zamba_train(cfg, params, x, positions)
    unit, n_units, rem = layer_plan(cfg)
    if "units" in params:
        for up in unbind_units(params["units"], n_units):
            x = _remat(cfg, _unit_forward, cfg, unit, up, x, positions, mrope_positions)
    else:
        for i, lp in enumerate(params.get("flat_layers", [])):
            x = _layer_train(cfg, unit[i % len(unit)], lp, x, positions, mrope_positions)
    for kind, lp in zip(rem, params["rem_layers"]):
        x = _layer_train(cfg, kind, lp, x, positions, mrope_positions)
    return C.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _zamba_train(cfg: ModelConfig, params, x, positions):
    """Zamba2: mamba backbone with 2 alternating shared attention blocks.

    Double units [period x mamba, shared A, period x mamba, shared B], each
    recomputed in the backward under ``cfg.remat``; the remainder applied
    flat, shared A after every ``period`` of its layers."""
    period = max(cfg.attn_every, 1)
    sa, sb = params["shared_attn"]

    def double_unit(xc, up, sa, sb):
        for half, shared in ((up["a"], sa), (up["b"], sb)):
            for lp in unbind_units(half, period):
                xc = _layer_train(cfg, "mamba", lp, xc, positions)
            xc = _layer_train(cfg, "attn_global", shared, xc, positions)
        return xc

    if "units" in params:
        for up in unbind_units(params["units"], layer_plan(cfg)[1]):
            x = _remat(cfg, double_unit, x, up, sa, sb)
    for i, lp in enumerate(params["rem_layers"]):
        x = _layer_train(cfg, "mamba", lp, x, positions)
        if (i + 1) % period == 0:
            x = _layer_train(cfg, "attn_global", sa, x, positions)
    return C.rmsnorm(params["final_norm"], x, cfg.norm_eps)


# ------------------------------------------------------------ whisper
def sinusoid_pos(n: int, d: int) -> torch.Tensor:
    """(n, d) float32 sinusoidal positions, computed in numpy as the JAX
    package does."""
    pos = np.arange(n)[:, None]
    dim = np.arange(0, d, 2)[None]
    ang = pos / (10_000 ** (dim / d))
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out)


def whisper_encode(cfg: ModelConfig, params, audio_embeds):
    """audio_embeds: (B, n_audio_ctx, d), the post-conv frontend stub."""
    pos = sinusoid_pos(audio_embeds.shape[1], cfg.d_model).to(audio_embeds.device, audio_embeds.dtype)
    x = audio_embeds + pos
    for lp in params["enc_layers"]:
        x = x + C.attention_train(lp["attn"], cfg, C.rmsnorm(lp["ln1"], x, cfg.norm_eps), None, causal=False)
        x = x + C.mlp(lp["mlp"], C.rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return C.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_attend(cfg: ModelConfig, p, x, enc_k, enc_v):
    q = (C.rmsnorm(p["ln"], x, cfg.norm_eps) @ p["attn"]["wq"]).reshape(x.shape[0], x.shape[1], cfg.n_heads, cfg.hd)
    out = C.chunked_attention(q, enc_k, enc_v, causal=False)
    return x + out.reshape(x.shape[0], x.shape[1], -1) @ p["attn"]["wo"]


def whisper_train(cfg: ModelConfig, params, audio_embeds, tokens):
    enc = whisper_encode(cfg, params, audio_embeds)
    x = C.embed_lookup(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None].expand(tokens.shape)
    kv_shape = (enc.shape[0], enc.shape[1], cfg.n_kv_heads, cfg.hd)
    for lp, cp in zip(params["flat_layers"], params["cross_layers"]):
        x = _layer_train(cfg, "attn_global", lp, x, positions)
        enc_k = (enc @ cp["attn"]["wk"]).reshape(kv_shape)
        enc_v = (enc @ cp["attn"]["wv"]).reshape(kv_shape)
        x = _cross_attend(cfg, cp, x, enc_k, enc_v)
    return C.rmsnorm(params["final_norm"], x, cfg.norm_eps)
