"""Model assembly of the dense and MoE decoders (PyTorch port of
``models/lm.py``).

A model is an embedding and a stack of layers. Parameters are nested
dictionaries with the JAX pytree's layout and keys: a homogeneous run of
layers is stacked with a leading layer dim under ``units/slot<i>`` (the JAX
package scans over it; here a Python loop indexes it), a heterogeneous
pattern that repeats once lives in ``flat_layers``, and the remainder of a
pattern in ``rem_layers``. The attention kinds ``attn_global`` and
``attn_local`` (sliding window, ring-buffer cache) are ported, with a
SwiGLU or a Mixture-of-Experts feed-forward (``models/moe.py``). When
``cfg.remat`` is set and grad is on, each stacked unit is recomputed in the
backward (``torch.utils.checkpoint``), as the JAX package wraps its scanned
unit in ``jax.checkpoint``. The SSM (zamba), xLSTM, whisper and VLM
assemblies are not ported (``ROADMAP.md``, queue A10).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as C
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig

ATTN_KINDS = ("attn_global", "attn_local")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet (ROADMAP.md, queue A10 lists what is "
                               "left: SSM/zamba, xLSTM, whisper, VLM)")


# ------------------------------------------------------------ block defs
def _layer_init(cfg: ModelConfig, kind: str, gen: torch.Generator, dtype):
    if kind not in ATTN_KINDS:
        raise _not_ported(f"layer kind {kind!r}")
    d = cfg.d_model
    p = {
        "ln1": C.rmsnorm_init(d, dtype, gen.device),
        "attn": C.attn_init(gen, cfg, dtype),
        "ln2": C.rmsnorm_init(d, dtype, gen.device),
    }
    if cfg.is_moe:
        p["moe"] = MOE.moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = C.mlp_init(gen, d, cfg.d_ff, dtype)
    return p


def _window(cfg: ModelConfig, kind: str):
    if kind not in ATTN_KINDS:
        raise _not_ported(f"layer kind {kind!r}")
    return cfg.sliding_window if kind == "attn_local" else None


def _ffn(cfg: ModelConfig, p, y):
    """The feed-forward half of a layer; the MoE aux losses are dropped, as
    the JAX package drops them."""
    if cfg.is_moe:
        return MOE.moe_apply(p["moe"], cfg, y)[0]
    return C.mlp(p["mlp"], y)


def _layer_train(cfg: ModelConfig, kind: str, p, x, positions):
    h = C.attention_train(p["attn"], cfg, C.rmsnorm(p["ln1"], x, cfg.norm_eps), positions,
                          window=_window(cfg, kind))
    x = x + h
    return x + _ffn(cfg, p, C.rmsnorm(p["ln2"], x, cfg.norm_eps))


def _layer_decode(cfg: ModelConfig, kind: str, p, x, cache, pos: int):
    """cache: per-layer dict, updated in place. Returns (x, cache)."""
    h, ck, cv = C.attention_decode(p["attn"], cfg, C.rmsnorm(p["ln1"], x, cfg.norm_eps), cache["k"], cache["v"],
                                   pos, window=_window(cfg, kind))
    x = x + h
    return x + _ffn(cfg, p, C.rmsnorm(p["ln2"], x, cfg.norm_eps)), {"k": ck, "v": cv}


def _layer_cache_init(cfg: ModelConfig, kind: str, batch: int, cache_len: int, dtype, device):
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
    them) rather than listed in ``flat_layers``."""
    return cfg.scan_layers and layer_plan(cfg)[1] > 1


def check_ported(cfg: ModelConfig) -> None:
    """Refuse the architectures whose assembly the port lacks."""
    if cfg.arch_type not in ("dense", "moe"):
        raise _not_ported(f"the {cfg.arch_type!r} architecture of {cfg.name}")


# ------------------------------------------------------------ init
def _stack(trees: list):
    """Stack a list of equally shaped parameter trees along a new leading dim."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed``, drawn on ``device``, in the JAX
    package's layout, distributions and dtype (the values differ: the two
    packages' generators differ)."""
    check_ported(cfg)
    dtype = C.dtype_of(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    unit, n_units, rem = layer_plan(cfg)
    params: dict[str, Any] = {
        "embed": C.embed_init(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": C.rmsnorm_init(cfg.d_model, dtype, gen.device),
    }
    if uses_units(cfg):
        params["units"] = {
            f"slot{i}": _stack([_layer_init(cfg, kind, gen, dtype) for _ in range(n_units)])
            for i, kind in enumerate(unit)
        }
    else:
        params["flat_layers"] = [_layer_init(cfg, unit[i % len(unit)], gen, dtype) for i in range(n_units * len(unit))]
    params["rem_layers"] = [_layer_init(cfg, k, gen, dtype) for k in rem]
    return params


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
def _unit_forward(cfg: ModelConfig, unit: list, unit_params: dict, x, positions):
    for i, kind in enumerate(unit):
        x = _layer_train(cfg, kind, unit_params[f"slot{i}"], x, positions)
    return x


def backbone_train(cfg: ModelConfig, params, x, positions):
    """Run the decoder stack on embeddings x (B,S,d). With ``cfg.remat`` and
    grad on, each stacked unit keeps only its input for the backward and is
    recomputed there."""
    check_ported(cfg)
    unit, n_units, rem = layer_plan(cfg)
    if "units" in params:
        remat = cfg.remat and torch.is_grad_enabled()
        for up in unbind_units(params["units"], n_units):
            if remat:
                x = checkpoint(_unit_forward, cfg, unit, up, x, positions, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = _unit_forward(cfg, unit, up, x, positions)
    else:
        for i, lp in enumerate(params.get("flat_layers", [])):
            x = _layer_train(cfg, unit[i % len(unit)], lp, x, positions)
    for kind, lp in zip(rem, params["rem_layers"]):
        x = _layer_train(cfg, kind, lp, x, positions)
    return C.rmsnorm(params["final_norm"], x, cfg.norm_eps)
