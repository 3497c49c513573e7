"""Public model API of the port: cache init, prefill and serve steps.

The JAX package's ``models/api.py`` for dense decoders (``arch_type ==
"dense"``). ``make_prefill_step`` runs the full forward over a prompt, and
so the attention kernel on every layer; ``make_serve_step`` decodes one
token against a KV cache that it updates in place. Training
(``make_train_step``, ``chunked_ce_loss``, AdamW) and the zamba, whisper,
VLM and MoE assemblies are not ported (``ROADMAP.md``, queue A10).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import common as C
from repro_torch.models import lm as L
from repro_torch.models.config import ModelConfig


# ------------------------------------------------------------- cache init
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None, device="cuda") -> dict:
    """Zeroed KV caches in the JAX package's layout: stacked under
    ``units/slot<i>`` with a leading layer dim, or listed under ``flat``,
    and ``rem``."""
    L.check_dense(cfg)
    dtype = dtype or C.dtype_of(cfg)
    unit, n_units, rem = L.layer_plan(cfg)

    def one(kind, lead=()):
        c = L._layer_cache_init(cfg, kind, batch, cache_len, dtype, device)
        return {k: x.expand(*lead, *x.shape).contiguous() for k, x in c.items()}

    cache: dict[str, Any] = {}
    if L.uses_units(cfg):
        cache["units"] = {f"slot{i}": one(kind, (n_units,)) for i, kind in enumerate(unit)}
    else:
        cache["flat"] = [one(unit[i % len(unit)]) for i in range(n_units * len(unit))]
    cache["rem"] = [one(k) for k in rem]
    return cache


# ------------------------------------------------------------- decode stack
def backbone_decode(cfg: ModelConfig, params, cache, x, pos: int):
    """One token through the stack; the caches are written in place.
    Returns (normed hidden state, cache)."""
    L.check_dense(cfg)
    unit, n_units, rem = L.layer_plan(cfg)
    if "units" in params:
        for u in range(n_units):
            for i, kind in enumerate(unit):
                x, _ = L._layer_decode(cfg, kind, L.unit_slice(params["units"][f"slot{i}"], u), x,
                                       L.unit_slice(cache["units"][f"slot{i}"], u), pos)
    else:
        for i, lp in enumerate(params.get("flat_layers", [])):
            x, _ = L._layer_decode(cfg, unit[i % len(unit)], lp, x, cache["flat"][i], pos)
    for kind, lp, rc in zip(rem, params["rem_layers"], cache["rem"]):
        x, _ = L._layer_decode(cfg, kind, lp, x, rc, pos)
    return C.rmsnorm(params["final_norm"], x, cfg.norm_eps), cache


# ------------------------------------------------------------- prefill step
def make_prefill_step(cfg: ModelConfig):
    """Full forward over the prompt, returning last-position logits (B,1,V).

    As in the JAX package, the step does not fill a cache: serving fills it
    by stepping the decode cache through the prompt."""
    L.check_dense(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        x = C.embed_lookup(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None].expand(tokens.shape)
        x = L.backbone_train(cfg, params, x, positions)
        return C.lm_logits(params["embed"], x[:, -1:])

    return prefill_step


# ------------------------------------------------------------- serve step
def make_serve_step(cfg: ModelConfig):
    """One-token decode step against a KV cache (updated in place)."""
    L.check_dense(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos: int):
        # tokens: (B,1) int; pos: absolute position of the token
        x = C.embed_lookup(params["embed"], tokens)
        x, cache = backbone_decode(cfg, params, cache, x, int(pos))
        return C.lm_logits(params["embed"], x), cache

    return serve_step
