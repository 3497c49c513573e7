"""Public model API of the port: cache init, AdamW, the train, prefill and
serve steps.

The JAX package's ``models/api.py`` for the dense and MoE decoders
(``arch_type`` "dense" and "moe"). ``make_train_step`` takes the loss's
gradient by autograd (the attention kernel forward, its plain version's VJP
backward, each stacked unit recomputed under ``cfg.remat``) and applies
AdamW in place; ``make_prefill_step`` runs the full forward over a prompt,
and so the attention kernel on every layer; ``make_serve_step`` decodes one
token against a KV cache that it updates in place. The zamba, whisper and
VLM assemblies are not ported (``ROADMAP.md``, queue A10).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import common as C
from repro_torch.models import lm as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves, tree_map


# ------------------------------------------------------------- cache init
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None, device="cuda") -> dict:
    """Zeroed KV caches in the JAX package's layout: stacked under
    ``units/slot<i>`` with a leading layer dim, or listed under ``flat``,
    and ``rem``."""
    L.check_ported(cfg)
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
    L.check_ported(cfg)
    unit, n_units, rem = L.layer_plan(cfg)
    if "units" in params:
        for lp, lc in zip(L.unbind_units(params["units"], n_units), L.unbind_units(cache["units"], n_units)):
            for i, kind in enumerate(unit):
                x, _ = L._layer_decode(cfg, kind, lp[f"slot{i}"], x, lc[f"slot{i}"], pos)
    else:
        for i, lp in enumerate(params.get("flat_layers", [])):
            x, _ = L._layer_decode(cfg, unit[i % len(unit)], lp, x, cache["flat"][i], pos)
    for kind, lp, rc in zip(rem, params["rem_layers"], cache["rem"]):
        x, _ = L._layer_decode(cfg, kind, lp, x, rc, pos)
    return C.rmsnorm(params["final_norm"], x, cfg.norm_eps), cache


# ------------------------------------------------------------- optimizer
def adamw_init(params) -> dict:
    """float32 first and second moments for every leaf, and a step count."""
    z = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), params)
    return {"m": z, "v": tree_map(torch.clone, z),
            "count": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)}


@torch.no_grad()
def adamw_update(params, grads, opt, *, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """The JAX package's AdamW, in place: moments and update in float32,
    the bias corrections from the float32 count, weight decay on every
    leaf, each leaf cast back to its dtype. Returns (params, opt)."""
    opt["count"] += 1
    c = opt["count"].to(torch.float32)
    bc1 = 1 - torch.full_like(c, b1) ** c
    bc2 = 1 - torch.full_like(c, b2) ** c
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(opt["m"]), tree_leaves(opt["v"])):
        gf = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf * gf)
        pf = p.to(torch.float32)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * pf
        p.copy_(pf - lr * step)
    return params, opt


# ------------------------------------------------------------- train step
def compute_loss(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (-1 ignored). The MoE aux losses are not added, as
    in the JAX package."""
    if cfg.arch_type in ("whisper", "vlm"):
        raise L._not_ported(f"the {cfg.arch_type!r} loss")
    tokens = batch["tokens"]
    x = C.embed_lookup(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None].expand(tokens.shape)
    x = L.backbone_train(cfg, params, x, positions)
    return C.chunked_ce_loss(params["embed"], x, batch["labels"])


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4):
    """``train_step(params, opt, batch) -> (params, opt, {"loss": ...})``:
    the loss and its gradient, then AdamW in place."""
    L.check_ported(cfg)

    def train_step(params, opt, batch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            try:
                loss = compute_loss(cfg, params, batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
        it = iter(grads)  # the gradients in the parameters' tree
        params, opt = adamw_update(params, tree_map(lambda _: next(it), params), opt, lr=lr)
        return params, opt, {"loss": loss.detach()}

    return train_step


# ------------------------------------------------------------- prefill step
def make_prefill_step(cfg: ModelConfig):
    """Full forward over the prompt, returning last-position logits (B,1,V).

    As in the JAX package, the step does not fill a cache: serving fills it
    by stepping the decode cache through the prompt."""
    L.check_ported(cfg)

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
    L.check_ported(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos: int):
        # tokens: (B,1) int; pos: absolute position of the token
        x = C.embed_lookup(params["embed"], tokens)
        x, cache = backbone_decode(cfg, params, cache, x, int(pos))
        return C.lm_logits(params["embed"], x), cache

    return serve_step
