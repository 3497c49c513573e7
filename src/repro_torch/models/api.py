"""Public model API of the port: cache init, AdamW, the train, prefill and
serve steps, for every architecture family of the JAX package's
``models/api.py``.

``make_train_step`` takes the loss's gradient by autograd (the attention
kernel forward, its plain version's VJP backward, each stacked unit
recomputed under ``cfg.remat``) and applies AdamW in place;
``make_prefill_step`` runs the full forward over a prompt (token ids; for
whisper the audio frames too, for the VLM merged embeddings and M-RoPE
position triples), and so the attention kernel on every attention layer;
``make_serve_step`` decodes one token against a KV or state cache that it
updates in place. As in the JAX package, whisper's cross-attention cache
is zeros from ``init_cache`` and nothing fills it from the encoder.
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
    """Zeroed caches in the JAX package's layout: stacked under
    ``units/slot<i>`` with a leading layer dim (zamba: ``units/{a,b}`` of
    (n_double, period, ...) mamba caches and ``units/{attn_a,attn_b}`` of
    the shared blocks' KV caches, then ``rem`` and ``rem_attn``), or listed
    under ``flat``, and ``rem``; whisper adds ``cross_k`` and ``cross_v``."""
    dtype = dtype or C.dtype_of(cfg)
    unit, n_units, rem = L.layer_plan(cfg)

    def one(kind, lead=()):
        c = L._layer_cache_init(cfg, kind, batch, cache_len, dtype, device)
        return {k: x.expand(*lead, *x.shape).contiguous() for k, x in c.items()}

    cache: dict[str, Any] = {}
    if cfg.arch_type == "zamba":
        period = max(cfg.attn_every, 1)
        cache["units"] = {
            "a": one("mamba", (n_units, period)),
            "b": one("mamba", (n_units, period)),
            "attn_a": one("attn_global", (n_units,)),
            "attn_b": one("attn_global", (n_units,)),
        }
        cache["rem"] = [one("mamba") for _ in rem]
        cache["rem_attn"] = [one("attn_global") for _ in range(len(rem) // period)]
        return cache
    if L.uses_units(cfg):
        cache["units"] = {f"slot{i}": one(kind, (n_units,)) for i, kind in enumerate(unit)}
    else:
        cache["flat"] = [one(unit[i % len(unit)]) for i in range(n_units * len(unit))]
    cache["rem"] = [one(k) for k in rem]
    if cfg.arch_type == "whisper":
        # cross-attention K/V: zeros, as the JAX package leaves them
        shape = (batch, cfg.n_audio_ctx, cfg.n_kv_heads, cfg.hd)
        for key in ("cross_k", "cross_v"):
            cache[key] = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.n_layers)]
    return cache


# ------------------------------------------------------------- decode stack
def backbone_decode(cfg: ModelConfig, params, cache, x, pos: int, mrope_positions=None):
    """One token through the stack; the caches are written in place.
    Returns (normed hidden state, cache)."""
    if cfg.arch_type == "zamba":
        return _zamba_decode(cfg, params, cache, x, pos)
    unit, n_units, rem = L.layer_plan(cfg)
    if "units" in params:
        for lp, lc in zip(L.unbind_units(params["units"], n_units), L.unbind_units(cache["units"], n_units)):
            for i, kind in enumerate(unit):
                x, _ = L._layer_decode(cfg, kind, lp[f"slot{i}"], x, lc[f"slot{i}"], pos, mrope_positions)
    else:
        # the JAX package passes no M-RoPE positions to flat layers' decode
        for i, lp in enumerate(params.get("flat_layers", [])):
            x, _ = L._layer_decode(cfg, unit[i % len(unit)], lp, x, cache["flat"][i], pos)
            if cfg.arch_type == "whisper":  # cross attention against the cached encoder K/V
                x = L._cross_attend(cfg, params["cross_layers"][i], x, cache["cross_k"][i], cache["cross_v"][i])
    for kind, lp, rc in zip(rem, params["rem_layers"], cache["rem"]):
        x, _ = L._layer_decode(cfg, kind, lp, x, rc, pos, mrope_positions)
    return C.rmsnorm(params["final_norm"], x, cfg.norm_eps), cache


def _zamba_decode(cfg: ModelConfig, params, cache, x, pos: int):
    period = max(cfg.attn_every, 1)
    sa, sb = params["shared_attn"]
    n_double = L.layer_plan(cfg)[1]
    for up, uc in zip(L.unbind_units(params["units"], n_double), L.unbind_units(cache["units"], n_double)):
        for half, shared, attn in (("a", sa, "attn_a"), ("b", sb, "attn_b")):
            for lp, lc in zip(L.unbind_units(up[half], period), L.unbind_units(uc[half], period)):
                x, _ = L._layer_decode(cfg, "mamba", lp, x, lc, pos)
            x, _ = L._layer_decode(cfg, "attn_global", shared, x, uc[attn], pos)
    ai = 0
    for i, (lp, rc) in enumerate(zip(params["rem_layers"], cache["rem"])):
        x, _ = L._layer_decode(cfg, "mamba", lp, x, rc, pos)
        if (i + 1) % period == 0 and ai < len(cache["rem_attn"]):
            x, _ = L._layer_decode(cfg, "attn_global", sa, x, cache["rem_attn"][ai], pos)
            ai += 1
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
def _hidden(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """The final normed hidden states (B,S,d) of ``batch``: whisper from its
    audio frames and tokens, the VLM from merged embeddings and M-RoPE
    position triples, the others from token ids."""
    if cfg.arch_type == "whisper":
        return L.whisper_train(cfg, params, batch["audio_embeds"], batch["tokens"])
    if cfg.arch_type == "vlm":
        x = batch["embeds"].to(C.dtype_of(cfg))
        return L.backbone_train(cfg, params, x, None, mrope_positions=batch["positions3"])
    tokens = batch["tokens"]
    x = C.embed_lookup(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None].expand(tokens.shape)
    return L.backbone_train(cfg, params, x, positions)


def compute_loss(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Mean next-token cross-entropy against ``batch["labels"]`` (-1
    ignored). The MoE aux losses are not added, as in the JAX package."""
    return C.chunked_ce_loss(params["embed"], _hidden(cfg, params, batch), batch["labels"])


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4):
    """``train_step(params, opt, batch) -> (params, opt, {"loss": ...})``:
    the loss and its gradient, then AdamW in place."""

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

    @torch.no_grad()
    def prefill_step(params, batch):
        return C.lm_logits(params["embed"], _hidden(cfg, params, batch)[:, -1:])

    return prefill_step


# ------------------------------------------------------------- serve step
def make_serve_step(cfg: ModelConfig):
    """One-token decode step against a KV or state cache (updated in place).
    The VLM's M-RoPE positions are the token's position in all three
    streams, as in the JAX package."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos: int):
        # tokens: (B,1) int; pos: absolute position of the token
        x = C.embed_lookup(params["embed"], tokens)
        mrope = None
        if cfg.arch_type == "vlm":
            mrope = torch.full((tokens.shape[0], 1, 3), int(pos), dtype=torch.int32, device=tokens.device)
        x, cache = backbone_decode(cfg, params, cache, x, int(pos), mrope_positions=mrope)
        return C.lm_logits(params["embed"], x), cache

    return serve_step
