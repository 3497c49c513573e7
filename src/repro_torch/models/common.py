"""Shared transformer building blocks of the LM decoders (PyTorch port).

The JAX package's ``models/common.py``: pure functions on parameter
dictionaries whose keys are the JAX pytree's. Attention over a prompt goes
through the attention kernel's wrapper (``kernels/flash_attention``), which
runs the hand-written CUDA kernel on the card and the plain chunked online
softmax on the CPU, in the forward and in a training step's recompute.
One-token decode attention is plain PyTorch, as the JAX package computes it
outside any Pallas kernel. The JAX code's sharding
annotations (``lshard``) are no-ops without a mesh and are dropped here.
``chunked_ce_loss`` is the training loss; ``apply_mrope`` is Qwen2-VL's
M-RoPE, which ``_qkv`` takes in place of RoPE when given (B,S,3) position
triples.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import MASKED


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, device=gen.device) * s).to(dtype)


# ------------------------------------------------------------------ RMSNorm
def rmsnorm_init(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------- RoPE
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    """The float32 rotary frequencies: the float32 exponents, then the power
    and reciprocal in float64, rounded once, which gives the values XLA's
    compiled power gives. torch's float32 power is an ulp off at some
    entries, and the angle's error grows with the position (2e-4 rad at
    4,000)."""
    expo = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return (1.0 / (theta ** expo.to(torch.float64))).to(torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B,S,H,hd), positions: (B,S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                         # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs           # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float, sections) -> torch.Tensor:
    """Qwen2-VL M-RoPE. x: (B,S,H,hd), positions: (B,S,3) [t,h,w]; sections
    sum to hd/2: each rotary frequency slot takes its position stream by
    section."""
    hd = x.shape[-1]
    half = hd // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(hd, theta, x.device)                         # (half,)
    sec_id = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device) for i, s in enumerate(sections)])
    pos = positions.to(torch.float32)[..., sec_id]                 # (B,S,half)
    ang = pos * freqs[None, None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
def attn_init(gen, cfg, dtype):
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, gen.device)
        p["k_norm"] = rmsnorm_init(hd, dtype, gen.device)
    return p


def _qkv(p, cfg, x, positions, mrope_positions=None):
    b, s, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
    elif positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q, k, v, *, causal: bool = True, window: int | None = None, q_offset: int = 0):
    """Attention over key chunks with an online softmax: q (B,S,H,hd), k and
    v (B,Skv,Hkv,hd). The kernel on CUDA tensors, the plain version on the
    CPU (``kernels/flash_attention/ops.py``)."""
    return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


def attention_train(p, cfg, x, positions, *, window=None, causal=True, mrope_positions=None):
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions, mrope_positions)
    out = chunked_attention(q, k, v, causal=causal, window=window)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]


def attention_decode(p, cfg, x, cache_k, cache_v, pos: int, *, window=None, mrope_positions=None):
    """One-token decode. cache_k/v: (B, Scache, Hkv, hd) ring or linear buffer.

    pos: absolute position of the new token. Writes the new key and value
    into the caches in place (the JAX function returns updated copies) and
    returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    hd = cfg.hd
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions, mrope_positions)
    s_cache = cache_k.shape[1]
    slot = pos % s_cache if window is not None else min(pos, s_cache - 1)
    cache_k[:, slot:slot + 1] = k.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v.to(cache_v.dtype)

    kf = cache_k.to(torch.float32)
    vf = cache_v.to(torch.float32)
    group = cfg.n_heads // cfg.n_kv_heads
    qf = q.to(torch.float32) * (1.0 / math.sqrt(hd))  # (B,1,H,hd)
    qf = qf.reshape(b, cfg.n_kv_heads, group, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, kf)    # (B,Hkv,g,Scache)
    idx = torch.arange(s_cache, device=x.device)
    if window is not None:
        # ring buffer: slot i holds the largest absolute position p' <= pos
        # with p' % s_cache == i; valid if within the window
        abs_pos = pos - torch.remainder(pos - idx, s_cache)
        mask = (abs_pos >= 0) & (abs_pos <= pos) & (pos - abs_pos < window)
    else:
        mask = idx <= pos
    scores = torch.where(mask, scores, MASKED)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, vf).reshape(b, 1, cfg.n_heads * hd).to(x.dtype)
    return out @ p["wo"], cache_k, cache_v


# -------------------------------------------------------------------- SwiGLU
def mlp_init(gen, d, ff, dtype):
    return {
        "wi": dense_init(gen, (d, ff), dtype),
        "wg": dense_init(gen, (d, ff), dtype),
        "wo": dense_init(gen, (ff, d), dtype),
    }


def mlp(p, x):
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


# ----------------------------------------------------------------- LM pieces
def embed_init(gen, vocab, d, dtype):
    return {"embedding": (torch.randn((vocab, d), generator=gen, device=gen.device) * 0.02).to(dtype)}


def embed_lookup(p, tokens):
    return p["embedding"][tokens]


def lm_logits(p_embed, x):
    return x @ p_embed["embedding"].T


def chunked_ce_loss(p_embed, x, labels, *, chunk: int = 512, z_loss: float = 0.0):
    """Mean cross-entropy over the valid labels (label -1 is ignored), plus
    ``z_loss`` x logsumexp^2, over sequence chunks: with grad on, each
    chunk is recomputed in the backward, so no (B, chunk, V) float32 logits
    outlive their chunk (the JAX package checkpoints the chunk step)."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)

    def step(xc, lc):
        logits = lm_logits(p_embed, xc).to(torch.float32)  # (B,chunk,V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp(lc, min=0)[..., None])[..., 0]
        valid = lc >= 0
        nll = torch.where(valid, lse - gold, 0.0)
        if z_loss:
            nll = nll + torch.where(valid, z_loss * lse**2, 0.0)
        return torch.sum(nll), torch.sum(valid)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[1], chunk):
        xc, lc = x[:, lo:lo + chunk], labels[:, lo:lo + chunk]
        if torch.is_grad_enabled():
            nll, n = checkpoint(step, xc, lc, use_reentrant=False, preserve_rng_state=False)
        else:
            nll, n = step(xc, lc)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1)
