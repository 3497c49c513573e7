"""Mamba2 (SSD) block, PyTorch port of ``models/ssm.py``.

Train path: the chunked state-space duality algorithm of the Mamba2 paper,
as the JAX package computes it: an intra-chunk quadratic term and an
inter-chunk recurrence over chunks of 64 (the JAX ``lax.scan`` is a Python
loop over chunks here), the same einsum contractions and float32 islands.
The causal mask is applied to the decay's logarithm before ``exp`` (the
upper triangle would overflow and give inf x 0 gradients). Decode path: the
single-step recurrent update, with the cache updated in place (the JAX
function returns a new cache). Nothing here reaches a Pallas kernel in the
JAX package, so everything is PyTorch ops; the causal depthwise conv is
``F.conv1d``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, rmsnorm, rmsnorm_init

CONV_WIDTH = 4
CHUNK = 64
MASKED_LOG = -1e30  # the log-space mask of the decay, as the JAX package's


def mamba2_dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    h = cfg.ssm_heads
    p = di // h
    n = cfg.ssm_state
    return di, h, p, n


def mamba2_init(gen: torch.Generator, cfg, dtype):
    d = cfg.d_model
    di, h, p, n = mamba2_dims(cfg)
    conv_ch = di + 2 * n
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * n + h), dtype),
        "conv_w": (torch.randn((CONV_WIDTH, conv_ch), generator=gen, device=dev) * 0.2).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(di, dtype, dev),
        "out_proj": dense_init(gen, (di, d), dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``softplus``, ``logaddexp(x, 0)``, in the same form."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_depthwise_conv(x, w, b):
    """x: (B,S,C), w: (W,C), b: (C,). Causal depthwise conv."""
    c = x.shape[-1]
    xw = F.pad(x.transpose(1, 2), (CONV_WIDTH - 1, 0))             # (B,C,S+W-1)
    return F.conv1d(xw, w.t()[:, None, :], groups=c).transpose(1, 2) + b


def _split_proj(cfg, xproj):
    di, h, hp, n = mamba2_dims(cfg)
    z = xproj[..., :di]
    xc = xproj[..., di:2 * di + 2 * n]   # conv channels: x, B, C
    dt = xproj[..., 2 * di + 2 * n:]     # (..., H)
    return z, xc, dt


def mamba2_train(p, cfg, x):
    """x: (B,S,d) -> (B,S,d)."""
    bsz, s, d = x.shape
    di, h, hp, n = mamba2_dims(cfg)
    proj = x @ p["in_proj"]
    z, xc, dt = _split_proj(cfg, proj)
    xc = F.silu(_causal_depthwise_conv(xc, p["conv_w"], p["conv_b"]))
    xh = xc[..., :di].reshape(bsz, s, h, hp)
    bmat = xc[..., di:di + n]              # (B,S,N)
    cmat = xc[..., di + n:]                # (B,S,N)

    dt = softplus(dt.to(torch.float32) + p["dt_bias"])             # (B,S,H)
    a = -torch.exp(p["a_log"])                                      # (H,)
    da = dt * a                                                     # (B,S,H) negative

    c = CHUNK
    pad = (-s) % c
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        bmat, cmat, dt, da = (F.pad(t, (0, 0, 0, pad)) for t in (bmat, cmat, dt, da))
    nc = xh.shape[1] // c
    xh_ = xh.reshape(bsz, nc, c, h, hp).to(torch.float32)
    b_ = bmat.reshape(bsz, nc, c, n).to(torch.float32)
    c_ = cmat.reshape(bsz, nc, c, n).to(torch.float32)
    dt_ = dt.reshape(bsz, nc, c, h)
    da_ = da.reshape(bsz, nc, c, h)

    cums = torch.cumsum(da_, dim=2)                                 # (B,nc,c,H) inclusive
    # ---- intra-chunk (quadratic within chunk)
    cb = torch.einsum("bnis,bnjs->bnij", c_, b_)                    # (B,nc,c,c)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    dlog = cums[:, :, :, None, :] - cums[:, :, None, :, :]          # (B,nc,c,c,H)
    decay = torch.exp(torch.where(causal[None, None, :, :, None], dlog, MASKED_LOG))
    w = cb[..., None] * decay * dt_[:, :, None]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", w, xh_)

    # ---- inter-chunk recurrence
    chunk_total = cums[:, :, -1, :]                                 # (B,nc,H)
    state_in = torch.einsum("bnjh,bnjs,bnjhp->bnhsp", torch.exp(chunk_total[:, :, None] - cums) * dt_, b_,
                            xh_)                                    # (B,nc,H,N,P)
    s_prev = torch.zeros((bsz, h, n, hp), dtype=torch.float32, device=x.device)
    s_prevs = []                                                    # the state before each chunk
    for i in range(nc):
        s_prevs.append(s_prev)
        if i + 1 < nc:
            s_prev = s_prev * torch.exp(chunk_total[:, i])[:, :, None, None] + state_in[:, i]
    y_inter = torch.einsum("bnis,bnih,bnhsp->bnihp", c_, torch.exp(cums), torch.stack(s_prevs, 1))

    y = (y_intra + y_inter).reshape(bsz, nc * c, h, hp)[:, :s]
    y = y + p["d_skip"][None, None, :, None] * xh[:, :s].to(torch.float32)
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return y @ p["out_proj"]


def mamba2_cache_init(cfg, batch, dtype, device="cuda"):
    di, h, hp, n = mamba2_dims(cfg)
    return {
        "state": torch.zeros((batch, h, n, hp), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, di + 2 * n), dtype=dtype, device=device),
    }


def mamba2_decode(p, cfg, x, cache):
    """x: (B,1,d). Returns (y (B,1,d), cache), the cache updated in place."""
    bsz = x.shape[0]
    di, h, hp, n = mamba2_dims(cfg)
    proj = x[:, 0] @ p["in_proj"]                                   # (B, ...)
    z, xc, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([cache["conv"], xc[:, None]], dim=1)       # (B,W,Cc)
    xc = F.silu(torch.einsum("bwc,wc->bc", conv_in, p["conv_w"]) + p["conv_b"])

    xh = xc[:, :di].reshape(bsz, h, hp).to(torch.float32)
    bvec = xc[:, di:di + n].to(torch.float32)
    cvec = xc[:, di + n:].to(torch.float32)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])             # (B,H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a)                                       # (B,H)
    state = cache["state"] * decay[:, :, None, None] + torch.einsum("bh,bs,bhp->bhsp", dt, bvec, xh)
    y = torch.einsum("bs,bhsp->bhp", cvec, state) + p["d_skip"][None, :, None] * xh
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = y * F.silu(z[:, None])
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    cache["state"].copy_(state)
    cache["conv"].copy_(conv_in[:, 1:])
    return y @ p["out_proj"], cache
