"""xLSTM blocks (Beck et al., arXiv:2405.04517), PyTorch port of
``models/xlstm.py``: mLSTM + sLSTM.

mLSTM: matrix-memory LSTM with exponential gating. The train path is the
JAX package's chunkwise-parallel form, carrying the matrix state C, the
normalizer n and the log-scale stabilizer m across chunks of 64 (its
``lax.scan`` over chunks is a Python loop here). The intra-chunk mask is
-inf in log space, before ``exp``, and the row stabilizer is clamped at
-1e30; the padding of a ragged last chunk gives the forget gate's log -1e4,
as the JAX code does. Decode is the plain recurrence.

sLSTM: scalar-memory LSTM with recurrent per-head weights, sequential over
time (a Python loop of one step per token, the JAX ``lax.scan`` over time;
its ``shard_map`` branch is a mesh branch and the port's models have no
mesh). Decode updates its cache in place (the JAX functions return new
caches). Nothing here reaches a Pallas kernel in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, rmsnorm, rmsnorm_init

CHUNK = 64


def _dims(cfg):
    h = cfg.n_heads
    hd = cfg.d_model // h
    return h, hd


# ================================================================== mLSTM ==
def mlstm_init(gen: torch.Generator, cfg, dtype):
    d = cfg.d_model
    h, hd = _dims(cfg)
    dev = gen.device
    return {
        "wq": dense_init(gen, (d, d), dtype),
        "wk": dense_init(gen, (d, d), dtype),
        "wv": dense_init(gen, (d, d), dtype),
        "wi": dense_init(gen, (d, h), torch.float32, scale=0.02),
        "wf": dense_init(gen, (d, h), torch.float32, scale=0.02),
        "wo_gate": dense_init(gen, (d, d), dtype),
        "fbias": torch.full((h,), 3.0, dtype=torch.float32, device=dev),  # open forget gates at init
        "norm": rmsnorm_init(d, dtype, dev),
        "out_proj": dense_init(gen, (d, d), dtype),
    }


def _mlstm_qkvif(p, cfg, x):
    bsz, s, d = x.shape
    h, hd = _dims(cfg)
    q = (x @ p["wq"]).reshape(bsz, s, h, hd)
    # the JAX code's float32 sqrt, cast to x's dtype
    k = (x @ p["wk"]).reshape(bsz, s, h, hd) / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(x.dtype)
    v = (x @ p["wv"]).reshape(bsz, s, h, hd)
    ilog = x.to(torch.float32) @ p["wi"]                                    # (B,S,H) input gate logit
    flog = F.logsigmoid(x.to(torch.float32) @ p["wf"] + p["fbias"])        # (B,S,H)
    return q, k, v, ilog, flog


def _mlstm_chunk(carry, qc, kc, vc, il, fl):
    """One chunk of the chunkwise mLSTM: (carry, y) from the (C, n, m) carry
    and the chunk's float32 q, k, v (B,c,H,hd) and gate logs (B,c,H)."""
    cstate, nstate, m = carry       # (B,H,hd,hd), (B,H,hd), (B,H)
    cf = torch.cumsum(fl, dim=1)                                        # (B,c,H) inclusive
    total_f = cf[:, -1]                                                 # (B,H)
    # intra-chunk log weights w_ij = cf_i - cf_j + il_j  (j <= i)
    wlog = cf[:, :, None, :] - cf[:, None, :, :] + il[:, None, :, :]    # (B,i,j,H)
    causal = torch.tril(torch.ones((wlog.shape[1], wlog.shape[1]), dtype=torch.bool, device=wlog.device))
    wlog = torch.where(causal[None, :, :, None], wlog, -torch.inf)
    carry_log = cf + m[:, None]                                         # (B,i,H) carry-in scale per row
    m_row = torch.maximum(torch.amax(wlog, dim=2), carry_log)          # (B,i,H)
    m_row = torch.maximum(m_row, m_row.new_full((), -1e30))
    wa = torch.exp(wlog - m_row[:, :, None, :])                         # (B,i,j,H)
    cscale = torch.exp(carry_log - m_row)                               # (B,i,H)

    scores = torch.einsum("bihd,bjhd->bijh", qc, kc)                    # (B,i,j,H)
    num_intra = torch.einsum("bijh,bijh,bjhp->bihp", wa, scores, vc)
    num_carry = torch.einsum("bihd,bhdp,bih->bihp", qc, cstate, cscale)
    den_intra = torch.einsum("bijh,bijh->bih", wa, scores)
    den_carry = torch.einsum("bihd,bhd,bih->bih", qc, nstate, cscale)
    num = num_intra + num_carry
    den = den_intra + den_carry
    denom = torch.maximum(torch.abs(den), torch.exp(-m_row))            # xLSTM max(|n q|, 1) at scale m
    y = num / denom[..., None]                                          # (B,i,H,P)

    # ---- state to next chunk, restabilized at m_new
    upd_log = total_f[:, None] - cf + il                                # (B,j,H)
    m_new = torch.maximum(m + total_f, torch.amax(upd_log, dim=1))
    uw = torch.exp(upd_log - m_new[:, None])                            # (B,j,H)
    keep = torch.exp(m + total_f - m_new)
    c_next = cstate * keep[:, :, None, None] + torch.einsum("bjh,bjhd,bjhp->bhdp", uw, kc, vc)
    n_next = nstate * keep[:, :, None] + torch.einsum("bjh,bjhd->bhd", uw, kc)
    return (c_next, n_next, m_new), y


def mlstm_train(p, cfg, x):
    bsz, s, d = x.shape
    h, hd = _dims(cfg)
    q, k, v, ilog, flog = _mlstm_qkvif(p, cfg, x)

    c = min(CHUNK, s)
    pad = (-s) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        ilog = F.pad(ilog, (0, 0, 0, pad))
        flog = F.pad(flog, (0, 0, 0, pad), value=-1e4)
    nc = q.shape[1] // c

    def rs(t):  # (B, nc*c, ...) -> nc chunks of (B, c, ...)
        return t.reshape(bsz, nc, c, *t.shape[2:]).unbind(1)

    qs, ks_, vs = (rs(t.to(torch.float32)) for t in (q, k, v))
    ils, fls = rs(ilog), rs(flog)
    carry = (torch.zeros((bsz, h, hd, hd), dtype=torch.float32, device=x.device),
             torch.zeros((bsz, h, hd), dtype=torch.float32, device=x.device),
             torch.full((bsz, h), -1e30, dtype=torch.float32, device=x.device))
    ys = []
    for i in range(nc):
        carry, y = _mlstm_chunk(carry, qs[i], ks_[i], vs[i], ils[i], fls[i])
        ys.append(y)
    y = torch.stack(ys, 1).reshape(bsz, nc * c, h, hd)[:, :s]

    o = torch.sigmoid(x @ p["wo_gate"])
    y = y.reshape(bsz, s, d).to(x.dtype) * o
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return y @ p["out_proj"]


def mlstm_cache_init(cfg, batch, device="cuda"):
    h, hd = _dims(cfg)
    return {
        "c": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=torch.float32, device=device),
    }


def mlstm_decode(p, cfg, x, cache):
    """x: (B,1,d). Returns (y (B,1,d), cache), the cache updated in place."""
    bsz = x.shape[0]
    h, hd = _dims(cfg)
    q, k, v, ilog, flog = _mlstm_qkvif(p, cfg, x)   # seq dim = 1
    qf, kf, vf = (t[:, 0].to(torch.float32) for t in (q, k, v))
    il, fl = ilog[:, 0], flog[:, 0]                                 # (B,H)
    m_new = torch.maximum(cache["m"] + fl, il)
    scale_old = torch.exp(cache["m"] + fl - m_new)
    scale_in = torch.exp(il - m_new)
    c_new = (cache["c"] * scale_old[:, :, None, None]
             + torch.einsum("bhd,bhp->bhdp", kf, vf) * scale_in[:, :, None, None])
    n_new = cache["n"] * scale_old[:, :, None] + kf * scale_in[:, :, None]
    num = torch.einsum("bhd,bhdp->bhp", qf, c_new)
    den = torch.einsum("bhd,bhd->bh", qf, n_new)
    denom = torch.maximum(torch.abs(den), torch.exp(-m_new))
    y = (num / denom[..., None]).reshape(bsz, 1, h * hd).to(x.dtype)
    y = y * torch.sigmoid(x @ p["wo_gate"])
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    for key, val in (("c", c_new), ("n", n_new), ("m", m_new)):
        cache[key].copy_(val)
    return y @ p["out_proj"], cache


# ================================================================== sLSTM ==
def slstm_init(gen: torch.Generator, cfg, dtype):
    d = cfg.d_model
    h, hd = _dims(cfg)
    dev = gen.device
    return {
        "wx": dense_init(gen, (d, 4 * d), dtype),        # z,i,f,o pre-activations
        "r": (torch.randn((h, hd, 4 * hd), generator=gen, device=dev) * 0.02).to(dtype),  # recurrent per head
        "fbias": torch.full((d,), 3.0, dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d, dtype, dev),
        "out_proj": dense_init(gen, (d, d), dtype),
    }


def _slstm_step(pre, fbias, cs, ns, ms):
    """One sLSTM step from the (B,4,H,hd) pre-activations: (c, n, m, y)."""
    h, hd = pre.shape[2:]
    z = torch.tanh(pre[:, 0])
    ilog = pre[:, 1]
    flog = F.logsigmoid(pre[:, 2] + fbias.reshape(h, hd)[None])
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(flog + ms, ilog)
    i_s = torch.exp(ilog - m_new)
    f_s = torch.exp(flog + ms - m_new)
    c_new = f_s * cs + i_s * z
    n_new = f_s * ns + i_s
    # torch.maximum, not clamp: a tie (n = 1 on the first step) splits its
    # gradient in halves, as jnp.maximum's does
    return c_new, n_new, m_new, o * c_new / torch.maximum(n_new, n_new.new_ones(()))


def _slstm_scan(wx, r, fbias):
    """Pure local recurrence. wx: (B,S,4,H,hd) f32. Returns ys (B,S,H,hd)."""
    bsz, s, four, h, hd = wx.shape
    cs = ns = ys = torch.zeros((bsz, h, hd), dtype=torch.float32, device=wx.device)
    ms = torch.full((bsz, h, hd), -1e30, dtype=torch.float32, device=wx.device)
    out = []
    for t in range(s):
        # (B,H,4hd) read as (B,4,H,hd), as the JAX code reshapes it
        pre = wx[:, t] + torch.einsum("bhd,hdk->bhk", ys, r).reshape(bsz, 4, h, hd)
        cs, ns, ms, ys = _slstm_step(pre, fbias, cs, ns, ms)
        out.append(ys)
    return torch.stack(out, 1)


def slstm_train(p, cfg, x):
    bsz, s, d = x.shape
    h, hd = _dims(cfg)
    wx = (x @ p["wx"]).reshape(bsz, s, 4, h, hd).to(torch.float32)
    ys = _slstm_scan(wx, p["r"].to(torch.float32), p["fbias"])
    y = ys.reshape(bsz, s, d).to(x.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return y @ p["out_proj"]


def slstm_cache_init(cfg, batch, device="cuda"):
    h, hd = _dims(cfg)
    shape = (batch, h, hd)
    # four separate tensors: decode writes each in place
    return {"c": torch.zeros(shape, dtype=torch.float32, device=device),
            "n": torch.zeros(shape, dtype=torch.float32, device=device),
            "m": torch.full(shape, -1e30, dtype=torch.float32, device=device),
            "y": torch.zeros(shape, dtype=torch.float32, device=device)}


def slstm_decode(p, cfg, x, cache):
    """x: (B,1,d). Returns (y (B,1,d), cache), the cache updated in place."""
    bsz = x.shape[0]
    h, hd = _dims(cfg)
    wx = (x[:, 0] @ p["wx"]).reshape(bsz, 4, h, hd).to(torch.float32)
    pre = wx + torch.einsum("bhd,hdk->bhk", cache["y"], p["r"].to(torch.float32)).reshape(bsz, 4, h, hd)
    new = _slstm_step(pre, p["fbias"], cache["c"], cache["n"], cache["m"])
    out = new[3].reshape(bsz, 1, h * hd).to(x.dtype)
    out = rmsnorm(p["norm"], out, cfg.norm_eps)
    for key, val in zip(("c", "n", "m", "y"), new):
        cache[key].copy_(val)
    return out @ p["out_proj"], cache
