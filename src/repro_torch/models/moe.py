"""Mixture-of-Experts layer (PyTorch port of ``models/moe.py``): a top-k
router and sort-based capacity dispatch.

Each batch row is one dispatch group: its (token, choice) pairs are sorted
by expert id (stably), packed into a fixed (E, C, d) buffer (a pair past
its expert's capacity C is dropped), run through the experts as batched
products, then gathered back, unsorted and combined with the gate weights
in float32. The JAX package vmaps the dispatch over rows; here every step
carries the batch dim. One-token decode folds the batch into one group.

The choice order follows ``jax.lax.top_k``: gates in descending order,
ties to the lower expert id (a stable descending sort, so the card and the
CPU break ties alike). The router is float32 whatever the model's dtype.
``moe_apply`` returns the JAX function's aux dict (load-balance loss,
router z-loss, dropped share); the model drops it, as the JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, mlp, mlp_init


def moe_init(gen: torch.Generator, cfg, dtype):
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": dense_init(gen, (d, e), torch.float32, scale=0.02),
        "wi": dense_init(gen, (e, d, ff), dtype),
        "wg": dense_init(gen, (e, d, ff), dtype),
        "wo": dense_init(gen, (e, ff, d), dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, ff * cfg.n_shared_experts, dtype)
    return p


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, i]] for (B, N, d) x and (B, M) idx -> (B, M, d)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def dispatch(flat_e: torch.Tensor, e: int, cap: int):
    """(B, N) expert ids of the (token, choice) pairs -> (order, dest,
    keep): the stable sort of the pairs by expert, and each sorted pair's
    row of the (E * cap + 1) dispatch buffer with whether it fits its
    expert's capacity (a dropped pair goes to the dummy row E * cap)."""
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    b, n = flat_e.shape
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=flat_e.device).expand(b, e).contiguous())
    pos_in_e = torch.arange(n, device=flat_e.device) - torch.gather(starts, 1, sorted_e)
    keep = pos_in_e < cap
    return order, torch.where(keep, sorted_e * cap + pos_in_e, e * cap), keep


def moe_apply(p, cfg, x):
    """x: (B,S,d) -> (out (B,S,d), aux dict)."""
    b, s, d = x.shape
    if s == 1 and b > 1:
        # decode: one dispatch group for the whole batch, not E slots a token
        out, aux = moe_apply(p, cfg, x.reshape(1, b, d))
        return out.reshape(b, 1, d), aux
    k = cfg.top_k
    e = cfg.n_experts
    cap = int((s * k / e) * cfg.capacity_factor) + 1
    dev = x.device

    logits = x.to(torch.float32) @ p["router"]                       # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]      # (B,S,k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # ---- dispatch: (token, choice) pairs sorted by expert, packed to capacity
    order, dest, keep = dispatch(gate_idx.reshape(b, s * k), e, cap)
    tok = order // k
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=dev)
    buf = buf.scatter(1, dest[..., None].expand(-1, -1, d), _rows(x, tok))
    buf = buf[:, : e * cap].reshape(b, e, cap, d)

    # ---- expert FFN, batched over experts
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["wg"])) * torch.einsum("becd,edf->becf", buf, p["wi"])
    y = torch.einsum("becf,efd->becd", h, p["wo"])

    # ---- combine: gather each pair's row (dropped -> 0) in token order, weight
    y_flat = torch.cat([y.reshape(b, e * cap, d), torch.zeros((b, 1, d), dtype=y.dtype, device=dev)], dim=1)
    inv = torch.argsort(order, dim=-1, stable=True)
    dest_tok = torch.gather(dest, 1, inv)                            # each pair's row, in token order
    y_exp = _rows(y_flat, dest_tok).reshape(b, s, k, d)
    out = torch.einsum("bskd,bsk->bsd", y_exp.to(torch.float32), gate_vals).to(x.dtype)

    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], x)

    # load-balance aux (Switch-style) + router z-loss
    me = torch.mean(probs, dim=(0, 1))                               # (E,)
    ce = torch.mean(F.one_hot(gate_idx, e).to(torch.float32).sum(2), dim=(0, 1))
    aux = {
        "lb_loss": e * torch.sum(me * ce),
        "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "drop_frac": 1.0 - torch.mean(keep.to(torch.float32)),
    }
    return out, aux
