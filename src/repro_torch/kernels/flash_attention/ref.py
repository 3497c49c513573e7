"""Plain PyTorch version of the attention kernel: chunked online softmax.

The JAX package's ``chunked_attention`` (``models/common.py``), computed the
same way: q cast to float32 and scaled there (the JAX code's scale is a NumPy
float64 scalar, which promotes a bfloat16 q to float32 before the product),
K and V expanded to the query heads (GQA, head h reads kv head h // group),
an online softmax over key chunks of 1024 with the padding, causal and
sliding-window masks setting masked scores to -1e30, the output divided by
``max(l, 1e-30)`` and cast to the input dtype.

``flash_attention.cu`` computes the same function with other block sizes and
another summation order. The two agree exactly in which scores are masked;
they agree in value wherever each query row has at least one unmasked key.
A row with none (only possible with a ``q_offset`` or ``window`` that puts
every key out of its reach) gets an average of V over the padded chunks
here, and the CUDA wrapper refuses such arguments.
"""
from __future__ import annotations

import math

import torch

MASKED = -1e30


def attention_ref(
    q: torch.Tensor,   # (B, S, H, hd)
    k: torch.Tensor,   # (B, Skv, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    chunk: int = 1024,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd), masked) v, (B, S, H, hd) in q's dtype."""
    b, s, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qf = (q.to(torch.float32) * scale).transpose(1, 2)                          # (B,H,S,hd)
    kf = k.to(torch.float32).transpose(1, 2).repeat_interleave(group, dim=1)     # (B,H,Skv,hd)
    vf = v.to(torch.float32).transpose(1, 2).repeat_interleave(group, dim=1)

    chunk = min(chunk, skv)
    nc = -(-skv // chunk)
    q_pos = q_offset + torch.arange(s, device=dev)

    m = torch.full((b, h, s), MASKED, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, s, hd), dtype=torch.float32, device=dev)
    for ci in range(nc):
        lo = ci * chunk
        kc, vc = kf[:, :, lo:lo + chunk], vf[:, :, lo:lo + chunk]
        kv_pos = lo + torch.arange(chunk, device=dev)
        scores = torch.einsum("bhqd,bhkd->bhqk", qf, kc)
        if kc.shape[2] < chunk:  # the last chunk's padding keys: zero K, masked
            scores = torch.nn.functional.pad(scores, (0, chunk - kc.shape[2]))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, chunk - vc.shape[2]))
        mask = (kv_pos < skv)[None, :]
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
        scores = torch.where(mask, scores, MASKED)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)
