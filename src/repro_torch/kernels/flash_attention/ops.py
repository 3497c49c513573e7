"""Wrapper of the attention kernel: checks, dispatch by device, autograd.

``flash_attention(q, k, v, causal=, window=, q_offset=)`` takes q (B, S, H,
hd) and k, v (B, Skv, Hkv, hd) and returns (B, S, H, hd) in q's dtype. On
CPU tensors it runs the plain version (``ref.attention_ref``); on CUDA
tensors it runs ``flash_attention.cu`` on the tensors' own layout (no head
repetition, no padding, no transpose), or raises: bfloat16 on the tensor
cores (TMA loads, so the base pointers must be 16-byte aligned), float32 on
the CUDA cores. There is no length limit and no fallback: the kernels stream
K and V through shared memory.

It is a ``torch.autograd.Function`` on both devices whose backward is the
vector-Jacobian product of the plain version, recomputed from the saved
inputs, as the JAX package's ``custom_vjp`` does with its oracle. The
forward opens one operation-counter region (``kernels/cost.py``
``region``) around its choice of device and reports the kernel's formula
from it on both; the backward's plain ops are counted one by one.
``launch`` only checks, allocates and launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import cost as _cost
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (32, 64, 112, 128)  # head widths the kernel is instantiated for
DTYPES = (torch.float32, torch.bfloat16)

launch_count = _lib.launches("flash_attention_fwd")


def _rows_reach_a_key(s: int, skv: int, causal: bool, window: int | None, q_offset: int) -> bool:
    """Whether every query row has at least one unmasked key. The masks'
    bounds grow with the row's position, so the first and last rows decide."""
    for pos in (q_offset, q_offset + s - 1):
        lo = max(pos - window + 1, 0) if window is not None else 0
        hi = min(pos, skv - 1) if causal else skv - 1
        if lo > hi:
            return False
    return True


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
           window: int | None = None, q_offset: int = 0) -> torch.Tensor:
    """Run ``flash_attention.cu`` on CUDA tensors; returns (B, S, H, hd)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,hd) and k, v (B,Skv,Hkv,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or hkv == 0 or h % hkv:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)} (GQA needs H % Hkv == 0)")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {q.dtype} tensor on {dev}, "
                             f"got {x.dtype} on {x.device} (contiguous: {x.is_contiguous()})")
    if q.dtype not in DTYPES:
        raise ValueError(f"the kernel takes {DTYPES}, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for head_dim in {HEAD_DIMS}, got {hd}")
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name}: the bfloat16 kernel reads through TMA and needs a 16-byte-aligned "
                                 f"base pointer, got {x.data_ptr():#x}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty_like(q)
    if s == 0 or b * h == 0:
        return out
    if not _rows_reach_a_key(s, skv, causal, window, q_offset):
        raise ValueError(f"q_offset {q_offset}, window {window}, causal {causal} over Skv {skv} leave a query "
                         "row with no unmasked key; the kernel's result is defined only where every row has one")
    _lib.call("flash_attention_fwd", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, skv, h, hkv,
              hd, int(q.dtype == torch.bfloat16), int(causal), -1 if window is None else int(window), int(q_offset),
              1.0 / math.sqrt(hd))
    return out


class FlashAttention(torch.autograd.Function):
    """The kernel (CUDA) or the plain version (CPU) forward; the plain
    version's VJP backward, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window, q_offset: int):
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset)
        ctx.save_for_backward(q, k, v)
        with _cost.region("flash_attention") as r:
            if q.device.type == "cuda":
                out = launch(q, k, v, **ctx.kw)
            else:
                # contiguous, as the kernel writes it, so that what follows
                # runs the same ops on both devices
                out = attention_ref(q, k, v, **ctx.kw).contiguous()
            if r:
                r.report(*_cost.attention_cost(q, k, v, **ctx.kw), out)
        return out

    @staticmethod
    def backward(ctx, gout):
        leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_ref(*leaves, **ctx.kw)
            grads = torch.autograd.grad(out, leaves, gout)
        return (*grads, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None, q_offset: int = 0):
    """softmax(q k^T / sqrt(hd), masked) v: the kernel on CUDA, the plain
    version on the CPU. q (B,S,H,hd), k and v (B,Skv,Hkv,hd)."""
    return FlashAttention.apply(q, k, v, causal, window, int(q_offset))
