"""Adam with per-field learning rates (3D-GS trains each field at its own LR).

The JAX package's own Adam (``optim/adam.py``), not ``torch.optim.Adam``:
eps 1e-15, a learning rate per parameter field, and the bias correction
computed in float32 from the int32 step count, as JAX computes it. The
update is functional, as in JAX: it returns new tensors and leaves its
inputs alone. Each field's update is one launch of ``kernels/adam/adam.cu``
on CUDA tensors and the plain version (``kernels/adam/ref.py``) on the CPU,
chosen inside the field's operation-counter region ``adam``, which reports
``kernels/cost.py`` ``adam_cost`` for either. The SH field's update runs in
the train step's stage ``adam_sh`` (``obs/steptrace.py``), nested in
``adam``: the colour coefficients are most of a Gaussian's floats at higher
SH degrees.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch.kernels import cost as _cost
from repro_torch.kernels.adam import ops as adam_ops
from repro_torch.kernels.adam.ref import adam_ref
from repro_torch.obs import steptrace

_NO_STAGE = contextlib.nullcontext()


class AdamState(NamedTuple):
    m: object             # NamedTuple of tensors like params
    v: object             # NamedTuple of tensors like params
    count: torch.Tensor   # () int32


def adam_init(params) -> AdamState:
    zeros = type(params)(*[torch.zeros_like(x) for x in params])
    return AdamState(
        zeros,
        type(params)(*[torch.zeros_like(x) for x in params]),
        torch.zeros((), dtype=torch.int32, device=params[0].device),
    )


def adam_update(
    grads,
    state: AdamState,
    params,
    lr_tree,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
):
    """One Adam step. ``lr_tree`` is a NamedTuple of scalars (floats or 0-d
    float32 tensors) matching params, or a single scalar for every field."""
    count = state.count + 1
    c = count.to(torch.float32)
    # torch.full fills on the device; torch.tensor(x, device=...) would copy
    # from the host and synchronize the stream
    bc1 = 1.0 - torch.pow(torch.full((), b1, dtype=torch.float32, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.full((), b2, dtype=torch.float32, device=c.device), c)
    if not hasattr(lr_tree, "_fields"):
        lr_tree = type(params)(*[lr_tree] * len(params))

    new_m, new_v, new_p = [], [], []
    tc = steptrace.current()
    for f, g, m, v, p, lr in zip(params._fields, grads, state.m, state.v, params, lr_tree):
        with steptrace.record(tc, "adam_sh") if f == "sh" else _NO_STAGE, _cost.region("adam") as r:
            update = adam_ops.launch if p.device.type == "cuda" else adam_ref
            p, m, v = update(p, g, m, v, bc1, bc2, lr, b1=b1, b2=b2, eps=eps)
            if r:
                r.report(*_cost.adam_cost(p.numel()), p, m, v)
        new_p.append(p)
        new_m.append(m)
        new_v.append(v)
    kind = type(params)
    return kind(*new_p), AdamState(kind(*new_m), kind(*new_v), count)
