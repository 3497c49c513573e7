"""Plain PyTorch version of the Adam kernel: one parameter field's update.

The JAX package's update (``optim/adam.py``), one PyTorch op per operation
of ``adam.cu``, in the kernel's order. Functional: it returns new tensors
and leaves its inputs alone. The CPU runs it; on the card it is what the
kernel is held to, bitwise.
"""
from __future__ import annotations

import torch


def adam_ref(p, g, m, v, bc1, bc2, lr, *, b1: float, b2: float, eps: float):
    """(p', m', v') of one field: ``bc1``, ``bc2`` are the bias corrections
    (0-d float32), ``lr`` a float or a 0-d float32 tensor."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mhat = m / bc1
    vhat = v / bc2
    return p - lr * mhat / (torch.sqrt(vhat) + eps), m, v
