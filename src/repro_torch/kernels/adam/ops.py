"""Wrapper of the Adam kernel: input checks, allocation, one launch.

``launch(p, g, m, v, bc1, bc2, lr, b1=, b2=, eps=)`` runs ``adam.cu`` on one
parameter field of CUDA tensors and returns fresh (p', m', v'), as
``ref.adam_ref`` does on any device: the inputs are never written. ``lr``
is a float or a 0-d float32 tensor on the field's device (the position
schedule's), which the kernel reads by pointer, as it reads the bias
corrections ``bc1`` and ``bc2``. The hyperparameters are rounded to float32
as PyTorch rounds a Python scalar, ``1 - b1`` and ``1 - b2`` formed in
double first. ``optim/adam.py`` ``adam_update`` chooses between the two
versions a field, and reports the kernel's work to the operation counter.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

launch_count = _lib.launches("adam_update")


def launch(p, g, m, v, bc1, bc2, lr, *, b1: float, b2: float, eps: float):
    """One field's Adam step on the card: (p', m', v'), new tensors."""
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"adam kernel needs CUDA tensors, got {dev}")
    shape = tuple(p.shape)
    g = g.contiguous()
    for name, x in (("p", p), ("g", g), ("m", m), ("v", v)):
        _lib.check_tensor(name, x, shape, dev)
    for name, x in (("bc1", bc1), ("bc2", bc2)):
        _lib.check_tensor(name, x, (), dev)
    if isinstance(lr, torch.Tensor):
        _lib.check_tensor("lr", lr, (), dev)
        lr_ptr, lr = lr.data_ptr(), 0.0
    else:
        lr_ptr, lr = None, float(lr)
    outs = tuple(torch.empty_like(p) for _ in range(3))
    if p.numel():
        _lib.call("adam_update", dev, p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                  *(x.data_ptr() for x in outs), p.numel(), bc1.data_ptr(), bc2.data_ptr(), lr_ptr, lr,
                  b1, 1 - b1, b2, 1 - b2, eps)
    return outs
