"""Shared pieces of the PyTorch-port parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed (``conftest.make_scene`` /
``make_cam``), go through the JAX package as JAX arrays and through the port
as numpy -> torch, and the outputs come back as numpy. The tests that need
the card live in ``tests/test_torch_gpu.py``, which imports no JAX (the
machine with the card has none).
"""
import functools

import jax
import numpy as np
import torch

from repro.core import render as JR
from repro_torch.core import gaussians as TG
from repro_torch.core import projection as TP

# six xdist workers share the host: keep each worker's torch pool small
torch.set_num_threads(2)


def to_port(g, cam=None, device="cpu"):
    """JAX model (and camera) -> the port's, via numpy."""
    gp = TG.from_numpy(jax.tree_util.tree_map(np.asarray, g), device)
    if cam is None:
        return gp
    return gp, TP.camera_from_numpy(cam)


@functools.lru_cache(maxsize=None)
def _jitted_render(static: tuple):
    return jax.jit(functools.partial(JR.render, **dict(static)))


def jax_render(g, cam, **static):
    """The JAX package's ``render``, jitted once per static configuration
    (its eager form dispatches op by op, several times slower on the CPU)."""
    return _jitted_render(tuple(sorted(static.items())))(g, cam)


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
