"""Parameter trees: from the JAX pytree (as numpy) to the port, and between
devices.

``params_from_jax(tree, device)`` takes the JAX package's ``lm.init_params``
tree with its leaves converted to numpy arrays and returns the port's
parameters: the same nested dictionaries and lists, key for key, with each
leaf a tensor of the same shape and dtype on ``device``. bfloat16 leaves
(numpy's ``ml_dtypes`` bfloat16, which torch cannot read directly) cross
bit for bit through their 16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(x, device) -> torch.Tensor:
    a = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of dictionaries and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def params_from_jax(tree, device="cuda"):
    """The port's parameter tree for a JAX parameter tree of numpy leaves."""
    return tree_map(lambda x: _leaf(x, device), tree)


def tree_to(tree, device):
    """A copy of a parameter (or cache) tree on ``device`` (a copy also when
    the tree is there already: the train step updates its tree in place)."""
    return tree_map(lambda x: x.to(device, copy=True), tree)
