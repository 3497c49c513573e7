"""Tree utilities shared across the port (PyTorch copy of the JAX package's
``utils/tree.py``).

A tree is a nest of tuples (NamedTuples included), lists and dicts whose
leaves are tensors. Leaves come in the order ``jax.tree_util`` flattens the
same structure: tuple and list items in order, dict entries by sorted key,
so a packed vector equals the JAX package's for the same values.
"""
from __future__ import annotations

import torch


def tree_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def _rebuild(like, leaves):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if hasattr(like, "_fields"):
        return type(like)(*[_rebuild(x, leaves) for x in like])
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(x, leaves) for x in like)
    return next(leaves)


def tree_count(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes across all leaves (uses each leaf's dtype)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def pack_pytree(tree):
    """Flatten a tree of tensors into one contiguous float32 vector.

    Used for the fused all-reduce: one collective over the packed gradient
    vector instead of one per tensor (the paper's "fused all-reduce scheme").
    Returns (vector, unpack_fn)."""
    leaves = tree_leaves(tree)
    shapes = [x.shape for x in leaves]
    dtypes = [x.dtype for x in leaves]
    sizes = [x.numel() for x in leaves]
    if leaves:
        vec = torch.cat([x.detach().to(torch.float32).reshape(-1) for x in leaves])
    else:
        vec = torch.zeros((0,), dtype=torch.float32)

    def unpack(v: torch.Tensor):
        parts = torch.split(v, sizes)
        out = [p.reshape(s).to(dt) for p, s, dt in zip(parts, shapes, dtypes)]
        return _rebuild(tree, iter(out))

    return vec, unpack


def unpack_pytree(vec: torch.Tensor, like):
    """Unpack a packed float32 vector into the structure, shapes and dtypes
    of ``like``."""
    _, unpack = pack_pytree(like)
    return unpack(vec)
