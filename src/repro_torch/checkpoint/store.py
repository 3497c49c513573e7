"""Checkpointing: per-leaf .npy files + a JSON manifest.

The on-disk layout of the JAX package's ``checkpoint/store.py``, so that a
checkpoint written by one package restores in the other:

    <dir>/step_<N>/manifest.json
    <dir>/step_<N>/<flat.key.path>.npy

Keys are the dotted paths of the leaves in a tree of NamedTuples, dicts and
lists/tuples: NamedTuple fields by name, dict entries by key, sequence items
by index (``params.means``, ``adam.m.sh``, ``adam.count``, ``step``).

A train state sharded over the model axis of a mesh is saved as full arrays:
every rank gathers it, rank 0 writes, then all ranks meet at a barrier. So
a checkpoint written across ranks serves from one device and restores in
the JAX package. Restoring onto a mesh gives each rank its own shard.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch.core.train import gather_state, shard_state


def _is_leaf(x) -> bool:
    return not (isinstance(x, (dict, list, tuple)))


def _flatten(tree, prefix: tuple = ()) -> dict:
    """{dotted key: leaf} in the tree's own order."""
    if _is_leaf(tree):
        key = ".".join(str(p) for p in prefix)
        return {re.sub(r"[^\w.\-]", "_", key) or "root": tree}
    if isinstance(tree, dict):
        items = sorted(tree.items())  # jax orders dict keys
    elif hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    else:
        items = list(enumerate(tree))
    out = {}
    for name, sub in items:
        out.update(_flatten(sub, prefix + (name,)))
    return out


def _unflatten(like, leaves):
    if _is_leaf(like):
        return next(leaves)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if hasattr(like, "_fields"):
        return type(like)(*[_unflatten(x, leaves) for x in like])
    return type(like)(_unflatten(x, leaves) for x in like)


def _leaf_to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, mesh=None) -> str:
    """Write ``tree`` as ``<ckpt_dir>/step_<step>``. With ``mesh``, ``tree``
    is a ``GSTrainState`` sharded over it and every rank of the mesh calls
    this (it gathers the shards); rank 0 writes."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    if mesh is not None:
        tree = gather_state(tree, mesh)
        if mesh.rank == 0:
            save_checkpoint(ckpt_dir, step, tree)
        mesh.barrier()
        return d
    os.makedirs(d, exist_ok=True)
    manifest = {}
    for key, leaf in _flatten(tree).items():
        arr = _leaf_to_host(leaf)
        np.save(os.path.join(d, key + ".npy"), arr)
        manifest[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f, indent=1)
    return d


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for n in os.listdir(ckpt_dir) if (m := re.match(r"step_(\d+)$", n))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like, device=None, *, mesh=None):
    """Restore into the structure of ``like``. Leaf shapes come from the
    files, so ``like`` may hold a model of another size (a checkpoint taken
    after densification). Each leaf becomes a tensor on ``device`` (default:
    the device of the matching ``like`` leaf if it is a tensor, else the CPU).
    With ``mesh``, ``like`` is a ``GSTrainState`` and each rank gets its own
    shard of the saved full state."""
    if mesh is not None:
        return shard_state(restore_checkpoint(ckpt_dir, step, like, device), mesh)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for key, ref in _flatten(like).items():
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {key}")
        dev = device if device is not None else (ref.device if isinstance(ref, torch.Tensor) else "cpu")
        leaves.append(torch.from_numpy(np.load(os.path.join(d, key + ".npy"))).to(dev))
    return _unflatten(like, iter(leaves))
