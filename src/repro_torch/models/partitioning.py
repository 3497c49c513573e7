"""Parameter, batch and cache partition specs (rule-based, shape-aware): the
port's copy of the JAX package's ``models/partitioning.py``.

Specs come from leaf names with divisibility checks against the mesh, so
the same rules serve every architecture and mesh. Stacked leading layer
dims are padded with None (rules describe trailing dims). The trees are the
port's (nested dicts and lists of tensors, on ``meta`` or any device); the
mesh is anything with a ``.shape`` dict of axis sizes
(``launch/mesh.py`` ``make_production_mesh``) or such a dict itself.

Each leaf's spec is a tuple with one entry per tensor dim: a mesh axis
name, a tuple of names, or None. That tuple is the neutral form of a JAX
``PartitionSpec`` (and the placements of a ``DTensor`` can be built from
it); ``per_device_bytes`` gives the bytes of one device's shard.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves


def _shape(mesh) -> dict:
    return mesh.shape if hasattr(mesh, "shape") else dict(mesh)


def _axis_size(mesh_shape: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh_shape[a] for a in axis)
    return mesh_shape[axis]


def _div(n: int, mesh_shape: dict, axis) -> bool:
    if axis is None:
        return True
    if isinstance(axis, tuple):
        return n % math.prod(mesh_shape[a] for a in axis) == 0
    if axis not in mesh_shape:
        return False
    return n % mesh_shape[axis] == 0


def _checked(spec_tail: tuple, shape: tuple, mesh_shape: dict) -> tuple:
    """Pad leading Nones to rank; drop axes that don't divide; a one-axis
    tuple is that axis (as ``PartitionSpec`` normalizes it)."""
    rank = len(shape)
    tail = list(spec_tail[-rank:]) if len(spec_tail) > rank else list(spec_tail)
    full = [None] * (rank - len(tail)) + tail
    out = (ax if (ax is not None and _div(dim, mesh_shape, ax)) else None for dim, ax in zip(shape, full))
    return tuple(ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax for ax in out)


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(names, leaf)`` over a tree of dicts and lists; ``names`` are the
    dict keys on the way to the leaf (list positions carry no name, as JAX's
    ``SequenceKey`` has no ``key``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path) for v in tree]
    return fn(path, tree)


_IN_OUT = {"wq", "wk", "wv", "wi", "wg", "wo_gate", "in_proj", "wx"}
_OUT_IN = {"wo", "out_proj"}


def param_pspecs(cfg: ModelConfig, params: Any, mesh, *, fsdp: bool = True) -> Any:
    """Tree of specs matching ``params``."""
    ms = _shape(mesh)
    fs = "data" if fsdp else None

    def rule(names, leaf):
        name = names[-1] if names else ""
        in_moe = "moe" in names or "shared" in names
        shape = tuple(leaf.shape)
        if name == "embedding":
            return _checked(("model", fs), shape, ms)
        if in_moe and name in ("wi", "wg", "wo") and len(shape) >= 3:
            # (E, d, ff) / (E, ff, d): expert-parallel only; expert weights
            # are replicated across "data"
            return _checked(("model", None, None), shape, ms)
        if name == "router":
            return _checked((fs, None), shape, ms)
        if name in _IN_OUT:
            return _checked((fs, "model"), shape, ms)
        if name in _OUT_IN:
            return _checked(("model", fs), shape, ms)
        if name == "conv_w":
            return _checked((None, "model"), shape, ms)
        if name in ("a_log", "d_skip", "dt_bias", "fbias"):
            return _checked(("model",), shape, ms)
        if name == "r":  # sLSTM recurrent (H, hd, 4hd)
            return _checked(("model", None, None), shape, ms)
        return (None,) * len(shape)  # norms, scalars: replicated

    if getattr(cfg, "pure_dp", False):
        # no tensor parallelism: weights replicated over "model", fsdp over data
        return _map_with_path(lambda n, x: tuple(None if a == "model" else a for a in rule(n, x)), params)
    return _map_with_path(rule, params)


def batch_pspecs(cfg: ModelConfig, batch: Any, mesh) -> Any:
    ms = _shape(mesh)
    axes = ("pod", "data", "model") if getattr(cfg, "pure_dp", False) else ("pod", "data")
    baxes = tuple(a for a in axes if a in ms)
    return _map_with_path(lambda n, x: _checked((baxes,) + (None,) * (x.dim() - 1), tuple(x.shape), ms), batch)


def cache_pspecs(cfg: ModelConfig, cache: Any, mesh) -> Any:
    """Decode-cache specs: batch->data when divisible, else seq->data (long
    context, batch 1); heads->model when divisible, else seq->model."""
    ms = _shape(mesh)

    def rule(names, leaf):
        name = names[-1] if names else ""
        shape = tuple(leaf.shape)
        if name in ("k", "v", "cross_k", "cross_v"):
            # (..., B, S, Hkv, hd)
            b, s, hkv = shape[-4], shape[-3], shape[-2]
            baxis = "data" if _div(b, ms, "data") else None
            haxis = "model" if _div(hkv, ms, "model") else None
            saxis = None
            if haxis is None and _div(s, ms, "model"):
                saxis = "model"
            if baxis is None and saxis is None and _div(s, ms, "data"):
                saxis = "data"
            return _checked((baxis, saxis, haxis, None), shape, ms)
        if name == "state":      # mamba (B,H,N,P)
            return _checked(("data", "model", None, None), shape, ms)
        if name == "conv":       # (B, W-1, C)
            return _checked(("data", None, "model"), shape, ms)
        if name == "c" and len(shape) == 4:   # mlstm (B,H,hd,hd)
            return _checked(("data", "model", None, None), shape, ms)
        if name in ("c", "n", "m", "y"):
            return _checked(("data", "model", None), shape, ms)
        return _checked(("data",) + (None,) * (len(shape) - 1), shape, ms)

    return _map_with_path(rule, cache)


def spec_leaves(specs: Any) -> list:
    """The leaf specs of a spec tree, in the tree's own order (each leaf is
    a tuple of per-dim entries)."""
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in spec_leaves(v)]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def per_device_bytes(tree: Any, specs: Any, mesh) -> int:
    """The exact bytes of one device's shard of ``tree`` under ``specs``,
    leaf by leaf (every sharded dim divides its axes, by construction)."""
    ms = _shape(mesh)
    return sum(t.numel() * t.element_size() // math.prod(_axis_size(ms, ax) for ax in s)
               for t, s in zip(tree_leaves(tree), spec_leaves(specs), strict=True))
