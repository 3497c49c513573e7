"""Logical-axis sharding rules (MaxText-style) of the LM substrate: the
port's copy of the JAX package's rules table and its resolution to mesh
axes.

Model code names each dim by a logical axis; the rules map logical axes to
mesh axes, and axes the mesh lacks are dropped. The partitioning rules
(``models/partitioning.py``) and the dry run (``launch/dryrun.py``) read
the table. The JAX package's ``lshard`` (a sharding constraint on an
activation inside a compiled step) is not ported: an eager tensor has no
layout to constrain, and the port runs each rank's shard as its own
program.
"""
from __future__ import annotations

DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),     # missing mesh axes are dropped automatically
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "kv_seq": None,
    "ff": "model",
    "experts": "model",
    "vocab": "model",
    "moe_d": "model",             # token-side d-shard inside the MoE block
    "fsdp": "data",               # weight sharding axis for large models
    "cache_seq": None,
    "state": None,
}

# the pure data-parallel configs' overrides (the JAX dry run's ``rules``)
PURE_DP_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data", "model"), "heads": None, "kv_heads": None,
    "ff": None, "experts": None, "vocab": None, "moe_d": None,
}


def mesh_rules(rules: dict | None = None) -> dict:
    """The default table with ``rules`` laid over it."""
    return dict(DEFAULT_RULES, **(rules or {}))


def spec_for(mesh_shape: dict, *names: str | None, rules: dict | None = None) -> tuple:
    """One mesh axis (a name, a tuple of names, or None) per logical name,
    under ``rules`` on a mesh of ``mesh_shape`` (name -> size): the JAX
    ``spec_for`` under ``use_mesh_rules``."""
    table = mesh_rules(rules)
    axes = []
    for nm in names:
        ax = table.get(nm) if nm is not None else None
        if ax is None:
            axes.append(None)
        elif isinstance(ax, str):
            axes.append(ax if ax in mesh_shape else None)
        else:
            present = tuple(a for a in ax if a in mesh_shape)
            # a one-axis tuple is that axis, as PartitionSpec normalizes it
            axes.append(present[0] if len(present) == 1 else present or None)
    return tuple(axes)
