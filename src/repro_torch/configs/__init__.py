"""Configurations of the port: datasets and renders (``gs_datasets``), and
the LM architectures ported so far, resolved by ``--arch <id>`` here.

The JAX package's registry lists ten architectures; the port lists those
whose layers it runs (dense decoders). Any other id raises ``KeyError``.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "gemma3_27b",
    "qwen3_0_6b",
]

ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
ALIASES["qwen3-0.6b"] = "qwen3_0_6b"
ALIASES["qwen3_0.6b"] = "qwen3_0_6b"


def get_arch(name: str):
    """Resolve an architecture id (dash or underscore form) to its module."""
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"arch {name!r} is not ported to repro_torch (ROADMAP.md, queue A10 lists what is left); "
                       f"ported: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")
