"""Configurations of the port: datasets and renders (``gs_datasets``),
input shapes (``common``), and the ten LM architectures of the JAX
package's registry, resolved by ``--arch <id>`` here.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "granite_3_8b",
    "gemma3_27b",
    "granite_moe_3b_a800m",
    "xlstm_350m",
    "zamba2_7b",
    "kimi_k2_1t_a32b",
    "qwen3_0_6b",
    "whisper_tiny",
    "qwen2_vl_72b",
    "moonshot_v1_16b_a3b",
]

ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
ALIASES["qwen3-0.6b"] = "qwen3_0_6b"
ALIASES["qwen3_0.6b"] = "qwen3_0_6b"


def get_arch(name: str):
    """Resolve an architecture id (dash or underscore form) to its module."""
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")
