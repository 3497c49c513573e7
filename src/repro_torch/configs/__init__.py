"""Configurations of the port: datasets and renders (``gs_datasets``), and
the LM architectures ported so far, resolved by ``--arch <id>`` here.

The JAX package's registry lists ten architectures; the port lists those
whose layers it runs: the dense decoders and the MoE decoders. The SSM,
xLSTM, whisper and VLM ids raise ``KeyError``.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "granite_3_8b",
    "gemma3_27b",
    "granite_moe_3b_a800m",
    "kimi_k2_1t_a32b",
    "qwen3_0_6b",
    "moonshot_v1_16b_a3b",
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
