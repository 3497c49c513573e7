"""gemma3-27b — dense GQA, 5:1 local:global sliding-window attention.

Spec: 62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
[hf:google/gemma-3-1b-pt family, 27B dims; 5:1 local:global, 128k ctx]

long_500k: RUN — local layers use a 1024-token sliding window (ring-buffer
KV cache); the 1-in-6 global layers carry the full 500k cache, sharded.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

SKIP_SHAPES = {}


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", arch_type="dense",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
        d_ff=21504, vocab=262144, head_dim=128, rope_theta=1_000_000.0,
        sliding_window=1024, layer_pattern="LLLLLG",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, head_dim=64, sliding_window=32,
        layer_pattern="LG", dtype="float32",
    )
