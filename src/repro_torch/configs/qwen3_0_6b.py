"""qwen3-0.6b — dense GQA with per-head q/k RMSNorm [hf:Qwen/Qwen3-8B family].

Spec: 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, qk_norm.
long_500k: SKIPPED — full attention.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

SKIP_SHAPES = {"long_500k": "full global attention; no sub-quadratic variant"}


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", arch_type="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=3072, vocab=151936, head_dim=128, qk_norm=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, head_dim=64, dtype="float32",
    )
