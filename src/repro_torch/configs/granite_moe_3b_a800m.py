"""granite-moe-3b-a800m — MoE decoder, 40 experts top-8.

Spec: 32L d_model=1536 24H (GQA kv=8) expert d_ff=512 vocab=49155, 40e top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family, 3b-a800m dims]

Expert dim shards over "model" (expert parallelism); dispatch is the
sort-based capacity scheme in models/moe.py.
long_500k: SKIPPED — full attention.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

SKIP_SHAPES = {"long_500k": "full global attention MoE; no sub-quadratic variant"}


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", arch_type="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=0, vocab=49155, head_dim=64,
        n_experts=40, top_k=8, moe_d_ff=512,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        vocab=512, head_dim=64, n_experts=4, top_k=2, moe_d_ff=128, dtype="float32",
    )
