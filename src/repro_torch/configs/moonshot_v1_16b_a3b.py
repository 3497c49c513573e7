"""moonshot-v1-16b-a3b — Moonlight-style MoE [hf:moonshotai/Moonlight-16B-A3B].

Spec: 48L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=163840,
MoE 64 experts top-6. (Pool labels it [dense] but the spec line carries the
MoE fields and the name says a3b-active -> built as MoE, noted here.)
long_500k: SKIPPED — full attention.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

SKIP_SHAPES = {"long_500k": "full global attention MoE; no sub-quadratic variant"}


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", arch_type="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=0, vocab=163840, head_dim=128,
        n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        vocab=512, head_dim=64, n_experts=4, top_k=2, moe_d_ff=128,
        n_shared_experts=1, dtype="float32",
    )
