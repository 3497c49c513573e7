"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table scale) [arXiv:2501.kimi2].

Spec: 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 experts top-8 (+1 shared expert, K2's DeepSeek-style design).

Scale note: about 1.0e12 parameters, 2 TB of bfloat16 weights alone, which
no single card holds; the port runs its smoke config (tests) and no
full-width card run. It is the "exceeds single-unit memory" case, the
transformer analogue of Miranda-on-one-A100.
long_500k: SKIPPED — full attention.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

SKIP_SHAPES = {"long_500k": "full global attention MoE; no sub-quadratic variant"}


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", arch_type="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=0, vocab=163840, head_dim=112,
        n_experts=384, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        vocab=512, head_dim=64, n_experts=4, top_k=2, moe_d_ff=128,
        n_shared_experts=1, dtype="float32",
    )
