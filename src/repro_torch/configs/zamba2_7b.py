"""zamba2-7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

Spec: 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64.
Two shared attention blocks alternate every 6 mamba layers (Zamba2's
shared-weight design; we omit the per-invocation LoRA deltas — noted
deviation). ssm: expand 2 -> d_inner 7168, headdim 64 -> 112 ssm heads.

long_500k: RUN — SSM state is O(1); the shared attention blocks carry the
long cache.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

SKIP_SHAPES = {}


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", arch_type="zamba",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab=32000, head_dim=112,
        ssm_state=64, ssm_heads=112, ssm_expand=2, attn_every=6,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab=512, head_dim=64,
        ssm_state=16, ssm_heads=8, attn_every=1, dtype="float32",
    )
