"""granite-3-8b — dense GQA decoder.

Spec: 40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base family, 8B variant dims]

Paper-technique note: the GS distribution scheme (gaussian-shard +
pixel-shard) is point-primitive-specific; this arch gets the generic
DPxTP substrate (fused-allreduce data parallel + tensor parallel).
long_500k: SKIPPED — full attention, no sub-quadratic variant.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

SKIP_SHAPES = {"long_500k": "full global attention; no sliding-window/block-sparse variant"}


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b", arch_type="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12800, vocab=49155, head_dim=128, rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, head_dim=64, dtype="float32",
    )
