"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517].

Spec: 24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.
Block ratio 7:1 mLSTM:sLSTM (the paper's main xLSTM[7:1] configuration).
d_ff=0: xLSTM blocks carry their own projections; no separate FFN.

long_500k: RUN — recurrent state, O(1) memory per token (this family is
exactly why the shape exists).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

SKIP_SHAPES = {}


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", arch_type="xlstm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, xlstm_pattern="MMMMMMMS", pure_dp=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        vocab=512, xlstm_pattern="MS", dtype="float32",
    )
