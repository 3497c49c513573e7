"""qwen2-vl-72b — VLM decoder with M-RoPE [arXiv:2409.12191].

Spec: 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
M-RoPE sections (16,24,24) over head_dim 128; dynamic-resolution ViT
frontend is a STUB: input_specs supplies merged (B,S,8192) embeddings and
(B,S,3) [t,h,w] position triples (the allowed modality carve-out).
long_500k: SKIPPED — full attention.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

SKIP_SHAPES = {"long_500k": "full global attention VLM; no sub-quadratic variant"}


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", arch_type="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, head_dim=128,
        mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, head_dim=64, mrope_sections=(8, 12, 12),
        dtype="float32",
    )
