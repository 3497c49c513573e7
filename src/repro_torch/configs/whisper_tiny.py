"""whisper-tiny — encoder-decoder audio transformer [arXiv:2212.04356].

Spec: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865, enc-dec,
conv frontend STUB: input_specs supplies (B, 1500, 384) post-conv frame
embeddings (the allowed modality carve-out); the transformer backbone is
fully implemented.

Deviations (documented): RoPE decoder positions instead of learned
embeddings; SwiGLU MLP instead of GELU. decode_32k runs structurally
(RoPE extends past the 448-token learned context of the original).
long_500k: SKIPPED — enc-dec audio model, no sub-quadratic decoder.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

SKIP_SHAPES = {"long_500k": "enc-dec audio decoder; full attention, no sub-quadratic variant"}


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", arch_type="whisper",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab=51865, head_dim=64,
        n_enc_layers=4, n_audio_ctx=1500, scan_layers=False, pure_dp=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, n_enc_layers=2, d_model=128, n_heads=2,
        n_kv_heads=2, d_ff=256, vocab=512, n_audio_ctx=64, dtype="float32",
    )
