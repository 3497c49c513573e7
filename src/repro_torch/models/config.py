"""Architecture configuration for the assigned model pool."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str               # dense | moe | xlstm | zamba | whisper | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None         # default d_model // n_heads
    qk_norm: bool = False                  # qwen3-style per-head q/k RMSNorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    # sliding-window / local:global pattern (gemma3): e.g. "LLLLLG" repeats
    sliding_window: Optional[int] = None
    layer_pattern: Optional[str] = None

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0              # dense experts always on (kimi/moonshot style)

    # SSM (mamba2 / zamba hybrid)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    attn_every: int = 0                    # zamba: shared attn block period

    # xLSTM: pattern of m/s blocks, e.g. "MMMMMMMS" repeats
    xlstm_pattern: str = "M"

    # whisper (enc-dec)
    n_enc_layers: int = 0
    n_audio_ctx: int = 0                   # encoder frames (post-conv)

    # vlm
    mrope_sections: tuple[int, int, int] = (0, 0, 0)
    n_patches: int = 0                     # image patch embeddings per sample (stub frontend)

    # numerics / compile strategy
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    # distribution strategy: small models waste the "model" axis on 64-wide
    # tensor shards whose TP psums dwarf their compute — run them pure-DP
    # with the batch sharded over EVERY mesh axis instead (§Perf xlstm iter 4)
    pure_dp: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Analytic total parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.arch_type in ("dense", "vlm", "moe"):
            if self.is_moe:
                ff = 3 * d * self.moe_d_ff * self.n_experts + d * self.n_experts  # router
                ff += 3 * d * self.moe_d_ff * self.n_shared_experts
            else:
                ff = 3 * d * self.d_ff
            per_layer = att + ff + 2 * d
            return emb + self.n_layers * per_layer
        if self.arch_type == "xlstm":
            di = self.ssm_expand * d
            per_layer = 4 * d * di + 2 * d  # qkv/gates + out proj (approx)
            return emb + self.n_layers * per_layer
        if self.arch_type == "zamba":
            di = self.ssm_expand * d
            mamba = 2 * d * di + di * d + di * (2 * self.ssm_state) + 2 * d
            n_attn = self.n_layers // max(self.attn_every, 1)
            return emb + self.n_layers * mamba + 2 * (att + 3 * d * self.d_ff) + n_attn * 0
        if self.arch_type == "whisper":
            enc = self.n_enc_layers * (att + 3 * d * self.d_ff + 2 * d)
            dec = self.n_layers * (2 * att + 3 * d * self.d_ff + 3 * d)
            return emb + enc + dec
        return emb + self.n_layers * (att + 3 * d * self.d_ff + 2 * d)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_experts = 3 * d * self.moe_d_ff * self.n_experts * self.n_layers
        active = 3 * d * self.moe_d_ff * (self.top_k + self.n_shared_experts) * self.n_layers
        return full - all_experts + active
