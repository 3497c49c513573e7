"""Shared input-shape definitions and their stand-in tensors (PyTorch port
of ``configs/common.py``).

The JAX package returns ``ShapeDtypeStruct``s; here every stand-in is a
tensor on the ``meta`` device: the shape and dtype of each model input,
cache and parameter, with nothing allocated. The one exception is the
serve step's position, a host value by the step's contract (it indexes the
cache): ``decode_specs`` gives it as an int32 CPU scalar, so the serve step
runs on the stand-ins (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models import api, lm
from repro_torch.models.config import ModelConfig


class ShapeCase(NamedTuple):
    seq_len: int
    global_batch: int
    kind: str   # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCase] = {
    "train_4k": ShapeCase(4_096, 256, "train"),
    "prefill_32k": ShapeCase(32_768, 32, "prefill"),
    "decode_32k": ShapeCase(32_768, 128, "decode"),
    "long_500k": ShapeCase(524_288, 1, "decode"),
}


def _meta(shape, dtype: str) -> torch.Tensor:
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def lm_batch_specs(cfg: ModelConfig, shape: ShapeCase) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.arch_type == "whisper":
        return {
            "audio_embeds": _meta((b, cfg.n_audio_ctx, cfg.d_model), cfg.dtype),
            "tokens": _meta((b, s), "int32"),
            "labels": _meta((b, s), "int32"),
        }
    if cfg.arch_type == "vlm":
        return {
            "embeds": _meta((b, s, cfg.d_model), cfg.dtype),
            "positions3": _meta((b, s, 3), "int32"),
            "labels": _meta((b, s), "int32"),
        }
    return {"tokens": _meta((b, s), "int32"), "labels": _meta((b, s), "int32")}


def decode_specs(cfg: ModelConfig, shape: ShapeCase) -> dict:
    """Stand-ins for serve_step: one new token against a seq_len-deep cache,
    written at its last position (``pos``, an int32 CPU scalar)."""
    b, s = shape.global_batch, shape.seq_len
    return {
        "cache": api.init_cache(cfg, b, s, device="meta"),
        "tokens": _meta((b, 1), "int32"),
        "pos": torch.tensor(s - 1, dtype=torch.int32),
    }


def params_specs(cfg: ModelConfig, seed: int = 0) -> dict:
    """The parameter tree on the ``meta`` device (no allocation)."""
    return lm.init_params(cfg, seed, device="meta")


def vlm_positions3(batch: int, seq: int, n_text: int, grid: tuple[int, int]) -> np.ndarray:
    """(batch, seq, 3) int32 M-RoPE positions [t, h, w] of a text run of
    ``n_text`` tokens, then one image of ``grid`` (rows, cols) patches at
    temporal index ``n_text`` (rows and columns offset by it), then text
    again from ``n_text + max(grid)``: Qwen2-VL's rule for one image. The
    stub frontend's stand-in for a real sequence's positions."""
    gh, gw = grid
    n_img = min(gh * gw, seq - n_text)
    pos = np.zeros((seq, 3), np.int32)
    pos[:n_text] = np.arange(n_text)[:, None]
    i = np.arange(n_img)
    pos[n_text:n_text + n_img] = np.stack([np.full(n_img, n_text), n_text + i // gw, n_text + i % gw], 1)
    rest = seq - n_text - n_img
    pos[n_text + n_img:] = (n_text + max(gh, gw) + np.arange(rest))[:, None]
    return np.tile(pos, (batch, 1, 1))
