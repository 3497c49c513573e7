"""Batched LM serving CLI (PyTorch port): prefill by decode steps, then
cached greedy decode.

The JAX package's ``launch/serve.py`` for every architecture of the
registry: dense (``--arch qwen3-0.6b``, ``gemma3-27b``, ``granite-3-8b``),
MoE (``granite-moe-3b-a800m``, ``moonshot-v1-16b-a3b``, ``kimi-k2-1t-a32b``),
the SSM hybrid ``zamba2-7b``, ``xlstm-350m``, ``whisper-tiny`` and
``qwen2-vl-72b``. Token prompts are stepped through the serve step for
every family, as the JAX CLI does: whisper decodes against its
cross-attention cache as ``init_cache`` leaves it (zeros; nothing fills it
from the encoder), and the VLM embeds tokens and gives M-RoPE the token's
position in all three streams. kimi-k2 (1T parameters) and qwen2-vl-72b
(146 GB of bf16 weights at 80 layers) fit no single card at full depth:
serve them ``--smoke``. Weights are random from ``--seed``, drawn on the
device, and the prompt is random from an explicit ``torch.Generator``
seeded with it. Runs on the card by default and refuses when there is none;
``--device cpu`` runs the plain PyTorch versions.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --device cpu \\
      --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import api, lm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_loop(cfg, params, *, batch: int, prompt_len: int, gen: int, cache_len: int, device,
               generator: torch.Generator) -> dict:
    """Step the decode cache through a random prompt, then decode ``gen``
    tokens greedily. Returns the generated ids (batch, gen) and the wall
    seconds of the prefill steps and of the decode steps."""
    device = torch.device(device)
    serve = api.make_serve_step(cfg)
    cache = api.init_cache(cfg, batch, cache_len, device=device)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=generator).to(device)

    # prefill by stepping the decode cache through the prompt (token-by-token
    # cache population, as the JAX CLI does; a fused prefill that
    # bulk-writes the cache is its enumerated follow-up)
    _sync(device)
    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):
        logits, cache = serve(params, cache, prompt[:, t:t + 1], t)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    toks = torch.argmax(logits[:, -1:], dim=-1)
    out = [toks[:, 0].cpu().numpy()]
    t0 = time.perf_counter()
    for t in range(prompt_len, prompt_len + gen - 1):
        logits, cache = serve(params, cache, toks, t)
        toks = torch.argmax(logits[:, -1:], dim=-1)
        out.append(toks[:, 0].cpu().numpy())
    _sync(device)
    t_decode = time.perf_counter() - t0
    return {"ids": np.stack(out, axis=1), "prefill_s": t_prefill, "decode_s": t_decode,
            "prompt": prompt.cpu().numpy()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=0, help="default prompt+gen")
    ap.add_argument("--device", default="cuda", help="torch device to serve on (default: the card)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights and prompt")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device; pass --device cpu to serve on the CPU")
    mod = get_arch(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.config()
    cache_len = args.cache_len or (args.prompt_len + args.gen)
    print(f"{cfg.name}: {cfg.n_layers}L d={cfg.d_model} ({cfg.arch_type}); "
          f"batch={args.batch} cache={cache_len}")

    params = lm.init_params(cfg, seed=args.seed, device=device)
    res = serve_loop(cfg, params, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                     cache_len=cache_len, device=device, generator=torch.Generator().manual_seed(args.seed))
    print("generated ids:\n", res["ids"])
    print(f"prefill {res['prefill_s']*1e3:.0f} ms ({args.prompt_len} steps), "
          f"decode {res['decode_s']/max(args.gen-1,1)*1e3:.1f} ms/token")
    return res


if __name__ == "__main__":
    main()
