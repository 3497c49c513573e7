"""Serving example for the port's transformer substrate (the mirror of
``examples/serve_lm.py``): batched greedy decode with a KV cache through
the port's ``make_serve_step``, at the reduced smoke variant of any
architecture of the registry (dense, MoE, the SSM hybrid, xLSTM, whisper,
the VLM). Runs on the card by default; ``--device cpu`` runs the plain
PyTorch versions.

  PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen3-0.6b --tokens 16
  PYTHONPATH=src python examples/serve_lm_torch.py --arch granite-moe-3b-a800m --device cpu
  PYTHONPATH=src python examples/serve_lm_torch.py --arch zamba2-7b --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import api, lm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="torch device to serve on (default: the card)")
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to serve on the CPU")
    cfg = get_arch(args.arch).smoke_config()
    print(f"{cfg.name} (reduced): {cfg.n_layers}L d={cfg.d_model} arch={cfg.arch_type}")
    params = lm.init_params(cfg, seed=0, device=device)
    serve = api.make_serve_step(cfg)
    cache = api.init_cache(cfg, args.batch, args.cache_len, device=device)

    toks = torch.full((args.batch, 1), 1, dtype=torch.long, device=device)
    out = []
    for t in range(args.tokens):
        logits, cache = serve(params, cache, toks, t)
        toks = torch.argmax(logits[:, -1:], dim=-1)
        out.append(toks[:, 0].cpu().numpy())
    gen = np.stack(out, 1)
    print("greedy-decoded token ids (batch x steps):")
    print(gen)
    assert torch.isfinite(logits).all()
    print("ok: cache-backed batched decode ran", args.tokens, "steps")


if __name__ == "__main__":
    main()
