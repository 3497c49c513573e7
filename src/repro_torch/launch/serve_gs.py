"""Gaussian render-serving driver (PyTorch port): model -> multi-client service.

Loads a trained model from a checkpoint (``--ckpt``, written by either
package's training CLI) or initializes a fresh one from a synthetic
isosurface, builds the LOD pyramid, and drives the batched render server
with a synthetic client fleet, printing a JSON report. Runs on the card by
default and raises when there is none; ``--device cpu`` serves through the
plain PyTorch versions instead.

  PYTHONPATH=src python -m repro_torch.launch.serve_gs --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_gs --ckpt experiments/ckpts/run0 --res 64
  PYTHONPATH=src python -m repro_torch.launch.serve_gs --res 512 --clients 4 --requests 4

``--trace-out PATH.jsonl`` records the requests' span trees and writes them
as JSONL (the JAX package's schema) with a Perfetto-viewable
``.chrome.json`` beside it.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs.gs_datasets import DATASETS
from repro_torch.core import gaussians as G
from repro_torch.core.config import GSConfig
from repro_torch.obs import Obs, export_trace
from repro_torch.serve_gs import RenderServer, make_clients, run_load
from repro_torch.volume import datasets as VD
from repro_torch.volume.isosurface import extract_isosurface_points


def load_params_from_ckpt(ckpt_dir: str) -> G.GaussianModel:
    """Host (CPU) model of the newest checkpoint under ``ckpt_dir``."""
    step = latest_step(ckpt_dir)
    if step is None:
        raise SystemExit(f"no checkpoint under {ckpt_dir}")
    like = {"params": G.GaussianModel(*[None] * len(G.GaussianModel._fields))}
    return restore_checkpoint(ckpt_dir, step, like, device="cpu")["params"]


def init_params_from_volume(dataset: str, *, volume_res: int, max_points: int) -> G.GaussianModel:
    """Host (CPU) model seeded from the dataset's synthetic isosurface."""
    ds = DATASETS[dataset]
    vol = getattr(VD, ds.volume)(res=volume_res)
    pts, _, cols = extract_isosurface_points(vol, max_points=max_points)
    return G.init_from_points(pts, cols, init_scale=0.05, device="cpu")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="reduced config (32px, 32 requests)")
    ap.add_argument("--device", default="cuda", help="torch device to serve on (default: the card)")
    ap.add_argument("--ckpt", default=None, help="checkpoint dir written by either package's training CLI")
    ap.add_argument("--dataset", choices=list(DATASETS), default="kingsnake")
    ap.add_argument("--volume-res", type=int, default=48)
    ap.add_argument("--max-points", type=int, default=4000)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--keep-ratio", type=float, default=0.5)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8, help="requests per client")
    ap.add_argument("--orbit-views", type=int, default=12)
    ap.add_argument("--radius-spread", type=float, default=1.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="in-flight micro-batches kept on-device (1 = synchronous dispatch)",
    )
    ap.add_argument("--cache", type=int, default=512,
                    help="cache capacity in frame-equivalents (byte budget = "
                    "N x frame bytes; 0 disables)")
    ap.add_argument("--cache-bytes", type=int, default=None,
                    help="cache byte budget directly (overrides --cache)")
    ap.add_argument("--frame-cache", action="store_true",
                    help="whole-frame cache baseline (disables the "
                    "tile-granular cache + partial strip renders)")
    ap.add_argument("--rate", type=float, default=0.0, help="request rounds per second (0 = flat out)")
    ap.add_argument("--report", default=None, help="write the JSON report here too")
    ap.add_argument("--trace-out", default=None, metavar="PATH.jsonl",
                    help="record request span traces; on exit write JSONL "
                         "here plus a Perfetto-viewable .chrome.json next to it")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="span ring size (oldest spans drop beyond this)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve_gs: no CUDA device; pass --device cpu to serve on the CPU")
    if args.smoke:
        args.res = min(args.res, 32)
        args.volume_res = min(args.volume_res, 32)
        args.max_points = min(args.max_points, 800)

    if args.ckpt:
        params = load_params_from_ckpt(args.ckpt)
    else:
        params = init_params_from_volume(
            args.dataset, volume_res=args.volume_res, max_points=args.max_points
        )
    cfg = GSConfig(img_h=args.res, img_w=args.res, k_per_tile=128 if args.smoke else 256)

    obs = Obs(trace=args.trace_out is not None, trace_capacity=args.trace_capacity)
    with RenderServer(
        params,
        cfg,
        device=device,
        obs=obs,
        n_levels=args.levels,
        keep_ratio=args.keep_ratio,
        max_batch=args.max_batch,
        cache_capacity=args.cache,
        cache_bytes=args.cache_bytes,
        tile_cache=not args.frame_cache,
        store_frames=False,
        pipeline_depth=args.pipeline_depth,
    ) as server:
        print(
            f"serve_gs: {args.dataset} n={params.n} levels={server.pyramid.live_counts} "
            f"res={args.res} clients={args.clients}x{args.requests} device={device}"
        )
        clients = make_clients(
            args.clients,
            n_views=args.orbit_views,
            img_h=args.res,
            img_w=args.res,
            radius_spread=args.radius_spread,
        )
        report = run_load(server, clients, requests_per_client=args.requests, rate_hz=args.rate)
    report["config"] = {
        "res": args.res,
        "clients": args.clients,
        "requests_per_client": args.requests,
        "levels": args.levels,
        "keep_ratio": args.keep_ratio,
        "max_batch": args.max_batch,
        "pipeline_depth": args.pipeline_depth,
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    out = json.dumps(report, indent=1)
    print(out)
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            f.write(out)
    if args.trace_out:
        export_trace(obs.trace, args.trace_out,
                     {"max_batch": args.max_batch, "pipeline_depth": args.pipeline_depth})
    if report["completed"] != args.clients * args.requests:
        raise SystemExit(
            f"pipelined path dropped requests: completed {report['completed']} of "
            f"{args.clients * args.requests}"
        )
    print(f"served {report['completed']} requests "
          f"({report['frames_per_s']} frames/s on {report['config']['device_name']}, "
          f"cache hit rate {report['cache']['hit_rate']}, "
          f"depth {report['pipeline']['depth']}, deduped {report['pipeline']['deduped']})")


if __name__ == "__main__":
    main()
