"""Quickstart of the PyTorch port: turn a Gaussian model into a render
service and save frames (the mirror of ``examples/serve_gs_quickstart.py``).

Builds a tiny synthetic isosurface scene (or restores a checkpoint written
by either package's training CLI), stands up the LOD-aware batched
``RenderServer`` on the card, and serves one orbit worth of frames to PPM
files plus a serving report. ``--device cpu`` serves through the plain
PyTorch versions instead.

  PYTHONPATH=src python examples/serve_gs_quickstart_torch.py --out experiments/served_torch
  PYTHONPATH=src python examples/serve_gs_quickstart_torch.py --device cpu --ckpt experiments/ckpts/tckpt
"""
import argparse
import json
import os

import torch

from repro_torch.core.config import GSConfig
from repro_torch.launch.serve_gs import init_params_from_volume, load_params_from_ckpt
from repro_torch.serve_gs import RenderServer
from repro_torch.utils.image import write_ppm
from repro_torch.volume.cameras import camera_slice, orbit_cameras


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="torch device to serve on (default: the card)")
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--out", default="experiments/served_torch")
    args = ap.parse_args()

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to serve on the CPU")
    if args.ckpt:
        params = load_params_from_ckpt(args.ckpt)
    else:
        params = init_params_from_volume("kingsnake", volume_res=32, max_points=800)

    cfg = GSConfig(img_h=args.res, img_w=args.res, k_per_tile=128)
    # store_frames off: frames arrive through each request's FrameFuture, so
    # nothing needs to sit in the server's retirement buffer
    server = RenderServer(params, cfg, device=args.device, n_levels=2, max_batch=4, store_frames=False)

    # one orbit: near views hit LOD 0, a far ring hits the coarser level
    near = orbit_cameras(args.views, img_h=args.res, img_w=args.res, radius=3.0)
    far = orbit_cameras(args.views, img_h=args.res, img_w=args.res, radius=7.0)
    futures = []
    for cams in (near, far):
        for i in range(args.views):
            futures.append(server.submit(camera_slice(cams, i)))
    server.run()  # drains the pipelined dispatch ring; futures resolve

    os.makedirs(args.out, exist_ok=True)
    for k, fut in enumerate(futures):
        write_ppm(os.path.join(args.out, f"frame_{k:03d}.ppm"), fut.result())
    print(f"wrote {len(futures)} frames to {args.out}")
    print(json.dumps(server.report(), indent=1))


if __name__ == "__main__":
    main()
