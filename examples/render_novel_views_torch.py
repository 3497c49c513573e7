"""Post-hoc visualization with the PyTorch port: restore a trained
checkpoint (written by either package's training CLI) and render a novel
orbit on the card (the mirror of ``examples/render_novel_views.py``).
Writes PPM images (no imaging deps needed); ``--device cpu`` renders
through the plain PyTorch versions.

  PYTHONPATH=src python examples/render_novel_views_torch.py --ckpt experiments/ckpts/miranda_demo_torch
"""
import argparse
import os

import torch

from repro_torch.checkpoint import latest_step
from repro_torch.core.config import GSConfig
from repro_torch.core.train import make_eval_render
from repro_torch.launch.serve_gs import load_params_from_ckpt
from repro_torch.utils.image import write_ppm
from repro_torch.volume.cameras import camera_slice, orbit_cameras


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--device", default="cuda", help="torch device to render on (default: the card)")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--out", default="experiments/renders_torch")
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to render on the CPU")
    if latest_step(args.ckpt) is None:
        raise SystemExit(f"no checkpoint under {args.ckpt} — run the training example first")
    params = load_params_from_ckpt(args.ckpt).to(device)

    cfg = GSConfig(img_h=args.res, img_w=args.res, k_per_tile=256)
    render = make_eval_render(cfg)
    cams = orbit_cameras(args.views, img_h=args.res, img_w=args.res, radius=2.5, elev_cycles=1.0)
    os.makedirs(args.out, exist_ok=True)
    with torch.no_grad():
        for i in range(args.views):
            img, _ = render(params, camera_slice(cams, i))
            path = os.path.join(args.out, f"novel_{i:03d}.ppm")
            write_ppm(path, img)
            print("wrote", path)


if __name__ == "__main__":
    main()
