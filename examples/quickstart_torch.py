"""Quickstart of the PyTorch port: fit 3D Gaussians to a synthetic
isosurface (the mirror of ``examples/quickstart.py``).

Extracts the isosurface, ray-marches ground-truth views, seeds Gaussians
from the point cloud, trains 60 steps with the one-device train step
(``make_train_step(cfg)``, the counterpart of the JAX file's (1, 1) mesh)
and prints the PSNR of an eval render. Runs on the card by default;
``--device cpu`` trains through the plain PyTorch versions.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import gaussians as G
from repro_torch.core.config import GSConfig
from repro_torch.core.losses import psnr
from repro_torch.core.train import init_state, make_eval_render, make_train_step
from repro_torch.data.views import ViewDataset
from repro_torch.volume import extract_isosurface_points, kingsnake_like


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device to train on (default: the card)")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to train on the CPU")
    dev = torch.device(args.device)

    # 1. scientific volume -> isosurface point cloud (the ParaView step, in-repo)
    vol = kingsnake_like(res=40)
    points, normals, colors = extract_isosurface_points(vol, max_points=2500)
    print(f"extracted {points.shape[0]} isosurface points from '{vol.name}'")

    # 2. ground-truth views: ray-marched isosurface renders on a structured orbit
    data = ViewDataset(vol, n_views=12, img_h=64, img_w=64, cache_dir=None, n_steps_raymarch=96, device=dev)

    # 3. Gaussians seeded from the point cloud (padded with far, dark points to
    #    a multiple of 256, as the JAX file pads them)
    pad = (-points.shape[0]) % 256
    points = np.concatenate([points, np.full((pad, 3), 1e6, np.float32)])
    colors = np.concatenate([colors, np.zeros((pad, 3), np.float32)])
    g = G.init_from_points(points, colors, init_scale=0.05, device=dev)

    # 4. the one-device train step (the same code runs Gaussian-sharded and
    #    pixel-sharded across ranks with make_train_step(cfg, mesh))
    cfg = GSConfig(img_h=64, img_w=64, batch_size=4, k_per_tile=192)
    state = init_state(g)
    step = make_train_step(cfg)
    for i, (cams, gt) in enumerate(data.batches(cfg.batch_size, steps=args.steps)):
        state, metrics = step(state, cams, gt)
        if i % 10 == 0:
            print(f"step {i:3d}  loss {float(metrics['loss']):.5f}")

    # 5. evaluate
    eval_render = make_eval_render(cfg)
    cam, gt = data.view(0)
    with torch.no_grad():
        img, _ = eval_render(state.params, cam)
    print(f"PSNR vs ground truth: {float(psnr(img, gt)):.2f} dB")


if __name__ == "__main__":
    main()
