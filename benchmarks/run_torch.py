"""Benchmark entry point of the PyTorch port, one section per paper table or
figure (the counterpart of ``benchmarks/run.py``).

Prints the kernel micro-benchmark CSV (``name,us_per_call,derived``;
``benchmarks/raster_kernel_torch.py``), a reduced one-device GS train step,
then Table I and Tables II/III from the cached results of
``benchmarks/table1_scaling_torch.py`` (``experiments/table1_torch/``) and
``benchmarks/table23_quality_torch.py`` (``experiments/quality_torch/``)
when they exist, then the dry run's roofline table
(``benchmarks/roofline_torch.py`` over ``experiments/dryrun_torch/``).
Runs on the card by default; ``--device cpu`` runs the plain versions and
leaves the kernel rows out.

  PYTHONPATH=src python benchmarks/run_torch.py
  PYTHONPATH=src python benchmarks/run_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, HERE)


def gs_train_row(device: str) -> str:
    """The JAX file's reduced step: 1,500 isosurface points (padded to 256),
    64 px, K 192, batch 2; the mean of 3 steps after one warm-up, wall time
    ending in the loss read."""
    from repro_torch.core import gaussians as G
    from repro_torch.core.config import GSConfig
    from repro_torch.core.train import init_state, make_train_step
    from repro_torch.data.views import ViewDataset
    from repro_torch.volume import extract_isosurface_points, kingsnake_like

    dev = torch.device(device)
    cfg = GSConfig(img_h=64, img_w=64, k_per_tile=192, batch_size=2, backend="ref")
    vol = kingsnake_like(res=32)
    pts, _, cols = extract_isosurface_points(vol, max_points=1500, seed=0)
    pad = (-pts.shape[0]) % 256
    pts = np.concatenate([pts, np.full((pad, 3), 1e6, np.float32)])
    cols = np.concatenate([cols, np.zeros((pad, 3), np.float32)])
    state = init_state(G.init_from_points(pts, cols, init_scale=0.05, device=dev))
    step = make_train_step(cfg)
    data = ViewDataset(vol, n_views=2, img_h=64, img_w=64, n_steps_raymarch=64, device=dev)
    cams, gt = next(data.batches(2, steps=1))
    state, m = step(state, cams, gt)
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(3):
        state, m = step(state, cams, gt)
    loss = float(m["loss"])
    us = (time.perf_counter() - t0) / 3 * 1e6
    return f"gs_train_step_{pts.shape[0]}g_64px,{us:.0f},loss={loss:.5f} device={device}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_torch: no CUDA device; pass --device cpu")
    backends = ("plain", "cuda") if torch.device(args.device).type == "cuda" else ("plain",)

    print("# --- kernel micro-benchmarks (name,us_per_call,derived) ---")
    import raster_kernel_torch

    for name, us, derived in (raster_kernel_torch.rows(args.device, backends)
                              + raster_kernel_torch.flash_rows(args.device, backends)):
        print(f"{name},{us:.1f},{derived}")

    print("\n# --- GS train step (single device, reduced scale) ---")
    print(gs_train_row(args.device))

    print("\n# --- Table I: scaling (measured on the cards) ---")
    t1 = os.path.join(ROOT, "experiments", "table1_torch", "table1_rows.json")
    if os.path.exists(t1):
        import table1_scaling_torch

        with open(t1) as f:
            d = json.load(f)
        print(f"# {d['card']}")
        table1_scaling_torch.table(d["rows"])
    else:
        print("(cached Table I rows not found; run benchmarks/table1_scaling_torch.py)")

    print("\n# --- Tables II/III: quality vs workers ---")
    t23 = os.path.join(ROOT, "experiments", "quality_torch", "quality_rows.json")
    if os.path.exists(t23):
        import table23_quality_torch

        with open(t23) as f:
            table23_quality_torch.table(json.load(f)["rows"])
    else:
        print("(cached quality rows not found; run benchmarks/table23_quality_torch.py)")

    print("\n# --- Roofline summary (dry run, one H100) ---")
    dr = os.path.join(ROOT, "experiments", "dryrun_torch")
    if glob.glob(os.path.join(dr, "*_card1.json")):
        import roofline_torch

        roofline_torch.table(dirname=dr, mesh="card1")
    else:
        print("(dry-run artifacts missing; run benchmarks/dryrun_all_torch.py)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
