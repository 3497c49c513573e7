"""How a cell's step cost drifts as the model trains, on one chip.

  python3 gsbench/drift.py --workload ks4m-train-512 --seed 3141592653 --blocks 8 --block-steps 50 \\
      --out drift.json

After ``run.py``'s set-up it trains on without the window's snapshot, in
blocks of ``--block-steps`` steps through ``GSTrainer.fit``, and records
for each block the steps' wall ms (mean, p50, p90) and the live Gaussians'
mean scale and opacity; 3 steps under ``torch.profiler`` before the first
block and after the last give ``slab_bwd_ms`` and ``proj_bwd_ms``. Then
it restores the snapshot and runs one block again as the window runs it
(stretches of one epoch, each from the snapshot), with 3 profiled steps
from the snapshot. One JSON object goes to ``--out`` and standard output.
The benchmark's own runs never run this.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _profiled(tr, feed, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from gsbench.profread import node_device_ms
    from gsbench.rangeread import range_device_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.fit(feed, steps=steps, densify=False, log_every=10**9)
        torch.cuda.synchronize()
    return {"slab_bwd_ms": (range_device_ms(prof, "gs.slab_bwd") or 0.0) / steps,
            "proj_bwd_ms": node_device_ms(prof, "ProjectBackward") / steps,
            "step_ms": list(tr.step_ms_log)}


@torch.no_grad()
def _model_stats(tr) -> dict:
    p = tr.state.params
    live = p.opacity_logit > -10.0
    return {"mean_log_scale": float(p.log_scales[live].mean()),
            "mean_opacity": float(torch.sigmoid(p.opacity_logit[live]).mean())}


def _block(log: list[float]) -> dict:
    return {"steps": len(log), "mean_ms": float(np.mean(log)), "p50_ms": float(np.percentile(log, 50)),
            "p90_ms": float(np.percentile(log, 90))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--block-steps", type=int, default=50)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from gsbench.harness import Feed, Snapshot, build_trainer, card_line, load_cell, program_readings, setup
    from gsbench.scene import batch_order

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or cell["chips"] != 1:
        print("drift: needs a CUDA device and a one-chip cell", file=sys.stderr)
        return 2
    opts = dict(cell=cell, seed=args.seed, device="cuda", t0=T0)
    dev, _, _, cams, gt = setup(0, 1, opts)
    tr, _, _ = build_trainer(cell, args.seed, dev, None, False)
    views, batch = cell["config_data"]["views"], cell["traffic_data"]["batch"]

    def new_order():
        return batch_order(views, batch, args.seed)

    order = new_order()
    program_readings(tr, cams, gt, order, None)
    snap = Snapshot(tr)
    out = {"workload": args.workload, "seed": args.seed, "card": card_line(), "blocks": []}
    out["start"] = dict(_profiled(tr, Feed(cams, gt, order, count=3), 3), **_model_stats(tr))
    for _ in range(args.blocks):
        tr.fit(Feed(cams, gt, order, count=args.block_steps), steps=args.block_steps, densify=False,
               log_every=10**9)
        out["blocks"].append(dict(_block(tr.step_ms_log), **_model_stats(tr)))
        print(json.dumps(out["blocks"][-1]), flush=True)
    out["end"] = dict(_profiled(tr, Feed(cams, gt, order, count=3), 3), **_model_stats(tr))
    logs = []
    for _ in range(max(1, args.block_steps // (views // batch))):
        snap.restore(tr)
        tr.fit(Feed(cams, gt, new_order(), count=views // batch), steps=views // batch, densify=False,
               log_every=10**9)
        logs += tr.step_ms_log
    out["restored_block"] = _block(logs)
    snap.restore(tr)
    out["restored"] = dict(_profiled(tr, Feed(cams, gt, new_order(), count=3), 3), **_model_stats(tr))
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
