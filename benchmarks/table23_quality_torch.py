"""Tables II/III on the card: reconstruction quality over 1, 2 and 4 workers
(the PyTorch port's mirror of ``benchmarks/table23_quality.py``).

Paper claim: distribution does not compromise quality. The sharded step
computes the same optimization trajectory as one device (losses within
rtol 1e-5), so PSNR / SSIM / LPIPS-proxy after N steps match across worker
counts; this file measures it with one rank per card over NCCL (gloo ranks
with ``--device cpu``), on the JAX file's worker-to-mesh map (1 -> (1, 1),
2 -> (2, 1), 4 -> (2, 2)) and its default scene: ``kingsnake_like(res=40)``,
2,500 isosurface points padded to model x 256 with far points at opacity
logit -20, init scale 0.05, 64 px, K 192, batch 4, 12 views ray-marched at
96 steps, 60 steps, the metrics averaged over views 0, 3, 6 and 9, and the
final loss. Each worker count's per-step losses are held to one worker's at
rtol 1e-5 (a miss fails the run).

Beside each quality number stands how much of the frame the final model's
tile lists cover over the same views: valid entries of the config's lists
and of the flat lists, and the covered share (mean 1 - T) of each. At the
paper's scale the hierarchical lists saturate (``ROADMAP.md`` queue C), so
quality there measures the binning as much as the splats.

``--points`` above what the volume's isosurface gives switches to the
paper-scale scene (``paper_scene``: the surface points replicated with
jitter, random shapes and opacities from ``SEED``), padded the same way.

  PYTHONPATH=src python benchmarks/table23_quality_torch.py                       # 1, 2, 4 cards
  PYTHONPATH=src python benchmarks/table23_quality_torch.py --points 4000000 --volume-res 96 \\
      --res 512 --k-per-tile 256 --steps 200                                     # the paper's Kingsnake
  PYTHONPATH=src python benchmarks/table23_quality_torch.py --device cpu --workers 1 2 --points 600 \\
      --res 32 --steps 4

Outputs go under ``experiments/quality_torch/``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)

MESH = {1: (1, 1), 2: (2, 1), 4: (2, 2)}
OUT = "experiments/quality_torch"
VIEWS, EVAL_VIEWS = 12, (0, 3, 6, 9)
INIT_SCALE = 0.05
SEED = 0                  # the paper-scale scene's shapes and opacities
RANKS_TIMEOUT_S = 3600.0  # seconds a world of ranks may take


def build_scene(points: int, volume_res: int, seed: int):
    """The unpadded host model and its volume: the JAX script's (``points``
    isosurface points of ``kingsnake_like(res=volume_res)`` at init scale
    0.05) when the surface gives that many, else ``paper_scene``'s."""
    from repro_torch.configs.gs_datasets import paper_scene
    from repro_torch.core import gaussians as G
    from repro_torch.volume.datasets import kingsnake_like
    from repro_torch.volume.isosurface import extract_isosurface_points

    vol = kingsnake_like(res=volume_res)
    pts, _, cols = extract_isosurface_points(vol, max_points=points, seed=0)
    if pts.shape[0] >= points:
        return G.to_numpy(G.init_from_points(pts, cols, init_scale=INIT_SCALE, device="cpu")), vol
    g, _, vol = paper_scene("kingsnake", points, seed, vol=vol)
    return g, vol


@torch.no_grad()
def coverage(params, data, cfg, views) -> dict:
    """Mean over ``views`` of the valid tile-list entries and the covered
    share (mean 1 - T) of the config's lists and of the flat lists."""
    from repro_torch.core import projection as P
    from repro_torch.core import render as R
    from repro_torch.kernels.tile_raster import ops as tr_ops

    geo = dict(img_h=cfg.img_h, img_w=cfg.img_w, tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    bg = torch.zeros(3, device=params.means.device)
    acc = {"valid_entries": [], "valid_entries_flat": [], "covered_share": [], "covered_share_flat": []}
    for i in views:
        cam, _ = data.view(int(i))
        packed, _ = P.sort_by_depth(P.project(params, cam))
        lists = {"": R.bin_tiles(packed, **geo, k_per_tile=cfg.k_per_tile, binning=cfg.binning),
                 "_flat": R.build_tile_lists(packed, **geo, k_per_tile=cfg.k_per_tile)}
        for sfx, (idx, valid) in lists.items():
            _, t = tr_ops.rasterize_tiles(packed, idx, valid, **geo, bg=bg)
            acc[f"valid_entries{sfx}"].append(int(valid.sum()))
            acc[f"covered_share{sfx}"].append(float((1 - t).mean()))
    return {k: float(np.mean(v)) for k, v in acc.items()}


def _rank(rank: int, world: int, opts: dict) -> None:
    """One rank of a world of ``world`` ranks on ``MESH[world]``: train,
    evaluate, measure the lists' coverage; rank 0 writes the record."""
    sys.path.insert(0, SRC)
    from repro_torch.configs.gs_datasets import pad_dead
    from repro_torch.core import gaussians as G
    from repro_torch.core.config import GSConfig
    from repro_torch.core.train import gather_state
    from repro_torch.data.views import ViewDataset
    from repro_torch.launch.mesh import init_ranks, make_gs_mesh
    from repro_torch.launch.train import GSTrainer
    from repro_torch.volume.datasets import VolumeSpec

    dev = torch.device("cuda", rank) if opts["device"] == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    init_ranks(dev, init_method=f"file://{os.path.abspath(opts['out'])}/store_{world}", rank=rank, world_size=world,
               timeout_s=300.0)
    mesh = make_gs_mesh(*MESH[world], device=dev)
    z = np.load(opts["scene"])
    g = pad_dead(G.GaussianModel(*[z[f] for f in G.GaussianModel._fields]), mesh.model.size * 256,
                 init_scale=INIT_SCALE)
    vol = VolumeSpec(**opts["volume"])
    res = opts["res"]

    def views():
        return ViewDataset(vol, n_views=VIEWS, img_h=res, img_w=res, cache_dir=opts["cache_dir"],
                           n_steps_raymarch=96, device=dev)

    if rank == 0:  # rank 0 ray-marches and writes the ground-truth cache; the others read it
        data = views()
    mesh.barrier()
    if rank != 0:
        data = views()
    cfg = GSConfig(img_h=res, img_w=res, k_per_tile=opts["k_per_tile"], batch_size=4, backend="ref")
    tr = GSTrainer(cfg, params=g, mesh=mesh, device=dev, verbose=False)
    losses = tr.fit(data, steps=opts["steps"], densify=False)
    metrics = tr.evaluate(data, EVAL_VIEWS)
    full = gather_state(tr.state, mesh).params
    if rank == 0:
        rec = {"workers": world, "mesh": list(MESH[world]), **metrics, "loss": losses[-1], "losses": losses,
               "n_gaussians": int(g.means.shape[0]), "step_ms_p50": float(np.median(tr.step_ms_log)),
               **coverage(full, data, cfg, EVAL_VIEWS),
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
        with open(os.path.join(opts["out"], f"quality_{world}w.json"), "w") as f:
            json.dump(rec, f)
    torch.distributed.destroy_process_group()


def table(rows: list[dict], out=print) -> None:
    out("workers,psnr,ssim,lpips_proxy,final_loss,valid_entries,valid_entries_flat,covered_share,covered_share_flat")
    for d in rows:
        out(f"{d['workers']},{d['psnr']:.2f},{d['ssim']:.4f},{d['lpips_proxy']:.4f},{d['loss']:.5f},"
            f"{d['valid_entries']:.1f},{d['valid_entries_flat']:.1f},{d['covered_share']:.4f},"
            f"{d['covered_share_flat']:.4f}")


def main(argv=None) -> int:
    from repro_torch.launch.mesh import spawn_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (one rank per card, NCCL) or cpu (gloo ranks)")
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4], choices=sorted(MESH))
    ap.add_argument("--points", type=int, default=2500)
    ap.add_argument("--volume-res", type=int, default=40)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--k-per-tile", type=int, default=192)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--cache-dir", default=None, help="ground-truth cache (default OUT/gt)")
    args = ap.parse_args(argv)

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("table23_quality_torch: no CUDA device; pass --device cpu to run gloo ranks on the CPU")
        if max(args.workers) > torch.cuda.device_count():
            raise SystemExit(f"table23_quality_torch: {max(args.workers)} workers need as many cards, the machine "
                             f"has {torch.cuda.device_count()}")
    elif args.device != "cpu":
        raise SystemExit(f"table23_quality_torch: --device {args.device!r}: want cuda or cpu")
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    g, vol = build_scene(args.points, args.volume_res, SEED)
    scene = os.path.join(args.out, "scene.npz")
    np.savez(scene, **g._asdict())
    print(f"scene: {g.means.shape[0]} Gaussians on {vol.name} at {args.volume_res}^3 "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    opts = dict(device=args.device, out=args.out, scene=scene, volume=vol._asdict(), res=args.res,
                k_per_tile=args.k_per_tile, steps=args.steps,
                cache_dir=args.cache_dir or os.path.join(args.out, "gt"))
    rows = []
    for world in args.workers:
        store = os.path.join(args.out, f"store_{world}")
        if os.path.exists(store):
            os.remove(store)
        t1 = time.perf_counter()
        spawn_ranks(_rank, (world, opts), world, timeout_s=RANKS_TIMEOUT_S)
        with open(os.path.join(args.out, f"quality_{world}w.json")) as f:
            rows.append(json.load(f))
        print(f"workers {world} mesh {MESH[world]}: {time.perf_counter() - t1:.1f} s", flush=True)
    table(rows)
    base = rows[0]
    bad = [d["workers"] for d in rows if not np.allclose(d["losses"], base["losses"], rtol=1e-5, atol=0)]
    with open(os.path.join(args.out, "quality_rows.json"), "w") as f:
        json.dump({"config": vars(args), "rows": rows}, f, indent=1)
    if bad:
        raise SystemExit(f"table23_quality_torch: the per-step losses of workers {bad} differ from "
                         f"{base['workers']} worker(s) beyond rtol 1e-5")
    return 0


if __name__ == "__main__":
    sys.exit(main())
