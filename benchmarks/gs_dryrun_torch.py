"""GS train step counted and timed at the paper's scale on H100s: the port's
counterpart of ``benchmarks/gs_dryrun.py``.

The JAX file lowers the distributed train step with shape stand-ins and
reads the compiled HLO's cost. The port runs its own train step on real
tensors, one process per rank (``src/repro_torch/launch/mesh.py``
``spawn_ranks``; NCCL with one rank per card, gloo ranks with ``--device
cpu``), on ``paper_scene``'s Kingsnake (4M) or Miranda (18.18M) padded to
``workers x 256``, at ``paper_gs_config`` (hierarchical binning, batch 4,
K ``--k-per-tile``) over ``batch`` ray-marched orbit views. Per point it

* times ``--steps`` steps after ``--warmup`` (wall per step, ending in the
  loss read; p50 on rank 0): ``measured_step_ms``;
* counts one more step under ``src/repro_torch/launch/op_cost.py``
  ``OpCost``: every dispatched op, the three splatting kernels' own work
  (they report the bounds' formulas, ``kernels/cost.py``), the
  collectives by the ring formulas.

``per_worker`` holds rank 0's count (every rank runs the same shapes) and
its peak: the card's ``max_memory_allocated`` over the run
(``peak_live_bytes`` of the counted step on the CPU). ``roofline_s`` is on
H100 terms: compute at the float32 peak (the step runs in float32 on the
CUDA cores; TF32 is off), memory at HBM3's rate, collectives at NVLink 4's
(every rank sits in one node). ``roofline_share`` is the largest term over
the measured step. There is no ``alpha_class`` or kernel-adjusted term: the
kernels report their own bytes.

  PYTHONPATH=src python benchmarks/gs_dryrun_torch.py --points 4000000 --res 512 --workers 4
  PYTHONPATH=src python benchmarks/gs_dryrun_torch.py --points 3000 --res 32 --workers 1 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)

OUT = "experiments/gs_dryrun_torch"
SCENES = os.path.join(ROOT, "build", "gs_dryrun_torch")  # the padded scene and the ranks' store, for the ranks
SEED = 0
RANKS_TIMEOUT_S = 3600.0


def _rank(rank: int, world: int, points: list, opts: dict) -> None:
    """One rank of every point on a world of ``world`` ranks; rank 0 writes
    each point's JSON."""
    sys.path.insert(0, SRC)
    import torch.distributed as dist

    from repro_torch.configs.gs_datasets import DATASETS, paper_gs_config
    from repro_torch.core import gaussians as G
    from repro_torch.data.views import ViewDataset
    from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_FP32, init_ranks, make_gs_mesh
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.launch.train import GSTrainer
    from repro_torch.volume.datasets import VolumeSpec

    dev = torch.device("cuda", rank) if opts["device"] == "cuda" else torch.device("cpu")
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    if world > 1:
        init_ranks(dev, init_method=f"file://{opts['scratch']}/store_{world}", rank=rank,
                   world_size=world, timeout_s=300.0)
    vol = VolumeSpec(**opts["volume"])
    z = np.load(opts["scene"])
    host = G.GaussianModel(*[z[f] for f in G.GaussianModel._fields])
    for pt in points:
        d, m = pt["data_par"], pt["workers"]
        mesh = make_gs_mesh(d, m, device=dev) if world > 1 else None
        cfg = paper_gs_config(pt["res"], k_per_tile=opts["k_per_tile"], gather_mode=opts["gather_mode"],
                              batch_size=opts["batch"], max_steps=opts["warmup"] + opts["steps"] + 1)
        data = ViewDataset(vol, n_views=opts["batch"], img_h=pt["res"], img_w=pt["res"],
                           radius=DATASETS[opts["dataset"]].radius, device=dev)
        cams, gt = next(data.batches(cfg.batch_size, steps=1))
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        tr = GSTrainer(cfg, params=host, mesh=mesh, device=dev, verbose=False)
        step_ms = []
        for i in range(opts["warmup"] + opts["steps"]):
            t0 = time.perf_counter()
            tr.state, metrics = tr.step_fn(tr.state, cams, gt)
            float(metrics["loss"])
            if i >= opts["warmup"]:
                step_ms.append((time.perf_counter() - t0) * 1e3)
        args_bytes = torch.cuda.memory_allocated(dev) if cuda else None
        with OpCost() as counter:
            tr.state, metrics = tr.step_fn(tr.state, cams, gt)
            loss = float(metrics["loss"])
        cost = counter.result()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else cost["peak_live_bytes"]
        del tr, data
        if cuda:
            torch.cuda.empty_cache()
        if mesh is not None:
            dist.barrier()
        if rank != 0:
            continue
        measured = float(np.median(step_ms))
        terms = {"compute": cost["flops"] / PEAK_FLOPS_FP32, "memory": cost["bytes"] / HBM_BW,
                 "collective": cost["coll_total_moved_bytes"] / NVLINK_BW}
        rec = {
            "name": pt["name"], "points": opts["points"], "n_gaussians": int(host.means.shape[0]),
            "res": pt["res"], "workers": m, "data_par": d, "batch": opts["batch"], "k_per_tile": opts["k_per_tile"],
            "gather_mode": opts["gather_mode"], "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "card": opts["card"],
            "per_worker": {
                "flops": cost["flops"], "hbm_bytes": cost["bytes"],
                "collective_bytes": cost["coll_total_moved_bytes"], "collectives": cost["coll"],
                "peak_bytes": peak, "peak_live_bytes": cost["peak_live_bytes"], "argument_bytes": args_bytes,
                "transfer_bytes": cost["transfer_bytes"],
            },
            "roofline_s": terms,
            "roofline_dominant": max(terms, key=terms.get),
            "measured_step_ms": measured if cuda else None,
            "step_ms": step_ms,
            "roofline_share": max(terms.values()) * 1e3 / measured if cuda else None,
            "loss": loss,
            "top_bytes": cost["top_bytes"],
            "by_op": cost["by_op"],
        }
        tag = f"{m}w" + (f"_1pod{d}dp" if d > 1 else "")
        path = os.path.join(opts["out"], f"{pt['name']}_{opts['points']}_{pt['res']}_{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        share = f"{rec['roofline_share']:.4f}" if cuda else "not measured (CPU)"
        print(f"gs_dryrun {pt['name']} {opts['points']} {pt['res']}px ({d}, {m}): flops {cost['flops']:.4e}, "
              f"bytes {cost['bytes']:.4e}, collective bytes {cost['coll_total_moved_bytes']:.4e}, peak {peak} B; "
              f"roofline ms compute {terms['compute'] * 1e3:.3f} memory {terms['memory'] * 1e3:.3f} collective "
              f"{terms['collective'] * 1e3:.3f}; measured step ms p50 "
              f"{measured if cuda else 'not measured (CPU)'}; roofline share {share}", flush=True)
    if world > 1:
        dist.destroy_process_group()


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    from repro_torch.configs.gs_datasets import DATASETS, pad_dead, paper_scene
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.volume import datasets as VD

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, required=True)
    ap.add_argument("--res", type=int, nargs="+", required=True)
    ap.add_argument("--workers", type=int, nargs="+", required=True, help="model-axis workers (one run each)")
    ap.add_argument("--data-par", type=int, default=1, help="data-axis ranks (views)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--k-per-tile", type=int, default=256, help="paper_gs_config's K (the JAX file defaults to 1024)")
    ap.add_argument("--gather-mode", default="projected", choices=["projected", "params3d"])
    ap.add_argument("--dataset", default=None, help="kingsnake or miranda (default: miranda above 10M points)")
    ap.add_argument("--volume-res", type=int, default=None, help="the stand-in volume's side (default: the dataset's)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (one rank per card, NCCL) or cpu (gloo ranks)")
    ap.add_argument("--name", default="gs")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--scratch", default=SCENES, help="where the padded scene and the ranks' store go")
    args = ap.parse_args(argv)

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("gs_dryrun_torch: no CUDA device; pass --device cpu to run gloo ranks on the CPU")
        n_cards, card = torch.cuda.device_count(), card_line()
    elif args.device == "cpu":
        n_cards, card = None, "cpu"
    else:
        raise SystemExit(f"gs_dryrun_torch: --device {args.device!r}: want cuda or cpu")
    dataset = args.dataset or ("miranda" if args.points > 10_000_000 else "kingsnake")
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.scratch, exist_ok=True)
    print(card, flush=True)
    t0 = time.perf_counter()
    vol = getattr(VD, DATASETS[dataset].volume)(res=args.volume_res or DATASETS[dataset].volume_res)
    g, n_surface, vol = paper_scene(dataset, args.points, SEED, vol=vol)
    worlds = sorted({w * args.data_par for w in args.workers})
    scene = os.path.join(args.scratch, f"scene_{dataset}_{args.points}.npz")
    name = args.name if args.gather_mode == "projected" else f"{args.name}-{args.gather_mode}"
    for world in worlds:
        if n_cards is not None and world > n_cards:
            print(f"world {world}: not run, the machine has {n_cards} cards", flush=True)
            continue
        w = world // args.data_par
        gp = pad_dead(g, w * 256)  # the JAX file's quantum: model workers x 256
        np.savez(scene, **gp._asdict())
        print(f"scene {dataset}: {n_surface} surface points -> {args.points} Gaussians, padded to "
              f"{gp.means.shape[0]} ({time.perf_counter() - t0:.1f} s)", flush=True)
        opts = dict(device=args.device, out=args.out, volume=vol._asdict(), scene=scene, dataset=dataset,
                    points=args.points, batch=args.batch, k_per_tile=args.k_per_tile, gather_mode=args.gather_mode,
                    warmup=args.warmup, steps=args.steps, card=card, scratch=os.path.abspath(args.scratch))
        pts = [dict(name=name, res=r, workers=w, data_par=args.data_par) for r in args.res]
        store = os.path.join(args.scratch, f"store_{world}")
        if os.path.exists(store):
            os.remove(store)
        t1 = time.perf_counter()
        spawn_ranks(_rank, (world, pts, opts), world, timeout_s=RANKS_TIMEOUT_S)
        print(f"world {world}: {len(pts)} points in {time.perf_counter() - t1:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
