"""Table I on the card: distributed-GS training time over 1, 2 and 4 cards
(the PyTorch port's mirror of ``benchmarks/table1_scaling.py``, measured
where the JAX file models).

Paper Table I measures training time on 1/2/4 A100s at 512/1024/2048 px
for Kingsnake (4M Gaussians) and Miranda (18.18M). This file keeps the JAX
file's ``CASES`` and measures each on cards: one rank per card over NCCL
(gloo ranks with ``--device cpu``), the workers on the model axis, a
(1, w) mesh, as ``benchmarks/gs_dryrun.py`` lays them out. The one-worker
row is the one-device trainer with no mesh (the paper's single-GPU
baseline); two- and four-worker rows run in both gather modes. Data-axis
rows add Kingsnake at 512 and 2048 px on (2, 1), (4, 1) and (2, 2) in
``projected`` mode.

Each row trains ``GSTrainer`` at ``paper_gs_config(res)`` (K 256,
hierarchical binning, batch 4, densification off) on 16 ray-marched orbit
views of the synthetic stand-in volume, from ``paper_scene`` (the surface
points replicated with jitter up to the paper's count, padded with dead
Gaussians to a multiple of 4 x 256 so that every row trains the same
model): ``--warmup`` steps, then ``--steps`` timed ones. Per row: step ms
p50 and p90 (wall per step, ending in the loss read; rank 0), the speedup
over the one-worker row, every rank's peak bytes
(``torch.cuda.max_memory_allocated`` from before the trainer is built,
gathered to rank 0) against 40 GB (the paper's A100) and 80 GB, rank 0's
per-stage split from its own span trace (``train_stage_breakdown``), one
``torch.profiler`` step on rank 0 (device busy share, device ms in NCCL
kernels against the rest), the computed all-gather bytes and the losses,
held to the one-worker row at rtol 1e-5 (a miss fails the run). A row that
runs out of device memory is kept as "does not fit", with the bytes the
allocator asked for: the paper's claim C2, measured. Rank 0 also records
each kernel's launches in the row's fit (its counters zeroed just before
and read just after).

  # on the card (one rank per card; rows that need more cards than the
  # machine has are listed as not run)
  PYTHONPATH=src python benchmarks/table1_scaling_torch.py --bench-out BENCH_table1.json
  PYTHONPATH=src python benchmarks/table1_scaling_torch.py --fast           # skip 2048 px
  # on the CPU: gloo ranks, 32 px, a few thousand Gaussians, 2 steps
  PYTHONPATH=src python benchmarks/table1_scaling_torch.py --smoke --device cpu

Outputs (rows JSON, rank 0's traces, the scenes and ground truth) go under
``experiments/table1_torch/``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, SRC)

from bench_schema import write_bench  # noqa: E402

CASES = [
    # (name, points, res, workers)
    ("kingsnake", 4_000_000, r, w) for r in (512, 1024, 2048) for w in (1, 2, 4)
] + [
    ("miranda", 18_180_000, r, w) for r in (512, 1024, 2048) for w in (1, 2, 4)
]
# data-axis rows (views across ranks): Kingsnake, projected
DATA_RES = (512, 2048)
DATA_MESHES = ((2, 1), (4, 1), (2, 2))

OUT = "experiments/table1_torch"
# paper-hardware memory budget per worker (A100-40GB on Polaris), and the H100's
WORKER_HBM = 40e9
CARD_HBM = 80e9
PAD = 4 * 256          # the largest model axis x pad_quantum: every row trains the same model
SEED = 0               # the scenes' shapes and opacities
RANKS_TIMEOUT_S = 3600.0  # seconds a world of ranks may take
N_VIEWS = 16
SMOKE = dict(res=32, points=3000, volume_res=32, views=4, warmup=1, steps=1, workers=(1, 2))  # data rows at res too
_OOM_ASKED = re.compile(r"Tried to allocate ([\d.]+) (GiB|MiB|KiB|B)")
_UNIT = {"GiB": 2**30, "MiB": 2**20, "KiB": 2**10, "B": 1}


def case_key(name: str, res: int, mesh: tuple, mode: str) -> str:
    """The JAX file's key (``gs_dryrun.py``'s file tag): ``<name>_<res>_<w>w``,
    ``-params3d`` after the name in that mode, ``_1pod<d>dp`` on a data axis."""
    d, m = mesh
    tag = f"{m}w" + (f"_1pod{d}dp" if d > 1 else "")
    return f"{name}{'-params3d' if mode == 'params3d' else ''}_{res}_{tag}"


def select_rows(args, data_res) -> list[dict]:
    """The rows to run, in order: every (1, w) case (both gather modes when
    w > 1), then the data-axis cases (Kingsnake at ``data_res``)."""
    rows = []

    def add(name, pts, res, mesh, mode):
        if res in args.res and name in args.datasets and mesh[0] * mesh[1] in args.workers:
            pts = SMOKE["points"] if args.smoke else pts
            rows.append(dict(case=case_key(name, res, mesh, mode), dataset=name, points=pts, res=res,
                             mesh=list(mesh), mode=mode))

    datasets = dict.fromkeys((name, pts) for name, pts, _, _ in CASES)  # in the JAX file's order
    for name, pts in datasets:
        for res in args.res:
            for w in (1, 2, 4):
                for mode in (("projected",) if w == 1 else ("projected", "params3d")):
                    add(name, pts, res, (1, w), mode)
    for res in data_res:
        for mesh in DATA_MESHES:
            add("kingsnake", 4_000_000, res, mesh, "projected")
    return rows


def profile_device(fn, enabled: bool) -> dict:
    """Run ``fn()`` once; when ``enabled``, under ``torch.profiler``: its
    device busy time (the union of its kernels' and copies' intervals on
    the card's timeline), its share of the profiled call's own wall time,
    and the NCCL kernels' time (which includes the wait for the other
    ranks) against the rest's, with their overlap (``obs/devtime.py``)."""
    if not enabled:
        fn()
        return {}
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.devtime import device_time

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    d = device_time(prof, wall_ms)
    return {"device_busy_ms": d["busy_ms"], "profiled_wall_ms": wall_ms, "busy_share": d["busy_share"],
            "nccl_ms": d["nccl_ms"], "other_device_ms": d["other_ms"], "nccl_overlap_ms": d["overlap_ms"]}


def _views(dataset: str, vol, res: int, dev, opts: dict):
    from repro_torch.configs.gs_datasets import DATASETS
    from repro_torch.data.views import ViewDataset

    return ViewDataset(vol, n_views=opts["views"], img_h=res, img_w=res, radius=DATASETS[dataset].radius,
                       cache_dir=opts["gt_dir"], device=dev)


def run_row(row: dict, rank: int, world: int, dev, host, vol, mesh, opts: dict) -> dict | None:
    """One row on this rank (on ``mesh``, or one device when None); rank 0
    returns its record, the others None."""
    import torch.distributed as dist

    from repro_torch.configs.gs_datasets import paper_gs_config
    from repro_torch.core.train import all_gather_bytes_per_step
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.gsproject import ops as gp_ops
    from repro_torch.kernels.tile_raster import ops as tr_ops
    from repro_torch.launch.train import GSTrainer
    from repro_torch.obs import Obs, trace_meta, write_trace
    from repro_torch.obs.replay import load_trace, train_stage_breakdown

    cuda = dev.type == "cuda"
    if rank == 0:  # rank 0 ray-marches and writes the ground-truth cache; the others read it
        data = _views(row["dataset"], vol, row["res"], dev, opts)
    if mesh is not None:
        mesh.barrier()
    if rank != 0:
        data = _views(row["dataset"], vol, row["res"], dev, opts)
    warmup, steps = opts["warmup"], opts["steps"]
    cfg = paper_gs_config(row["res"], gather_mode=row["mode"], max_steps=warmup + steps)
    obs = Obs(trace=rank == 0)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    counters = {"gsproject": gp_ops.launch_count, "tile_raster_fwd": tr_ops.launch_count,
                "tile_raster_bwd": tr_ops.bwd_launch_count, "flash_attention": fa_ops.launch_count}
    tr = losses = oom = None
    prof = {}
    try:
        tr = GSTrainer(cfg, params=host, mesh=mesh, device=dev, obs=obs, verbose=False)
        for c in counters.values():  # zeroed just before the fit, read just after
            c.n = 0
        losses = tr.fit(data, steps=warmup + steps, densify=False)
        launches = {k: c.n for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        cams, gt = next(data.batches(cfg.batch_size, steps=1))

        def one_step():  # replaces the state, as fit does, so it holds no second copy
            tr.state = tr.step_fn(tr.state, cams, gt)[0]

        prof = profile_device(one_step, rank == 0 and cuda)
    except torch.cuda.OutOfMemoryError as e:  # the row does not fit; any other error fails the run
        oom = str(e)
        peak = torch.cuda.max_memory_allocated(dev)
    step_ms = list(tr.step_ms_log) if tr is not None else []
    n_total = host.means.shape[0]
    del tr, data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    peaks = [peak]
    if mesh is not None:
        peaks = [None] * world
        dist.all_gather_object(peaks, peak)
    if rank != 0:
        return None
    rec = dict(row, n_gaussians=n_total, workers=row["mesh"][0] * row["mesh"][1], peak_bytes=peaks)
    if oom is not None:
        asked = _OOM_ASKED.search(oom)
        return dict(rec, fits=False, oom_requested_bytes=int(float(asked.group(1)) * _UNIT[asked.group(2)])
                    if asked else None, oom_message=oom.splitlines()[0][:300])
    spans = obs.trace.drain()
    path = os.path.join(opts["out"], f"trace_{row['case']}.jsonl")
    write_trace(path, spans, meta=trace_meta(obs.trace, knobs={"case": row["case"], "mesh": row["mesh"]}))
    _, records = load_trace(path)
    stages = train_stage_breakdown([r for r in records if r.get("step", 0) >= warmup])
    timed = step_ms[warmup:]
    return dict(rec, fits=True, losses=losses, launches=launches, step_ms=timed, step_ms_p50=float(np.median(timed)),
                step_ms_p90=float(np.percentile(timed, 90)),
                stages_ms={k: {"p50": v.percentile(50) * 1e3, "mean": v.mean * 1e3, "count": v.count}
                           for k, v in stages.items() if k != "timesteps"},
                all_gather_bytes=all_gather_bytes_per_step(cfg, mesh, n_total), **prof)


def _rank(rank: int, world: int, rows: list, opts: dict) -> None:
    """One rank of every row on a world of ``world`` ranks (NCCL on
    cuda:rank, gloo on the CPU; no process group at world 1); rank 0 writes
    the rows' records."""
    sys.path.insert(0, SRC)
    from repro_torch.core import gaussians as G
    from repro_torch.launch.mesh import init_ranks, make_gs_mesh
    from repro_torch.volume.datasets import VolumeSpec

    dev = torch.device("cuda", rank) if opts["device"] == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' bmm stays float32
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    if world > 1:
        init_ranks(dev, init_method=f"file://{os.path.abspath(opts['out'])}/store_{world}", rank=rank,
                   world_size=world, timeout_s=opts["collective_timeout_s"])
    vols = {name: VolumeSpec(**v) for name, v in opts["volumes"].items()}
    scenes, meshes = {}, {}
    out = []
    for row in rows:
        if row["dataset"] not in scenes:
            z = np.load(opts["scenes"][row["dataset"]])
            scenes[row["dataset"]] = G.GaussianModel(*[z[f] for f in G.GaussianModel._fields])
        shape = tuple(row["mesh"])
        if world > 1 and shape not in meshes:  # one mesh (its process groups) per shape, made by every rank
            meshes[shape] = make_gs_mesh(*shape, device=dev)
        rec = run_row(row, rank, world, dev, scenes[row["dataset"]], vols[row["dataset"]], meshes.get(shape),
                      opts)
        if rec is not None:
            rec["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            out.append(rec)
            print(f"table1 {rec['case']} mesh {tuple(rec['mesh'])}: " + (
                f"step ms p50 {rec['step_ms_p50']:.3f}, peak bytes per rank {rec['peak_bytes']}" if rec["fits"]
                else f"does not fit ({rec['oom_message'][:120]})"), flush=True)
    if rank == 0:
        with open(os.path.join(opts["out"], f"rows_{world}.json"), "w") as f:
            json.dump(out, f)
    if world > 1:
        torch.distributed.destroy_process_group()


def finish(rows: list[dict]) -> tuple[list[dict], list[str]]:
    """Speedups over the one-worker row and the loss check, per (dataset,
    res): each row's losses are held at rtol 1e-5 to the one-worker row, or,
    where that one does not fit, to the first row that does. Returns the
    rows and the failures."""
    failures = []
    for r in rows:
        ref = [x for x in rows if x["dataset"] == r["dataset"] and x["res"] == r["res"] and x.get("fits")]
        base = next((x for x in ref if x["mesh"] == [1, 1]), None)
        held = base or (ref[0] if ref else None)
        if not r.get("fits"):
            continue
        r["held_to"] = held["case"]
        r["losses_within_rtol_1e-5"] = bool(np.allclose(r["losses"], held["losses"], rtol=1e-5, atol=0))
        if not r["losses_within_rtol_1e-5"]:
            failures.append(f"{r['case']}: losses {r['losses']} differ from {held['case']}'s {held['losses']} "
                            "beyond rtol 1e-5")
        r["speedup"] = base["step_ms_p50"] / r["step_ms_p50"] if base is not None else None
        if r["peak_bytes"][0] is not None:  # measured on the card only
            peak = max(r["peak_bytes"])
            r["fits_40gb"], r["fits_80gb"] = peak < WORKER_HBM, peak < CARD_HBM
    return rows, failures


def table(rows: list[dict], out=print) -> None:
    """The JAX file's two CSV tables, with measured seconds in place of
    modelled ones."""
    out("dataset,res,workers,mesh,gather_mode,step_s_p50,step_s_p90,peak_gb_per_worker,fits_A100_40GB,"
        "fits_H100_80GB,nccl_ms,busy_share")
    for r in rows:
        mesh = f"{r['mesh'][0]}x{r['mesh'][1]}"
        if r.get("fits"):
            busy = f"{r['busy_share']:.4f}" if "busy_share" in r else "not measured"
            nccl = f"{r['nccl_ms']:.3f}" if "nccl_ms" in r else "not measured"
            peak = r["peak_bytes"]
            gb = f"{max(peak) / 1e9:.2f}" if peak[0] is not None else "not measured"
            out(f"{r['dataset']},{r['res']},{r['workers']},{mesh},{r['mode']},{r['step_ms_p50'] / 1e3:.5f},"
                f"{r['step_ms_p90'] / 1e3:.5f},{gb},{r.get('fits_40gb', 'not measured')},"
                f"{r.get('fits_80gb', 'not measured')},{nccl},{busy}")
        else:
            why = r.get("not_run") or f"does not fit (asked {r.get('oom_requested_bytes')} B)"
            out(f"{r['dataset']},{r['res']},{r['workers']},{mesh},{r['mode']},{why},,,False,False,,")
    out("")
    out("dataset,res,workers,mesh,gather_mode,measured_speedup_vs_1w")
    for r in rows:
        if r.get("fits") and r["mesh"] != [1, 1] and r.get("speedup") is not None:
            out(f"{r['dataset']},{r['res']},{r['workers']},{r['mesh'][0]}x{r['mesh'][1]},{r['mode']},"
                f"{r['speedup']:.2f}")


def emit_bench(rows: list[dict], path: str, config: dict) -> dict:
    """Schema-2 record in the JAX file's key layout: per-case measured step
    seconds (p50) and worst-rank peak bytes, speedups over the one-worker
    row, the case count and how many fit 40 GB and 80 GB."""
    metrics = {}
    ran = [r for r in rows if "not_run" not in r]
    for r in ran:
        if r["peak_bytes"][0] is not None:
            metrics[f"peak_bytes.{r['case']}"] = int(max(r["peak_bytes"]))
        if r.get("fits"):
            metrics[f"step_s_p50.{r['case']}"] = round(r["step_ms_p50"] / 1e3, 6)
            if r["mesh"] != [1, 1] and r.get("speedup") is not None:
                metrics[f"speedup.{r['case']}"] = round(r["speedup"], 3)
    metrics["cases"] = len(ran)
    metrics["fits_40gb"] = sum(1 for r in ran if r.get("fits_40gb"))
    metrics["fits_80gb"] = sum(1 for r in ran if r.get("fits_80gb"))
    return write_bench(path, "table1_scaling_torch", config=config, metrics=metrics)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    from repro_torch.configs.gs_datasets import DATASETS, pad_dead, paper_scene
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.volume import datasets as VD

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (one rank per card, NCCL) or cpu (gloo ranks)")
    ap.add_argument("--fast", action="store_true", help="skip the 2048px cases")
    ap.add_argument("--smoke", action="store_true", help="32 px, a few thousand Gaussians, 2 steps, 1 and 2 ranks")
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4], help="worker counts (ranks) to run")
    ap.add_argument("--datasets", nargs="+", default=["kingsnake", "miranda"])
    ap.add_argument("--res", type=int, nargs="+", default=[512, 1024, 2048])
    ap.add_argument("--warmup", type=int, default=2, help="steps before the timed ones")
    ap.add_argument("--steps", type=int, default=8, help="timed steps")
    ap.add_argument("--out", default=None, help=f"output directory (default {OUT}, {OUT}/smoke with --smoke)")
    ap.add_argument("--bench-out", default=None, help="also write a flat BENCH_*.json record (bench_schema)")
    args = ap.parse_args(argv)

    volume_res, data_res, views = None, DATA_RES, N_VIEWS
    if args.smoke:
        args.res, views = [SMOKE["res"]], SMOKE["views"]
        args.warmup, args.steps, volume_res = SMOKE["warmup"], SMOKE["steps"], SMOKE["volume_res"]
        args.workers = [w for w in args.workers if w in SMOKE["workers"]]
        data_res = args.res
    if args.fast:
        args.res = [r for r in args.res if r <= 1024]
    out_dir = args.out or (os.path.join(OUT, "smoke") if args.smoke else OUT)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("table1_scaling_torch: no CUDA device; pass --device cpu to run gloo ranks on the CPU")
        n_cards, card = torch.cuda.device_count(), card_line()
    elif args.device == "cpu":
        n_cards, card = None, "cpu"
    else:
        raise SystemExit(f"table1_scaling_torch: --device {args.device!r}: want cuda or cpu")
    os.makedirs(out_dir, exist_ok=True)
    print(card, flush=True)

    rows = select_rows(args, data_res)
    t0 = time.perf_counter()
    scenes, volumes = {}, {}
    for name in sorted({r["dataset"] for r in rows}):
        pts = next(r["points"] for r in rows if r["dataset"] == name)
        vol = getattr(VD, DATASETS[name].volume)(res=volume_res or DATASETS[name].volume_res)
        g, n_surface, vol = paper_scene(name, pts, SEED, vol=vol)
        g = pad_dead(g, PAD)
        scenes[name] = os.path.join(out_dir, f"scene_{name}.npz")
        np.savez(scenes[name], **g._asdict())
        volumes[name] = vol._asdict()
        print(f"scene {name}: {n_surface} surface points -> {pts} Gaussians, padded to {g.means.shape[0]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    opts = dict(device=args.device, out=out_dir, gt_dir=os.path.join(out_dir, "gt"), views=views,
                warmup=args.warmup, steps=args.steps, scenes=scenes, volumes=volumes, collective_timeout_s=300.0)
    done = []
    for world in sorted({r["mesh"][0] * r["mesh"][1] for r in rows}):
        mine = [r for r in rows if r["mesh"][0] * r["mesh"][1] == world]
        if n_cards is not None and world > n_cards:
            done += [dict(r, fits=False, not_run=f"not run: {world} ranks need {world} cards, the machine has "
                                                   f"{n_cards}", workers=world, peak_bytes=[None]) for r in mine]
            continue
        store = os.path.join(out_dir, f"store_{world}")
        if os.path.exists(store):
            os.remove(store)
        t1 = time.perf_counter()
        spawn_ranks(_rank, (world, mine, opts), world, timeout_s=RANKS_TIMEOUT_S)
        with open(os.path.join(out_dir, f"rows_{world}.json")) as f:
            done += json.load(f)
        print(f"world {world}: {len(mine)} rows in {time.perf_counter() - t1:.1f} s", flush=True)
    order = {r["case"]: i for i, r in enumerate(rows)}
    done.sort(key=lambda r: order[r["case"]])
    done, failures = finish(done)
    table(done)
    with open(os.path.join(out_dir, "table1_rows.json"), "w") as f:
        json.dump({"card": card, "rows": done}, f, indent=1)
    if args.bench_out:
        emit_bench(done, args.bench_out, config={
            "card": card, "device": args.device, "worker_hbm_bytes": WORKER_HBM, "card_hbm_bytes": CARD_HBM,
            "warmup_steps": args.warmup, "timed_steps": args.steps, "views": views, "seed": SEED,
            "source": out_dir})
    print(f"table1: {len(done)} rows in {time.perf_counter() - t0:.1f} s -> {out_dir}/table1_rows.json")
    if failures:
        raise SystemExit("table1_scaling_torch: " + "; ".join(failures))
    return 0


if __name__ == "__main__":
    sys.exit(main())
