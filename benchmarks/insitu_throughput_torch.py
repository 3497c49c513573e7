"""Streaming reconstruction benchmark of the PyTorch port: warm-start vs
cold-start, per-timestep wall-clock, train-step shape signatures,
temporal-store compression (the mirror of ``benchmarks/insitu_throughput.py``,
with its methodology and report keys).

Methodology: one time-varying synthetic stream (T timesteps). The *warm*
pipeline cold-starts at t=0 and warm-starts every later timestep (params +
Adam moments carried over, dead slots reseeded), with a PSNR-vs-steps curve
recorded per timestep. For every t >= 1 a *cold baseline* trains the same
timestep from scratch at the same fixed capacity and step budget. The target
PSNR for timestep t is the cold baseline's final PSNR (minus a small
tolerance); steps-to-target are read off both curves. Emits one JSON report:

  warm_steps_to_target[t] < cold_steps_to_target[t]  on >= 2 consecutive t
  recompile_count == 1 (one train-step shape signature for the whole sequence;
  the JAX package counts jit traces)

Temporal checkpoints are written by the store's background writer (delta
quantization + compression overlap the next timestep's training); the report
carries the overlap accounting (append_wall_s vs write_s). A final phase
reloads the sequence into a pipelined timeline server and time-scrubs every
stored timestep; the script exits nonzero if that pipelined serving path
completes fewer requests than were submitted (or if either training
acceptance criterion fails). Runs on the card unless ``--device cpu``.

  PYTHONPATH=src python benchmarks/insitu_throughput_torch.py --out report.json
  PYTHONPATH=src python benchmarks/insitu_throughput_torch.py --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.core.config import GSConfig  # noqa: E402
from repro_torch.insitu import InsituTrainer, TemporalCheckpointStore, build_timeline_server, scrub  # noqa: E402
from repro_torch.serve_gs import front_camera  # noqa: E402
from repro_torch.volume.timevary import GENERATORS, synthetic_stream  # noqa: E402

SCHEMA_VERSION = 2  # the flat BENCH_*.json record of benchmarks/bench_schema.py


def stage_breakdown(snapshot: dict, prefix: str | None = None) -> dict:
    """The histogram entries of a ``MetricsRegistry.snapshot()`` as a BENCH
    ``stages`` block ({dotted name: histogram dict}); ``prefix`` filters to
    one tier (a copy of ``bench_schema.stage_breakdown``)."""
    return {name: v for name, v in snapshot.items()
            if (prefix is None or name.startswith(prefix)) and isinstance(v, dict) and "p99" in v
            and "buckets" in v}


def write_bench(path: str, name: str, config: dict, metrics: dict, stages: dict | None = None) -> dict:
    """Write a flat BENCH record (a copy of ``bench_schema.write_bench``)."""
    rec = {"bench": name, "schema": SCHEMA_VERSION, "config": config, "metrics": metrics}
    if stages:
        rec["stages"] = stages
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def steps_to_target(curve: list, target: float) -> int | None:
    """First recorded step whose PSNR reaches ``target`` (None if never)."""
    for step, p in curve:
        if p >= target:
            return int(step)
    return None


def make_trainer(cfg, args, *, capacity=None, eval_every):
    return InsituTrainer(
        cfg, device=args.device,
        capacity=capacity,
        capacity_factor=args.capacity_factor,
        cold_steps=args.cold_steps,
        warm_steps=args.cold_steps,  # same budget as cold: fairness of steps-to-target
        n_views=args.views, max_points=args.max_points,
        n_steps_raymarch=args.raymarch_steps, init_scale=0.06,
        eval_every=eval_every, seed=args.seed,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device to train and serve on (default: the card)")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--dataset", choices=list(GENERATORS), default="miranda")
    ap.add_argument("--timesteps", type=int, default=4)
    ap.add_argument("--t1", type=float, default=0.25)
    ap.add_argument("--volume-res", type=int, default=40)
    # the JAX file's default, 56 px, is not a whole number of 16-px tiles and
    # renders in neither package; 64 is the next size that tiles
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-points", type=int, default=1200)
    ap.add_argument("--cold-steps", type=int, default=120)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--raymarch-steps", type=int, default=48)
    ap.add_argument("--capacity-factor", type=float, default=1.5)
    ap.add_argument("--target-tol-db", type=float, default=0.1)
    ap.add_argument("--keyframe-interval", type=int, default=4)
    ap.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="in-flight depth for the time-scrub serving phase (1 = sync)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--bench-out", default=None,
                    help="also write a flat BENCH_*.json record (bench_schema) with "
                         "per-stage train histograms + shard-balance gauges")
    args = ap.parse_args(argv)

    if args.smoke:
        args.timesteps = min(args.timesteps, 3)
        args.volume_res, args.res = 32, 48
        args.max_points = min(args.max_points, 800)
        args.cold_steps = min(args.cold_steps, 80)
        args.t1 = min(args.t1, 0.15)

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    cfg = GSConfig(
        img_h=args.res, img_w=args.res, batch_size=args.batch,
        k_per_tile=128 if args.smoke else 256,
        max_steps=args.cold_steps * args.timesteps,
        densify_from=10**9, opacity_reset_interval=10**9,
    )
    vols = list(synthetic_stream(args.dataset, args.timesteps, res=args.volume_res, t1=args.t1))

    # ---- warm pipeline over the whole stream, with temporal checkpoints
    # (context manager: queued background writes are flushed + the writer
    # joined even if a later benchmark phase raises)
    with TemporalCheckpointStore(
        os.path.join(tempfile.mkdtemp(prefix="insitu_bench_"), "seq"),
        keyframe_interval=args.keyframe_interval,
    ) as store:
        warm = make_trainer(cfg, args, eval_every=args.eval_every)
        warm_reports = warm.run(iter(vols), store=store)

        # ---- cold baselines: from-scratch at each later timestep, same capacity
        rows = [{
            "t": 0,
            "mode": "cold_start",
            "steps": warm_reports[0].steps,
            "psnr_after": round(warm_reports[0].psnr_after, 3),
            "train_s": round(warm_reports[0].train_s, 3),
            "wall_s": round(warm_reports[0].wall_s, 3),
        }]
        fewer = []
        cold = make_trainer(cfg, args, capacity=warm.capacity, eval_every=args.eval_every)
        for t in range(1, args.timesteps):
            if cold.state is not None:
                cold.reset()  # keep the step fns: no new shape signature per baseline
            cold_rep = cold.start(vols[t])
            target = cold_rep.psnr_after - args.target_tol_db
            w_rep = warm_reports[t]
            w_steps = steps_to_target(w_rep.psnr_curve, target)
            c_steps = steps_to_target(cold_rep.psnr_curve, target)
            fewer.append(w_steps is not None and c_steps is not None and w_steps < c_steps)
            rows.append({
                "t": t,
                "target_psnr": round(target, 3),
                "warm": {
                    "steps_to_target": w_steps,
                    "psnr_before": round(w_rep.psnr_before, 3),
                    "psnr_after": round(w_rep.psnr_after, 3),
                    "n_reseeded": w_rep.n_reseeded,
                    "train_s": round(w_rep.train_s, 3),
                    "wall_s": round(w_rep.wall_s, 3),
                    "curve": [(s, round(p, 3)) for s, p in w_rep.psnr_curve],
                },
                "cold": {
                    "steps_to_target": c_steps,
                    "psnr_after": round(cold_rep.psnr_after, 3),
                    "train_s": round(cold_rep.train_s, 3),
                    "curve": [(s, round(p, 3)) for s, p in cold_rep.psnr_curve],
                },
                "warm_fewer_steps": fewer[-1],
            })

        # ---- pipelined time-scrub serving over the stored sequence: every
        # timestep requested at one camera through the FrameFuture path
        # (store_frames off, depth-D dispatch); all submits must complete.
        with build_timeline_server(
            store, cfg, n_levels=2, max_batch=2, store_frames=False,
            pipeline_depth=args.pipeline_depth, device=args.device,
        ) as server:
            cam = front_camera(server.pyramid, img_h=cfg.img_h, img_w=cfg.img_w)
            scrub_ts = store.timesteps()
            frames = scrub(server, cam, scrub_ts)
            serve_rep = server.report()
        if serve_rep["completed"] != len(scrub_ts):
            raise SystemExit(
                f"pipelined scrub dropped requests: completed {serve_rep['completed']} "
                f"of {len(scrub_ts)}"
            )

        consec = 0
        best_consec = 0
        for f in fewer:
            consec = consec + 1 if f else 0
            best_consec = max(best_consec, consec)
        report = {
            "config": {
                "dataset": args.dataset, "timesteps": args.timesteps,
                "volume_res": args.volume_res, "res": args.res,
                "capacity": warm.capacity, "cold_steps": args.cold_steps,
                "eval_every": args.eval_every, "target_tol_db": args.target_tol_db,
                "device": args.device,
            },
            "timesteps": rows,
            "recompile_count": warm.n_traces,
            "per_timestep_wall_s": [round(r.wall_s, 3) for r in warm_reports],
            "warm_fewer_steps_consecutive": best_consec,
            "store": store.stats(),
            "scrub_serving": {
                "timesteps": len(scrub_ts),
                "completed": serve_rep["completed"],
                "frames_per_s": serve_rep["frames_per_s"],
                "pipeline": serve_rep["pipeline"],
                "frame_shape": list(frames[scrub_ts[0]].shape),
            },
            "acceptance": {
                "warm_fewer_on_2_consecutive": best_consec >= 2,
                "single_train_step_trace": warm.n_traces == 1,
                "scrub_served_all": serve_rep["completed"] == len(scrub_ts),
            },
        }
        out = json.dumps(report, indent=1)
        print(out)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                f.write(out)
        if args.bench_out:
            # the warm trainer's registry holds the whole run's train.*
            # telemetry: step/timestep histograms become the stages block,
            # shard-balance gauges ride along as flat metrics
            snap = warm.obs.metrics.snapshot()
            total_steps = sum(r.steps for r in warm_reports)
            total_train_s = sum(r.train_s for r in warm_reports)
            bench_metrics = {
                "steps_per_s": round(total_steps / max(total_train_s, 1e-9), 3),
                "frames_per_s": serve_rep["frames_per_s"],
                "recompile_count": warm.n_traces,
                "warm_fewer_steps_consecutive": best_consec,
                "gather_bytes": snap.get("train.gather_bytes", 0),
            }
            for k, v in snap.items():
                if k.startswith("train.shard_") or k in ("train.alive_total", "train.psnr"):
                    bench_metrics[k] = v
            write_bench(
                args.bench_out, "insitu_throughput_torch",
                config={
                    "dataset": args.dataset, "timesteps": args.timesteps,
                    "volume_res": args.volume_res, "res": args.res,
                    "capacity": warm.capacity, "cold_steps": args.cold_steps,
                    "smoke": args.smoke,
                },
                metrics=bench_metrics,
                stages=stage_breakdown(snap, "train."),
            )
        if not report["acceptance"]["single_train_step_trace"]:
            raise SystemExit(f"train step saw {report['recompile_count']} shape signatures, want 1")
        if not report["acceptance"]["warm_fewer_on_2_consecutive"]:
            raise SystemExit(f"warm start did not reach the cold target in fewer steps on 2 consecutive "
                             f"timesteps: {fewer}")


if __name__ == "__main__":
    main()
