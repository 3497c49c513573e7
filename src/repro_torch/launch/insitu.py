"""Streaming in situ reconstruction driver (PyTorch port): stream ->
warm-start train -> temporal checkpoints -> time-scrub serving smoke.

Consumes a time-varying synthetic volume stream (Kingsnake uncoiling or
Miranda mixing-layer growth), keeps one fixed-capacity Gaussian model
tracking the isosurface (cold start at t=0, warm delta-training after),
appends every timestep to a keyframe+delta temporal checkpoint store, then
reloads the sequence into a timeline RenderServer and scrubs one camera
across time. Prints a JSON report; exits nonzero if the train step saw more
than one shape signature, scrubbed frames are not per-timestep distinct, or
the scrub's replay missed the frame cache.

Runs on the card by default and raises when there is none; ``--device cpu``
runs the plain PyTorch versions instead. With ``--data-par`` or
``--model-par`` above 1 it runs one process per rank under torchrun (NCCL
on ``cuda:LOCAL_RANK``, or gloo with ``--device cpu``); rank 0 keeps the
store, serves the smoke, prints and writes the span trace of
``--trace-out`` (JSONL in the JAX package's schema, with a
Perfetto-viewable ``.chrome.json`` beside it).

  PYTHONPATH=src python -m repro_torch.launch.insitu --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.insitu --dataset miranda \\
      --timesteps 6 --res 64 --cold-steps 200 --warm-steps 40 \\
      --ckpt experiments/insitu/run0
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.insitu --smoke --device cpu --model-par 2
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.config import GSConfig
from repro_torch.insitu import (
    InsituTrainer,
    TemporalCheckpointStore,
    build_timeline_server,
    replay_live,
    scrub,
)
from repro_torch.launch.mesh import init_ranks, make_gs_mesh
from repro_torch.obs import Obs, export_trace
from repro_torch.obs.clock import now, since
from repro_torch.serve_gs import front_camera
from repro_torch.volume.timevary import GENERATORS, synthetic_stream


def scrub_smoke(
    store: TemporalCheckpointStore, cfg: GSConfig, *, n_scrub: int = 3, pipeline_depth: int = 2, device="cuda"
) -> dict:
    """Time-scrubbing smoke: one camera, ``n_scrub`` timesteps, frames must
    be distinct per timestep and cache-hit on replay. Runs with
    ``store_frames=False`` (the production serving configuration): frames
    arrive through each request's ``FrameFuture``, nothing is pinned."""
    ts = store.timesteps()[:n_scrub]
    with build_timeline_server(
        store, cfg, n_levels=2, max_batch=2, store_frames=False,
        pipeline_depth=pipeline_depth, device=device,
    ) as server:
        cam = front_camera(server.pyramid, img_h=cfg.img_h, img_w=cfg.img_w)

        frames = scrub(server, cam, ts)
        misses_first = server.cache.misses
        frames2 = scrub(server, cam, ts)  # replay: must be pure cache hits
        diffs = {
            f"{a}->{b}": float(np.abs(frames[a] - frames[b]).max()) for a, b in zip(ts, ts[1:])
        }
        return {
            "timesteps": ts,
            "frame_shape": list(frames[ts[0]].shape),
            "max_abs_frame_delta": diffs,
            "frames_distinct": all(d > 1e-4 for d in diffs.values()),
            "replay_identical": all(np.array_equal(frames[t], frames2[t]) for t in ts),
            "replay_cache_hits": server.cache.hits,
            "replay_new_misses": server.cache.misses - misses_first,
            "pipeline": server.report()["pipeline"],
            "timeline": server.report()["timeline"],
        }


def live_replay_smoke(store: TemporalCheckpointStore, cfg: GSConfig, *, device="cuda") -> dict:
    """Live-update smoke: replay the stored sequence through ONE serving
    slot. The store's per-timestep changed slots drive world-space
    invalidation: after the first viewer pose registers, later updates
    should drop only the tile rows the changed Gaussians can touch (partial
    invalidations), not the whole frame."""
    ts = store.timesteps()
    events: list[int | None] = []  # None = full drop, int = dirty row count
    with build_timeline_server(
        store, cfg, timesteps=ts[:1], n_levels=2, max_batch=2, store_frames=False, device=device
    ) as server:
        server.add_invalidation_listener(
            lambda t, rows: events.append(None if rows is None else len(rows))
        )
        cam = front_camera(server.pyramid, img_h=cfg.img_h, img_w=cfg.img_w)

        def view(_t=None):
            fut = server.submit(cam, timestep=ts[0])
            server.run()
            fut.result()

        view()  # registers the pose the invalidator projects through
        replay_live(store, server, timesteps=ts[1:], serve_timestep=ts[0], on_timestep=view)
        return {
            "updates": len(ts) - 1,
            "invalidations": events,
            "partial_invalidations": sum(1 for e in events if e is not None),
            "full_invalidations": sum(1 for e in events if e is None),
        }


def traced_overhead_gate(trainer: InsituTrainer, vol, *, probe_steps: int, budget: float) -> dict:
    """Bound what span tracing costs a warm train step (the training twin of
    the serving stack's traced-request gate). Three probe laps on the live
    model (warmup+untraced, untraced, traced), each through the real
    ``_fit`` loop on throwaway ``Obs`` bundles (the run's registry/ring stay
    clean). The traced lap is judged against the SLOWER untraced lap, so
    ordinary jitter doesn't fail the gate; a real regression (tracing adds
    more than ``budget`` fractional per-step overhead) does. On a mesh every
    rank runs the laps (they hold collectives)."""
    data = trainer._dataset(vol)
    saved = trainer.obs

    def lap(traced: bool) -> float:
        trainer.obs = Obs(trace=traced, trace_capacity=8 * probe_steps + 16)
        t0 = now()
        trainer._fit(data, probe_steps, psnr0=0.0)
        return since(t0)

    try:
        lap(False)  # warm caches/launches before anything is timed
        untraced = [lap(False), lap(False)]
        traced = lap(True)
    finally:
        trainer.obs = saved
    overhead = traced / max(max(untraced), 1e-9) - 1.0
    return {
        "probe_steps": probe_steps,
        "untraced_s": [round(t, 4) for t in untraced],
        "traced_s": round(traced, 4),
        "overhead": round(overhead, 4),
        "budget": budget,
        "ok": overhead <= budget,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device to train and serve on (default: the card; "
                                                       "cuda:LOCAL_RANK across ranks)")
    ap.add_argument("--smoke", action="store_true", help="reduced config (48px, 3 timesteps)")
    ap.add_argument("--dataset", choices=list(GENERATORS), default="miranda")
    ap.add_argument("--timesteps", type=int, default=4)
    ap.add_argument("--t1", type=float, default=0.3, help="simulation time of the last timestep")
    ap.add_argument("--volume-res", type=int, default=48)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-points", type=int, default=2000)
    ap.add_argument("--cold-steps", type=int, default=150)
    ap.add_argument("--warm-steps", type=int, default=30)
    ap.add_argument("--capacity-factor", type=float, default=1.5)
    ap.add_argument("--keyframe-interval", type=int, default=4)
    ap.add_argument("--raymarch-steps", type=int, default=48)
    ap.add_argument("--data-par", type=int, default=1, help="data-axis ranks (views); above 1: run under torchrun")
    ap.add_argument("--model-par", type=int, default=1, help="model-axis ranks (Gaussian shards, pixel strips)")
    ap.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="serving smoke: in-flight micro-batches (1 = synchronous dispatch)",
    )
    ap.add_argument(
        "--sync-store", action="store_true",
        help="write temporal checkpoints inline instead of on the background writer",
    )
    ap.add_argument("--ckpt", default=None, help="temporal store dir (default: temp dir)")
    ap.add_argument("--no-scrub", action="store_true", help="skip the serving smoke")
    ap.add_argument("--report", default=None, help="write the JSON report here too")
    ap.add_argument("--trace-out", default=None, metavar="PATH.jsonl",
                    help="record per-timestep/per-step span traces; write JSONL "
                         "here plus a Perfetto-viewable .chrome.json next to it")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="span ring size (oldest spans drop beyond this)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final train.* registry snapshot as JSON")
    ap.add_argument("--overhead-gate", type=int, default=0, metavar="STEPS",
                    help="probe-lap steps for the traced-step overhead gate "
                         "(0 = off); exits nonzero when tracing costs more "
                         "than --overhead-budget per step")
    ap.add_argument("--overhead-budget", type=float, default=0.25)
    args = ap.parse_args(argv)

    if args.smoke:
        args.timesteps = min(args.timesteps, 3)
        args.volume_res = min(args.volume_res, 32)
        args.res = min(args.res, 48)
        args.views = min(args.views, 6)
        args.max_points = min(args.max_points, 800)
        args.cold_steps = min(args.cold_steps, 40)
        args.warm_steps = min(args.warm_steps, 10)
        args.t1 = min(args.t1, 0.15)

    device = torch.device(args.device)
    ranks = args.data_par * args.model_par
    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh, owns_group = None, False
    if ranks > 1 or world > 1:
        if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
            raise SystemExit(f"insitu: --data-par {args.data_par} --model-par {args.model_par} runs one process per "
                             f"rank; launch it under torchrun: python -m torch.distributed.run --nproc-per-node "
                             f"{ranks} -m repro_torch.launch.insitu ...")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        if not dist.is_initialized():
            init_ranks(device)
            owns_group = True
        mesh = make_gs_mesh(args.data_par, args.model_par, device=device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("insitu: no CUDA device; pass --device cpu to run on the CPU")
    lead = mesh is None or mesh.rank == 0

    cfg = GSConfig(
        img_h=args.res, img_w=args.res, batch_size=args.batch,
        k_per_tile=128 if args.smoke else 256,
        max_steps=args.cold_steps + args.warm_steps * max(args.timesteps - 1, 0),
        densify_from=10**9, opacity_reset_interval=10**9,
    )
    stream = synthetic_stream(args.dataset, args.timesteps, res=args.volume_res, t1=args.t1)
    store_dir = args.ckpt or os.path.join(tempfile.mkdtemp(prefix="insitu_"), "seq")
    # context manager: queued background writes survive (flush + writer join)
    # even when a later stage of this driver raises; rank 0 keeps the store
    store_cm = TemporalCheckpointStore(
        store_dir, keyframe_interval=args.keyframe_interval, async_writes=not args.sync_store,
    ) if lead else contextlib.nullcontext()
    with store_cm as store:
        if lead and store.timesteps():
            raise SystemExit(
                f"temporal store {store_dir} already holds timesteps {store.timesteps()}; "
                "this driver records a fresh sequence from t=0 — pass a new --ckpt dir"
            )

        obs = Obs(trace=args.trace_out is not None, trace_capacity=args.trace_capacity)
        trainer = InsituTrainer(
            cfg, mesh, device=device,
            capacity_factor=args.capacity_factor,
            cold_steps=args.cold_steps, warm_steps=args.warm_steps,
            n_views=args.views, max_points=args.max_points,
            n_steps_raymarch=args.raymarch_steps, init_scale=0.06, verbose=lead,
            obs=obs,
        )
        where = f"mesh {mesh.shape} ({mesh.device}, rank 0)" if mesh is not None else f"device {device}"
        if lead:
            print(
                f"insitu: {args.dataset} x{args.timesteps} timesteps, vol {args.volume_res}^3, "
                f"{args.res}px, {where}, store {store_dir}"
            )
        reports = trainer.run(stream, store=store)
        balance = trainer.shard_balance(record=False)  # a collective on a mesh

        out = None
        if lead:
            out = {
                "config": {
                    "dataset": args.dataset, "timesteps": args.timesteps, "res": args.res,
                    "volume_res": args.volume_res, "capacity": trainer.capacity,
                    "cold_steps": args.cold_steps, "warm_steps": args.warm_steps,
                    "device": str(device), "mesh": mesh.shape if mesh is not None else None,
                },
                "timesteps": [
                    {k: v for k, v in dataclasses.asdict(r).items() if k != "psnr_curve"}
                    for r in reports
                ],
                "recompile_count": trainer.n_traces,
                "shard_balance": balance,
                "store": store.stats(),
            }
            if not args.no_scrub:
                out["scrub"] = scrub_smoke(
                    store, cfg, n_scrub=min(3, args.timesteps), pipeline_depth=args.pipeline_depth,
                    device=device,
                )
                if args.timesteps > 1:
                    out["live_replay"] = live_replay_smoke(store, cfg, device=device)

    if args.overhead_gate > 0:
        probe_vol = next(iter(synthetic_stream(args.dataset, 1, res=args.volume_res, t1=0.0)))
        gate = traced_overhead_gate(
            trainer, probe_vol, probe_steps=args.overhead_gate, budget=args.overhead_budget
        )
        if lead:
            out["traced_overhead"] = gate
    if owns_group:
        dist.destroy_process_group()
    if not lead:
        return

    txt = json.dumps(out, indent=1)
    print(txt)
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            f.write(txt)
    if args.metrics_out:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(obs.metrics.snapshot(), f, indent=1, sort_keys=True)
        print("metrics:", args.metrics_out)
    if args.trace_out:
        export_trace(obs.trace, args.trace_out, {
            "dataset": args.dataset, "timesteps": args.timesteps,
            "cold_steps": args.cold_steps, "warm_steps": args.warm_steps,
            "capacity": trainer.capacity,
            "data_par": args.data_par, "model_par": args.model_par,
        })

    if trainer.n_traces != 1:
        raise SystemExit(f"train step saw {trainer.n_traces} shape signatures, want 1")
    if not args.no_scrub:
        if not out["scrub"]["frames_distinct"]:
            raise SystemExit("scrubbed frames are not per-timestep distinct")
        if out["scrub"]["replay_new_misses"] != 0:
            raise SystemExit("scrub replay missed the frame cache")
    if args.overhead_gate > 0:
        g = out["traced_overhead"]
        if not g["ok"]:
            raise SystemExit(
                f"traced-step overhead gate FAILED: {g['overhead']:.1%} per step "
                f"(budget {g['budget']:.0%}) over {g['probe_steps']} probe steps"
            )
        print(f"traced-step overhead {g['overhead']:+.1%} (budget {g['budget']:.0%}) ok")
    ratio = out["store"]["delta_compression"]
    print(
        f"insitu ok: {len(reports)} timesteps, 1 train-step shape signature, "
        f"final PSNR {reports[-1].psnr_after:.2f} dB"
        + (f", delta frames {ratio}x smaller than keyframes" if ratio else "")
    )


if __name__ == "__main__":
    main()
