"""Render-serving throughput of the PyTorch port across ranks: batched vs
serial, pipelined vs sync, LOD speed, cache effect, in-flight dedup (the
mirror of ``benchmarks/serve_throughput.py``, with its scenarios and
report keys).

One process per rank under torchrun: NCCL with one rank per card
(``cuda:LOCAL_RANK``), or gloo ranks on the CPU with ``--device cpu``.
Without torchrun it runs one rank. Methodology as in the JAX file: one
synthetic isosurface scene, one fixed request set (a multi-client orbit
wavefront), measured after warmup:

  serial    — max_batch=1, cache off, ``mesh=None`` on the lead alone: one
              render dispatch per request
  batched   — max_batch=B, cache off, on a (world, 1) mesh: each
              micro-batch renders its views split over the data ranks
  cached    — max_batch=B, cache on, shared-orbit clients: revisited poses
  sync      — duplicate-heavy trace, pipeline depth 1, max_batch=world
  pipelined — the same trace at --pipeline-depth (default 2)

plus the batched render time of one fixed batch per LOD level, timed on a
one-device server on the lead (a mesh server's render fn run outside its
dispatch would leave the followers behind). Rank 0 (the lead) prints one
JSON report; every other rank serves until the lead closes each server.
Exits nonzero if any scenario completes fewer requests than were submitted.

  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      benchmarks/serve_throughput_torch.py --smoke --device cpu --out report.json
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      benchmarks/serve_throughput_torch.py --res 512 --volume-res 96 --max-points 40000

``--config-from RECOMMEND.json`` takes ``max_batch`` and ``pipeline_depth``
from a recommendation that ``python -m repro_torch.launch.tune`` wrote (or a
bare knob dict), as the JAX benchmark does.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from bench_schema import stage_breakdown, write_bench  # noqa: E402
from repro_torch.core.config import GSConfig  # noqa: E402
from repro_torch.launch.mesh import init_ranks, make_gs_mesh  # noqa: E402
from repro_torch.launch.serve_gs import init_params_from_volume  # noqa: E402
from repro_torch.launch.tune import load_recommended_knobs  # noqa: E402
from repro_torch.serve_gs import RenderServer, make_clients, run_load  # noqa: E402
from repro_torch.serve_gs.batcher import stack_cameras  # noqa: E402


def build_server(params, cfg, *, mesh, device, max_batch, cache_capacity, n_levels, keep_ratio,
                 pipeline_depth=1):
    return RenderServer(
        params,
        cfg,
        mesh=mesh,
        device=device,
        n_levels=n_levels,
        keep_ratio=keep_ratio,
        max_batch=max_batch,
        cache_capacity=cache_capacity,
        store_frames=False,
        pipeline_depth=pipeline_depth,
    )


def served(body, params, cfg, **kw):
    """Build a server (a collective on a mesh); the lead runs ``body(server)``
    and closes it, every other rank serves until then and gets None."""
    with build_server(params, cfg, **kw) as srv:
        if not srv.is_lead:
            srv.serve_follower()
            return None
        return body(srv)


def drive(server, *, n_clients, requests, n_views, res, radius_spread, dup_pairs=False,
          flush_every_round=True):
    clients = make_clients(
        n_clients, n_views=n_views, img_h=res, img_w=res, radius_spread=radius_spread,
        dup_pairs=dup_pairs,
    )
    rep = run_load(
        server, clients, requests_per_client=requests, flush_every_round=flush_every_round
    )
    submitted = n_clients * requests
    if rep["completed"] != submitted:
        raise SystemExit(
            f"serving path dropped requests: completed {rep['completed']} of {submitted}"
        )
    return rep


def _wait(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def time_level(server, level, *, batch, repeats=3):
    """Median seconds for one batched render call at a pyramid level (a
    one-device server: its render fn has no followers to leave behind)."""
    cam = make_clients(1, n_views=8, img_h=server.cfg.img_h, img_w=server.cfg.img_w)[0].next_camera()
    cams = stack_cameras([cam] * batch)
    lp = server._level_params[level]
    render = server._level_render[level]
    _wait(render(lp, cams))  # first call outside the timing
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _wait(render(lp, cams))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(args, mesh, device) -> tuple[dict, dict] | None:
    """Every scenario: on the lead the report and the pipelined lap's
    metrics snapshot, None on the other ranks."""
    lead = mesh.rank == 0
    world = mesh.data.size
    params = init_params_from_volume(
        args.dataset, volume_res=args.volume_res, max_points=args.max_points
    )
    cfg = GSConfig(img_h=args.res, img_w=args.res, k_per_tile=128 if args.smoke else 256)
    common = dict(params=params, cfg=cfg, device=device, n_levels=args.levels, keep_ratio=args.keep_ratio)
    load = dict(
        n_clients=args.clients, requests=args.requests, n_views=12,
        res=args.res, radius_spread=0.0,  # same level for all: isolates batching
    )

    # ---- serial baseline: one request per dispatch, the lead alone, no cache
    def serial_body(srv):
        srv.warmup(buckets=(1,))
        return drive(srv, **load)

    rep_serial = served(serial_body, mesh=None, max_batch=1, cache_capacity=0, **common) if lead else None

    # ---- micro-batched: same request set, no cache. Each round's wavefront
    # (one request per client, all same level) coalesces into one dispatch,
    # its views split over the data ranks.
    def batched_body(srv):
        wave = srv.batcher.bucket_for(min(args.clients, srv.batcher.max_batch))
        srv.warmup(buckets=(wave,))
        return drive(srv, **load), wave, list(srv.pyramid.live_counts)

    batched = served(batched_body, mesh=mesh, max_batch=args.max_batch, cache_capacity=0, **common)

    # ---- cached: shared-orbit clients revisit poses across LOD rings
    # (the tile-granular cache path)
    def cached_body(srv):
        bucket = srv.batcher.bucket_for
        srv.warmup(buckets=tuple(sorted({bucket(n) for n in (1, 2, args.clients)})))
        return drive(srv, **dict(load, radius_spread=1.0))

    rep_cached = served(cached_body, mesh=mesh, max_batch=args.max_batch, cache_capacity=512, **common)

    # ---- pipelined vs sync on a duplicate-heavy trace, cache off; one view
    # per rank per micro-batch; a warm lap, then best-of-2 measured windows
    # over a fresh metrics slate
    dup_load = dict(load, radius_spread=0.0, dup_pairs=True, flush_every_round=False)

    def depth_body(traced_lap):
        def body(srv):
            srv.warmup(buckets=srv.batcher.buckets)
            drive(srv, **dup_load)  # warm lap: allocator + dispatch paths hot
            best, best_snap, lap_fps = None, {}, []
            for _ in range(2):
                srv.reset_metrics()
                rep = drive(srv, **dup_load)
                lap_fps.append(rep["frames_per_s"])
                snap = srv.obs.metrics.snapshot()
                if best is None or rep["frames_per_s"] > best["frames_per_s"]:
                    best, best_snap = rep, snap
            tracing = None
            if traced_lap:
                # the same trace with the span recorder live; overhead judged
                # against the SLOWER untraced lap
                srv.obs.enable_trace()
                srv.reset_metrics()
                rep_t = drive(srv, **dup_load)
                spans = srv.obs.trace.drain()
                tracing = {
                    "traced_frames_per_s": rep_t["frames_per_s"],
                    "spans": len(spans),
                    "dropped": srv.obs.trace.dropped,
                    "overhead": round(1.0 - rep_t["frames_per_s"] / max(min(lap_fps), 1e-9), 3),
                }
                srv.obs.disable_trace()
            return best, best_snap, tracing
        return body

    sync = served(depth_body(False), mesh=mesh, max_batch=world, cache_capacity=0, pipeline_depth=1, **common)
    pipe = served(depth_body(True), mesh=mesh, max_batch=world, cache_capacity=0,
                  pipeline_depth=args.pipeline_depth, **common)
    if not lead:
        return None
    rep_batched, wave, live_counts = batched
    rep_sync = sync[0]
    rep_pipe, pipe_snap, tracing = pipe

    # ---- per-LOD render speed for one fixed batch, on the lead alone
    def lod_body(srv):
        return [round(time_level(srv, lvl, batch=wave) * 1e3, 3) for lvl in range(srv.pyramid.n_levels)]

    lod_ms = served(lod_body, mesh=None, max_batch=wave, cache_capacity=0, **common)

    report = {
        "scene": {"dataset": args.dataset, "gaussians": params.n, "res": args.res},
        "devices": world,
        "mesh": [world, 1],
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "request_set": {"clients": args.clients, "requests_per_client": args.requests},
        "serial": {"frames_per_s": rep_serial["frames_per_s"], "latency_ms": rep_serial["latency_ms"]},
        "batched": {
            "max_batch": args.max_batch,
            "frames_per_s": rep_batched["frames_per_s"],
            "latency_ms": rep_batched["latency_ms"],
            "mean_batch": rep_batched["render"]["mean_batch"],
            "control": rep_batched["mesh"],
        },
        "batched_speedup": round(
            rep_batched["frames_per_s"] / max(rep_serial["frames_per_s"], 1e-9), 3
        ),
        "cached": {
            "frames_per_s": rep_cached["frames_per_s"],
            "cache": rep_cached["cache"],
            "tiles": rep_cached["tiles"],
            "requests_per_level": rep_cached["lod"]["requests_per_level"],
        },
        "sync": {
            "frames_per_s": rep_sync["frames_per_s"],
            "latency_ms": rep_sync["latency_ms"],
            "pipeline": rep_sync["pipeline"],
        },
        "pipelined": {
            "frames_per_s": rep_pipe["frames_per_s"],
            "latency_ms": rep_pipe["latency_ms"],
            "pipeline": rep_pipe["pipeline"],
        },
        "pipeline_speedup": round(
            rep_pipe["frames_per_s"] / max(rep_sync["frames_per_s"], 1e-9), 3
        ),
        "deduped": rep_pipe["pipeline"]["deduped"],
        "tracing": tracing,
        "lod": {
            "live_counts": live_counts,
            "batch_render_ms": lod_ms,
            "coarsest_vs_full_speedup": round(lod_ms[0] / max(lod_ms[-1], 1e-9), 3),
        },
    }
    return report, pipe_snap


def config_from(args) -> None:
    """Set ``args``' engine knobs from ``--config-from`` (the tuner's
    recommendation), as ``benchmarks/serve_throughput.py`` does."""
    knobs = load_recommended_knobs(args.config_from)
    if "max_batch" in knobs:
        args.max_batch = int(knobs["max_batch"])
    if "pipeline_depth" in knobs:
        args.pipeline_depth = int(knobs["pipeline_depth"])
    print(f"config-from {args.config_from}: max_batch={args.max_batch} "
          f"pipeline_depth={args.pipeline_depth}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="reduced CPU config")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card, cuda:LOCAL_RANK under torchrun)")
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--volume-res", type=int, default=48)
    ap.add_argument("--max-points", type=int, default=3000)
    ap.add_argument("--dataset", default="kingsnake")
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--keep-ratio", type=float, default=0.5)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="in-flight depth for the pipelined scenario (sync baseline is 1)",
    )
    ap.add_argument("--config-from", default=None, metavar="RECOMMEND.json",
                    help="take max_batch / pipeline_depth from a launch.tune "
                    "recommendation (or a bare knob dict)")
    ap.add_argument(
        "--max-trace-overhead", type=float, default=0.25,
        help="fail if the span-traced lap loses more than this fraction of "
        "fps vs the slower untraced lap",
    )
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--bench-out", default=None,
        help="also write a flat BENCH_*.json record (bench_schema)",
    )
    args = ap.parse_args(argv)

    if args.config_from:
        config_from(args)
    if args.smoke:
        args.res, args.volume_res, args.max_points = 32, 32, 800
        args.requests = min(args.requests, 6)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("serve_throughput_torch: no CUDA device; pass --device cpu to serve on the CPU")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if "WORLD_SIZE" in os.environ:
        init_ranks(device)
    else:  # one rank, no launcher
        init_ranks(device, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_gs_mesh(dist.get_world_size(), 1, device=device)
        result = run(args, mesh, device)
    finally:
        dist.destroy_process_group()
    if result is None:
        return
    report, pipe_snap = result
    out = json.dumps(report, indent=1)
    print(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(out)
    tracing = report["tracing"]
    if args.bench_out:
        write_bench(
            args.bench_out, "serve_throughput_torch",
            config={
                "clients": args.clients, "requests_per_client": args.requests,
                "res": args.res, "gaussians": report["scene"]["gaussians"], "devices": report["devices"],
                "device": report["device"], "max_batch": args.max_batch,
                "pipeline_depth": args.pipeline_depth, "smoke": args.smoke,
            },
            metrics={
                "frames_per_s": report["pipelined"]["frames_per_s"],
                "p50_ms": report["pipelined"]["latency_ms"]["p50"],
                "p99_ms": report["pipelined"]["latency_ms"]["p99"],
                "sync_frames_per_s": report["sync"]["frames_per_s"],
                "pipeline_speedup": report["pipeline_speedup"],
                "batched_speedup": report["batched_speedup"],
                "serial_frames_per_s": report["serial"]["frames_per_s"],
                "cached_frames_per_s": report["cached"]["frames_per_s"],
                "deduped": report["deduped"],
                "cached_renders_per_frame": report["cached"]["tiles"]["renders_per_frame"],
                "tile_cache_hit_rate": report["cached"]["cache"]["hit_rate"],
                "tile_dedup_bytes_saved": report["cached"]["cache"]["tiles"]["dedup_bytes_saved"],
                "trace_spans": tracing["spans"],
                "trace_overhead": tracing["overhead"],
            },
            stages=stage_breakdown(pipe_snap, prefix="server."),
        )

    if tracing["dropped"]:
        raise SystemExit(
            f"span ring overflowed during the traced lap: {tracing['dropped']} spans dropped"
        )
    if tracing["overhead"] > args.max_trace_overhead:
        raise SystemExit(
            f"tracing overhead {tracing['overhead']} exceeds budget "
            f"{args.max_trace_overhead} (traced {tracing['traced_frames_per_s']} "
            f"fps vs untraced floor)"
        )


if __name__ == "__main__":
    main()
