"""Foveated per-tile LOD + world-space invalidation: render cost vs quality,
on the PyTorch port (the mirror of ``benchmarks/lod_serving.py``, over the
port's ``RenderServer``; on the card by default, ``--device cpu`` serves
through the plain PyTorch versions).

Methodology: one synthetic isosurface scene served over an orbit trace,
measured in three phases:

  dirty    world-space dirty-row precision. Two identical tile servers take
           the same in situ update; one is handed the classic caller-computed
           dirty-row union (``dirty_rows=``), the other only the changed
           Gaussian *indices* (``changed=``) and must bound the damage itself
           by projecting the changed set through its registered viewer poses.
           The auto server must replay the orbit bitwise identically to the
           hand server with no more render work (its per-pose bounds can
           only be tighter than the all-pose union).
  foveate  per-tile foveated LOD. A uniform lap at the coverage level fills
           the tile cache; a foveated replay (gaze at frame center) reuses
           the sharp rows from cache and coarsens the periphery one pyramid
           level per row of distance. Gaze rows must stay BITWISE equal to
           the uniform frames; the assigned render cost (tile rows weighted
           by keep_ratio**level — the fraction of Gaussians each level
           keeps) must land strictly below uniform-finest.
  budget   budget-aware degradation. With the per-row cost estimate warmed
           by the foveated lap, requests carry a ``budget_ms`` of ~half the
           uniform-sharp frame cost; the server must shrink the sharp zone
           (coarse rows > 0) rather than blow the budget, and never coarsen
           the gaze row itself.

Exits nonzero if the auto-dirty replay diverges from the hand-dirty replay
by one ulp, if the auto server renders more than the hand server, if
foveated gaze rows differ from uniform, if the foveated cost is not below
uniform, or if the budget never degrades the periphery. Writes a
BENCH_lod.json perf-trajectory record (bench_schema). Every server is the
port's, so the replays and gaze rows are held to the port's own frames.

  PYTHONPATH=src python benchmarks/lod_serving_torch.py --smoke --out BENCH_lod.json
  PYTHONPATH=src python benchmarks/lod_serving_torch.py --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_schema import stage_breakdown, write_bench  # noqa: E402
from tile_serving_torch import build_server, perturb, projected_rows, top_slab_indices  # noqa: E402
from repro_torch.core import projection as P  # noqa: E402
from repro_torch.core.config import GSConfig  # noqa: E402
from repro_torch.launch.serve_gs import init_params_from_volume  # noqa: E402
from repro_torch.serve_gs import RenderServer, select_level_map  # noqa: E402
from repro_torch.volume.cameras import camera_slice, orbit_cameras  # noqa: E402


def lap(server, cams, **submit_kw) -> list:
    """Serve every pose once (fixed t=0); returns the frames in order."""
    return [server.submit(cam, **submit_kw).result() for cam in cams]


# --------------------------------------------------------- phase A: dirty rows
def run_dirty(params, idx, cams, cfg, cache_bytes, device) -> dict:
    """Hand-computed dirty-row union vs server-computed world-space bounds."""
    new_params = perturb(params, idx, step=0)
    hand_rows = projected_rows(
        [params, new_params], idx, cams, img_h=cfg.img_h, tile_h=cfg.tile_h, device=device
    )
    reports = {}
    frames = {}
    for kind in ("hand", "auto"):
        srv = build_server(params, cfg, tile_cache=True, cache_bytes=cache_bytes, device=device)
        srv.warmup(buckets=(1,))
        srv.warmup_tiles(levels=[0])
        lap(srv, cams)  # cold lap: fills tiles AND registers every pose
        if kind == "hand":
            srv.add_timestep(0, new_params, dirty_rows=hand_rows)
        else:
            srv.add_timestep(0, new_params, changed=idx)
        srv.reset_metrics()
        frames[kind] = lap(srv, cams)
        rep = srv.report()
        reports[kind] = {
            "renders_per_frame": rep["tiles"]["renders_per_frame"],
            "rows_rendered": rep["tiles"]["rows_rendered_partial"],
            "partial_hits": rep["tiles"]["partial_hits"],
            "frame_misses": rep["tiles"]["frame_misses"],
        }
        srv.close()

    for i, (a, b) in enumerate(zip(frames["auto"], frames["hand"])):
        if not np.array_equal(a, b):
            raise SystemExit(
                f"dirty phase, replay frame {i}: changed= server diverged from "
                f"dirty_rows= server (max abs diff {float(np.abs(a - b).max()):.3e})"
            )
    return {
        "hand_rows": sorted(hand_rows),
        "tiles_y": cfg.img_h // cfg.tile_h,
        "hand": reports["hand"],
        "auto": reports["auto"],
    }


# ----------------------------------------------------------- phase B: foveated
def run_foveated(params, cams, cfg, cache_bytes, *, n_levels, keep_ratio, device) -> tuple:
    """Uniform-finest lap, then a gaze-centered foveated replay of the same
    orbit on the same server; returns the phase report plus the live server
    for the budget phase (caller closes)."""
    srv = RenderServer(
        params, cfg, device=device, n_levels=n_levels, keep_ratio=keep_ratio, max_batch=4,
        cache_bytes=cache_bytes, tile_cache=True, store_frames=False,
    )
    tiles_y = cfg.img_h // cfg.tile_h
    n_built = srv.pyramid.n_levels
    srv.warmup(buckets=(1,))
    srv.warmup_tiles()  # every (level, row) strip: latency below excludes traces

    # the level maps the server will assign (identical code path): sharp rows
    # sit at the coverage level, so they can reuse the uniform lap's tiles.
    # Gaze at the TOP edge: with only a handful of tile rows a centered gaze
    # keeps every row inside the sharp zone (nothing to coarsen)
    gaze = (0.5, 0.0)
    gaze_row = min(int(gaze[1] * tiles_y), tiles_y - 1)
    maps = [
        select_level_map(
            srv.pyramid, cam, img_w=cfg.img_w, tiles_y=tiles_y,
            gaze_row=gaze_row, n_levels=n_built, keep_ratio=keep_ratio,
        )
        for cam in cams
    ]
    if any(len(set(m)) == 1 for m in maps):
        raise SystemExit(
            f"foveate phase degenerate: uniform level map {maps} — the orbit "
            f"poses sit too deep in the {n_built}-level pyramid to coarsen"
        )

    srv.reset_metrics()
    uniform = lap(srv, cams)
    rep_u = srv.report()
    units_uniform = sum(
        keep_ratio ** lvl * n for lvl, n in enumerate(rep_u["lod"]["rows_per_level"])
    )
    p99_uniform = rep_u["latency_ms"]["p99"]

    srv.reset_metrics()
    fov = lap(srv, cams, gaze=gaze)
    rep_f = srv.report()
    units_fov = sum(
        keep_ratio ** lvl * n for lvl, n in enumerate(rep_f["lod"]["rows_per_level"])
    )
    th = cfg.tile_h
    for i, (uf, ff, m) in enumerate(zip(uniform, fov, maps)):
        base = min(m)
        for r in range(tiles_y):
            if m[r] == base and not np.array_equal(
                uf[r * th:(r + 1) * th], ff[r * th:(r + 1) * th]
            ):
                raise SystemExit(
                    f"foveate phase, pose {i} row {r}: gaze row (level {base}) "
                    f"diverged from the uniform-finest frame"
                )
    return {
        "levels_built": n_built,
        "level_maps": sorted(set(maps)),
        "uniform": {
            "cost_units": round(units_uniform, 3),
            "rows_per_level": rep_u["lod"]["rows_per_level"],
            "p99_ms": p99_uniform,
        },
        "foveated": {
            "cost_units": round(units_fov, 3),
            "rows_per_level": rep_f["lod"]["rows_per_level"],
            "p99_ms": rep_f["latency_ms"]["p99"],
            "requests": rep_f["lod"]["foveated_requests"],
            "full_hits": rep_f["tiles"]["full_hits"],
            "partial_hits": rep_f["tiles"]["partial_hits"],
        },
        "row_cost_ms": rep_f["lod"]["row_cost_ms"],
    }, srv


# ------------------------------------------------------------- phase C: budget
def run_budget(srv, cams, cfg, *, keep_ratio, frac=0.5) -> dict:
    """Requests carrying ``budget_ms`` ~= ``frac`` of the uniform-sharp frame
    cost must degrade the periphery (coarse rows) but never the gaze row."""
    tiles_y = cfg.img_h // cfg.tile_h
    row_cost = srv.report()["lod"]["row_cost_ms"]
    if not row_cost:
        raise SystemExit("budget phase: row cost estimate never warmed up")
    gaze = (0.5, 0.0)
    gaze_row = min(int(gaze[1] * tiles_y), tiles_y - 1)
    base = min(
        select_level_map(
            srv.pyramid, cams[0], img_w=cfg.img_w, tiles_y=tiles_y,
            gaze_row=gaze_row, n_levels=srv.pyramid.n_levels, keep_ratio=keep_ratio,
        )
    )
    budget_ms = frac * row_cost * tiles_y * keep_ratio ** base
    srv.reset_metrics()
    frames = lap(srv, cams, gaze=gaze, budget_ms=budget_ms)
    rep = srv.report()
    rows = rep["lod"]["rows_per_level"]
    coarse = sum(n for lvl, n in enumerate(rows) if lvl > base)
    if not all(f.shape == (cfg.img_h, cfg.img_w, 3) for f in frames):
        raise SystemExit(f"budget phase: a frame is not ({cfg.img_h}, {cfg.img_w}, 3)")
    return {
        "budget_ms": round(budget_ms, 4),
        "row_cost_ms": row_cost,
        "base_level": base,
        "rows_per_level": rows,
        "coarse_rows": coarse,
        "sharp_rows": rows[base] if base < len(rows) else 0,
        "p99_ms": rep["latency_ms"]["p99"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda", help="torch device to serve on (default: the card)")
    ap.add_argument("--dataset", default="kingsnake")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--volume-res", type=int, default=48)
    ap.add_argument("--max-points", type=int, default=2000)
    ap.add_argument("--orbit-views", type=int, default=12)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--keep-ratio", type=float, default=0.5)
    ap.add_argument("--update-frac", type=float, default=0.12)
    ap.add_argument("--cache-mb", type=float, default=64.0)
    ap.add_argument("--out", default=None, help="write the BENCH_lod.json record here")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("lod_serving_torch: no CUDA device; pass --device cpu to serve on the CPU")

    if args.smoke:
        args.res, args.volume_res, args.max_points = 48, 32, 600
        args.orbit_views = 6

    params = init_params_from_volume(
        args.dataset, volume_res=args.volume_res, max_points=args.max_points
    )
    cfg = GSConfig(img_h=args.res, img_w=args.res, k_per_tile=64 if args.smoke else 128)
    cache_bytes = int(args.cache_mb * (1 << 20))
    cams = orbit_cameras(
        args.orbit_views, img_h=args.res, img_w=args.res, radius=5.0,
        elev_cycles=0.0, elev_max_deg=0.0,
    )
    orbit = [
        P.Camera(*[np.asarray(x) for x in camera_slice(cams, i)])
        for i in range(args.orbit_views)
    ]
    idx = top_slab_indices(params, args.update_frac)

    dirty = run_dirty(params, idx, orbit, cfg, cache_bytes, args.device)
    fov, srv = run_foveated(
        params, orbit, cfg, cache_bytes,
        n_levels=args.levels, keep_ratio=args.keep_ratio, device=args.device,
    )
    try:
        budget = run_budget(srv, orbit, cfg, keep_ratio=args.keep_ratio)
        stages = stage_breakdown(srv.obs.metrics.snapshot(), prefix="server.")
    finally:
        srv.close()

    report = {
        "scene": {"dataset": args.dataset, "gaussians": params.n, "res": args.res,
                  "changed_gaussians": int(idx.size)},
        "orbit_views": args.orbit_views,
        "device": torch.cuda.get_device_name(args.device) if torch.device(args.device).type == "cuda" else "cpu",
        "dirty": dirty,
        "foveate": fov,
        "budget": budget,
    }
    print(json.dumps(report, indent=1))

    if args.out:
        write_bench(
            args.out, "lod_serving",
            config={
                "res": args.res, "gaussians": params.n,
                "orbit_views": args.orbit_views, "levels": args.levels,
                "keep_ratio": args.keep_ratio, "update_frac": args.update_frac,
                "smoke": args.smoke, "device": report["device"],
            },
            metrics={
                "dirty_renders_per_frame_auto": dirty["auto"]["renders_per_frame"],
                "dirty_renders_per_frame_hand": dirty["hand"]["renders_per_frame"],
                "dirty_rows_hand": len(dirty["hand_rows"]),
                "fov_cost_units": fov["foveated"]["cost_units"],
                "uniform_cost_units": fov["uniform"]["cost_units"],
                "fov_vs_uniform": round(
                    fov["foveated"]["cost_units"] / max(fov["uniform"]["cost_units"], 1e-9), 4
                ),
                "fov_p99_ms": fov["foveated"]["p99_ms"],
                "uniform_p99_ms": fov["uniform"]["p99_ms"],
                "budget_p99_ms": budget["p99_ms"],
                "budget_coarse_rows": budget["coarse_rows"],
                "row_cost_ms": budget["row_cost_ms"],
            },
            stages=stages,
        )

    # ---- hard acceptance: precision and the foveated economy must hold
    failures = []
    if dirty["auto"]["renders_per_frame"] > dirty["hand"]["renders_per_frame"]:
        failures.append(
            f"dirty: auto bounds render MORE than the hand union "
            f"({dirty['auto']['renders_per_frame']} vs "
            f"{dirty['hand']['renders_per_frame']} renders/frame)"
        )
    if not fov["foveated"]["cost_units"] < fov["uniform"]["cost_units"]:
        failures.append(
            f"foveate: assigned cost {fov['foveated']['cost_units']} units not "
            f"below uniform-finest {fov['uniform']['cost_units']}"
        )
    if budget["coarse_rows"] <= 0:
        failures.append("budget: periphery never degraded under a half-cost budget")
    if failures:
        raise SystemExit("; ".join(failures))
    print(
        f"lod serving ok: auto dirty bounds {dirty['auto']['renders_per_frame']} "
        f"renders/frame vs hand {dirty['hand']['renders_per_frame']} "
        f"(rows {dirty['hand_rows']} of {dirty['tiles_y']}); foveated "
        f"{fov['foveated']['cost_units']} cost units vs uniform "
        f"{fov['uniform']['cost_units']} with gaze rows bitwise equal; "
        f"budget {budget['budget_ms']}ms -> {budget['coarse_rows']} coarse rows"
    )


if __name__ == "__main__":
    main()
