"""Tile-granular serving vs the whole-frame baseline: renders and bytes, on
the PyTorch port (the mirror of ``benchmarks/tile_serving.py``, over the
port's ``RenderServer``; on the card by default, ``--device cpu`` serves
through the plain PyTorch versions).

Methodology: one synthetic isosurface scene served twice — by a
tile-granular server (tile cache + dirty-row invalidation + partial strip
renders) and by a whole-frame baseline with the SAME cache byte budget —
over two viewer traces drawn from the paper's workloads:

  orbit   a viewer orbits the scene (lap 1, cold), an in situ update then
          perturbs the Gaussians in one world slab (changes confined to a
          few screen tile rows for every orbit pose, verified by
          projection), and the viewer replays the orbit (lap 2). The
          baseline must re-render every frame; the tile server re-renders
          only the dirty rows.
  scrub   a fixed camera drags the time slider back and forth over a
          recorded timeline (lap 1, cold on the way out, revisits on the
          way back), every timestep then receives a localized refinement
          update, and the viewer scrubs again (lap 2).

Wire cost is measured by feeding the served frame sequences to the v2
``tiles8`` changed-tile encoder and to the v1 ``zdelta8`` whole-frame-delta
encoder (full message bytes, headers included).

Every lap-2 tile-server frame is checked BITWISE against the baseline's
full re-render — the benchmark exits nonzero if the tile path diverges by
one ulp, if tiles-on-wire is not strictly below the frame-delta baseline,
or if the tile server's render work is not strictly below the baseline's.
Both servers are the port's, so the tile path is held to the port's own
frames (its strips are bitwise its frames' rows on both devices; the JAX
package's are not on jax 0.9.0, ``ROADMAP.md`` queue C). The dirty rows
are proven by projecting the changed set on the serving device.
Writes a BENCH_tiles.json perf-trajectory record (bench_schema).

  PYTHONPATH=src python benchmarks/tile_serving_torch.py --smoke --out BENCH_tiles.json
  PYTHONPATH=src python benchmarks/tile_serving_torch.py --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from bench_schema import stage_breakdown, write_bench  # noqa: E402
from repro_torch.core import gaussians as G  # noqa: E402
from repro_torch.core import projection as P  # noqa: E402
from repro_torch.core.config import GSConfig  # noqa: E402
from repro_torch.frontend import protocol as proto  # noqa: E402
from repro_torch.frontend.encode import FrameEncoder  # noqa: E402
from repro_torch.launch.serve_gs import init_params_from_volume  # noqa: E402
from repro_torch.serve_gs import RenderServer  # noqa: E402
from repro_torch.volume.cameras import camera_slice, orbit_cameras  # noqa: E402


# --------------------------------------------------------------- scene edits
def top_slab_indices(params, frac: float) -> np.ndarray:
    """Gaussians in the scene's top world-z slab (the 'update region')."""
    z = np.asarray(params.means)[:, 2]
    return np.nonzero(z >= np.quantile(z, 1.0 - frac))[0]


def perturb(params, idx: np.ndarray, step: int, scale: float = 0.01):
    """Deterministically nudge the slab's Gaussians (one update tick)."""
    rng = np.random.default_rng(1000 + step)
    means = np.asarray(params.means).copy()
    means[idx] += rng.normal(0, scale, (idx.size, 3)).astype(np.float32)
    return params._replace(means=means)


def projected_rows(params_list, idx, cams, *, img_h, tile_h, device="cpu") -> set[int]:
    """Union of tile rows covered by ``idx`` Gaussians' screen footprints
    across every listed model and pose — the exact dirty-row bound the
    in situ updater would compute from its changed set (projected on the
    serving ``device``, as the servers project)."""
    rows: set[int] = set()
    tiles_y = img_h // tile_h
    for params in params_list:
        model = G.GaussianModel(*params).to(device)
        for cam in cams:
            with torch.no_grad():
                packed = P.project(model, cam).cpu().numpy()
            my, rad = packed[idx, P.MY], packed[idx, P.RAD]
            live = rad > 0
            for y, r in zip(my[live], rad[live]):
                lo = max(int(np.floor((y - r) / tile_h)), 0)
                hi = min(int(np.floor((y + r) / tile_h)), tiles_y - 1)
                rows.update(range(lo, hi + 1))
    return rows


# ------------------------------------------------------------------- serving
def build_server(params, cfg, *, tile_cache, cache_bytes, device, max_batch=4):
    return RenderServer(
        params, cfg, device=device, n_levels=1, max_batch=max_batch, cache_bytes=cache_bytes,
        tile_cache=tile_cache, store_frames=False,
    )


def lap(server, reqs) -> tuple[list, dict]:
    """Serve one trace lap; returns (frames, per-lap tile/render report)."""
    server.reset_metrics()
    frames = []
    for ts, cam in reqs:
        frames.append(server.submit(cam, timestep=ts).result())
    rep = server.report()
    return frames, {
        "renders_per_frame": rep["tiles"]["renders_per_frame"],
        "render_calls": rep["render"]["calls"],
        "cache": rep["cache"],
        "frames_per_s": rep["frames_per_s"],
    }


def wire_bytes(frames, *, tiles: bool, tile) -> tuple[int, dict]:
    """Full on-wire bytes (headers included) for a frame sequence."""
    enc = FrameEncoder(tiles=tiles, tile=tile)
    total = 0
    for i, f in enumerate(frames):
        meta, payload = enc.encode("s", f)
        header = {"type": proto.FRAME, "seq": i, "stream": "s", **meta}
        total += len(proto.pack_message(header, payload))
    return total, enc.stats()


def run_trace(name, params_by_ts, update_by_ts, dirty_rows, reqs, cfg, cache_bytes, device):
    """Drive one trace through the tile server and the whole-frame baseline:
    cold lap -> localized update -> replay lap. Returns the trace report;
    raises SystemExit if the tile path is not bitwise the baseline."""
    servers = {}
    laps = {}
    stages = {}
    for kind, tiled in (("tile", True), ("frame", False)):
        ts0 = sorted(params_by_ts)[0]
        srv = build_server(
            params_by_ts[ts0], cfg, tile_cache=tiled, cache_bytes=cache_bytes, device=device
        )
        for t in sorted(params_by_ts)[1:]:
            srv.add_timestep(t, params_by_ts[t])
        srv.warmup(buckets=(1,))
        if tiled:
            srv.warmup_tiles(levels=[0], rows=sorted(dirty_rows))
        servers[kind] = srv
        cold = lap(srv, reqs)
        # the in situ update: same new models, but only the tile server can
        # exploit the bounded dirty region — the baseline drops whole frames
        for t, new_params in update_by_ts.items():
            srv.add_timestep(t, new_params, dirty_rows=dirty_rows if tiled else None)
        warm = lap(srv, reqs)
        laps[kind] = {"cold": cold, "update_replay": warm}
        if tiled:
            # stage breakdown of the replay window (lap() resets the unified
            # registry on entry, so this snapshot covers exactly that lap)
            stages = stage_breakdown(srv.obs.metrics.snapshot(), prefix="server.")

    # ---- bitwise equivalence: tile-path frames == baseline full re-renders
    for phase in ("cold", "update_replay"):
        for i, (a, b) in enumerate(zip(laps["tile"][phase][0], laps["frame"][phase][0])):
            if not np.array_equal(a, b):
                raise SystemExit(
                    f"{name} trace, {phase} frame {i}: tile path diverged "
                    f"from the whole-frame baseline (max abs diff "
                    f"{float(np.abs(a - b).max()):.3e})"
                )

    # ---- wire cost over the full served sequence (cold + replay)
    seq = laps["tile"]["cold"][0] + laps["tile"]["update_replay"][0]
    tile_shape = (cfg.tile_h, cfg.tile_w)
    bytes_tiles, enc_tiles = wire_bytes(seq, tiles=True, tile=tile_shape)
    bytes_delta, enc_delta = wire_bytes(seq, tiles=False, tile=tile_shape)
    bytes_raw = enc_delta["bytes_raw_equiv"]

    for srv in servers.values():
        srv.close()
    return {
        "stages": stages,  # popped (not printed) by main; BENCH-record only
        "requests_per_lap": len(reqs),
        "dirty_rows": sorted(dirty_rows),
        "tiles_y": cfg.img_h // cfg.tile_h,
        "renders_per_frame": {
            "tile_cold": laps["tile"]["cold"][1]["renders_per_frame"],
            "tile_replay": laps["tile"]["update_replay"][1]["renders_per_frame"],
            "frame_cold": laps["frame"]["cold"][1]["renders_per_frame"],
            "frame_replay": laps["frame"]["update_replay"][1]["renders_per_frame"],
        },
        "tile_cache": laps["tile"]["update_replay"][1]["cache"],
        "wire": {
            "raw_bytes": bytes_raw,
            "tiles8_bytes": bytes_tiles,
            "zdelta8_bytes": bytes_delta,
            "tiles_vs_delta": round(bytes_tiles / max(bytes_delta, 1), 4),
            "tiles_shipped_frac": enc_tiles["tiles_shipped_frac"],
            "raw_fallbacks": enc_tiles["raw_fallbacks"] + enc_delta["raw_fallbacks"],
        },
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
    ap.add_argument("--timeline-steps", type=int, default=6)
    ap.add_argument("--update-frac", type=float, default=0.12,
                    help="fraction of Gaussians (top world-z slab) the in "
                    "situ update touches")
    ap.add_argument("--cache-mb", type=float, default=64.0)
    ap.add_argument("--out", default=None,
                    help="write the BENCH_tiles.json record here")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tile_serving_torch: no CUDA device; pass --device cpu to serve on the CPU")

    if args.smoke:
        args.res, args.volume_res, args.max_points = 48, 32, 600
        args.orbit_views, args.timeline_steps = 8, 4

    params = init_params_from_volume(
        args.dataset, volume_res=args.volume_res, max_points=args.max_points
    )
    cfg = GSConfig(img_h=args.res, img_w=args.res, k_per_tile=64 if args.smoke else 128)
    cache_bytes = int(args.cache_mb * (1 << 20))
    idx = top_slab_indices(params, args.update_frac)

    # ---- orbit trace: flat circular orbit (elev 0) so the top-z slab stays
    # in the top screen rows for every pose; far enough that background
    # tiles exist (the changed-tile wire win) — poses chosen, rows PROVEN
    # below by projecting the changed set through every pose
    cams = orbit_cameras(
        args.orbit_views, img_h=args.res, img_w=args.res, radius=5.0,
        elev_cycles=0.0, elev_max_deg=0.0,
    )
    orbit_cams = [
        P.Camera(*[np.asarray(x) for x in camera_slice(cams, i)])
        for i in range(args.orbit_views)
    ]
    orbit_update = {0: perturb(params, idx, step=0)}
    orbit_rows = projected_rows(
        [params, orbit_update[0]], idx, orbit_cams, img_h=args.res, tile_h=cfg.tile_h, device=args.device
    )
    tiles_y = args.res // cfg.tile_h
    orbit = run_trace(
        "orbit", {0: params}, orbit_update, orbit_rows,
        [(0, c) for c in orbit_cams], cfg, cache_bytes, args.device,
    )

    # ---- time-scrub trace: fixed camera, timeline whose steps drift the
    # slab; the update then refines every timestep's slab in place
    scrub_cam = orbit_cams[0]
    timeline = {
        t: perturb(params, idx, step=t, scale=0.004 * t)
        for t in range(args.timeline_steps)
    }
    scrub_update = {
        t: perturb(timeline[t], idx, step=100 + t, scale=0.004)
        for t in range(args.timeline_steps)
    }
    scrub_rows = projected_rows(
        list(timeline.values()) + list(scrub_update.values()), idx, [scrub_cam],
        img_h=args.res, tile_h=cfg.tile_h, device=args.device,
    )
    # the slider drags out and back: revisited timesteps are tile-store refs
    scrub_order = list(range(args.timeline_steps)) + list(
        range(args.timeline_steps - 2, -1, -1)
    )
    scrub = run_trace(
        "scrub", timeline, scrub_update, scrub_rows,
        [(t, scrub_cam) for t in scrub_order], cfg, cache_bytes, args.device,
    )

    stages = {
        **{f"orbit.{k}": v for k, v in orbit.pop("stages").items()},
        **{f"scrub.{k}": v for k, v in scrub.pop("stages").items()},
    }
    report = {
        "scene": {"dataset": args.dataset, "gaussians": params.n, "res": args.res,
                  "changed_gaussians": int(idx.size)},
        "device": torch.cuda.get_device_name(args.device) if torch.device(args.device).type == "cuda" else "cpu",
        "tile": [cfg.tile_h, cfg.tile_w],
        "cache_bytes": cache_bytes,
        "orbit": orbit,
        "scrub": scrub,
    }
    print(json.dumps(report, indent=1))

    if args.out:
        write_bench(
            args.out, "tile_serving",
            config={
                "res": args.res, "gaussians": params.n,
                "orbit_views": args.orbit_views,
                "timeline_steps": args.timeline_steps,
                "update_frac": args.update_frac, "smoke": args.smoke, "device": report["device"],
            },
            metrics={
                "orbit_tiles8_bytes": orbit["wire"]["tiles8_bytes"],
                "orbit_zdelta8_bytes": orbit["wire"]["zdelta8_bytes"],
                "orbit_tiles_vs_delta": orbit["wire"]["tiles_vs_delta"],
                "orbit_tiles_shipped_frac": orbit["wire"]["tiles_shipped_frac"],
                "orbit_renders_per_frame_tile": orbit["renders_per_frame"]["tile_replay"],
                "orbit_renders_per_frame_base": orbit["renders_per_frame"]["frame_replay"],
                "scrub_tiles8_bytes": scrub["wire"]["tiles8_bytes"],
                "scrub_zdelta8_bytes": scrub["wire"]["zdelta8_bytes"],
                "scrub_tiles_vs_delta": scrub["wire"]["tiles_vs_delta"],
                "scrub_renders_per_frame_tile": scrub["renders_per_frame"]["tile_replay"],
                "scrub_renders_per_frame_base": scrub["renders_per_frame"]["frame_replay"],
                "tile_cache_hit_rate": orbit["tile_cache"]["hit_rate"],
            },
            stages=stages,
        )

    # ---- hard acceptance: the tile economy must actually materialize
    failures = []
    for name, tr in (("orbit", orbit), ("scrub", scrub)):
        if tr["wire"]["tiles8_bytes"] >= tr["wire"]["zdelta8_bytes"]:
            failures.append(
                f"{name}: tiles8 wire bytes {tr['wire']['tiles8_bytes']} not "
                f"below frame-delta {tr['wire']['zdelta8_bytes']}"
            )
        r = tr["renders_per_frame"]
        if not r["tile_replay"] < r["frame_replay"]:
            failures.append(
                f"{name}: tile replay render work {r['tile_replay']} not "
                f"below whole-frame baseline {r['frame_replay']}"
            )
    if failures:
        raise SystemExit("; ".join(failures))
    print(
        f"tile serving ok: orbit replay renders/frame "
        f"{orbit['renders_per_frame']['tile_replay']} vs baseline "
        f"{orbit['renders_per_frame']['frame_replay']} "
        f"(dirty rows {orbit['dirty_rows']} of {tiles_y}); "
        f"tiles8 wire {orbit['wire']['tiles8_bytes']}B vs zdelta8 "
        f"{orbit['wire']['zdelta8_bytes']}B "
        f"({orbit['wire']['tiles_vs_delta']}x); scrub "
        f"{scrub['renders_per_frame']['tile_replay']} vs "
        f"{scrub['renders_per_frame']['frame_replay']}, wire "
        f"{scrub['wire']['tiles_vs_delta']}x"
    )


if __name__ == "__main__":
    main()
