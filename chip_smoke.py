#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: build the kernels, hold each against
its plain PyTorch version on the card, time both, then serve a 4M-Gaussian
Kingsnake scene at 512 px through the port's ``RenderServer``.

    python3 chip_smoke.py [--seed 0] [--points 4000000] [--res 512]

Run from the root of a checkout on a machine with one NVIDIA card (an H100
is what the numbers in PERF.md were taken on). It builds the kernels from
the checkout's ``.cu`` sources into ``build/repro_torch_kernels/``, imports
nothing of JAX, and exits non-zero, printing no result, when there is no
CUDA device or no ``src/repro_torch`` beside it. The last line of its
output is one JSON object ``{"ok": true, "device": {...}}``; the line
before it holds the kernels' numbers as JSON.

Phases, in order (any failure exits non-zero):
  1. card name and power limit; kernel build and its time;
  2. each kernel against its plain version at the main path's shapes;
  3. each kernel and its plain version timed with CUDA events;
  4. serving: a few orbit clients through the port's RenderServer, with
     the launch counters zeroed just before and read just after, a strip
     bitwise equal to its full-frame rows, and a small render checked
     against the port's CPU path;
  5. the kernels' JSON line and the final status line.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA data sheet (SXM)
H100_FP32_PER_S = 67e12      # float32 outside the tensor cores (SXM)
# operation counts per unit of work, from the kernels' sources
GSPROJECT_BYTES_PER_GAUSSIAN = (14 + 11) * 4
GSPROJECT_OPS_PER_GAUSSIAN = 130  # mul/add/compare incl. 5 exp/rsqrt/sqrt, 2 divisions
RASTER_OPS_PER_EVAL = 24          # dx, dy, power, clamp, exp, alpha, tests, T update, 3 color FMAs
SPIN_CYCLES = 200_000_000         # ~0.1 s at the H100's clock, longer than the timed enqueues
RASTER_FIELDS_READ = 9            # mx, my, conic a/b/c, opacity, r, g, b (not depth, radius)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def card_device() -> torch.device:
    return torch.device("cuda", 0)


def cuda_ms(fn, iters: int, label: str, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, after warm-up.

    A spin kernel holds the stream while the host enqueues all ``iters``
    calls, so CUDA events time the device work back to back and not the
    host's launch rate (a small kernel runs faster than Python launches
    it). If the host's enqueue outlasts the spin, ``fn`` itself waits for
    the device (a copy from pageable host memory, a read-back); its time is
    then the wall time per call with the device drained after each, and a
    line says so."""
    torch.cuda._sleep(1000)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    h0 = time.perf_counter()
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    for _ in range(iters):
        fn()
    ev[2].record()
    host_ms = (time.perf_counter() - h0) * 1e3
    torch.cuda.synchronize()
    if host_ms < ev[0].elapsed_time(ev[1]):
        return ev[1].elapsed_time(ev[2]) / iters
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    log(f"  {label}: waits for the device; wall ms per call")
    return total / iters * 1e3


def host_us(fn, iters: int = 200) -> float:
    """Mean host microseconds to enqueue one ``fn()`` (the wrapper's cost)."""
    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - h0) / iters * 1e6
    torch.cuda.synchronize()
    return dt


def kingsnake_scene(n_points: int, seed: int):
    """Host model of ``n_points`` Gaussians on the Kingsnake isosurface.

    The synthetic volume is extracted at the dataset's resolution, and each
    surface point is replicated with sub-voxel jitter until the paper's
    count is reached; the init scale shrinks with the replication so the
    surface keeps its coverage. Rotations, anisotropy and opacities are
    drawn from ``seed`` (random weights, as a trained model would vary)."""
    from repro_torch.configs.gs_datasets import DATASETS
    from repro_torch.core import gaussians as G
    from repro_torch.volume import datasets as VD
    from repro_torch.volume.isosurface import extract_isosurface_points

    ds = DATASETS["kingsnake"]
    vol = getattr(VD, ds.volume)(res=ds.volume_res)
    pts, _, cols = extract_isosurface_points(vol)
    rng = np.random.default_rng(seed)
    spacing = 2.0 * vol.extent / (ds.volume_res - 1)
    rep = n_points / pts.shape[0]
    src = np.arange(n_points) % pts.shape[0]
    means = (pts[src] + rng.uniform(-0.5, 0.5, (n_points, 3)) * spacing).astype(np.float32)
    g = G.to_numpy(G.init_from_points(means, cols[src], init_scale=0.5 * spacing / math.sqrt(rep), device="cpu"))
    g = g._replace(
        log_scales=(g.log_scales + rng.normal(0.0, 0.3, (n_points, 3))).astype(np.float32),
        quats=rng.normal(0.0, 1.0, (n_points, 4)).astype(np.float32),
        opacity_logit=(g.opacity_logit + rng.normal(0.0, 0.5, n_points)).astype(np.float32),
    )
    return g, pts.shape[0]


def allclose_report(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float):
    """(max |got-want| over finite entries, entries outside atol+rtol|want|)."""
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise SystemExit("finite/inf pattern differs between kernel and plain version")
    d = (got[fin] - want[fin]).abs()
    bad = int((d > atol + rtol * want[fin].abs()).sum())
    return float(d.max()) if d.numel() else 0.0, bad


def raster_evals(splats_t: torch.Tensor, valid: torch.Tensor, composited: torch.Tensor) -> int:
    """Alpha evaluations this run's tiles need: each pixel walks its tile's
    valid splats until the stop rule fires (one past its last composited)."""
    kv = (valid > 0.5).sum(dim=1, keepdim=True)  # lists are valid-first
    return int(torch.minimum(kv, composited + 1).sum())


def raster_bytes(valid: torch.Tensor, p: int) -> int:
    """Bytes the rasterizer must move on these lists: the (T, K) float valid
    mask, the 9 fields it reads of each valid entry, and its (T, 3, P) color
    and (T, P) transmittance outputs."""
    n_valid = int((valid > 0.5).sum())
    return valid.numel() * 4 + n_valid * RASTER_FIELDS_READ * 4 + valid.shape[0] * 4 * p * 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--points", type=int, default=4_000_000, help="Gaussians (the paper's Kingsnake: 4M)")
    ap.add_argument("--res", type=int, default=512, help="served image side (paper_gs_config)")
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--requests", type=int, default=3, help="requests per client")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' bmm stays float32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.gs_datasets import paper_gs_config
    from repro_torch.core import gaussians as G
    from repro_torch.core import projection as P
    from repro_torch.core import render as R
    from repro_torch.core.train import make_batched_eval_render, make_tile_row_render
    from repro_torch.kernels import _lib
    from repro_torch.kernels.gsproject import ops as gp_ops
    from repro_torch.kernels.gsproject.ref import project_ref
    from repro_torch.kernels.tile_raster import ops as tr_ops
    from repro_torch.kernels.tile_raster.ref import composite_ref, composited_counts
    from repro_torch.obs import Obs
    from repro_torch.serve_gs import RenderServer, make_clients, run_load, stack_cameras
    from repro_torch.volume.cameras import camera_slice, orbit_cameras

    dev = card_device()
    name = torch.cuda.get_device_name(0)
    card = card_line()
    t_all = time.perf_counter()

    # ---------------------------------------------------------- 1. build
    log(card)
    build = _lib.build_library()
    log(f"build: {build.seconds:.3f} s -> {build.path.relative_to(ROOT)}")
    for line in build.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    _lib.library()

    # ---------------------------------------------------------- scene
    t0 = time.perf_counter()
    host, n_surface = kingsnake_scene(args.points, args.seed)
    log(f"scene: kingsnake {n_surface} surface points -> {host.means.shape[0]} Gaussians "
        f"({time.perf_counter() - t0:.1f} s)")
    cfg = paper_gs_config(args.res)
    g_dev = G.from_numpy(host, dev)
    cams = orbit_cameras(12, img_h=cfg.img_h, img_w=cfg.img_w, radius=3.0)
    cam = camera_slice(cams, 0)

    # ---------------------------------------------------------- 2. compare
    proj_k = gp_ops.project_packed(g_dev, cam)
    proj_p = project_ref(g_dev, cam)
    gp_err, gp_bad = allclose_report(proj_k, proj_p, 2e-5, 2e-5)
    log(f"compare gsproject N={g_dev.n}: max_abs_err {gp_err:.3e}, entries outside atol 2e-5/rtol 2e-5: {gp_bad}")
    if gp_bad:
        raise SystemExit("gsproject disagrees with its plain version")

    pk_sorted, _ = P.sort_by_depth(proj_k)
    tiles_x = cfg.img_w // cfg.tile_w
    # the main path's lists (the paper config's hierarchical binning), a strip
    # at row_offset != 0, and the flat lists of the same frame, which are far
    # denser (at 4M Gaussians the hierarchical lists leave most tiles empty)
    idx, valid = R.bin_tiles(pk_sorted, img_h=cfg.img_h, img_w=cfg.img_w, tile_h=cfg.tile_h,
                             tile_w=cfg.tile_w, k_per_tile=cfg.k_per_tile, binning=cfg.binning)
    row = (cfg.img_h // cfg.tile_h) // 2 + 1
    idx_r, valid_r = R.bin_tile_row(pk_sorted, row=row, img_h=cfg.img_h, img_w=cfg.img_w, tile_h=cfg.tile_h,
                                    tile_w=cfg.tile_w, k_per_tile=cfg.k_per_tile, binning=cfg.binning)
    fidx, fvalid = R.build_tile_lists(pk_sorted, img_h=cfg.img_h, img_w=cfg.img_w, tile_h=cfg.tile_h,
                                      tile_w=cfg.tile_w, k_per_tile=cfg.k_per_tile)
    raster_cases = [("frame", idx, valid, 0), (f"row {row}", idx_r, valid_r, row * cfg.tile_h),
                    ("frame, flat lists", fidx, fvalid, 0)]
    tr_err = 0.0
    raster_inputs = {}
    for label, ix, vd, roff in raster_cases:
        splats_t = pk_sorted[ix.long()].transpose(1, 2).contiguous()
        vf = vd.to(torch.float32).contiguous()
        kw = dict(tiles_x=tiles_x, tile_h=cfg.tile_h, tile_w=cfg.tile_w, row_offset=roff)
        out_k, t_k = tr_ops.composite(splats_t, vf, **kw)
        out_p, t_p = composite_ref(splats_t, vf, **kw)
        d_rgb = (out_k - out_p).abs().amax(dim=1)                 # (T, P) worst channel
        d_t = (t_k - t_p).abs()
        tol_rgb = 1e-5 + 1e-4 * out_p.abs().amax(dim=1)
        tol_t = 1e-5 + 1e-4 * t_p.abs()
        outside = int(((d_rgb > tol_rgb) | (d_t > tol_t)).sum())
        n_pix = d_t.numel()
        err = float(torch.maximum(d_rgb.max(), d_t.max()))
        tr_err = max(tr_err, err)
        log(f"compare tile_raster {label} T={splats_t.shape[0]} K={splats_t.shape[2]} P={d_t.shape[1]}: "
            f"max_abs_err {err:.3e}, pixels outside atol 1e-5/rtol 1e-4: {outside} of {n_pix}")
        if outside > 1e-4 * n_pix or err > 2e-2:
            raise SystemExit(f"tile_raster disagrees with its plain version ({label})")
        if roff == 0:
            raster_inputs[label] = (splats_t, vf, kw)

    # ---------------------------------------------------------- 3. time
    cam_vec = gp_ops.cam_vector(cam)
    gp_ms = cuda_ms(lambda: gp_ops.launch(g_dev, cam_vec), 20, "gsproject kernel")
    cam_dev = P.Camera(*[torch.as_tensor(x).to(dev) for x in cam])  # no host copy per call
    gp_plain_ms = cuda_ms(lambda: project_ref(g_dev, cam_dev), 5, "gsproject plain")
    n = g_dev.n
    gp_bound_bytes = n * GSPROJECT_BYTES_PER_GAUSSIAN / H100_BYTES_PER_S * 1e3
    gp_bound_ops = n * GSPROJECT_OPS_PER_GAUSSIAN / H100_FP32_PER_S * 1e3
    log(f"time gsproject N={n}: kernel {gp_ms:.4f} ms (host {host_us(lambda: gp_ops.launch(g_dev, cam_vec)):.1f} us "
        f"per launch), plain {gp_plain_ms:.4f} ms, bound {max(gp_bound_bytes, gp_bound_ops):.4f} ms "
        f"({n * GSPROJECT_BYTES_PER_GAUSSIAN} B), no library call")

    tr = {}
    for label, (splats_t, vf, kw) in raster_inputs.items():
        ms = cuda_ms(lambda: tr_ops.composite(splats_t, vf, **kw), 20, f"tile_raster {label} kernel")
        plain_ms = cuda_ms(lambda: composite_ref(splats_t, vf, **kw), 3, f"tile_raster {label} plain")
        evals = raster_evals(splats_t, vf, composited_counts(splats_t, vf, **kw))
        nbytes = raster_bytes(vf, cfg.tile_h * cfg.tile_w)
        b_ops = evals * RASTER_OPS_PER_EVAL / H100_FP32_PER_S * 1e3
        b_bytes = nbytes / H100_BYTES_PER_S * 1e3
        tr[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(b_ops, b_bytes),
                         bound_by="operations" if b_ops >= b_bytes else "bytes")
        full_evals = splats_t.shape[0] * splats_t.shape[2] * cfg.tile_h * cfg.tile_w
        log(f"time tile_raster {label} T={splats_t.shape[0]} K={splats_t.shape[2]}: kernel {ms:.4f} ms (host "
            f"{host_us(lambda: tr_ops.composite(splats_t, vf, **kw)):.1f} us per launch), plain "
            f"{plain_ms:.4f} ms, bound {max(b_ops, b_bytes):.4f} ms ({tr[label]['bound_by']}; "
            f"{int((vf > 0.5).sum())} valid entries, {evals} alpha evaluations of {full_evals} before early exit, "
            f"{nbytes} B), no library call")

    # hierarchical vs flat lists at this density (the strip renderer's premise)
    same = (torch.where(fvalid, fidx, -1) == torch.where(valid, idx, -1)).all(dim=1)
    log(f"binning: hierarchical lists equal flat lists on {int(same.sum())} of {same.numel()} tiles; "
        f"valid entries hierarchical {int(valid.sum())}, flat {int(fvalid.sum())}")
    bg = torch.zeros(3, device=dev)
    ras_kw = dict(img_h=cfg.img_h, img_w=cfg.img_w, tile_h=cfg.tile_h, tile_w=cfg.tile_w, bg=bg)
    img_h_, t_h_ = tr_ops.rasterize_tiles(pk_sorted, idx, valid, **ras_kw)
    img_f_, t_f_ = tr_ops.rasterize_tiles(pk_sorted, fidx, fvalid, **ras_kw)
    log(f"binning: covered share (mean 1-T) hierarchical {float((1 - t_h_).mean()):.4f}, flat "
        f"{float((1 - t_f_).mean()):.4f}; max |image difference| {float((img_h_ - img_f_).abs().max()):.4f}")

    # where one served view's time goes (level 0, one camera), device time per stage
    bin_kw = dict(img_h=cfg.img_h, img_w=cfg.img_w, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                  k_per_tile=cfg.k_per_tile, binning=cfg.binning)
    st_proj = cuda_ms(lambda: P.project(g_dev, cam), 5, "stage project")
    st_sort = cuda_ms(lambda: P.sort_by_depth(proj_k), 5, "stage sort")
    st_bin = cuda_ms(lambda: R.bin_tiles(pk_sorted, **bin_kw), 3, "stage bin")
    st_rast = cuda_ms(lambda: tr_ops.rasterize_tiles(pk_sorted, idx, valid, img_h=cfg.img_h, img_w=cfg.img_w,
                                                      tile_h=cfg.tile_h, tile_w=cfg.tile_w, bg=bg),
                      5, "stage raster")
    render_one = make_batched_eval_render(cfg)
    one_cam = stack_cameras([cam])
    st_view = cuda_ms(lambda: render_one(g_dev, one_cam), 3, "whole view")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_one(g_dev, one_cam)
    host_enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    log(f"view breakdown N={n} {cfg.img_h}px ({card}): project {st_proj:.3f} ms, sort {st_sort:.3f} ms, "
        f"bin {st_bin:.3f} ms, gather+raster+blend {st_rast:.3f} ms; whole view {st_view:.3f} ms "
        f"(host enqueue {host_enqueue:.3f} ms)")
    del proj_k, proj_p, pk_sorted, raster_inputs, fidx, fvalid, img_h_, img_f_

    # ---------------------------------------------------------- 4. serve
    n_req = args.clients * args.requests
    server = RenderServer(host, cfg, device=dev, obs=Obs(), n_levels=3, keep_ratio=0.5,
                          max_batch=4, pipeline_depth=2, frames_capacity=4 * n_req)
    log(f"serve: levels live {list(server.pyramid.live_counts)}, "
        f"warmup {server.warmup(buckets=(1,)):.2f} s")
    clients = make_clients(args.clients, n_views=12, img_h=cfg.img_h, img_w=cfg.img_w, radius_spread=1.0)
    torch.cuda.reset_peak_memory_stats(dev)
    gp_ops.launch_count.n = 0
    tr_ops.launch_count.n = 0
    report = run_load(server, clients, requests_per_client=args.requests)
    # a localized update: drop two tile rows of the timestep, then revisit two
    # served poses -> partial hits render only those rows (the strip path)
    server.invalidate(0, rows={row, row + 1})
    revisit = [server.submit(camera_slice(cams, i)) for i in range(2)]
    frames_revisit = [f.result() for f in revisit]
    server.run()
    gp_launches, tr_launches = gp_ops.launch_count.n, tr_ops.launch_count.n
    report = server.report()
    peak = torch.cuda.max_memory_allocated(dev)
    done = report["completed"]
    if done != n_req + len(revisit):
        raise SystemExit(f"served {done} of {n_req + len(revisit)} requests")
    frames = list(server.frames.values())
    for f in frames + frames_revisit:
        if f.shape != (cfg.img_h, cfg.img_w, 3) or not np.isfinite(f).all() or f.min() < -1e-6 or f.max() > 1 + 1e-6:
            raise SystemExit(f"bad frame: shape {f.shape}, range [{f.min()}, {f.max()}]")
    if gp_launches == 0 or tr_launches == 0:
        raise SystemExit(f"main path missed a kernel: gsproject {gp_launches}, tile_raster {tr_launches}")
    rendered = report["tiles"]["render_rows"] / (cfg.img_h // cfg.tile_h)  # full-frame equivalents
    lat = report["latency_ms"]
    log(f"serve {name} ({card}): {done} requests, {report['frames_per_s']} frames/s, "
        f"p50 {lat['p50']} ms, p99 {lat['p99']} ms, max_memory_allocated {peak} B, "
        f"requests per level {report['lod']['requests_per_level']}, partial hits {report['tiles']['partial_hits']}, "
        f"full hits {report['tiles']['full_hits']}, render calls {report['render']['calls']}, "
        f"wall {report['wall_s']} s, render union {report['render']['total_s']} s, "
        f"dispatch {report['pipeline']['dispatch_s']} s, block {report['pipeline']['block_s']} s")
    log(f"launches on the main path: gsproject {gp_launches}, tile_raster {tr_launches} "
        f"({rendered:.3f} full-frame equivalents rendered)")
    server.close()

    # strip bitwise equal to the same rows of the full frame (tile cache rests on it)
    full = make_batched_eval_render(cfg)(g_dev, stack_cameras([cam]))[0]  # level 0 = the full model
    strip = make_tile_row_render(cfg, row=row)(g_dev, cam)
    rows = slice(row * cfg.tile_h, (row + 1) * cfg.tile_h)
    if not torch.equal(strip, full[rows]):
        raise SystemExit(f"strip row {row} is not bitwise equal to the full frame's rows "
                         f"(max diff {float((strip - full[rows]).abs().max())})")
    log(f"strip row {row}: bitwise equal to the full frame's rows {rows.start}..{rows.stop - 1}")

    # small input against the port's CPU path (held to the JAX package by the tests)
    small = host._replace(**{f: getattr(host, f)[: 20000] for f in host._fields})
    scfg = paper_gs_config(64)
    scam = camera_slice(orbit_cameras(12, img_h=64, img_w=64, radius=3.0), 5)
    img_gpu = make_batched_eval_render(scfg)(G.from_numpy(small, dev), stack_cameras([scam]))[0].cpu()
    img_cpu = make_batched_eval_render(scfg)(G.from_numpy(small, "cpu"), stack_cameras([scam]))[0]
    d = float((img_gpu - img_cpu).abs().max())
    log(f"small render 20000 Gaussians at 64 px, card vs CPU path: max_abs_err {d:.3e}")
    if not torch.allclose(img_gpu, img_cpu, atol=1e-4, rtol=1e-4):
        raise SystemExit("card render disagrees with the CPU path on a small input")

    # ---------------------------------------------------------- 5. result
    log(f"total {time.perf_counter() - t_all:.1f} s")
    kernels = [
        {"name": "gsproject", "route": "cuda", "source": "src/repro_torch/kernels/gsproject/gsproject.cu",
         "replaces": "src/repro/kernels/gsproject/gsproject.py:24", "launches": gp_launches,
         "max_abs_err": gp_err, "ms": gp_ms, "plain_ms": gp_plain_ms,
         "bound_ms": max(gp_bound_bytes, gp_bound_ops),
         "bound_by": "bytes" if gp_bound_bytes >= gp_bound_ops else "operations", "library_ms": None},
        {"name": "tile_raster_fwd", "route": "cuda", "source": "src/repro_torch/kernels/tile_raster/tile_raster.cu",
         "replaces": "src/repro/kernels/tile_raster/tile_raster.py:102", "launches": tr_launches,
         "max_abs_err": tr_err, **tr["frame"], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
