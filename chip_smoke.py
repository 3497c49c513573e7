#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: build the kernels, hold each against
its plain PyTorch version on the card, time both, serve a 4M-Gaussian
Kingsnake scene at 512 px through the port's ``RenderServer``, on one
device and on a mesh of ranks over NCCL, train the same scene for a few
steps through ``GSTrainer``, on one device and on a mesh of ranks, and
at SH degree 3, stream
a time-varying Miranda volume through the in situ trainer, its temporal
store and a time-scrubbing server, serve both to TCP clients through the
network frontend, train at the paper's scale (Miranda's 18.18M Gaussians
on one card), then prefill, decode and
train the full-width Qwen3-0.6B LM through the port's prefill, serve and
train steps, prefill, serve and train the full-width granite-moe
(3.3B parameters, 40 experts top-8), and the other families of the
registry: zamba2-7b (Mamba2 with shared attention at head width 112),
xlstm-350m, whisper-tiny and qwen2-vl-72b (M-RoPE); last, the port's
static-analysis CLI over the checkout.

    python3 chip_smoke.py [--seed 0] [--points 4000000] [--res 512] [--train-steps 6]
    python3 chip_smoke.py --ranks-only    # the phases across ranks alone, e.g. on several cards

Run from the root of a checkout on a machine with one NVIDIA card (an H100
is what the numbers in PERF.md were taken on). It builds the kernels from
the checkout's ``.cu`` sources into ``build/repro_torch_kernels/``, imports
nothing of JAX, and exits non-zero, printing no result, when there is no
CUDA device or no ``src/repro_torch`` beside it. The last line of its
output is one JSON object ``{"ok": true, "device": {...}}``; the line
before it holds the kernels' numbers as JSON.

Phases, in order (any failure exits non-zero):
  1. card name and power limit; kernel build and its time; the rasterizer
     kernels' and the bf16 attention instances' registers and spill bytes
     from ptxas; the rasterizer kernels' resident CTAs per SM;
  2. each kernel against its plain version at the main path's shapes: the
     projection at SH degree 0 and, on the same 4M scene with random bands
     1-3 from the seed, at degrees 1, 2 and 3 (atol/rtol 2e-5, two launches
     bitwise equal); the rasterizer forward at atol 3e-6 / rtol 1e-5 on
     every pixel and channel of the frame, a strip, the flat lists and a dense slab (the view an
     isosurface fills: 1,024 tiles, K 256, every slot valid; and at K 250,
     staged by 4-byte copies), its n_contrib
     equal to the plain version's and two launches bitwise equal; the
     backward fed the forward's residuals, with d(out) from a real loss and
     a random one, two launches bitwise equal;
  3. each kernel and its plain version timed with CUDA events (the
     projection at each SH degree beside its bound); for the rasterizer,
     per-tile load (valid entries and alpha evaluations: max, p99, p50, mean) and each kernel's time on the densest tile alone;
  4. serving: a few orbit clients through the port's RenderServer, with
     the launch counters zeroed just before and read just after, then a
     localized update and two revisited poses (strips); the device busy
     share of one served micro-batch (``profile_step``); a strip bitwise
     equal to its full-frame rows, and a small render checked against the
     port's CPU path;
  4b. serve ranks: this process's world-1 NCCL group (made here, shared
     with phase 5b) drives ``RenderServer(mesh=(1, 1))`` over phase 4's
     host model with phase 4's requests, the counters zeroed just before
     and read just after: every frame bitwise equal to phase 4's; frames/s,
     p50 and p99 beside phase 4's, the control plane's descriptor cost per
     dispatch and the level exchange's time, the busy share of one served
     micro-batch; with two or more cards, the same requests on (2, 1),
     (4, 1), (1, 2) and (1, 4) over NCCL, one rank per card, frames bitwise
     equal to world 1, frames/s, p50 and p99 on the lead, peak memory on
     the fullest rank;
  5. training: 8 ray-marched orbit views, ``GSTrainer.fit`` at batch 4 with
     one densify round and ``evaluate``, with the launch counters zeroed
     just before and read just after (4 per step for each kernel, plus one
     forward per eval view), each step's loss, step time, a per-stage device
     breakdown and peak memory; a small train step, and a densify round
     that clones, splits and prunes followed by one more step, each checked
     against the port's CPU path;
  5b. ranks: the world-1 NCCL process group drives ``GSTrainer(mesh=...)``
     at the training configuration (the splats' all-gather and its
     reduce-scatter, the loss sums' all-reduce and the fused gradient
     all-reduce are real NCCL calls over groups of one; with one model
     rank there are no pixel strips, so the SSIM halo exchange and
     per-strip binning run only across cards) for 3 steps in each gather mode from phase 5's initial state, with
     the launch counters zeroed just before and read just after; bitwise
     equal to the one-device trainer on the same batches, step p50 beside
     it and beside phase 5's; the NCCL version and the group's init time;
     the computed all-gather bytes of (1, 2) and (1, 4) in both modes;
     with two or more cards, (1, 2) and (1, 4) in both modes over NCCL
     with one rank per card, 8 steps each, the losses held to the
     one-device trainer at rtol 1e-5, step p50 beside its;
  5f. (run after 5b, on phase 5's views) SH degrees 1-3 (``sh_phase``):
     ``GSTrainer`` at ``sh_degree=3`` on phase 4's 4M scene with random
     bands 1-3, 512 px, batch 4, 5 steps, densification off, the counters
     zeroed just before and read just after (4 a step of each splatting
     kernel): step ms p50, peak memory, the per-stage split and the busy
     share of one step; phase 5's small step (20,000 Gaussians, 64 px) at
     SH degrees 1 and 2 on the card against the CPU path (loss rtol 1e-5,
     gradients as the backward), each with its launches;
  5c. in situ: ``InsituTrainer`` over the Miranda growth stream (4
     timesteps of a 256^3 field; capacity 1.5x the first extraction) at
     ``paper_gs_config(512)`` with densification off, 8 orbit views
     ray-marched on the card per timestep, 100 cold and 20 warm steps, a
     temporal store with asynchronous writes, then the in situ CLI's scrub
     and live-replay smokes on the card at depth 2, with the launch
     counters zeroed just before and read just after; each timestep's
     extraction, reseed and wall time split (from the trace ring), step ms
     p50 cold and warm beside phase 5's, the busy share of one warm step,
     the store's stats and peak memory; it fails unless the train step saw
     one shape signature, the scrubbed frames are distinct with no new
     miss on replay, a small run (miranda at 32^3, 32 px, 2 timesteps) on
     the card matches the CPU path (first loss rtol 1e-5, the rest 1e-3,
     the same reseeded slots), and the world-1 NCCL mesh is bitwise the one
     device over 2 timesteps of the stream;
  5d. frontend: one ``SessionManager`` on the card (3 levels at keep 0.5,
     max batch 8, depth 2, tile cache) with stream ``static`` = phase 4's
     host model and stream ``timeline`` = phase 5c's temporal store; 8
     clients x 8 requests (even clients orbit ``static``, odd clients scrub
     ``timeline`` at a fixed pose) in process, then over TCP to a
     ``GatewayThread`` on an ephemeral localhost port (queue limit 8, wave
     per session 4, coalesce 2 ms, tiles8), the cache and metrics reset and
     the launch counters zeroed before each lap; frames/s of both laps and
     their ratio, client p50 and p99, payload bytes per frame by encoding
     and raw fallbacks, the gateway's render/encode/write seconds, the busy
     share of one wave of 8 new poses, each lap's launches and peak memory;
     it fails unless every TCP frame is bitwise ``quantize_rgb8`` of the
     in-process frame, the scrubbed timesteps are distinct, nothing is shed
     and no protocol, request or engine error occurs, and both forward
     kernels launch over TCP;
  5e. paper scale: Miranda at the paper's 18,180,000 Gaussians
     (``paper_scene``) on one card at ``paper_gs_config(512)``, 8
     ray-marched views, 4 steps with densification off and a span trace, the
     launch counters zeroed just before and read just after (4 a step of
     each splatting kernel); step ms p50, peak memory against 40 GB (the
     paper's A100) and 80 GB, the per-stage split of the trace
     (``train_stage_breakdown``) and the busy share of one step; then
     phase 4's 4M Kingsnake at 2048 px, 4 views, 3 steps: step ms, peak
     and the busy share of one step; it fails on a non-finite loss or a
     wrong launch count;
  7. lm: the attention kernel against its plain version (the JAX kernel
     test's sweep, Skv 9000, a 1024-key window and a ragged long case at
     hd 128, each in float32 on the CUDA-core kernel and in bfloat16 on the
     tensor-core kernel with its bitwise-equal share; the model's own
     prefill shape in both types, two launches bitwise equal, the
     autograd.Function's gradient), timed beside its plain version, its
     bound and PyTorch's ``scaled_dot_product_attention`` (the float32
     kernel timed at the same shape); Qwen3-0.6B at full width (28 layers,
     bfloat16, random weights from ``--seed``) through ``make_prefill_step``
     at batch 4 x 4096 tokens with the launch counters zeroed just before
     and read just after (one attention launch per layer and call), and
     through the serving CLI's loop (batch 4, 32 prompt steps, 16 greedy
     tokens); in float32, a 128-token prompt's last logits on the card
     against the CPU path and against the card's serve steps; the phase's
     peak memory;
  7b. lm training: Qwen3-0.6B at full width through ``make_train_step`` at
     batch 4 x 4096 (the train_4k sequence; its global batch of 256 cut to
     4), remat on: one warm-up and 3 timed steps with the launch counters
     zeroed just before and read just after (2 x 28 attention launches a
     step: the forward and the remat recompute), step ms p50, tokens/s,
     peak memory, the busy share and the attention VJP's device time of one
     profiled step, and the step's pieces timed alone (the forward, one
     layer's attention plain VJP x 28, the chunked cross-entropy, AdamW);
     in float32, one step at 1 x 128 tokens on the card against the CPU
     path (loss rtol 1e-4, every gradient leaf within 1e-3 x its max |g|);
     it fails on a non-finite loss or a wrong launch count;
  7c. MoE: granite-moe-3b-a800m at full width (32 layers, d 1536, 40
     experts top-8, bf16): the attention kernel against its plain version
     at the prefill's and training's shapes (4 and 2 x 4096, 24/8 heads, hd
     64, causal, float32 and bf16); ``make_prefill_step`` at 4 x 4096 (ms
     p50, tokens/s, 32 attention launches a call, ``drop_frac`` per layer at
     capacity 1,025), the serving CLI's loop at its defaults (ms/token, the
     decode fold's ``drop_frac``; one serve step profiled: busy share,
     device ops a token), ``make_train_step`` at batch 2 x 4096 (1
     warm-up and 3 timed steps, 64 attention launches a step, peak memory);
     in float32 at full widths but 4 layers, card against CPU: prefill
     logits within 1e-3 x max |logit|, every (token, choice)'s dispatch
     row equal (so the same dropped tokens), one train step as in 7b;
  7d-7g. the other LM families, each at its published widths with random
     weights from ``--seed`` (``family_phase``): the attention kernel
     against its plain version at the family's shapes (float32 and bf16,
     two bf16 launches bitwise equal) and timed beside its bound and
     ``scaled_dot_product_attention(..., enable_gqa=)``; ``make_prefill_step``
     at 4 x 4096 (ms p50, tokens/s, the attention launches a call from the
     JAX layer plan, the counters zeroed just before and read just after,
     one profiled call); the serving CLI's loop at its defaults;
     ``make_train_step`` (1 warm-up + 3 timed steps, ms p50, tokens/s, peak
     memory, a finite loss, the launches); float32 at full widths and a few
     layers, card against CPU: the prefill's last logits within 1e-3 x max
     |logit|, one train step as in 7b. 7d zamba2-7b: the kernel at hd 112,
     32/32 heads (4 and 1 x 4096); prefill and the CLI at 81 layers (13
     shared-attention calls a prefill), training at 24 layers (2 double
     units, 1 x 4096; 8 launches a step with the remat recompute), one
     mamba layer's SSD timed alone; the CPU check at 4 layers with period
     1. 7e xlstm-350m: full size throughout (no attention), one sLSTM
     layer timed alone and its share of the prefill and of a train step,
     neither profiled (a prefill's ~350,000 device ops take the profiler
     minutes), the prefill timed over one call after its warm-up (host-bound,
     ~8 s a call); the CPU check at 2 layers of the smoke pattern "MS" (an mLSTM and an
     sLSTM layer). 7f
     whisper-tiny: full size, 1,500 audio frames from the seed; the kernel
     at the encoder's 1,500 x 1,500, the cross-attention's 4,096 x 1,500
     and its one-token decode (1 x 1,500, the serve step's), non-causal,
     and the decoder's 4,096 (causal); 12 launches a prefill,
     4 a serve step (the cross-attention over the zeroed encoder cache).
     7g qwen2-vl-72b: merged embeddings and the M-RoPE triples of a text run
     and one image's grid; prefill and the CLI's loop at 8 of 80 layers,
     training at 2 layers, 1 x 4096; the CPU check at 1 layer;
  8. the operation counter (``src/repro_torch/launch/op_cost.py``,
     ``cost_phase``): one train step of phase 5's 4M scene (512 px, batch 4)
     counted (flops, bytes by op, collectives, the peak live bytes above the
     arguments against ``max_memory_allocated``, the roofline on H100 terms
     and its share of phase 5's p50); phase 5's small step (20,000
     Gaussians, 64 px) counted on the card and on the CPU, the counts equal
     in total and op by op (the three splatting kernels report the bounds'
     formulas, ``kernels/cost.py``); the dry run of Qwen3-0.6B's prefill at
     4 x 4096 on ``card1`` (``launch/dryrun.py``, meta tensors) beside
     phase 7's measured prefill;
  9. the static passes: ``python -m repro_torch.launch.analyze -q --report
     build/repro_torch_analysis/report.json`` over the checkout in its own
     process (this machine has no JAX), exit 0 against the committed
     baseline; the findings and the CLI's elapsed ms;
  6. the result, printed last (after phase 9): the kernels' JSON line (``launches`` from each
     kernel's main path: training for the splatting kernels, the LM prefill
     for attention; the projection at SH degrees 1-3 as ``gsproject_sh1``
     to ``_sh3``, each with its own degree's launches from phase 5f;
     ``launches_by_path`` with every path's own counts,
     ``lm_train``, ``moe_prefill``, ``moe_serve_cli`` and ``moe_train`` those
     of phases 7b and 7c, ``<family>_prefill``, ``_serve_cli`` and ``_train``
     those of 7d-7g for zamba, xlstm, whisper and vlm, ``family_shapes`` the
     kernel's times at their shapes,
     ``serve_ranks`` the mesh server of phase 4b, ``ranks`` the sharded fits
     of phase 5b, ``insitu`` the stream, scrub and replay of phase 5c,
     ``frontend`` the TCP lap of phase 5d, ``paper_scale`` the two fits of
     phase 5e) and the final status line.

With ``--ranks-only`` it builds, makes the scene and its views, and runs
phases 4b and 5b, then Miranda's 18.18M Gaussians: phase 5e's one-device
run and, with two or more cards, (1, 2) and (1, 4) in ``projected`` mode
with one rank per card, 4 steps each, the losses held to one device at rtol
1e-5 and the peak on the fullest rank printed; then the in situ trainer on
a (1, 2) mesh across two cards over 2 timesteps of phase 5c's stream, held
to one device (per-step losses rtol 1e-5, the same reseeded slots). Its last
line is their result as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SPIN_CYCLES = 200_000_000         # ~0.1 s at the H100's clock, longer than the timed enqueues
# the H100's peaks (launch/mesh.py) and the kernels' work formulas
# (kernels/cost.py) come from the package, once it is on the path (main)


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


def wall_ms(fn, iters: int) -> float:
    """Mean wall milliseconds of ``fn()`` with the device drained after each call."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
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


def profile_step(fn, wall_ms: float, top: int = 8, label: str = "train step"):
    """Device busy time of one ``fn()`` from a torch.profiler trace: the
    union of its kernels', copies' and fills' intervals on the card's
    timeline (``obs/devtime.py``; rows on several streams count once), its
    share of the same profiled call's wall time, and the kernels that take
    most of the device time. ``wall_ms`` is the unprofiled p50, printed
    beside it. Says so when the trace holds no device time, and then
    returns None; else the profiler and the device-time summary."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.devtime import device_time

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    d = device_time(prof, prof_wall_ms)
    if d["busy_ms"] <= 0:
        log(f"{label} profile: the trace holds no device time; device busy share not measured")
        return None
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0),
                  reverse=True)
    host = sorted(((ev.self_cpu_time_total, ev.count, ev.key) for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CPU), reverse=True)
    log(f"{label} profile: device busy {d['busy_ms']:.3f} ms (union of {d['n_ops']} device ops' intervals; "
        f"summed {d['summed_ms']:.3f} ms, NCCL {d['nccl_ms']:.3f} ms overlapping the rest by {d['overlap_ms']:.3f} "
        f"ms) of the profiled call's {prof_wall_ms:.3f} ms wall (unprofiled p50 {wall_ms:.3f} ms) -> busy share "
        f"{d['busy_share']:.4f}, idle share {1 - d['busy_share']:.4f}; top: "
        + "; ".join(f"{k[:60]} x{c} {us / 1e3:.3f} ms" for us, c, k in rows[:top]))
    log(f"{label} profile, host side (self time): "
        + "; ".join(f"{k[:40]} x{c} {us / 1e3:.3f} ms" for us, c, k in host[:top]))
    return prof, d


def allclose_report(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float):
    """(max |got-want| over finite entries, entries outside atol+rtol|want|)."""
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise SystemExit("finite/inf pattern differs between kernel and plain version")
    d = (got[fin] - want[fin]).abs()
    bad = int((d > atol + rtol * want[fin].abs()).sum())
    return float(d.max()) if d.numel() else 0.0, bad


RASTER_ATOL, RASTER_RTOL = 3e-6, 1e-5  # the North star's forward tolerance (tests/test_tile_raster_kernel.py)


def raster_fwd_report(out_k, t_k, out_p, t_p, stop: torch.Tensor):
    """The rasterizer forward against its plain version at atol 3e-6 / rtol
    1e-5 on every pixel and channel of rgb (T, 3, P) and t_final (T, P):
    (max |difference|, entries outside, a line for each of the first pixels
    outside with its T from both and its stop index, the first slot the stop
    rule drops, from ``composited_counts``)."""
    if not (torch.isfinite(out_k).all() and torch.isfinite(t_k).all()):
        raise SystemExit("tile_raster: the kernel wrote a non-finite value")
    d_rgb, d_t = (out_k - out_p).abs(), (t_k - t_p).abs()
    bad_rgb = d_rgb > RASTER_ATOL + RASTER_RTOL * out_p.abs()
    bad_t = d_t > RASTER_ATOL + RASTER_RTOL * t_p.abs()
    lines = [f"tile {t} pixel {p}: T kernel {float(t_k[t, p]):.9e}, plain {float(t_p[t, p]):.9e}; stop index "
             f"{int(stop[t, p])}; rgb kernel {out_k[t, :, p].tolist()}, plain {out_p[t, :, p].tolist()}"
             for t, p in (bad_rgb.any(dim=1) | bad_t).nonzero()[:8].tolist()]
    return float(torch.maximum(d_rgb.max(), d_t.max())), int(bad_rgb.sum() + bad_t.sum()), lines


def dense_slab(dev, seed: int, tiles_x: int, tiles_y: int, tile: int, k: int):
    """The view an isosurface fills, as kernel input: tiles_x * tiles_y tiles
    of tile x tile pixels with K splats each, every slot valid, each mean
    inside its tile, footprints (sigma 10-20 px) that cover the tile, and
    opacities 0.02-0.08, with which the median pixel composites ~216 splats
    before the 1e-4 stop. Made on the card from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = tiles_x * tiles_y

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((t, k), device=dev, generator=gen)

    tid = torch.arange(t, device=dev)[:, None]
    s = torch.zeros((t, 11, k), device=dev)
    s[:, 0] = (tid % tiles_x) * tile + u(0, tile)
    s[:, 1] = (tid // tiles_x) * tile + u(0, tile)
    sx, sy = u(10, 20), u(10, 20)
    s[:, 2] = 1 / (sx * sx)
    s[:, 3] = u(-0.3, 0.3) / (sx * sy)  # correlation within +-0.3
    s[:, 4] = 1 / (sy * sy)
    s[:, 5] = u(0.02, 0.08)
    s[:, 6:9] = torch.rand((t, 3, k), device=dev, generator=gen)
    s[:, 9] = torch.arange(k, device=dev) + 1.0  # depth, front to back
    s[:, 10] = 3 * torch.maximum(sx, sy)
    return s, torch.ones((t, k), device=dev)


def tile_load(vf: torch.Tensor, counts: torch.Tensor):
    """Per tile: its valid count and its alpha evaluations (each pixel walks
    the valid prefix until its stop, as ``kernels/cost.py`` ``raster_evals`` counts)."""
    kv = (vf > 0.5).sum(dim=1)
    return kv, torch.minimum(kv[:, None], counts + 1).sum(dim=1)


def stats_line(x: torch.Tensor) -> str:
    x = x.double()
    return (f"max {float(x.max()):.0f}, p99 {float(torch.quantile(x, 0.99)):.1f}, "
            f"p50 {float(torch.quantile(x, 0.5)):.1f}, mean {float(x.mean()):.2f}")


def grad_report(got: torch.Tensor, want: torch.Tensor):
    """(max |got-want|, entries outside atol 2e-5*max|want| + rtol 2e-4|want|),
    the JAX package's gradient tolerance."""
    d = (got - want).abs()
    bad = int((d > 2e-5 * want.abs().max() + 2e-4 * want.abs()).sum())
    return float(d.max()) if d.numel() else 0.0, bad


def image_layout(raw: torch.Tensor, tfin: torch.Tensor, h: int, w: int, th: int, tw: int):
    """Kernel layout (T,3,P), (T,P) -> (H,W,3) image and (H,W) transmittance."""
    ty, tx = h // th, w // tw
    img = raw.reshape(ty, tx, 3, th, tw).permute(0, 3, 1, 4, 2).reshape(h, w, 3)
    return img, tfin.reshape(ty, tx, th, tw).permute(0, 2, 1, 3).reshape(h, w)


# the JAX flash-attention kernel test's sweep, (B, S, Skv, H, Hkv, hd, causal,
# window) with q_offset = Skv - S, then Skv 9000 (where the JAX wrapper falls
# back to its oracle), a Gemma3-style 1024-key window at hd 128, a ragged
# long case (S 100 over Skv 9000) at hd 128 and a ragged batch of two (the
# tensor maps' batch edge); each in float32 (the CUDA-core kernel) and
# bfloat16 (the tensor-core kernel)
FLASH_CASES = [
    (2, 128, 128, 4, 4, 64, True, None),
    (1, 256, 256, 4, 2, 32, True, None),
    (2, 128, 128, 2, 2, 64, True, 32),
    (1, 64, 128, 2, 2, 32, True, None),
    (1, 128, 128, 4, 1, 64, False, None),
    (1, 100, 100, 2, 2, 64, True, None),
    (1, 64, 9000, 1, 1, 32, True, None),
    (1, 2048, 2048, 4, 2, 128, True, 1024),
    (1, 100, 9000, 2, 1, 128, True, None),
    (2, 300, 300, 2, 1, 128, True, None),
]
FLASH_F32_TOL = (2e-5, 2e-4)    # atol, rtol: the JAX kernel test's
FLASH_BF16_TOL = (1e-2, 1.6e-2)  # one bfloat16 step is up to 2^-7 relative; P is rounded to bf16
LM_CROSS_TOL = 1e-3             # float32 logits: max |difference| <= this x max |logit|
LM_BATCH, LM_SEQ = 4, 4096      # the prefill step's batch and prompt length


def flash_compare(label, q, k, v, kw, tol):
    """The attention kernel's wrapper against its plain version on the same
    card tensors. Fails on an entry outside ``tol`` (atol, rtol) or a
    non-finite output; returns (max |difference|, the kernel's output)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    got = fa_ops.flash_attention(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    err, bad = allclose_report(got.float(), want.float(), *tol)
    same = float((got == want).float().mean())
    log(f"compare flash_attention {label} {tuple(q.shape)} kv {tuple(k.shape)} {str(q.dtype)[6:]} {kw}: "
        f"max_abs_err {err:.3e}, entries outside atol {tol[0]}/rtol {tol[1]}: {bad} of {got.numel()}, "
        f"bitwise equal share {same:.6f}")
    if bad or not torch.isfinite(got).all():
        raise SystemExit(f"flash_attention disagrees with its plain version ({label})")
    return err, got


def flash_model_check(label: str, cfg, b: int, s: int, dev, gen) -> None:
    """The attention kernel against its plain version at ``cfg``'s
    attention shape, causal over ``s`` tokens: in float32 (the CUDA-core
    kernel) and in ``cfg``'s bfloat16 (the tensor-core kernel the model's
    path launches)."""
    q, k, v = (torch.randn(shape, device=dev, generator=gen) for shape in
               ((b, s, cfg.n_heads, cfg.hd), (b, s, cfg.n_kv_heads, cfg.hd), (b, s, cfg.n_kv_heads, cfg.hd)))
    flash_compare(label, q, k, v, dict(causal=True), FLASH_F32_TOL)
    flash_compare(label, *(x.to(torch.bfloat16) for x in (q, k, v)), dict(causal=True), FLASH_BF16_TOL)


@contextlib.contextmanager
def moe_dispatches():
    """Collect each MoE layer call's dispatch, wrapping ``moe.dispatch``
    inside the block: per call, the share of (token, choice) pairs dropped
    at capacity (a tensor on the card, no host sync) and each pair's row of
    the dispatch buffer in token order."""
    from repro_torch.models import moe

    got, real = [], moe.dispatch

    def spy(flat_e, e, cap):
        order, dest, keep = real(flat_e, e, cap)
        got.append({"drop_frac": 1.0 - torch.mean(keep.to(torch.float32)),
                    "dest": torch.gather(dest, 1, torch.argsort(order, dim=-1, stable=True))})
        return order, dest, keep

    moe.dispatch = spy
    try:
        yield got
    finally:
        moe.dispatch = real


def ptxas_entries(log_text: str) -> dict:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: registers, spill
    store and load bytes, keyed by the mangled name."""
    out, name = {}, None
    for line in log_text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


def lm_phase(dev, card: str, seed: int, cfg, batch: int, seq: int, cli_argv: list, counters: dict) -> dict:
    """Phase 7: the attention kernel and the LM serving path at ``cfg``'s
    widths. Returns the kernel's JSON entry, each path's launch counts and
    the prefill's p50."""
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32
    from repro_torch.models import api, lm
    from repro_torch.models.params import tree_leaves, tree_to

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)

    def qkv(b, s, skv, h, hkv, hd, dtype=torch.float32):
        return [torch.randn(shape, device=dev, generator=gen).to(dtype)
                for shape in ((b, s, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd))]

    # ------------------------------------------------ a. kernel vs plain
    for c in FLASH_CASES:
        b, s, skv, h, hkv, hd, causal, window = c
        for dtype, tol in ((torch.float32, FLASH_F32_TOL), (torch.bfloat16, FLASH_BF16_TOL)):
            flash_compare("case", *qkv(b, s, skv, h, hkv, hd, dtype), dict(causal=causal, window=window, q_offset=skv - s),
                    tol)
    shape = (batch, seq, seq, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    q32, k32, v32 = qkv(*shape)
    flash_compare("model shape", q32, k32, v32, {}, FLASH_F32_TOL)
    q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
    bf16_err, out = flash_compare("model shape", q, k, v, {}, FLASH_BF16_TOL)
    if not torch.equal(fa_ops.flash_attention(q, k, v), out):
        raise SystemExit("flash_attention: two launches on the same inputs differ")
    log("flash_attention: two launches at the model shape bitwise equal")
    gq, gk, gv = qkv(2, 96, 160, 4, 2, 64)
    gout = torch.randn(gq.shape, device=dev, generator=gen)
    grads = []
    for fn in (fa_ops.flash_attention, attention_ref):
        leaves = [x.clone().requires_grad_() for x in (gq, gk, gv)]
        grads.append(torch.autograd.grad(fn(*leaves, causal=True, window=48, q_offset=64), leaves, gout))
    gerr = max(grad_report(a, b_)[0] for a, b_ in zip(*grads))
    gbad = sum(grad_report(a, b_)[1] for a, b_ in zip(*grads))
    log(f"flash_attention autograd.Function vs autograd of the plain version (2, 96, 4, 64), kv 160, window 48: "
        f"gradients max_abs_err {gerr:.3e}, entries outside atol 2e-5*max|g|/rtol 2e-4: {gbad}")
    if gbad:
        raise SystemExit("flash_attention gradient disagrees with the plain version's")

    # ------------------------------------------------ b. time at the prefill shape
    ms = cuda_ms(lambda: fa_ops.launch(q, k, v), 10, "flash_attention kernel")
    f32_ms = cuda_ms(lambda: fa_ops.launch(q32, k32, v32), 3, "flash_attention float32 kernel")
    plain_ms = wall_ms(lambda: attention_ref(q, k, v), 3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), 10,
                     "scaled_dot_product_attention")
    lib_err = float((F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
                     .float() - out.float()).abs().max())
    pairs = kcost.attention_pairs(seq, seq, True, None, 0)
    flops, nbytes = kcost.attention_cost(q, k, v, causal=True)
    bound, bound_by = kcost.bound_ms(flops, nbytes, PEAK_FLOPS_BF16, HBM_BW)
    log(f"time flash_attention {tuple(q.shape)} kv {tuple(k.shape)} bfloat16 causal ({card}): kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.2f} TFLOP/s of counted work; host "
        f"{host_us(lambda: fa_ops.launch(q, k, v), 20):.1f} us per launch), plain {plain_ms:.4f} ms (wall per call), "
        f"scaled_dot_product_attention {lib_ms:.4f} ms (max |difference| from the kernel {lib_err:.3e}), bound "
        f"{bound:.4f} ms ({bound_by}: {flops} flops = 4 x hd x {pairs} unmasked pairs x B x H at 989 TFLOP/s; "
        f"{nbytes} B of q, k, v, o at 3.35 TB/s)")
    log(f"time flash_attention {tuple(q.shape)} kv {tuple(k.shape)} float32 causal ({card}): CUDA-core kernel "
        f"{f32_ms:.4f} ms ({flops / f32_ms / 1e9:.2f} TFLOP/s of counted work; bound {flops / PEAK_FLOPS_FP32 * 1e3:.4f}"
        f" ms at 67 TFLOP/s float32)")
    del q, k, v, q32, k32, v32, qt, kt, vt, out, gq, gk, gv, grads

    # ------------------------------------------------ c. prefill at full width
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"lm: {cfg.name} {cfg.n_layers}L d={cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} hd {cfg.hd} "
        f"d_ff {cfg.d_ff} vocab {cfg.vocab} {cfg.dtype}, {n_params} parameters from seed {seed} on the card "
        f"({time.perf_counter() - t0:.2f} s)")
    tokens = torch.randint(0, cfg.vocab, (batch, seq), device=dev, generator=gen)
    prefill = api.make_prefill_step(cfg)
    prefill(params, {"tokens": tokens})  # warm-up: cuBLAS handles and the first launches
    torch.cuda.synchronize()
    calls = 3
    for c in counters.values():
        c.n = 0
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prefill_launches = {name: c.n for name, c in counters.items()}
    p50 = float(np.median(times))
    log(f"lm prefill {cfg.name} batch {batch} x {seq} tokens ({card}): ms {[round(x, 3) for x in times]}, p50 "
        f"{p50:.3f} ms, {batch * seq / p50 * 1e3:.1f} prompt tokens/s; logits {tuple(logits.shape)} "
        f"{str(logits.dtype)[6:]}, finite {bool(torch.isfinite(logits).all())}; launches {prefill_launches} "
        f"(want flash_attention {cfg.n_layers} per call x {calls}, the others 0)")
    if logits.shape != (batch, 1, cfg.vocab) or not torch.isfinite(logits).all():
        raise SystemExit("lm prefill: last-position logits of the wrong shape or not finite")
    want = {name: (cfg.n_layers * calls if name == "flash_attention" else 0) for name in counters}
    if prefill_launches != want:
        raise SystemExit(f"lm prefill launches {prefill_launches}, want {want}")
    profile_step(lambda: prefill(params, {"tokens": tokens}), p50, label="lm prefill step")
    del tokens, logits

    # ------------------------------------------------ d. the serving CLI's loop
    for c in counters.values():
        c.n = 0
    res = serve_cli.main(cli_argv)
    torch.cuda.synchronize()
    cli_launches = {name: c.n for name, c in counters.items()}
    n_prompt, n_gen = res["prompt"].shape[1], res["ids"].shape[1]
    log(f"lm serve CLI {cli_argv} ({card}): prefill {res['prefill_s'] * 1e3:.3f} ms over {n_prompt} serve steps "
        f"({res['prefill_s'] * 1e3 / n_prompt:.3f} ms per step), decode {res['decode_s'] / max(n_gen - 1, 1) * 1e3:.3f}"
        f" ms/token; ids {res['ids'].tolist()}; launches {cli_launches} (decode attention is plain PyTorch)")
    if res["ids"].shape != (res["prompt"].shape[0], n_gen) or any(cli_launches.values()):
        raise SystemExit(f"lm serve CLI: ids {res['ids'].shape}, launches {cli_launches}")
    # one decode step at the CLI's shapes, 33 tokens into a 48-slot cache
    serve = api.make_serve_step(cfg)
    b_cli = res["prompt"].shape[0]
    cache = api.init_cache(cfg, b_cli, n_prompt + n_gen, device=dev)
    tok = torch.as_tensor(res["ids"][:, :1], device=dev)
    for t in range(n_prompt + 1):
        serve(params, cache, tok, t)
    profile_step(lambda: serve(params, cache, tok, n_prompt + 1), res["decode_s"] / max(n_gen - 1, 1) * 1e3,
                 label="lm serve step")
    del params, cache

    # ------------------------------------------------ e. float32 cross-checks
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = lm.init_params(cfg32, seed=seed + 1, device=dev)
    toks = torch.randint(0, cfg.vocab, (1, 128), device=dev, generator=gen)
    step32 = api.make_prefill_step(cfg32)
    card_logits = step32(p32, {"tokens": toks}).float().cpu()
    t0 = time.perf_counter()
    cpu_logits = step32(tree_to(p32, "cpu"), {"tokens": toks.cpu()})
    cpu_s = time.perf_counter() - t0
    serve32 = api.make_serve_step(cfg32)
    cache = api.init_cache(cfg32, 1, 128, device=dev)
    for t in range(128):
        dec_logits, cache = serve32(p32, cache, toks[:, t:t + 1], t)
    dec_logits = dec_logits.cpu()
    scale = float(cpu_logits.abs().max())
    for label, got, ref in (("card prefill vs CPU prefill", card_logits, cpu_logits),
                            ("card prefill vs card serve steps", card_logits, dec_logits)):
        err = float((got - ref).abs().max())
        log(f"lm cross-check float32 {label} (1 x 128 tokens, {cfg.n_layers} layers): max_abs_err {err:.3e}, "
            f"relative to max |logit| {scale:.4f}: {err / scale:.3e} (tolerance {LM_CROSS_TOL:g}); "
            f"argmax equal {bool((got.argmax(-1) == ref.argmax(-1)).all())}")
        if not err <= LM_CROSS_TOL * scale:
            raise SystemExit(f"lm cross-check failed: {label}")
    log(f"lm cross-check: the CPU prefill took {cpu_s:.2f} s")
    del p32, cache

    # ------------------------------------------------ f. peak memory
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"lm phase ({card}): max_memory_allocated {peak} B, {time.perf_counter() - t_phase:.1f} s")
    entry = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/flash_attention.py:23",
             "launches": prefill_launches["flash_attention"], "max_abs_err": bf16_err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
             "library_ms": lib_ms, "float32_ms": f32_ms}
    return {"entry": entry, "lm_prefill": prefill_launches, "lm_serve_cli": cli_launches, "prefill_ms": p50}


LM_TRAIN_BATCH = 4              # the train_4k sequence; its global batch of 256 cut to 4 for one card
MOE_TRAIN_BATCH = 2             # granite-moe's weights, gradients and AdamW moments take ~40 GB
TRAIN_STEPS = 3                 # timed steps after one warm-up
TRAIN_LOSS_RTOL = 1e-4          # float32 card vs CPU: one step's loss
TRAIN_GRAD_TOL = 1e-3           # float32 card vs CPU: every gradient leaf, max |difference| <= this x max |g|
CROSS_SEQ = 128                 # tokens per row of the float32 card-vs-CPU checks


def train_batch(cfg, b: int, s: int, dev, gen) -> dict:
    """A batch of ``cfg``'s family on the device from ``gen``, key for key
    and shape for shape ``configs/common.py``'s ``lm_batch_specs``: token
    ids and labels (int64 here, the index type of torch's gathers; int32 in
    the specs); whisper's audio frames (the stub frontend's output) and the
    VLM's merged embeddings from a normal distribution in ``cfg``'s dtype;
    the VLM's M-RoPE triples those of a text run (a quarter of the
    sequence) and one image's (t, h, w) grid of 64-patch rows."""
    from repro_torch.configs.common import ShapeCase, lm_batch_specs, vlm_positions3

    out = {}
    for key, spec in lm_batch_specs(cfg, ShapeCase(s, b, "train")).items():
        if key == "positions3":
            n_img = s - s // 4
            grid = (n_img // 64, 64) if n_img >= 64 else (1, n_img)
            out[key] = torch.from_numpy(vlm_positions3(b, s, s // 4, grid)).to(dev)
        elif spec.dtype == torch.int32:
            out[key] = torch.randint(0, cfg.vocab, spec.shape, device=dev, generator=gen)
        else:
            out[key] = torch.randn(spec.shape, device=dev, generator=gen).to(spec.dtype)
    return out


def run_train_steps(label: str, card: str, step, params, opt, batch: dict, counters: dict, want_attn: int) -> dict:
    """One warm-up and ``TRAIN_STEPS`` timed steps of ``step``; the launch
    counters zeroed just before the timed steps and read just after (``want_attn``
    attention launches per step, the other kernels none); wall ms per step
    (ending in the loss read), tokens/s and peak memory. Fails on a
    non-finite loss or a wrong count."""
    dev = batch["labels"].device
    b, s = batch["labels"].shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params, opt, m = step(params, opt, batch)
    losses = [float(m["loss"])]
    for c in counters.values():
        c.n = 0
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {name: c.n for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    p50 = float(np.median(times))
    log(f"{label} train step batch {b} x {s} tokens ({card}): losses {[round(x, 6) for x in losses]} (warm-up first), "
        f"ms {[round(x, 3) for x in times]}, p50 {p50:.3f} ms, {b * s / p50 * 1e3:.1f} tokens/s; max_memory_allocated "
        f"{peak} B ({peak / 2**30:.2f} GiB); launches over {TRAIN_STEPS} steps {launches} (want flash_attention "
        f"{want_attn} per step, the forward and any remat recompute; the others 0)")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"{label} train step: non-finite loss {losses}")
    want = {name: (want_attn * TRAIN_STEPS if name == "flash_attention" else 0) for name in counters}
    if launches != want:
        raise SystemExit(f"{label} train step launches {launches}, want {want}")
    return {"params": params, "opt": opt, "p50": p50, "peak": peak, "launches": launches}


def attention_vjp_profile(prof) -> str:
    """Device ms under the attention's backward (its plain version's VJP,
    recomputed from the saved inputs) and in the kernel's own launches, from
    a profiled step."""
    # the autograd engine's node events only: the backward's own op event
    # nests inside one and would count its kernels twice
    vjp_ms = sum(ev.device_time_total for ev in prof.events()
                 if ev.name.startswith("autograd::engine::evaluate_function") and "FlashAttentionBackward" in ev.name
                 and ev.device_type == torch.autograd.DeviceType.CPU) / 1e3
    kern_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and ("attention_tc_kernel" in ev.key or "flash_attention_kernel" in ev.key)) / 1e3
    return (f"attention plain VJP (FlashAttentionBackward nodes) {vjp_ms:.3f} ms of device time, the attention "
            f"kernel's launches (forward and recompute) {kern_ms:.3f} ms")


def leaf_paths(tree, path: str = "") -> list:
    """The "/"-joined key paths of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in leaf_paths(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree) for q in leaf_paths(v, f"{path}/{i}")]
    return [path]


def cross_check_train(label: str, cfg32, dev, seed: int, gen, b: int) -> None:
    """One float32 train step on the card and on the CPU from the same
    weights and batch: the loss within ``TRAIN_LOSS_RTOL``, every gradient
    leaf (read from AdamW's first moment, g = m / 0.1) within
    ``TRAIN_GRAD_TOL`` x its max |g|."""
    from repro_torch.models import api, lm
    from repro_torch.models.params import tree_leaves, tree_to

    p_card = lm.init_params(cfg32, seed=seed, device=dev)
    p_host = tree_to(p_card, "cpu")  # before the card's step updates its weights in place
    batch = train_batch(cfg32, b, CROSS_SEQ, dev, gen)
    step = api.make_train_step(cfg32)
    res = []
    t0 = time.perf_counter()
    for p, d in ((p_card, dev), (p_host, torch.device("cpu"))):
        _, opt, m = step(p, api.adamw_init(p), {k: v.to(d) for k, v in batch.items()})
        res.append((float(m["loss"]), [x.cpu() / 0.1 for x in tree_leaves(opt["m"])]))
        del opt
    (l_k, g_k), (l_c, g_c) = res
    errs = [float((a - c).abs().max()) / max(float(c.abs().max()), 1e-30) for a, c in zip(g_k, g_c)]
    worst = int(np.argmax(errs))
    log(f"{label} cross-check float32 train step ({b} x {CROSS_SEQ} tokens, {cfg32.n_layers} layers), card vs CPU: "
        f"loss {l_k:.7f} vs {l_c:.7f} (rtol {TRAIN_LOSS_RTOL:g}); gradients over {len(errs)} leaves: worst max "
        f"|difference| / max |g| {errs[worst]:.3e} at {leaf_paths(p_card)[worst]} (tolerance {TRAIN_GRAD_TOL:g}); "
        f"{time.perf_counter() - t0:.1f} s")
    if abs(l_k - l_c) > TRAIN_LOSS_RTOL * abs(l_c) or max(errs) > TRAIN_GRAD_TOL:
        raise SystemExit(f"{label}: the card's train step disagrees with the CPU path")


def lm_train_phase(dev, card: str, seed: int, cfg, batch: int, seq: int, counters: dict) -> dict:
    """Phase 7b: ``make_train_step`` at ``cfg``'s widths. Returns the
    attention launches of the timed steps."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import api, lm
    from repro_torch.models import common as C
    from repro_torch.models.params import tree_leaves, tree_map

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    params = lm.init_params(cfg, seed=seed, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"lm train: {cfg.name} {cfg.n_layers}L d={cfg.d_model} vocab {cfg.vocab} {cfg.dtype}, {n_params} parameters "
        f"from seed {seed}, remat {cfg.remat}, AdamW moments float32")
    data = train_batch(cfg, batch, seq, dev, gen)
    step = api.make_train_step(cfg)
    run = run_train_steps("lm", card, step, params, api.adamw_init(params), data, counters, 2 * cfg.n_layers)
    params, opt = run["params"], run["opt"]
    got = profile_step(lambda: step(params, opt, data), run["p50"], label="lm train step")
    if got:
        log(f"lm train step profile: {attention_vjp_profile(got[0])}")

    # the step's pieces timed alone (wall per call, the device drained after
    # each: each piece is device-bound): the forward with grad on (remat keeps
    # each layer's input), one layer's attention plain VJP x n_layers, the
    # chunked cross-entropy forward and backward, AdamW
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    fwd_ms = wall_ms(lambda: api.compute_loss(cfg, params, data), 2)
    for p in leaves:
        p.requires_grad_(False)
    shape = (batch, seq, cfg.n_heads, cfg.hd)
    q, k, v = (torch.randn(sh, device=dev, generator=gen).to(C.dtype_of(cfg)).requires_grad_()
               for sh in (shape, (batch, seq, cfg.n_kv_heads, cfg.hd), (batch, seq, cfg.n_kv_heads, cfg.hd)))
    gout = torch.randn(shape, device=dev, generator=gen).to(C.dtype_of(cfg))
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    vjp_ms = wall_ms(lambda: torch.autograd.grad(attention_ref(q, k, v), (q, k, v), gout), 2)
    vjp_peak = torch.cuda.max_memory_allocated(dev) - base
    kern_ms = cuda_ms(lambda: fa_ops.launch(q.detach(), k.detach(), v.detach()), 5, "flash_attention kernel")
    del q, k, v, gout
    xh = torch.randn((batch, seq, cfg.d_model), device=dev, generator=gen).to(C.dtype_of(cfg)).requires_grad_()
    emb = params["embed"]["embedding"].detach().requires_grad_()
    ce_ms = wall_ms(lambda: torch.autograd.grad(C.chunked_ce_loss({"embedding": emb}, xh, data["labels"]),
                                                (xh, emb)), 2)
    del xh, emb
    zeros = tree_map(torch.zeros_like, params)
    adam_ms = wall_ms(lambda: api.adamw_update(params, zeros, opt), 2)
    del zeros
    log(f"lm train step split ({card}; wall per call of each piece alone, device-bound): step p50 {run['p50']:.3f} ms "
        f"= forward with grad {fwd_ms:.3f} ms (x2 with the remat recompute) + attention plain VJP {vjp_ms:.3f} ms a "
        f"layer x {cfg.n_layers} = {vjp_ms * cfg.n_layers:.3f} ms (its transient memory {vjp_peak} B; the kernel's "
        f"forward {kern_ms:.4f} ms a layer) + cross-entropy forward and backward {ce_ms:.3f} ms + AdamW "
        f"{adam_ms:.3f} ms + the rest of the backward "
        f"{run['p50'] - 2 * fwd_ms - vjp_ms * cfg.n_layers - ce_ms - adam_ms:.3f} ms")
    del params, opt, data

    cross_check_train("lm", dataclasses.replace(cfg, dtype="float32"), dev, seed + 2, gen, 1)
    log(f"lm train phase ({card}): {time.perf_counter() - t_phase:.1f} s")
    return run["launches"]


def moe_phase(dev, card: str, seed: int, cfg, batch: int, seq: int, cli_argv: list, counters: dict) -> dict:
    """Phase 7c: the MoE decoder ``cfg`` at its widths: the attention
    kernel at its shapes, prefill, the serving CLI's loop, training, and
    float32 checks against the CPU at 4 layers. Returns each path's launch
    counts."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import api, lm
    from repro_torch.models.params import tree_leaves, tree_to

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    cap = int((seq * cfg.top_k / cfg.n_experts) * cfg.capacity_factor) + 1
    params = lm.init_params(cfg, seed=seed, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"moe: {cfg.name} {cfg.n_layers}L d={cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} hd {cfg.hd}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} d_ff {cfg.moe_d_ff}, vocab {cfg.vocab} {cfg.dtype}: {n_params} "
        f"parameters ({cfg.active_param_count()} active a token) from seed {seed}")

    # ------------------------------------------------ the attention kernel at the prefill's and training's shapes
    for b in (batch, MOE_TRAIN_BATCH):
        flash_model_check("moe shape", cfg, b, seq, dev, gen)

    # ------------------------------------------------ prefill
    tokens = torch.randint(0, cfg.vocab, (batch, seq), device=dev, generator=gen)
    prefill = api.make_prefill_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    calls = 3
    for c in counters.values():
        c.n = 0
    times = []
    with moe_dispatches() as rec:
        for _ in range(calls):
            t0 = time.perf_counter()
            logits = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    prefill_launches = {name: c.n for name, c in counters.items()}
    p50 = float(np.median(times))
    drops = [float(a["drop_frac"]) for a in rec[:cfg.n_layers]]
    log(f"moe prefill batch {batch} x {seq} tokens ({card}): ms {[round(x, 3) for x in times]}, p50 {p50:.3f} ms, "
        f"{batch * seq / p50 * 1e3:.1f} prompt tokens/s; max_memory_allocated {torch.cuda.max_memory_allocated(dev)} B; "
        f"logits finite {bool(torch.isfinite(logits).all())}; launches {prefill_launches} (want flash_attention "
        f"{cfg.n_layers} per call x {calls}); capacity {cap} a expert and row; drop_frac per layer "
        f"{[round(x, 5) for x in drops]} (mean {np.mean(drops):.5f})")
    want = {name: (cfg.n_layers * calls if name == "flash_attention" else 0) for name in counters}
    if logits.shape != (batch, 1, cfg.vocab) or not torch.isfinite(logits).all() or prefill_launches != want:
        raise SystemExit(f"moe prefill: logits {tuple(logits.shape)}, launches {prefill_launches}, want {want}")
    profile_step(lambda: prefill(params, {"tokens": tokens}), p50, label="moe prefill step")
    del tokens, logits, rec

    # ------------------------------------------------ the serving CLI's loop
    for c in counters.values():
        c.n = 0
    with moe_dispatches() as rec:
        res = serve_cli.main(cli_argv)
    torch.cuda.synchronize()
    cli_launches = {name: c.n for name, c in counters.items()}
    n_prompt, n_gen = res["prompt"].shape[1], res["ids"].shape[1]
    b_cli = res["prompt"].shape[0]
    fold = [float(a["drop_frac"]) for a in rec]
    decode_ms = res["decode_s"] / max(n_gen - 1, 1) * 1e3
    log(f"moe serve CLI {cli_argv} ({card}): prefill {res['prefill_s'] * 1e3:.3f} ms over {n_prompt} serve steps, "
        f"decode {decode_ms:.3f} ms/token; ids {res['ids'].tolist()}; launches {cli_launches} (decode attention is "
        f"plain PyTorch); the decode fold (batch {b_cli} as one dispatch group, capacity "
        f"{int((b_cli * cfg.top_k / cfg.n_experts) * cfg.capacity_factor) + 1}): drop_frac over {len(fold)} layer "
        f"calls mean {np.mean(fold):.5f}, max {max(fold):.5f}")
    if (res["ids"].shape != (b_cli, n_gen) or any(cli_launches.values())
            or len(fold) != cfg.n_layers * (n_prompt + n_gen - 1)):
        raise SystemExit(f"moe serve CLI: ids {res['ids'].shape}, launches {cli_launches}, {len(fold)} MoE calls")
    # one decode step at the CLI's shapes, n_prompt + 1 tokens into its cache
    serve = api.make_serve_step(cfg)
    cache = api.init_cache(cfg, b_cli, n_prompt + n_gen, device=dev)
    tok = torch.as_tensor(res["ids"][:, :1], device=dev)
    for t in range(n_prompt + 1):
        serve(params, cache, tok, t)
    profile_step(lambda: serve(params, cache, tok, n_prompt + 1), decode_ms, label="moe serve step")
    del res, rec, cache

    # ------------------------------------------------ training
    step = api.make_train_step(cfg)
    data = train_batch(cfg, MOE_TRAIN_BATCH, seq, dev, gen)
    run = run_train_steps("moe", card, step, params, api.adamw_init(params), data, counters, 2 * cfg.n_layers)
    params, opt = run["params"], run["opt"]
    got = profile_step(lambda: step(params, opt, data), run["p50"], label="moe train step")
    if got:
        log(f"moe train step profile: {attention_vjp_profile(got[0])}")
    del params, opt, data
    torch.cuda.empty_cache()

    # ------------------------------------------------ float32, full widths, 4 layers: card vs CPU
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=4)
    p32 = lm.init_params(cfg32, seed=seed + 3, device=dev)
    toks = torch.randint(0, cfg.vocab, (2, CROSS_SEQ), device=dev, generator=gen)
    step32 = api.make_prefill_step(cfg32)
    out = []
    for p, d in ((p32, dev), (tree_to(p32, "cpu"), torch.device("cpu"))):
        with moe_dispatches() as rec:
            lg = step32(p, {"tokens": toks.to(d)}).float().cpu()
        out.append((lg, [r["dest"].cpu() for r in rec], [float(r["drop_frac"]) for r in rec]))
    (lg_k, dest_k, drop_k), (lg_c, dest_c, drop_c) = out
    err, scale = float((lg_k - lg_c).abs().max()), float(lg_c.abs().max())
    same = len(dest_k) == len(dest_c) == cfg32.n_layers and all(torch.equal(a, b_) for a, b_ in zip(dest_k, dest_c))
    log(f"moe cross-check float32 prefill (2 x {CROSS_SEQ} tokens, {cfg32.n_layers} layers), card vs CPU: max_abs_err "
        f"{err:.3e}, relative to max |logit| {scale:.4f}: {err / scale:.3e} (tolerance {LM_CROSS_TOL:g}); the same "
        f"dispatch (every pair's buffer row, the dropped ones included) {same}; drop_frac card {drop_k}, CPU {drop_c}")
    if not err <= LM_CROSS_TOL * scale or not same:
        raise SystemExit("moe cross-check failed: the card's prefill disagrees with the CPU path")
    del p32
    cross_check_train("moe", cfg32, dev, seed + 4, gen, 2)
    log(f"moe phase ({card}): {time.perf_counter() - t_phase:.1f} s")
    return {"moe_prefill": prefill_launches, "moe_serve_cli": cli_launches, "moe_train": run["launches"]}


# ---------------------------------------------------------------- phases 7d-7g: the other LM families
FAMILY_BATCH = 4                # the prefill step's batch x LM_SEQ tokens, as phases 7 and 7c


def attention_calls(cfg, train: bool = False) -> int:
    """The attention kernel's launches in one forward of ``cfg``, from the
    JAX layer plans (``models/lm.py``); with ``train``, in a train step,
    where a stacked unit under ``cfg.remat`` runs its forward again in the
    backward."""
    from repro_torch.models import lm

    unit, n_units, rem = lm.layer_plan(cfg)
    again = 2 if train and cfg.remat else 1
    if cfg.arch_type == "zamba":  # a shared block after each half of a double unit; A after every period of rem
        return again * 2 * n_units + len(rem) // max(cfg.attn_every, 1)
    if cfg.arch_type == "whisper":  # encoder, decoder and cross-attention layers, none stacked
        return cfg.n_enc_layers + 2 * cfg.n_layers
    per_unit = sum(k in lm.ATTN_KINDS for k in unit)
    return (again if lm.uses_units(cfg) else 1) * per_unit * n_units + sum(k in lm.ATTN_KINDS for k in rem)


def flash_family_checks(label: str, card: str, shapes: list, dev, gen) -> list:
    """The attention kernel against its plain version at a family's shapes
    ((what, B, S, Skv, H, Hkv, hd, causal)), float32 and bfloat16, the bf16
    launch twice bitwise equal; then each shape timed: the bf16 kernel (CUDA
    events), its bound, ``scaled_dot_product_attention(..., enable_gqa=)``
    and, at the first shape, the float32 kernel and the plain version.
    Returns one timing row per shape."""
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.kernels.flash_attention.ref import attention_ref

    rows = []
    for i, (what, b, s, skv, h, hkv, hd, causal) in enumerate(shapes):
        q32, k32, v32 = (torch.randn(sh, device=dev, generator=gen)
                         for sh in ((b, s, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd)))
        kw = dict(causal=causal)
        flash_compare(f"{label} {what}", q32, k32, v32, kw, FLASH_F32_TOL)
        q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
        err, out = flash_compare(f"{label} {what}", q, k, v, kw, FLASH_BF16_TOL)
        if not torch.equal(fa_ops.flash_attention(q, k, v, **kw), out):
            raise SystemExit(f"flash_attention ({label} {what}): two launches on the same inputs differ")
        ms = cuda_ms(lambda: fa_ops.launch(q, k, v, **kw), 10, f"flash_attention {label} {what}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True), 10,
                         "scaled_dot_product_attention")
        pairs = kcost.attention_pairs(s, skv, causal, None, 0)
        flops, nbytes = kcost.attention_cost(q, k, v, causal=causal)
        bound, bound_by = kcost.bound_ms(flops, nbytes, PEAK_FLOPS_BF16, HBM_BW)
        row = {"shape": f"{label} {what}: B {b}, S {s}, Skv {skv}, heads {h}/{hkv}, hd {hd}, "
                        f"{'causal' if causal else 'non-causal'}, bf16",
               "ms": ms, "max_abs_err": err, "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms}
        extra = ""
        if i == 0:
            row["float32_ms"] = cuda_ms(lambda: fa_ops.launch(q32, k32, v32, **kw), 3, "flash_attention float32")
            row["plain_ms"] = wall_ms(lambda: attention_ref(q, k, v, **kw), 3)
            extra = (f"; the float32 kernel {row['float32_ms']:.4f} ms, the plain version {row['plain_ms']:.4f} ms "
                     "(wall per call)")
        log(f"time flash_attention {row['shape']} ({card}): kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s of "
            f"counted work), scaled_dot_product_attention {lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({bound_by}: {flops} flops = 4 x hd x {pairs} unmasked pairs x B x H at 989 TFLOP/s; {nbytes} B at "
            f"3.35 TB/s){extra}")
        rows.append(row)
        del q32, k32, v32, q, k, v, qt, kt, vt, out
    return rows


def recurrent_layer_times(label: str, card: str, cfg, layer, fn, b_prefill: int, b_train: int, dev, gen) -> dict:
    """One recurrent layer's block (``fn(p, cfg, x)``: the SSD or the sLSTM)
    timed alone, wall per call with the device drained after each (one
    warm-up at the same shape, one timed call: the sLSTM's take seconds, and
    a cold SSD call pays the allocator for its first multi-GB tensors): its
    forward at the prefill's and the training's batch, and its forward and
    backward at the training's."""
    dtype = layer["norm"]["scale"].dtype
    x = torch.randn((b_prefill, LM_SEQ, cfg.d_model), device=dev, generator=gen).to(dtype)
    with torch.no_grad():
        fwd_ms = wall_ms(lambda: fn(layer, cfg, x), 1)
        fwd_train_ms = fwd_ms if b_train == b_prefill else wall_ms(lambda: fn(layer, cfg, x[:b_train]), 1)
    xt = x[:b_train].clone().requires_grad_()
    leaves = [v.requires_grad_() for v in layer.values() if isinstance(v, torch.Tensor)]
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fwd_bwd_ms = wall_ms(lambda: torch.autograd.grad(fn(layer, cfg, xt).float().sum(), [xt, *leaves]), 1)
    peak = torch.cuda.max_memory_allocated(dev) - base
    log(f"{label} {fn.__name__} alone ({card}; wall per call, the device drained after each): forward at "
        f"{b_prefill} x {LM_SEQ} {fwd_ms:.3f} ms, at {b_train} x {LM_SEQ} {fwd_train_ms:.3f} ms; forward and backward "
        f"at {b_train} x {LM_SEQ} {fwd_bwd_ms:.3f} ms (transient memory {peak} B)")
    return {"fwd_ms": fwd_ms, "fwd_train_ms": fwd_train_ms, "fwd_bwd_ms": fwd_bwd_ms}


def count_kind(cfg, kind: str) -> int:
    """Layers of ``kind`` in ``cfg``'s layer plan."""
    from repro_torch.models import lm

    unit, n_units, rem = lm.layer_plan(cfg)
    return unit.count(kind) * n_units + rem.count(kind)


def family_phase(dev, card: str, seed: int, label: str, cfg, *, counters: dict, attn_shapes: list, cli_argv,
                 train_cfg, train_batch_size: int, cross_cfg, cross_b: int, recurrent=None,
                 profile: tuple = ("prefill", "train"), prefill_calls: int = 3) -> dict:
    """Phases 7d-7g: one LM family at its widths. The attention kernel
    against its plain version at the family's shapes and timed
    (``flash_family_checks``); ``make_prefill_step`` at FAMILY_BATCH x
    LM_SEQ (``prefill_calls`` timed after a warm-up: ms p50, tokens/s,
    ``attention_calls`` launches a call, the counters zeroed just before and
    read just after); the serving CLI's
    loop at its defaults (``cli_argv``, or with None its ``serve_loop`` on
    the prefill's weights: a depth the CLI's full config cannot hold);
    ``make_train_step`` at ``train_cfg`` (1 warm-up + 3 timed steps);
    ``profile``: which of one prefill call and one train step to profile
    (``profile_step``); ``recurrent`` = (layer kind, its block's parameters
    from the prefill's weights, the block function): that block alone,
    against the prefill and the train step; float32 at ``cross_cfg`` (full
    widths, a few layers), card against CPU: the prefill's logits and one
    train step. Returns each path's launch counts and the kernel's timing
    rows."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import api, lm
    from repro_torch.models.params import tree_leaves, tree_to

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    torch.cuda.empty_cache()
    rows = flash_family_checks(label, card, attn_shapes, dev, gen)

    # ------------------------------------------------ prefill
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_params(cfg, seed=seed, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"{label}: {cfg.name} {cfg.n_layers}L d={cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} hd {cfg.hd} "
        f"vocab {cfg.vocab} {cfg.dtype}: {n_params} parameters from seed {seed}")
    data = train_batch(cfg, FAMILY_BATCH, LM_SEQ, dev, gen)
    prefill = api.make_prefill_step(cfg)
    prefill(params, data)
    torch.cuda.synchronize()
    calls, want_per_call = prefill_calls, attention_calls(cfg)
    for c in counters.values():
        c.n = 0
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        logits = prefill(params, data)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prefill_launches = {name: c.n for name, c in counters.items()}
    p50 = float(np.median(times))
    log(f"{label} prefill batch {FAMILY_BATCH} x {LM_SEQ} tokens ({card}): ms {[round(x, 3) for x in times]}, p50 "
        f"{p50:.3f} ms, {FAMILY_BATCH * LM_SEQ / p50 * 1e3:.1f} prompt tokens/s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} B; logits {tuple(logits.shape)} finite "
        f"{bool(torch.isfinite(logits).all())}; launches {prefill_launches} (want flash_attention {want_per_call} "
        f"per call x {calls})")
    want = {name: (want_per_call * calls if name == "flash_attention" else 0) for name in counters}
    if logits.shape != (FAMILY_BATCH, 1, cfg.vocab) or not torch.isfinite(logits).all() or prefill_launches != want:
        raise SystemExit(f"{label} prefill: logits {tuple(logits.shape)}, launches {prefill_launches}, want {want}")
    if "prefill" in profile:
        profile_step(lambda: prefill(params, data), p50, label=f"{label} prefill step")
    del logits, data
    layer_times = None
    if recurrent:
        kind, layer_of, fn = recurrent
        layer_times = recurrent_layer_times(label, card, cfg, layer_of(params), fn, FAMILY_BATCH, train_batch_size,
                                            dev, gen)
        n_rec = count_kind(cfg, kind)
        log(f"{label} {fn.__name__} share of the prefill ({card}): {n_rec} layers x {layer_times['fwd_ms']:.3f} ms = "
            f"{n_rec * layer_times['fwd_ms']:.3f} ms of the p50 {p50:.3f} ms "
            f"({n_rec * layer_times['fwd_ms'] / p50:.4f})")

    # ------------------------------------------------ the serving CLI's loop
    if cli_argv is not None:
        del params
        torch.cuda.empty_cache()
    for c in counters.values():
        c.n = 0
    if cli_argv is not None:
        res = serve_cli.main(cli_argv)
        where = f"{cli_argv}"
    else:
        res = serve_cli.serve_loop(cfg, params, batch=4, prompt_len=32, gen=16, cache_len=48, device=dev,
                                   generator=torch.Generator().manual_seed(seed))
        where = f"serve_loop at the CLI's defaults on the {cfg.n_layers}-layer weights"
        del params
    torch.cuda.synchronize()
    cli_launches = {name: c.n for name, c in counters.items()}
    n_prompt, n_gen = res["prompt"].shape[1], res["ids"].shape[1]
    decode_attn = cfg.n_layers if cfg.arch_type == "whisper" else 0  # the cross-attention, through the kernel
    log(f"{label} serve CLI {where} ({card}): prefill {res['prefill_s'] * 1e3:.3f} ms over {n_prompt} serve steps, "
        f"decode {res['decode_s'] / max(n_gen - 1, 1) * 1e3:.3f} ms/token; ids {res['ids'].tolist()}; launches "
        f"{cli_launches} (want flash_attention {decode_attn} per serve step: decode self-attention is plain PyTorch"
        f"{', the cross-attention over the zeroed encoder cache the kernel' if decode_attn else ''})")
    want = {name: (decode_attn * (n_prompt + n_gen - 1) if name == "flash_attention" else 0) for name in counters}
    if res["ids"].shape != (res["prompt"].shape[0], n_gen) or cli_launches != want:
        raise SystemExit(f"{label} serve CLI: ids {res['ids'].shape}, launches {cli_launches}, want {want}")
    del res
    torch.cuda.empty_cache()

    # ------------------------------------------------ training
    params = lm.init_params(train_cfg, seed=seed, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"{label} train: {train_cfg.n_layers} layers, {n_params} parameters, remat {train_cfg.remat}, batch "
        f"{train_batch_size} x {LM_SEQ}")
    step = api.make_train_step(train_cfg)
    data = train_batch(train_cfg, train_batch_size, LM_SEQ, dev, gen)
    run = run_train_steps(label, card, step, params, api.adamw_init(params), data, counters,
                          attention_calls(train_cfg, train=True))
    params, opt = run["params"], run["opt"]
    if "train" in profile:
        got = profile_step(lambda: step(params, opt, data), run["p50"], label=f"{label} train step")
        if got:
            log(f"{label} train step profile: {attention_vjp_profile(got[0])}")
    if layer_times:
        n_rec = count_kind(train_cfg, recurrent[0])
        per = layer_times["fwd_bwd_ms"] + (layer_times["fwd_train_ms"] if train_cfg.remat else 0.0)
        log(f"{label} {recurrent[2].__name__} share of a train step ({card}): {n_rec} layers x {per:.3f} ms (forward "
            f"and backward{', and the remat recompute' if train_cfg.remat else ''}) = {n_rec * per:.3f} ms of the p50 "
            f"{run['p50']:.3f} ms ({n_rec * per / run['p50']:.4f})")
    del params, opt, data, step
    torch.cuda.empty_cache()

    # ------------------------------------------------ float32 at full widths and a few layers: card vs CPU
    cfg32 = dataclasses.replace(cross_cfg, dtype="float32")
    p32 = lm.init_params(cfg32, seed=seed + 5, device=dev)
    batch = train_batch(cfg32, cross_b, CROSS_SEQ, dev, gen)
    step32 = api.make_prefill_step(cfg32)
    lg_k = step32(p32, batch).float().cpu()
    t0 = time.perf_counter()
    lg_c = step32(tree_to(p32, "cpu"), {k: v.cpu() for k, v in batch.items()})
    err, scale = float((lg_k - lg_c).abs().max()), float(lg_c.abs().max())
    log(f"{label} cross-check float32 prefill ({cross_b} x {CROSS_SEQ} tokens, {cfg32.n_layers} layers, "
        f"{attention_calls(cfg32)} attention calls), card vs CPU: max_abs_err {err:.3e}, relative to max |logit| "
        f"{scale:.4f}: {err / scale:.3e} (tolerance {LM_CROSS_TOL:g}); the CPU took {time.perf_counter() - t0:.1f} s")
    if not err <= LM_CROSS_TOL * scale:
        raise SystemExit(f"{label} cross-check failed: the card's prefill disagrees with the CPU path")
    del p32, batch
    cross_check_train(label, cfg32, dev, seed + 6, gen, cross_b)
    log(f"{label} phase ({card}): {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {f"{label}_prefill": prefill_launches, f"{label}_serve_cli": cli_launches,
                         f"{label}_train": run["launches"]}, "rows": rows}


def family_runs(seed: int) -> list:
    """Phases 7d-7g, in order: (label, ``family_phase`` keywords). Widths are
    the published ones; the cuts are of depth and batch."""
    from repro_torch.configs import get_arch
    from repro_torch.models import ssm as SSM
    from repro_torch.models import xlstm as XL
    from repro_torch.models.params import tree_map

    zamba, xl = get_arch("zamba2-7b").config(), get_arch("xlstm-350m").config()
    wh, vlm = get_arch("whisper-tiny").config(), get_arch("qwen2-vl-72b").config()
    cut = dataclasses.replace

    def cli(arch):
        return ["--arch", arch, "--device", "cuda", "--seed", str(seed)]

    def causal(what, b, h, hkv, hd):
        return (what, b, LM_SEQ, LM_SEQ, h, hkv, hd, True)

    return [
        # 7d: 81 layers (6 double units + 9 remainder, 13 shared-attention calls) for prefill and
        # serving; training at 24 layers (2 double units) and 1 x 4096: at 2 x 4096 the recompute
        # of one double unit (12 mamba layers' SSD tensors) runs out of the card's 80 GB; the CPU
        # check at 4 layers with period 1, so that both shared blocks run (2 double units of 1 + 1)
        ("zamba", dict(cfg=zamba, attn_shapes=[causal("shared attention", FAMILY_BATCH, 32, 32, 112),
                                               causal("training", 1, 32, 32, 112)],
                       cli_argv=cli("zamba2-7b"), train_cfg=cut(zamba, n_layers=24), train_batch_size=1,
                       cross_cfg=cut(zamba, n_layers=4, attn_every=1), cross_b=2,
                       recurrent=("mamba", lambda p: tree_map(torch.clone, p["rem_layers"][0]["mamba"]),
                                  SSM.mamba2_train))),
        # 7e: full size throughout; no attention; the CPU check at 2 layers of the smoke config's
        # pattern "MS" (one mLSTM, one sLSTM): deeper mLSTM stacks are ill-conditioned in float32
        # (1e-7 relative noise on the weights of the 8-layer "MMMMMMMS" moves the mLSTM forget-gate
        # bias gradients by up to 1.3e-3 of their max on the CPU, 4 mLSTM layers by 1.2e-4, these
        # 2 layers by 5e-6), so the 1e-3 gate would test rounding, not the card
        ("xlstm", dict(cfg=xl, attn_shapes=[], cli_argv=cli("xlstm-350m"), train_cfg=xl,
                       train_batch_size=FAMILY_BATCH, cross_cfg=cut(xl, n_layers=2, xlstm_pattern="MS"), cross_b=2,
                       recurrent=("slstm", lambda p: tree_map(lambda x: x[0].clone(), p["units"]["slot7"]["slstm"]),
                                  XL.slstm_train),
                       # 353,509 device ops a prefill: its trace takes the profiler minutes, and a
                       # train step's ~10^6 more; one timed prefill call: each takes ~8 s of host time
                       profile=(), prefill_calls=1)),
        # 7f: full size (4 + 4 layers), 1,500 audio frames
        ("whisper", dict(cfg=wh, attn_shapes=[("encoder", FAMILY_BATCH, 1500, 1500, 6, 6, 64, False),
                                              ("cross-attention", FAMILY_BATCH, LM_SEQ, 1500, 6, 6, 64, False),
                                              ("cross-attention decode", FAMILY_BATCH, 1, 1500, 6, 6, 64, False),
                                              causal("decoder", FAMILY_BATCH, 6, 6, 64)],
                         cli_argv=cli("whisper-tiny"), train_cfg=wh, train_batch_size=FAMILY_BATCH, cross_cfg=wh,
                         cross_b=2)),
        # 7g: 8 of 80 layers for prefill and serving (16.5 GB of bf16 weights), 2 for training (a
        # 62 GB peak), 1 for the CPU check (its full-width embedding alone is 1.25e9 parameters)
        ("vlm", dict(cfg=cut(vlm, n_layers=8), attn_shapes=[causal("prefill", FAMILY_BATCH, 64, 8, 128),
                                                           causal("training", 1, 64, 8, 128)],
                     cli_argv=None, train_cfg=cut(vlm, n_layers=2), train_batch_size=1,
                     cross_cfg=cut(vlm, n_layers=1), cross_b=1)),
    ]


RANKS_STEPS = 3
RANKS_CARD_STEPS = 8
RANKS_DIR = ROOT / "build" / "repro_torch_ranks"


def _rank_worker(rank: int, n: int, mode: str, steps: int, res: int, n_views: int, device_type: str,
                 timeout_s: float, dataset: str = "kingsnake") -> None:
    """One rank of a (1, n) run across cards: NCCL on cuda:rank (gloo on
    the CPU when the phase is rehearsed there), ``dataset``'s model
    (``RANKS_DIR/<dataset>.npz``) and views (the ground-truth cache in
    ``RANKS_DIR``), ``steps`` steps through ``GSTrainer(mesh=...)``; rank 0
    writes the losses, step times and every rank's peak memory."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.gs_datasets import DATASETS, paper_gs_config
    from repro_torch.core import gaussians as G
    from repro_torch.data.views import ViewDataset
    from repro_torch.launch.mesh import init_ranks, make_gs_mesh
    from repro_torch.launch.train import GSTrainer
    from repro_torch.volume import datasets as VD

    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    init_ranks(dev, init_method=f"file://{RANKS_DIR}/store_{dataset}_{mode}_{n}", rank=rank, world_size=n,
               timeout_s=timeout_s)
    mesh = make_gs_mesh(1, n, device=dev)
    host = np.load(RANKS_DIR / f"{dataset}.npz")
    ds = DATASETS[dataset]
    data = ViewDataset(getattr(VD, ds.volume)(res=ds.volume_res), n_views=n_views, img_h=res, img_w=res, radius=3.0,
                       cache_dir=str(RANKS_DIR), device=dev)
    cfg = paper_gs_config(res, gather_mode=mode, max_steps=steps)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tr = GSTrainer(cfg, params=G.GaussianModel(*[host[f] for f in G.GaussianModel._fields]), mesh=mesh,
                   verbose=False)
    losses = tr.fit(data, steps=steps, densify=False)
    peaks = [None] * n
    torch.distributed.all_gather_object(peaks, torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    if rank == 0:
        (RANKS_DIR / f"losses_{dataset}_{mode}_{n}.json").write_text(
            json.dumps({"losses": losses, "step_ms": tr.step_ms_log, "peak_bytes": peaks}))
    torch.distributed.destroy_process_group()


def world_one_group(dev) -> float:
    """This process's world-1 NCCL group (file store under ``RANKS_DIR``),
    made once: the serve-ranks and ranks phases share it. Returns the ms it
    took to come up, or 0.0 if it was up already."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks, make_gs_mesh

    if dist.is_initialized():
        return 0.0
    RANKS_DIR.mkdir(parents=True, exist_ok=True)
    for f in RANKS_DIR.glob("store_*"):
        f.unlink()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    init_ranks(dev, init_method=f"file://{RANKS_DIR}/store_1", rank=0, world_size=1, timeout_s=300)
    make_gs_mesh(1, 1, device=dev).barrier()
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
    log(f"ranks: NCCL {nccl}, world-1 group and (1, 1) mesh up in {init_ms:.1f} ms (backend {dist.get_backend()})")
    return init_ms


def ranks_phase(dev, card: str, host, data, counters: dict) -> dict:
    """Training across ranks at the full configuration. At world size 1 a
    NCCL group drives ``GSTrainer(mesh=...)`` (the gathers, reduce-scatters
    and all-reduces are real NCCL calls over groups of one; no pixel strips,
    so no halo exchange) for RANKS_STEPS steps in each gather mode, from the same state on
    the same batches as the one-device trainer: bitwise equal, or the phase
    fails. With two or more cards, (1, 2) and (1, 4) over NCCL with one rank
    per card in each gather mode, the losses held to the one-device trainer
    at rtol 1e-5."""
    import types

    from repro_torch.configs.gs_datasets import paper_gs_config
    from repro_torch.core.train import all_gather_bytes_per_step
    from repro_torch.launch.mesh import make_gs_mesh, spawn_ranks
    from repro_torch.launch.train import GSTrainer
    from repro_torch.utils.tree import tree_leaves

    res = data.img_h
    world_one_group(dev)
    mesh = make_gs_mesh(1, 1, device=dev)

    def fit(mode: str, with_mesh: bool):
        cfg = paper_gs_config(res, gather_mode=mode, max_steps=RANKS_STEPS)
        data.rng = np.random.default_rng(0)  # the same batches for every run
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        tr = GSTrainer(cfg, device=dev, params=host, mesh=mesh if with_mesh else None, verbose=False)
        for c in counters.values():
            c.n = 0
        losses = tr.fit(data, steps=RANKS_STEPS, densify=False)
        torch.cuda.synchronize()
        # the run's own peak: above what was allocated when it started
        return tr, losses, [c.n for c in counters.values()], torch.cuda.max_memory_allocated(dev) - base

    out = {"launches": dict.fromkeys(counters, 0), "step_ms": {}, "peak_bytes": {}}
    one_ms = {}
    for mode in ("projected", "params3d"):
        ref, ref_losses, _, ref_peak = fit(mode, False)
        tr, losses, launches, peak = fit(mode, True)
        same = losses == ref_losses and all(torch.equal(a, b) for a, b in zip(tree_leaves(tr.state),
                                                                               tree_leaves(ref.state)))
        for k, v in zip(counters, launches):
            out["launches"][k] += v
        p50, p50_one = float(np.median(tr.step_ms_log)), float(np.median(ref.step_ms_log))
        out["step_ms"][mode], one_ms[mode] = p50, p50_one
        out["peak_bytes"][mode] = {"world1": peak, "one_device": ref_peak}
        log(f"ranks {mode} ({card}): world-1 NCCL mesh vs one device, {RANKS_STEPS} steps at {host.means.shape[0]} "
            f"Gaussians, {res} px, batch {tr.cfg.batch_size}: losses {[round(x, 7) for x in losses]}; bitwise equal "
            f"(losses, parameters, Adam moments, densify statistics): {same}; step ms {[round(x, 3) for x in tr.step_ms_log]} "
            f"p50 {p50:.3f} vs one device {[round(x, 3) for x in ref.step_ms_log]} p50 {p50_one:.3f}; "
            f"peak above its start {peak} B vs one device {ref_peak} B; launches {dict(zip(counters, launches))}")
        if not same:
            again, again_losses, _, _ = fit(mode, False)
            repro = again_losses == ref_losses and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(again.state), tree_leaves(ref.state)))
            raise SystemExit(f"ranks {mode}: the world-1 sharded step is not bitwise the one-device step "
                             f"(the one-device step reproduces itself bitwise: {repro})")
        if launches[:3] != [4 * RANKS_STEPS] * 3 or launches[3]:
            raise SystemExit(f"ranks {mode}: launches {launches}, want {4 * RANKS_STEPS} of each splatting kernel")
        del ref, tr
    out["one_device_step_ms"] = one_ms

    cfg4 = paper_gs_config(res)
    for m in (2, 4):
        shape = types.SimpleNamespace(shape={"data": 1, "model": m})
        by_mode = {mode: all_gather_bytes_per_step(dataclasses.replace(cfg4, gather_mode=mode), shape,
                                                   host.means.shape[0]) for mode in ("projected", "params3d")}
        log(f"ranks: all_gather_bytes_per_step (computed) at (1, {m}), {host.means.shape[0]} Gaussians, batch "
            f"{cfg4.batch_size}: {by_mode}")
        out[f"gather_bytes_1x{m}"] = by_mode

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"ranks: {n_cards} card on this machine: the ranks phase ran at world size 1 only; (1, n) across cards "
            "not run")
        return out
    # (1, n) with one rank per card, n = 2 and 4 (512 px in 16-px tiles splits into whole-tile strips), each
    # held to the one-device trainer on the same batches; step p50 over the steps after the first two
    # (NCCL's communicators and the kernels warm up in them)
    np.savez(RANKS_DIR / "kingsnake.npz", **{f: getattr(host, f) for f in host._fields})
    np.save(RANKS_DIR / f"kingsnake_like_{data.n_views}v_{res}x{res}.npy", data.gt)
    out["multi_card"] = {}
    for mode in ("projected", "params3d"):
        data.rng = np.random.default_rng(0)
        one = GSTrainer(paper_gs_config(res, gather_mode=mode, max_steps=RANKS_CARD_STEPS), device=dev, params=host,
                        verbose=False)
        want = one.fit(data, steps=RANKS_CARD_STEPS, densify=False)
        world1_ms = one.step_ms_log
        del one
        for n in [k for k in (2, 4) if k <= n_cards]:
            spawn_ranks(_rank_worker, (n, mode, RANKS_CARD_STEPS, res, data.n_views, dev.type, 300.0), n,
                        timeout_s=600)
            got = json.loads((RANKS_DIR / f"losses_kingsnake_{mode}_{n}.json").read_text())
            ok = np.allclose(got["losses"], want, rtol=1e-5, atol=0)
            p50, p50_1 = float(np.median(got["step_ms"][2:])), float(np.median(world1_ms[2:]))
            log(f"ranks (1, {n}) {mode} over NCCL across {n} cards ({card}): {RANKS_CARD_STEPS} steps, losses "
                f"{got['losses']} vs world 1 {want}, within rtol 1e-5: {ok}; step ms (rank 0) "
                f"{[round(x, 3) for x in got['step_ms']]} p50 of steps 3-{RANKS_CARD_STEPS} {p50:.3f} vs one device "
                f"{[round(x, 3) for x in world1_ms]} p50 {p50_1:.3f} (x{p50_1 / p50:.3f}); peak on the fullest rank "
                f"{max(got['peak_bytes'])} B")
            if not ok:
                raise SystemExit(f"ranks: (1, {n}) {mode} losses differ from world 1 beyond rtol 1e-5")
            out["multi_card"][f"{mode}_1x{n}"] = {**got, "world1_losses": want, "world1_step_ms": world1_ms,
                                                  "p50_ms": p50, "world1_p50_ms": p50_1}
    return out


INSITU_DIR = ROOT / "build" / "repro_torch_insitu"
INSITU_STREAM = dict(dataset="miranda", n_timesteps=4, res=256, t1=0.3)
INSITU_COLD, INSITU_WARM, INSITU_VIEWS = 100, 20, 8
INSITU_SMALL = dict(img_h=32, img_w=32, batch_size=2, k_per_tile=128, max_steps=10, densify_from=10**9,
                    opacity_reset_interval=10**9)


def insitu_kw(vol0, res: int) -> dict:
    """The in situ trainer's keywords for a stream of ``res``^3 fields (its
    first field ``vol0``): 8 views, every extracted point, init scale one
    voxel."""
    spacing = 2.0 * vol0.extent / (res - 1)
    return dict(n_views=INSITU_VIEWS, max_points=None, init_scale=spacing, radius=3.0, seed=0)


def insitu_phase(dev, card: str, counters: dict, res: int, step_ms_4m: float) -> dict:
    """In situ at full width, reduced scale: ``InsituTrainer`` over the
    Miranda growth stream (4 timesteps of a 256^3 field, t in [0, 0.3]) at
    ``paper_gs_config(res)`` with densification off, 8 orbit views
    ray-marched on the card per timestep, 100 cold and 20 warm steps, a
    temporal store with asynchronous writes, then the CLI's scrub and live
    replay smokes on the card at pipeline depth 2. The launch counters are
    zeroed just before and read just after. Then the gates: one shape
    signature, distinct scrubbed frames and a replay with no new miss; a
    small run (miranda at res 32, 32 px, K 128, batch 2, 2 timesteps of 3
    cold and 2 warm steps) on the card against the CPU path on the same
    ground truth; and the world-1 NCCL mesh (phases 4b and 5b's group)
    bitwise equal to one device over 2 timesteps of the stream, 10 cold and
    5 warm steps. Returns the launch counts of the run, the scrub and the
    replay."""
    import shutil

    from repro_torch.configs.gs_datasets import paper_gs_config
    from repro_torch.core.config import GSConfig
    from repro_torch.insitu import InsituTrainer, TemporalCheckpointStore
    from repro_torch.launch.insitu import live_replay_smoke, scrub_smoke
    from repro_torch.launch.mesh import make_gs_mesh
    from repro_torch.obs import Obs
    from repro_torch.utils.tree import tree_leaves
    from repro_torch.volume.timevary import synthetic_stream

    shutil.rmtree(INSITU_DIR, ignore_errors=True)
    INSITU_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    vols = list(synthetic_stream(**INSITU_STREAM))
    log(f"insitu: stream {INSITU_STREAM}: {len(vols)} fields generated on the host in "
        f"{time.perf_counter() - t0:.2f} s (the simulation's side, outside the trainer)")
    n_t = len(vols)
    cfg = paper_gs_config(res, densify_from=10**9, opacity_reset_interval=10**9,
                          max_steps=INSITU_COLD + INSITU_WARM * (n_t - 1))
    kw = insitu_kw(vols[0], INSITU_STREAM["res"])
    log(f"insitu: cut to size: widths are the paper's ({res} px, {cfg.tile_h}x{cfg.tile_w} tiles, K "
        f"{cfg.k_per_tile}, binning {cfg.binning}, batch {cfg.batch_size}, lambda_dssim {cfg.lambda_dssim}); scale is "
        f"what extraction gives at a {INSITU_STREAM['res']}^3 field the host generates in seconds (not the paper's "
        f"18M-point Miranda), {n_t} timesteps, {INSITU_VIEWS} views, {INSITU_COLD} cold and {INSITU_WARM} warm steps")

    trainer = InsituTrainer(cfg, device=dev, cold_steps=INSITU_COLD, warm_steps=INSITU_WARM,
                            obs=Obs(trace=True), verbose=True, **kw)
    gt_s, last = [], []
    make_dataset = trainer._dataset

    def timed_dataset(vol):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d = make_dataset(vol)
        torch.cuda.synchronize()
        gt_s.append(time.perf_counter() - t)
        last[:] = [d]
        return d

    trainer._dataset = timed_dataset
    store = TemporalCheckpointStore(str(INSITU_DIR / "seq"), keyframe_interval=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    for c in counters.values():
        c.n = 0
    t0 = time.perf_counter()
    reports = trainer.run(vols, store=store)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    scrub = scrub_smoke(store, cfg, n_scrub=3, pipeline_depth=2, device=dev)
    replay = live_replay_smoke(store, cfg, device=dev)
    torch.cuda.synchronize()
    launches = {k: c.n for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev) - base
    stats = store.stats()
    store.close()

    # where each timestep's wall time goes, from the trace ring (one request id per timestep)
    by_rid: dict = {}
    t_of = {}
    for s in trainer.obs.trace.spans():
        by_rid.setdefault(s.rid, {}).setdefault(s.name, 0.0)
        by_rid[s.rid][s.name] += s.dur
        if s.name == "extract":
            t_of[s.rid] = s.meta["t_index"]
    for rid, names in by_rid.items():
        t = t_of[rid]
        r = reports[t]
        parts = {"extraction": names.get("extract", 0.0), "reseed": names.get("reseed", 0.0), "gt_views": gt_s[t],
                 "fit": names.get("fit", 0.0), "eval": names.get("eval", 0.0), "ckpt_append": names.get("ckpt", 0.0)}
        parts["other"] = r.wall_s - sum(v for k, v in parts.items() if k != "ckpt_append")
        log(f"insitu t={t} {r.mode} ({card}): {r.steps} steps, {r.n_extracted} points extracted, capacity "
            f"{trainer.capacity}, {r.n_reseeded} reseeded, changed slots "
            f"{len(r.changed_slots) if r.changed_slots is not None else None}, PSNR {r.psnr_before:.4f} -> "
            f"{r.psnr_after:.4f} dB, loss {r.loss_final:.6f}; wall_s {r.wall_s:.4f} = "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items() if k != "ckpt_append")
            + f"; then checkpoint append {parts['ckpt_append']:.4f} s")
    cold_ms = trainer.step_ms[:reports[0].steps]
    warm_ms = trainer.step_ms[reports[0].steps:]
    cold_p50, warm_p50 = float(np.median(cold_ms)), float(np.median(warm_ms))
    log(f"insitu ({card}): {sum(r.steps for r in reports)} steps at {trainer.capacity} Gaussians, {res} px, batch "
        f"{cfg.batch_size}: cold step ms p50 {cold_p50:.3f} (min {min(cold_ms):.3f}, max {max(cold_ms):.3f}), warm "
        f"step ms p50 {warm_p50:.3f} (min {min(warm_ms):.3f}, max {max(warm_ms):.3f}); phase 5's step at 4M Gaussians "
        f"p50 {step_ms_4m:.3f} ms; run {run_s:.3f} s; shape signatures {trainer.n_traces}; peak above start {peak} B")
    log(f"insitu store ({card}): {stats}")
    log(f"insitu scrub on the card, depth 2: timesteps {scrub['timesteps']}, frame {scrub['frame_shape']}, "
        f"max |frame delta| {scrub['max_abs_frame_delta']}, distinct {scrub['frames_distinct']}, replay identical "
        f"{scrub['replay_identical']}, replay hits {scrub['replay_cache_hits']}, new misses "
        f"{scrub['replay_new_misses']}, pipeline {scrub['pipeline']}")
    log(f"insitu live replay on the card: {replay['updates']} updates, invalidations {replay['invalidations']} "
        f"(partial {replay['partial_invalidations']}, full {replay['full_invalidations']})")
    log(f"insitu launches (counters zeroed just before the run and read after the scrub and replay): {launches}")
    steps = sum(r.steps for r in reports)
    if trainer.n_traces != 1:
        raise SystemExit(f"insitu: the train step saw {trainer.n_traces} shape signatures, want 1")
    if not scrub["frames_distinct"] or scrub["replay_new_misses"]:
        raise SystemExit(f"insitu: scrub frames distinct {scrub['frames_distinct']}, replay new misses "
                         f"{scrub['replay_new_misses']}")
    if launches["tile_raster_bwd"] != cfg.batch_size * steps or launches["gsproject"] < cfg.batch_size * steps + 2 * n_t \
            or launches["tile_raster_fwd"] < cfg.batch_size * steps + 2 * n_t or launches["flash_attention"]:
        raise SystemExit(f"insitu: launches {launches}, want {cfg.batch_size} of each splatting kernel per step "
                         "(plus eval views and scrubbed frames forward) and no attention")

    # the busy share of one warm step at the last timestep's state
    cams_b, gt_b = next(iter(last[0].batches(cfg.batch_size, steps=1)))
    profile_step(lambda: trainer._step_fn(trainer.state, cams_b, gt_b), warm_p50, label="in situ warm step")
    del trainer, last

    # the small run, on the card and on the CPU path, on the card's ray-marched ground truth
    small = GSConfig(**INSITU_SMALL)
    small_kw = dict(cold_steps=3, warm_steps=2, n_views=4, max_points=600, n_steps_raymarch=32, init_scale=0.06,
                    seed=0, gt_cache_dir=str(INSITU_DIR / "gt_small"))
    runs = []
    for d in (dev, torch.device("cpu")):
        tr = InsituTrainer(small, device=d, **small_kw)
        tr.run(synthetic_stream("miranda", 2, res=32, t1=0.15))
        runs.append(tr)
    card_tr, cpu_tr = runs
    lk, lc = np.asarray(card_tr.step_losses), np.asarray(cpu_tr.step_losses)
    same_slots = [s.tolist() for s in card_tr.reseed_log] == [s.tolist() for s in cpu_tr.reseed_log]
    first_ok = abs(lk[0] - lc[0]) <= 1e-5 * abs(lc[0])
    rest_ok = np.allclose(lk, lc, rtol=1e-3, atol=0)
    log(f"insitu small run (miranda 32^3, 32 px, K 128, batch 2, 2 timesteps of 3 cold and 2 warm steps), card vs "
        f"CPU path: losses {lk.tolist()} vs {lc.tolist()}, max rel err {float(np.max(np.abs(lk - lc) / np.abs(lc))):.3e} "
        f"(first step within rtol 1e-5: {first_ok}, all within rtol 1e-3: {rest_ok}); reseeded "
        f"{[s.size for s in card_tr.reseed_log]} vs {[s.size for s in cpu_tr.reseed_log]}, same slots {same_slots}")
    if not (first_ok and rest_ok and same_slots and card_tr.n_traces == 1):
        raise SystemExit("insitu: the small run on the card disagrees with the CPU path")
    del runs, card_tr, cpu_tr

    # the world-1 NCCL mesh against one device: 2 timesteps of the stream, bitwise
    cfg2 = dataclasses.replace(cfg, max_steps=15)
    mesh = make_gs_mesh(1, 1, device=dev)
    pair = []
    for m in (None, mesh):
        tr = InsituTrainer(cfg2, m, device=dev, cold_steps=10, warm_steps=5, **kw)
        tr.run(vols[:2])
        pair.append(tr)
    one, w1 = pair
    same = (one.step_losses == w1.step_losses and one.capacity == w1.capacity
            and [s.tolist() for s in one.reseed_log] == [s.tolist() for s in w1.reseed_log]
            and all(torch.equal(a, b) for a, b in zip(tree_leaves(one.state), tree_leaves(w1.state))))
    log(f"insitu world-1 NCCL mesh vs one device ({card}): 2 timesteps, 10 cold and 5 warm steps at "
        f"{one.capacity} Gaussians: losses {[round(x, 7) for x in w1.step_losses]}; reseeded "
        f"{[s.size for s in w1.reseed_log]}; bitwise equal (losses, reseeded slots, parameters, Adam moments, "
        f"densify statistics): {same}; step ms p50 {float(np.median(w1.step_ms)):.3f} vs one device "
        f"{float(np.median(one.step_ms)):.3f}")
    if not same:
        raise SystemExit("insitu: the world-1 mesh trainer is not bitwise the one-device trainer")
    del pair, one, w1
    shutil.rmtree(INSITU_DIR / "gt_small", ignore_errors=True)  # the store stays for phase 5d
    return launches


INSITU_RANKS_COLD, INSITU_RANKS_WARM = 10, 5  # 2 timesteps of the stream, as the world-1 check runs them


def _insitu_rank_worker(rank: int, n: int, res: int, stream: dict, device_type: str, timeout_s: float) -> None:
    """One rank of the in situ trainer on a (1, n) mesh across cards: 2
    timesteps of ``stream`` (``synthetic_stream``'s arguments) at
    ``paper_gs_config(res)``; rank 0 writes the step losses, the reseeded
    slots and the step times."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.gs_datasets import paper_gs_config
    from repro_torch.insitu import InsituTrainer
    from repro_torch.launch.mesh import init_ranks, make_gs_mesh
    from repro_torch.volume.timevary import synthetic_stream

    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    init_ranks(dev, init_method=f"file://{RANKS_DIR}/store_insitu_{n}", rank=rank, world_size=n, timeout_s=timeout_s)
    vols = list(synthetic_stream(**stream))[:2]
    cfg = paper_gs_config(res, densify_from=10**9, opacity_reset_interval=10**9,
                          max_steps=INSITU_RANKS_COLD + INSITU_RANKS_WARM)
    tr = InsituTrainer(cfg, make_gs_mesh(1, n, device=dev), device=dev, cold_steps=INSITU_RANKS_COLD,
                       warm_steps=INSITU_RANKS_WARM, **insitu_kw(vols[0], stream["res"]))
    tr.run(vols)
    if rank == 0:
        (RANKS_DIR / f"insitu_{n}.json").write_text(json.dumps(
            {"losses": tr.step_losses, "reseed": [s.tolist() for s in tr.reseed_log], "step_ms": tr.step_ms,
             "capacity": tr.capacity, "n_traces": tr.n_traces}))
    torch.distributed.destroy_process_group()


def insitu_ranks_phase(dev, card: str, res: int) -> dict:
    """The in situ trainer on a (1, 2) mesh across two cards (one rank per
    card, NCCL) over 2 timesteps of ``INSITU_STREAM``, held to the one-device
    trainer as ``tests/test_torch_insitu_ranks.py`` holds it on gloo ranks:
    per-step losses within rtol 1e-5, the same reseeded slots, one shape
    signature."""
    from repro_torch.configs.gs_datasets import paper_gs_config
    from repro_torch.insitu import InsituTrainer
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.volume.timevary import synthetic_stream

    if torch.cuda.device_count() < 2:
        log("insitu ranks: 1 card on this machine: the (1, 2) mesh across cards not run")
        return {}
    vols = list(synthetic_stream(**INSITU_STREAM))[:2]
    cfg = paper_gs_config(res, densify_from=10**9, opacity_reset_interval=10**9,
                          max_steps=INSITU_RANKS_COLD + INSITU_RANKS_WARM)
    one = InsituTrainer(cfg, device=dev, cold_steps=INSITU_RANKS_COLD, warm_steps=INSITU_RANKS_WARM,
                        **insitu_kw(vols[0], INSITU_STREAM["res"]))
    one.run(vols)
    want = {"losses": one.step_losses, "reseed": [s.tolist() for s in one.reseed_log], "step_ms": one.step_ms}
    del one
    torch.cuda.empty_cache()
    spawn_ranks(_insitu_rank_worker, (2, res, INSITU_STREAM, dev.type, 300.0), 2, timeout_s=600)
    got = json.loads((RANKS_DIR / "insitu_2.json").read_text())
    ok = np.allclose(got["losses"], want["losses"], rtol=1e-5, atol=0)
    same_slots = got["reseed"] == want["reseed"]
    log(f"insitu (1, 2) over NCCL across 2 cards ({card}): 2 timesteps, {INSITU_RANKS_COLD} cold and "
        f"{INSITU_RANKS_WARM} warm steps at {got['capacity']} Gaussians: losses within rtol 1e-5 of one device: {ok} "
        f"(max rel err {float(np.max(np.abs(np.subtract(got['losses'], want['losses'])) / np.abs(want['losses']))):.3e}"
        f"); reseeded {[len(x) for x in got['reseed']]}, same slots {same_slots}; shape signatures "
        f"{got['n_traces']}; step ms p50 (rank 0) {float(np.median(got['step_ms'])):.3f} vs one device "
        f"{float(np.median(want['step_ms'])):.3f}")
    if not (ok and same_slots and got["n_traces"] == 1):
        raise SystemExit("insitu ranks: the (1, 2) trainer across cards disagrees with one device")
    return {"losses": got["losses"], "step_ms_p50": float(np.median(got["step_ms"])),
            "one_device_step_ms_p50": float(np.median(want["step_ms"]))}


PAPER_MIRANDA = 18_180_000      # the paper's Miranda Gaussians
PAPER_RES, PAPER_STEPS, PAPER_VIEWS = 512, 4, 8
PAPER_HIGH_RES, PAPER_HIGH_STEPS, PAPER_HIGH_VIEWS = 2048, 3, 4  # Kingsnake 4M at the paper's largest frame
WORKER_HBM, CARD_HBM = 40e9, 80e9  # the paper's A100 and this card


def paper_fit(dev, card: str, label: str, host, data, res: int, steps: int, counters: dict, **cfg_kw) -> tuple:
    """``steps`` steps of ``GSTrainer`` at ``paper_gs_config(res, **cfg_kw)``,
    densification off, with a span trace, the launch counters zeroed just
    before and read just after: fails on a non-finite loss or unless each
    splatting kernel launched 4 times a step (and attention never). Prints
    step ms p50 (after the first step), the peak against 40 and 80 GB and
    the per-stage split of the trace (``train_stage_breakdown``). Returns the
    trainer, its losses, the step p50 and the launches."""
    from repro_torch.configs.gs_datasets import paper_gs_config
    from repro_torch.launch.train import GSTrainer
    from repro_torch.obs import Obs, spans_to_jsonl
    from repro_torch.obs.replay import load_trace, train_stage_breakdown

    cfg = paper_gs_config(res, max_steps=steps, **cfg_kw)
    data.rng = np.random.default_rng(0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = GSTrainer(cfg, device=dev, params=host, obs=Obs(trace=True), verbose=False)
    for c in counters.values():
        c.n = 0
    losses = tr.fit(data, steps=steps, densify=False)
    torch.cuda.synchronize()
    launches = {k: c.n for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    _, records = load_trace(spans_to_jsonl(tr.obs.trace.drain()))
    stages = train_stage_breakdown([r for r in records if r.get("step", 0) >= 1])
    p50 = float(np.median(tr.step_ms_log[1:]))
    log(f"paper scale {label} ({card}): {tr.state.params.n} Gaussians, {res} px, batch {cfg.batch_size}, K "
        f"{cfg.k_per_tile}, binning {cfg.binning}, {steps} steps: losses {[round(x, 6) for x in losses]}; step ms "
        f"{[round(x, 3) for x in tr.step_ms_log]}, p50 of steps 2-{steps} {p50:.3f}; peak {peak} B (fits 40 GB: "
        f"{peak < WORKER_HBM}, 80 GB: {peak < CARD_HBM}); launches {launches}")
    log(f"paper scale {label} stage split (span trace, train_stage_breakdown, steps 2-{steps}): "
        + ", ".join(f"{k} p50 {v.percentile(50) * 1e3:.3f} ms (mean {v.mean * 1e3:.3f}, n {v.count})"
                    for k, v in stages.items() if k != "timesteps"))
    want = [4 * steps] * 3 + [0]
    if not np.isfinite(losses).all() or len(losses) != steps:
        raise SystemExit(f"paper scale {label}: losses not finite: {losses}")
    if list(launches.values()) != want:
        raise SystemExit(f"paper scale {label}: launches {launches}, want {want}: 4 per step of each splatting "
                         "kernel and no attention")
    return tr, losses, p50, launches, peak


def paper_scale_phase(dev, card: str, counters: dict, seed: int, kingsnake, kingsnake_vol) -> dict:
    """Phase 5e: the paper's scale on one card. Miranda at 18,180,000
    Gaussians (``paper_scene``) at ``paper_gs_config(512)``, 8 ray-marched
    views, 4 steps, densification off, then the busy share of one step; then
    Kingsnake's 4M Gaussians (``kingsnake`` on ``kingsnake_vol``, phase 4's
    host model) at 2048 px, 4 views, 3 steps, and the busy share of one
    step. Returns the launches of both fits."""
    from repro_torch.configs.gs_datasets import paper_scene
    from repro_torch.data.views import ViewDataset

    t0 = time.perf_counter()
    host, n_surface, vol = paper_scene("miranda", PAPER_MIRANDA, seed)
    log(f"paper scale: miranda {n_surface} surface points -> {host.means.shape[0]} Gaussians "
        f"({time.perf_counter() - t0:.1f} s)")
    data = ViewDataset(vol, n_views=PAPER_VIEWS, img_h=PAPER_RES, img_w=PAPER_RES, radius=3.0, device=dev)
    tr, _, p50, launches, _ = paper_fit(dev, card, f"miranda 18.18M at {PAPER_RES} px", host, data, PAPER_RES,
                                        PAPER_STEPS, counters)
    cams_b, gt_b = next(iter(data.batches(4, steps=1)))
    profile_step(lambda: tr.step_fn(tr.state, cams_b, gt_b), p50,
                 label=f"paper scale step (miranda 18.18M, {PAPER_RES} px)")
    del tr, data, host
    t0 = time.perf_counter()
    data = ViewDataset(kingsnake_vol, n_views=PAPER_HIGH_VIEWS, img_h=PAPER_HIGH_RES, img_w=PAPER_HIGH_RES,
                       radius=3.0, device=dev)
    torch.cuda.synchronize()
    log(f"paper scale: {PAPER_HIGH_VIEWS} kingsnake views ray-marched at {PAPER_HIGH_RES} px "
        f"({time.perf_counter() - t0:.1f} s)")
    tr, _, p50, more, _ = paper_fit(dev, card, f"kingsnake 4M at {PAPER_HIGH_RES} px", kingsnake, data,
                                    PAPER_HIGH_RES, PAPER_HIGH_STEPS, counters)
    cams_b, gt_b = next(iter(data.batches(4, steps=1)))
    profile_step(lambda: tr.step_fn(tr.state, cams_b, gt_b), p50,
                 label=f"paper scale step (kingsnake 4M, {PAPER_HIGH_RES} px)")
    del tr, data
    torch.cuda.empty_cache()
    return {k: launches[k] + more[k] for k in launches}


# ---------------------------------------------------------------- phase 5f: SH degrees 1-3
SH_TRAIN_STEPS = 5


def sh_bands(n: int, seed: int) -> np.ndarray:
    """(n, 15, 3) coefficients of SH bands 1-3, random from ``seed``."""
    return np.random.default_rng(seed + 3).normal(0, 0.1, (n, 15, 3)).astype(np.float32)


def with_sh_degree(g, degree: int, seed: int):
    """Host model ``g`` at SH ``degree``: its DC term and ``sh_bands``."""
    n = g.means.shape[0]
    return g._replace(sh=np.concatenate([g.sh[:, :1], sh_bands(n, seed)[:, : (degree + 1) ** 2 - 1]], axis=1))


def sh_scene_models(g, seed: int, dev) -> dict:
    """Device model ``g`` at SH degrees 1, 2 and 3 (its DC term and
    ``sh_bands``), each degree's coefficients contiguous."""
    sh = torch.cat([g.sh[:, :1], torch.from_numpy(sh_bands(g.n, seed)).to(dev)], dim=1)
    return {d: g._replace(sh=sh[:, : (d + 1) ** 2].contiguous()) for d in (1, 2, 3)}


def sh_phase(dev, card: str, seed: int, host, vol, data, res: int, counters: dict) -> dict:
    """Phase 5f: ``GSTrainer`` at ``sh_degree=3`` on phase 4's 4M scene (its
    DC term, bands 1-3 from ``sh_bands``) at ``paper_gs_config(res)``, batch
    4, on phase 5's views, ``SH_TRAIN_STEPS`` steps with densification off
    (``paper_fit``: the counters zeroed just before and read just after, 4
    a step of each splatting kernel), and the busy share of one step; then
    phase 5's small step (20,000 Gaussians, 64 px) at SH degrees 1 and 2 on
    the card against the CPU path, each with its launches. Returns the
    launches of each degree's path."""
    from repro_torch.configs.gs_datasets import paper_gs_config
    from repro_torch.core import gaussians as G
    from repro_torch.core.train import init_state, make_train_step
    from repro_torch.data.views import ViewDataset
    from repro_torch.volume.cameras import camera_slice, orbit_cameras

    out = {}
    tr, _, p50, out[3], _ = paper_fit(dev, card, f"SH degree 3, kingsnake 4M at {res} px",
                                      with_sh_degree(host, 3, seed), data, res, SH_TRAIN_STEPS, counters,
                                      sh_degree=3)
    if tuple(tr.state.params.sh.shape[1:]) != (16, 3):
        raise SystemExit(f"SH degree 3 trainer holds sh {tuple(tr.state.params.sh.shape)}")
    cams_b, gt_b = next(iter(data.batches(4, steps=1)))
    profile_step(lambda: tr.step_fn(tr.state, cams_b, gt_b), p50, label=f"SH degree 3 train step (4M, {res} px)")
    del tr
    torch.cuda.empty_cache()

    small = host._replace(**{f: getattr(host, f)[: COST_SMALL_POINTS] for f in host._fields})
    scams = camera_slice(orbit_cameras(12, img_h=64, img_w=64, radius=3.0), torch.arange(4))
    sgt = ViewDataset(vol, n_views=12, img_h=64, img_w=64, radius=3.0, device=dev).gt[:4]
    for degree in (1, 2):
        step = make_train_step(paper_gs_config(64, sh_degree=degree))
        small_d = with_sh_degree(small, degree, seed)
        res_small = []
        for j, d in enumerate((dev, torch.device("cpu"))):
            for c in counters.values():
                c.n = 0
            st, m = step(init_state(G.from_numpy(small_d, d)), scams, torch.tensor(sgt, device=d))
            res_small.append((float(m["loss"]), [x.cpu() / 0.1 for x in st.adam.m]))  # m = 0.1 g after one step
            if j == 0:  # the card's launches
                out[degree] = {k: c.n for k, c in counters.items()}
        (l_k, g_k), (l_c, g_c) = res_small
        gerr = max(grad_report(a, b)[0] for a, b in zip(g_k, g_c))
        gbad = sum(grad_report(a, b)[1] for a, b in zip(g_k, g_c))
        sh_g = float(g_c[4][:, 1:].abs().max())
        log(f"small train step at SH degree {degree}, {COST_SMALL_POINTS} Gaussians at 64 px, card vs CPU path: loss "
            f"{l_k:.7f} vs {l_c:.7f}, gradients max_abs_err {gerr:.3e}, entries outside atol 2e-5*max|g|/rtol 2e-4: "
            f"{gbad}; max |g| of the bands above DC {sh_g:.3e}; card launches {out[degree]}")
        if abs(l_k - l_c) > 1e-5 * abs(l_c) or gbad or not sh_g > 0:
            raise SystemExit(f"card train step at SH degree {degree} disagrees with the CPU path on a small input")
        if list(out[degree].values()) != [4, 4, 4, 0]:
            raise SystemExit(f"small step at SH degree {degree}: launches {out[degree]}, want 4 of each splatting "
                             "kernel and no attention")
    return out


def paper_ranks_phase(dev, card: str, seed: int, counters: dict) -> dict:
    """Miranda at 18,180,000 Gaussians across cards: the one-device run of
    phase 5e (512 px, 8 views, 4 steps), then (1, 2) and (1, 4) in
    ``projected`` mode with one rank per card over NCCL, their losses held
    to one device at rtol 1e-5, the peak on the fullest rank printed."""
    from repro_torch.configs.gs_datasets import paper_scene
    from repro_torch.data.views import ViewDataset
    from repro_torch.launch.mesh import spawn_ranks

    host, _, vol = paper_scene("miranda", PAPER_MIRANDA, seed)
    RANKS_DIR.mkdir(parents=True, exist_ok=True)
    data = ViewDataset(vol, n_views=PAPER_VIEWS, img_h=PAPER_RES, img_w=PAPER_RES, radius=3.0, cache_dir=str(RANKS_DIR),
                       device=dev)
    tr, want, p50_one, _, peak_one = paper_fit(dev, card, f"miranda 18.18M at {PAPER_RES} px, one device", host, data,
                                               PAPER_RES, PAPER_STEPS, counters)
    del tr, data
    torch.cuda.empty_cache()
    out = {"one_device": {"losses": want, "step_ms_p50": p50_one, "peak_bytes": peak_one}}
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"paper scale ranks: {n_cards} card on this machine: miranda across cards not run")
        return out
    np.savez(RANKS_DIR / "miranda.npz", **{f: getattr(host, f) for f in host._fields})
    del host
    for n in [k for k in (2, 4) if k <= n_cards]:
        spawn_ranks(_rank_worker, (n, "projected", PAPER_STEPS, PAPER_RES, PAPER_VIEWS, dev.type, 300.0, "miranda"), n,
                    timeout_s=900)
        got = json.loads((RANKS_DIR / f"losses_miranda_projected_{n}.json").read_text())
        ok = np.allclose(got["losses"], want, rtol=1e-5, atol=0)
        p50 = float(np.median(got["step_ms"][1:]))
        log(f"paper scale ranks (1, {n}) projected over NCCL across {n} cards ({card}): miranda "
            f"{PAPER_MIRANDA} Gaussians, {PAPER_RES} px, {PAPER_STEPS} steps: losses {got['losses']} vs one device "
            f"{want}, within rtol 1e-5: {ok}; step ms (rank 0) {[round(x, 3) for x in got['step_ms']]} p50 of steps "
            f"2-{PAPER_STEPS} {p50:.3f} vs one device {p50_one:.3f} (x{p50_one / p50:.3f}); peak per rank "
            f"{got['peak_bytes']} B, fullest {max(got['peak_bytes'])} B (one device {peak_one} B)")
        if not ok:
            raise SystemExit(f"paper scale ranks: (1, {n}) miranda losses differ from one device beyond rtol 1e-5")
        out[f"projected_1x{n}"] = {**got, "p50_ms": p50}
    return out


FRONTEND_CLIENTS, FRONTEND_REQUESTS, FRONTEND_WINDOW = 8, 8, 2  # benchmarks/frontend_load.py's defaults
FRONTEND_GATEWAY = dict(queue_limit=8, wave_per_session=4, coalesce_ms=2.0)


def frontend_phase(dev, card: str, host, cfg, counters: dict, store_dir: Path) -> dict:
    """The network frontend on the card: one ``SessionManager`` (the serving
    CLI's defaults: 3 levels at keep 0.5, max batch 8, depth 2, tile cache,
    no retained frames) with stream ``static`` = phase 4's host model and
    stream ``timeline`` = phase 5c's temporal store (through
    ``timeline_stream``). The frontend load benchmark's trace (8 clients x 8
    requests; even clients orbit ``static``, odd clients scrub ``timeline``
    at a fixed pose) runs twice: in process (a wavefront of submits per
    round, then ``run``), then over TCP from asyncio clients (tiles8
    negotiated, 2 requests in flight each) to a ``GatewayThread`` on an
    ephemeral localhost port. The cache and the metrics are reset and the
    launch counters zeroed before each lap. Fails unless every TCP frame is
    bitwise ``quantize_rgb8`` of the in-process frame of the same request,
    the scrubbed timesteps are distinct, nothing is shed or fails, and both
    forward kernels launch in the network lap. Returns that lap's launches."""
    import asyncio
    import shutil

    from repro_torch.frontend import AsyncFrontendClient, Gateway, GatewayThread, SessionManager, quantize_rgb8
    from repro_torch.insitu import TemporalCheckpointStore, timeline_stream
    from repro_torch.obs import Obs
    from repro_torch.serve_gs import make_clients
    from repro_torch.serve_gs.server import _percentile
    from repro_torch.volume.cameras import camera_slice, orbit_cameras

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    manager = SessionManager(cfg, obs=Obs(), device=dev, n_levels=3, keep_ratio=0.5, max_batch=8,
                             cache_capacity=512, tile_cache=True, store_frames=False, pipeline_depth=2)
    manager.register_static("static", host)
    with TemporalCheckpointStore(str(store_dir)) as store:
        info = timeline_stream(manager, "timeline", store)
    server = manager.server
    warm_s = manager.warmup()
    n_t = len(info.timesteps)
    log(f"frontend: streams {manager.describe()}; levels live {list(server.pyramid.live_counts)} (static); warmup "
        f"{warm_s:.2f} s; gateway {FRONTEND_GATEWAY}, tiles8 negotiated, {FRONTEND_CLIENTS} clients x "
        f"{FRONTEND_REQUESTS} requests, {FRONTEND_WINDOW} in flight each")

    # the trace: (client, request) -> (stream, local timestep, camera)
    orbits = make_clients(FRONTEND_CLIENTS, n_views=12, img_h=cfg.img_h, img_w=cfg.img_w, shared_orbit=False)
    trace = []
    for c, orbit in enumerate(orbits):
        fixed = orbit.next_camera() if c % 2 else None
        trace.append([(("static", 0, orbit.next_camera()) if c % 2 == 0 else
                       ("timeline", info.timesteps[r % n_t], fixed)) for r in range(FRONTEND_REQUESTS)])
    n_req = FRONTEND_CLIENTS * FRONTEND_REQUESTS

    def reset_lap():
        server.cache.drop(lambda k: True)
        manager.obs.metrics.reset()

    # ---- lap 1: in process
    reset_lap()
    for c_ in counters.values():
        c_.n = 0
    local, lat_local = {}, []
    t0 = time.perf_counter()
    for r in range(FRONTEND_REQUESTS):
        wave = []
        for c, reqs in enumerate(trace):
            stream, t, cam = reqs[r]
            wave.append(((c, r), server.submit(cam, timestep=manager.resolve(stream, t), client_id=c),
                         time.perf_counter()))
        server.run()
        for key, fut, ts in wave:
            local[key] = fut.result()
            lat_local.append((time.perf_counter() - ts) * 1e3)
    local_s = time.perf_counter() - t0
    local_launches = {k: c_.n for k, c_ in counters.items()}
    local_pipe = server.report()["pipeline"]
    local_fps = n_req / local_s

    # ---- lap 2: over TCP
    gateway = Gateway(manager, port=0, **FRONTEND_GATEWAY)
    gt = GatewayThread(gateway).start()
    loop = asyncio.new_event_loop()
    wire = {}  # encoding -> [frames, payload bytes, client decode s]

    def count_payloads(cl):
        decode = cl._decoder.decode

        def counted(stream, meta, payload):
            d0 = time.perf_counter()
            out = decode(stream, meta, payload)
            w = wire.setdefault(meta["encoding"], [0, 0, 0.0])
            w[0] += 1
            w[1] += len(payload)
            w[2] += time.perf_counter() - d0
            return out

        cl._decoder.decode = counted

    async def connect():
        out = []
        for _ in trace:
            cl = AsyncFrontendClient("127.0.0.1", gt.port)
            await cl.connect()
            count_payloads(cl)
            out.append(cl)
        return out

    async def one_client(cl, c, reqs, frames, lat, errors):
        inflight = []

        async def drain():
            key, fut, ts = inflight.pop(0)
            try:
                frames[key] = await fut
                lat.append((time.perf_counter() - ts) * 1e3)
            except Exception as e:  # shed / remote error: counted and gated below
                errors.append(repr(e))

        for r, (stream, t, cam) in enumerate(reqs):
            if len(inflight) >= FRONTEND_WINDOW:
                await drain()
            inflight.append(((c, r), await cl.submit_render(stream, cam, timestep=t), time.perf_counter()))
        while inflight:
            await drain()

    async def run_lap(frames, lat, errors):
        await asyncio.gather(*[one_client(cl, c, reqs, frames, lat, errors)
                               for c, (cl, reqs) in enumerate(zip(clients, trace))])

    clients = []
    try:
        clients[:] = loop.run_until_complete(asyncio.wait_for(connect(), 60))
        protocols = {cl.protocol for cl in clients}
        gateway.run_on_engine(reset_lap).result(timeout=60)
        for c_ in counters.values():
            c_.n = 0
        net, lat_net, errors = {}, [], []
        t0 = time.perf_counter()
        loop.run_until_complete(asyncio.wait_for(run_lap(net, lat_net, errors), 300))
        net_s = time.perf_counter() - t0
        net_launches = {k: c_.n for k, c_ in counters.items()}
        wire_lap = {e: tuple(v) for e, v in wire.items()}  # the lap's frames, before the profiled waves add theirs
        net_pipe = gateway.run_on_engine(server.report).result(timeout=60)["pipeline"]
        stats = loop.run_until_complete(asyncio.wait_for(clients[0].stats(), 60))
        snap = manager.obs.metrics.snapshot()
        net_fps = len(net) / net_s

        # the busy share of one wave: 8 new level-0 poses of ``static``, one per client
        calls = itertools.count()

        async def wave_of_new_poses():
            cams = orbit_cameras(FRONTEND_CLIENTS, img_h=cfg.img_h, img_w=cfg.img_w, radius=3.05 + 1e-3 * next(calls))
            await asyncio.gather(*[cl.render("static", camera_slice(cams, i)) for i, cl in enumerate(clients)])

        def one_wave():
            loop.run_until_complete(asyncio.wait_for(wave_of_new_poses(), 60))

        one_wave()
        wave_ms = []
        for _ in range(3):
            w0 = time.perf_counter()
            one_wave()
            wave_ms.append((time.perf_counter() - w0) * 1e3)
        profile_step(one_wave, float(np.median(wave_ms)), label="frontend wave (8 new poses over TCP)")
        gw_stats = loop.run_until_complete(asyncio.wait_for(clients[0].stats(), 60))["gateway"]
        for cl in clients:
            loop.run_until_complete(asyncio.wait_for(cl.close(), 60))
    finally:
        # the gateway's close waits for its connections to end: drop any the
        # clients still hold (a failure above) before stopping it
        for cl in clients:
            if cl._writer is not None:
                cl._writer.close()
        loop.run_until_complete(asyncio.sleep(0.1))
        gt.stop()
        loop.close()
    peak = torch.cuda.max_memory_allocated(dev) - base

    gw = {k.split(".", 1)[1]: v for k, v in snap.items() if k.startswith("gateway.") and not isinstance(v, dict)}
    enc = {}
    for s in stats["sessions"].values():
        for k, v in s["encoder"].items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                enc[k] = enc.get(k, 0) + v
    lat_l, lat_n = sorted(lat_local), sorted(lat_net)
    log(f"frontend in process ({card}): {n_req} requests, {local_fps:.2f} frames/s, p50 "
        f"{_percentile(lat_l, 50):.3f} ms, p99 {_percentile(lat_l, 99):.3f} ms; launches {local_launches}; lap "
        f"{local_s:.4f} s: dispatch {local_pipe['dispatch_s']} s, wait for the device {local_pipe['block_s']} s")
    log(f"frontend over TCP ({card}): {len(net)} of {n_req} frames, {net_fps:.2f} frames/s "
        f"({net_fps / local_fps:.3f}x in process), client-observed p50 {_percentile(lat_n, 50):.3f} ms, p99 "
        f"{_percentile(lat_n, 99):.3f} ms; protocol {sorted(protocols)}; launches {net_launches}; lap {net_s:.4f} s: "
        f"dispatch {net_pipe['dispatch_s']} s, wait for the device {net_pipe['block_s']} s (on the render thread)")
    log(f"frontend wire: " + "; ".join(f"{e} {n} frames, {b / max(n, 1):.1f} payload B per frame, client decode "
                                        f"{d * 1e3 / max(n, 1):.3f} ms per frame"
                                        for e, (n, b, d) in sorted(wire_lap.items()))
        + f"; gateway bytes_out {gw.get('bytes_out', 0)} ({gw.get('bytes_out', 0) / max(len(net), 1):.1f} B per frame "
        f"with headers); raw_fallbacks {enc.get('raw_fallbacks', 0)}, tile frames {enc.get('tile_frames', 0)}, tiles "
        f"shipped {enc.get('tiles_shipped', 0)} and reffed {enc.get('tiles_reffed', 0)} of {enc.get('tiles_total', 0)}; "
        f"raw float32 frame {cfg.img_h * cfg.img_w * 3 * 4} B, RGB8 {cfg.img_h * cfg.img_w * 3} B")
    log(f"frontend gateway ({card}): render_wait_s {gw.get('render_wait_s', 0.0):.4f}, encode_wait_s "
        f"{gw.get('encode_wait_s', 0.0):.4f}, write_s {gw.get('write_s', 0.0):.4f} over {gw.get('waves', 0)} waves "
        f"(lap wall {net_s:.4f} s); shed {gw.get('shed', 0)}, protocol_errors {gw.get('protocol_errors', 0)}, "
        f"request_errors {gw.get('request_errors', 0)}, engine_errors {gw.get('engine_errors', 0)}, delivery_errors "
        f"{gw.get('delivery_errors', 0)}, dropped_writes {gw.get('dropped_writes', 0)}; one wave of 8 new poses: "
        f"wall {float(np.median(wave_ms)):.3f} ms (median of 3)")
    log(f"frontend ({card}): peak above the phase's start {peak} B; phase {time.perf_counter() - t_phase:.1f} s")

    bad = [key for key, f in local.items() if key not in net or not np.array_equal(net[key], quantize_rgb8(f))]
    scrub_distinct = all(
        len({net[(c, r)].tobytes() for r in range(min(n_t, FRONTEND_REQUESTS)) if (c, r) in net})
        == min(n_t, FRONTEND_REQUESTS) for c in range(1, FRONTEND_CLIENTS, 2))
    log(f"frontend gates: TCP frames bitwise quantize_rgb8(in-process frame) on {n_req - len(bad)} of {n_req}; "
        f"scrubbed timesteps distinct per scrubbing client: {scrub_distinct}; client errors {errors[:3]}")
    failures = [k for k in ("shed", "protocol_errors", "request_errors", "engine_errors", "delivery_errors",
                            "dropped_writes") if gw.get(k, 0) or gw_stats[k]]
    if errors or failures or len(net) != n_req:
        raise SystemExit(f"frontend: {len(net)} of {n_req} frames over TCP, client errors {errors[:3]}, "
                         f"gateway counters {failures}")
    if bad:
        raise SystemExit(f"frontend: {len(bad)} TCP frames differ from quantize_rgb8 of the in-process frame "
                         f"(first {bad[:4]})")
    if not scrub_distinct:
        raise SystemExit("frontend: scrubbed timesteps gave equal frames")
    if protocols != {2} or "tiles8" not in wire_lap:
        raise SystemExit(f"frontend: tiles8 not negotiated (protocols {protocols}, encodings {sorted(wire_lap)})")
    if not net_launches["gsproject"] or not net_launches["tile_raster_fwd"] or net_launches["tile_raster_bwd"] \
            or net_launches["flash_attention"]:
        raise SystemExit(f"frontend: launches over TCP {net_launches}: want both forward kernels, no backward "
                         "and no attention")
    shutil.rmtree(store_dir.parent, ignore_errors=True)
    return net_launches


SERVE_MESHES = ((2, 1), (4, 1), (1, 2), (1, 4))  # across cards: data-parallel, then model-sharded
SERVE_LEVELS = dict(n_levels=3, keep_ratio=0.5, max_batch=4, pipeline_depth=2)


def serve_load(server, cfg, n_clients: int, n_requests: int, counters: dict) -> dict:
    """Phase 4's requests through ``server``, the launch counters zeroed just
    before and read just after: ``n_clients`` orbit clients (three LOD
    rings) x ``n_requests``, then a localized update (two tile rows of the
    timestep dropped) and two served poses revisited, which render only
    those rows (the strip path). Returns the report, every frame in
    completion order, the revisits' frames and the launches."""
    from repro_torch.serve_gs import make_clients, run_load
    from repro_torch.volume.cameras import camera_slice, orbit_cameras

    cams = orbit_cameras(12, img_h=cfg.img_h, img_w=cfg.img_w, radius=3.0)
    row = (cfg.img_h // cfg.tile_h) // 2 + 1
    clients = make_clients(n_clients, n_views=12, img_h=cfg.img_h, img_w=cfg.img_w, radius_spread=1.0)
    for c in counters.values():
        c.n = 0
    run_load(server, clients, requests_per_client=n_requests)
    server.invalidate(0, rows={row, row + 1})
    revisit = [server.submit(camera_slice(cams, i)) for i in range(2)]
    frames_revisit = [f.result() for f in revisit]
    server.run()
    launches = {k: c.n for k, c in counters.items()}
    return {"report": server.report(), "frames": list(server.frames.values()), "revisit": frames_revisit,
            "launches": launches}


def serve_profile(server, cfg, label: str) -> None:
    """``profile_step`` over one served micro-batch: four level-0 poses no
    server has seen (the orbit's radius steps by 1e-3 per call), submitted
    and run until their frames are on the host; its wall is the median of
    three unprofiled calls, whose host time is split into the submits, the
    dispatch (the render's enqueue), the wait for the device and the rest
    of ``run`` (retiring: frames into the tile cache, futures)."""
    from repro_torch.volume.cameras import camera_slice, orbit_cameras

    calls = itertools.count()

    def one():
        cams = orbit_cameras(4, img_h=cfg.img_h, img_w=cfg.img_w, radius=3.05 + 1e-3 * next(calls))
        t0 = time.perf_counter()
        futs = [server.submit(camera_slice(cams, i)) for i in range(4)]
        t1 = time.perf_counter()
        server.run()
        for f in futs:
            f.result()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    parts = []
    for _ in range(3):
        p0 = server.report()["pipeline"]
        sub_ms, run_ms = one()
        p1 = server.report()["pipeline"]
        disp_ms, block_ms = ((p1[k] - p0[k]) * 1e3 for k in ("dispatch_s", "block_s"))
        parts.append((sub_ms + run_ms, sub_ms, run_ms, disp_ms, block_ms, run_ms - disp_ms - block_ms))
    wall, sub_ms, run_ms, disp_ms, block_ms, rest_ms = np.median(np.asarray(parts), axis=0)
    log(f"{label} host breakdown (median of 3 unprofiled calls): wall {wall:.3f} ms = submit x4 {sub_ms:.3f} ms + "
        f"run {run_ms:.3f} ms (dispatch {disp_ms:.3f}, wait for the device {block_ms:.3f}, the rest {rest_ms:.3f})")
    profile_step(one, float(wall), label=label)


def serve_summary(label: str, card: str, run: dict, extra: str = "") -> str:
    rep = run["report"]
    lat = rep["latency_ms"]
    mesh = rep["mesh"]
    control = ("no control plane" if mesh is None else
               f"descriptor {mesh['control_us_per_send']} us per dispatch on the lead's host over "
               f"{mesh['control_sends']} dispatches, levels out in {mesh['levels_s'] * 1e3:.1f} ms")
    return (f"{label} ({card}): {rep['completed']} requests, {rep['frames_per_s']} frames/s, p50 {lat['p50']} ms, "
            f"p99 {lat['p99']} ms, render calls {rep['render']['calls']}, partial hits {rep['tiles']['partial_hits']}, "
            f"wall {rep['wall_s']} s, dispatch {rep['pipeline']['dispatch_s']} s, block {rep['pipeline']['block_s']} s; "
            f"{control}{extra}")


def _serve_rank_worker(rank: int, shape: tuple, res: int, n_clients: int, n_requests: int, device_type: str,
                       timeout_s: float) -> None:
    """One rank of a serving mesh across cards: NCCL on cuda:rank (gloo on
    the CPU when the phase is rehearsed there). The lead (rank 0) serves
    phase 4's requests from the host model in ``RANKS_DIR`` and writes its
    frames and report; the others serve until it closes. Every rank writes
    its peak device memory."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.gs_datasets import paper_gs_config
    from repro_torch.core import gaussians as G
    from repro_torch.kernels.gsproject import ops as gp_ops
    from repro_torch.kernels.tile_raster import ops as tr_ops
    from repro_torch.launch.mesh import init_ranks, make_gs_mesh
    from repro_torch.obs import Obs
    from repro_torch.serve_gs import RenderServer

    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    tag = f"{shape[0]}x{shape[1]}"
    init_ranks(dev, init_method=f"file://{RANKS_DIR}/store_serve_{tag}", rank=rank, world_size=shape[0] * shape[1],
               timeout_s=timeout_s)
    mesh = make_gs_mesh(*shape, device=dev)
    cfg = paper_gs_config(res)
    host = None
    if rank == 0:
        arrays = np.load(RANKS_DIR / "host.npz")
        host = G.GaussianModel(*[arrays[f] for f in G.GaussianModel._fields])
    base = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    server = RenderServer(host, cfg, mesh=mesh, obs=Obs(), frames_capacity=4 * (n_clients * n_requests + 2),
                          **SERVE_LEVELS)
    with server:
        if server.is_lead:
            server.warmup(buckets=server.batcher.buckets[:1])
            run = serve_load(server, cfg, n_clients, n_requests,
                             {"gsproject": gp_ops.launch_count, "tile_raster_fwd": tr_ops.launch_count})
            np.save(RANKS_DIR / f"serve_frames_{tag}.npy", np.stack(run["frames"] + run["revisit"]))
            (RANKS_DIR / f"serve_{tag}.json").write_text(json.dumps(
                {"report": run["report"], "launches": run["launches"], "buckets": list(server.batcher.buckets)}))
        else:
            server.serve_follower()
    peak = torch.cuda.max_memory_allocated(dev) - base if dev.type == "cuda" else 0
    (RANKS_DIR / f"serve_peak_{tag}_{rank}.json").write_text(json.dumps({"peak_bytes": peak}))
    torch.distributed.destroy_process_group()


def serve_ranks_phase(dev, card: str, host, cfg, args, counters: dict, one_device: dict | None) -> dict:
    """Serving across ranks at the full configuration. The world-1 NCCL
    group of this process drives ``RenderServer(mesh=(1, 1))`` over phase
    4's host model with phase 4's requests: every frame bitwise equal to
    phase 4's one-device frames (``one_device``; with None, as in
    ``--ranks-only``, the one-device server runs first here), or the phase
    fails. With two or more cards, the same requests on each mesh of
    ``SERVE_MESHES`` that fits, one rank per card over NCCL, frames bitwise
    equal to world 1, frames/s and latency on the lead, each rank's peak
    memory above its start. The one-device server serves the same requests
    once more after the world-1 mesh (one device, mesh, one device), since
    serving is host-bound and its times drift within a call."""
    from repro_torch.launch.mesh import make_gs_mesh, spawn_ranks
    from repro_torch.obs import Obs
    from repro_torch.serve_gs import RenderServer

    def one_device_run():
        with RenderServer(host, cfg, device=dev, obs=Obs(), **kw) as srv:
            srv.warmup(buckets=(1,))
            return serve_load(srv, cfg, args.clients, args.requests, counters)

    kw = dict(frames_capacity=4 * (args.clients * args.requests + 2), **SERVE_LEVELS)
    if one_device is None:
        one_device = one_device_run()
        log(serve_summary("serve, one device", card, one_device))
    world_one_group(dev)
    mesh = make_gs_mesh(1, 1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    server = RenderServer(host, cfg, mesh=mesh, obs=Obs(), **kw)
    build_s = time.perf_counter() - t0
    with server:
        server.warmup(buckets=(1,))
        run = serve_load(server, cfg, args.clients, args.requests, counters)
        peak = torch.cuda.max_memory_allocated(dev) - base
        want = one_device["frames"] + one_device["revisit"]
        got = run["frames"] + run["revisit"]
        same = len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
        log(serve_summary("serve ranks, world-1 NCCL mesh", card, run,
                          f"; built in {build_s:.2f} s; peak memory above its start {peak} B; launches "
                          f"{run['launches']}; {len(got)} frames bitwise equal to the one-device server's: {same}"))
        log(serve_summary("serve ranks, the one-device server before the mesh", card, one_device))
        if not same:
            raise SystemExit("serve ranks: the world-1 mesh server's frames are not bitwise the one-device server's")
        launches = run["launches"]
        if not launches["gsproject"] or not launches["tile_raster_fwd"] or any(
                v for k, v in launches.items() if k not in ("gsproject", "tile_raster_fwd")):
            raise SystemExit(f"serve ranks: launches {launches}: want both forward kernels, no backward, no attention")
        serve_profile(server, cfg, "serve ranks micro-batch (world-1 NCCL mesh)")
    del server
    after = one_device_run()
    log(serve_summary("serve ranks, the one-device server after the mesh", card, after))
    out = {"launches": launches, "world1": {k: run["report"][k] for k in ("frames_per_s", "latency_ms", "mesh")},
           "one_device": [{k: r["report"][k] for k in ("frames_per_s", "latency_ms")} for r in (one_device, after)],
           "world1_peak_bytes": peak, "multi_card": {}}

    n_cards = torch.cuda.device_count()
    fits = [s for s in SERVE_MESHES if s[0] * s[1] <= n_cards]
    if not fits:
        log(f"serve ranks: {n_cards} card on this machine: served at world size 1 only; meshes across cards not run")
        return out
    np.savez(RANKS_DIR / "host.npz", **{f: getattr(host, f) for f in host._fields})
    for shape in fits:
        tag = f"{shape[0]}x{shape[1]}"
        n = shape[0] * shape[1]
        t0 = time.perf_counter()
        spawn_ranks(_serve_rank_worker, (shape, cfg.img_h, args.clients, args.requests, dev.type, 300.0), n,
                    timeout_s=600)
        res = json.loads((RANKS_DIR / f"serve_{tag}.json").read_text())
        frames = np.load(RANKS_DIR / f"serve_frames_{tag}.npy")
        same = frames.shape[0] == len(got) and all(np.array_equal(a, b) for a, b in zip(frames, got))
        peaks = [json.loads((RANKS_DIR / f"serve_peak_{tag}_{r}.json").read_text())["peak_bytes"] for r in range(n)]
        run_n = {"report": res["report"]}
        log(serve_summary(f"serve ranks {shape} over NCCL across {n} cards", card, run_n,
                          f"; buckets {res['buckets']}; launches on the lead {res['launches']}; peak memory above its "
                          f"start on the fullest rank {max(peaks)} B (ranks {peaks}); run {time.perf_counter() - t0:.1f} s with "
                          f"process start; {frames.shape[0]} frames bitwise equal to world 1: {same}"))
        if not same:
            raise SystemExit(f"serve ranks: the {shape} mesh's frames are not bitwise the world-1 server's")
        out["multi_card"][tag] = {"frames_per_s": res["report"]["frames_per_s"],
                                  "latency_ms": res["report"]["latency_ms"], "mesh": res["report"]["mesh"],
                                  "peak_bytes": peaks}
    return out


# ---------------------------------------------------------------- phase 8: the operation counter
COST_SMALL_POINTS = 20000       # the card-vs-CPU count: phase 5's small step
COST_SMALL_RES = 64


def count_step(step, state, cams, gt) -> tuple:
    """One train step under ``launch/op_cost.py`` ``OpCost``, ending in the
    loss read; returns (the new state, the count)."""
    from repro_torch.launch.op_cost import OpCost

    with OpCost() as counter:
        state, m = step(state, cams, gt)
        float(m["loss"])
    return state, counter.result()


def count_diff(a: dict, b: dict) -> list:
    """The totals and per-op (flops, bytes) where two counts differ."""
    keys = ("flops", "bytes", "coll_total_moved_bytes")
    out = [f"{k}: {a[k]} vs {b[k]}" for k in keys if a[k] != b[k]]
    for op in sorted(set(a["by_op"]) | set(b["by_op"])):
        x = a["by_op"].get(op, {"flops": 0.0, "bytes": 0.0})
        y = b["by_op"].get(op, {"flops": 0.0, "bytes": 0.0})
        if (x["flops"], x["bytes"]) != (y["flops"], y["bytes"]):
            out.append(f"{op}: flops {x['flops']} vs {y['flops']}, bytes {x['bytes']} vs {y['bytes']}")
    return out


def cost_phase(dev, card: str, host, vol, res: int, step_ms_p50: float, prefill_ms: float) -> dict:
    """Phase 8: the operation counter on the card. (a) One train step of
    phase 5's scene (4M Gaussians, 512 px, batch 4, no densification)
    counted: flops, bytes (the ops classes that hold them), the peak live
    bytes above the arguments against ``max_memory_allocated``, and the
    roofline terms on H100 terms (float32 peak, HBM3) against phase 5's p50.
    (b) Phase 5's small step (20,000 Gaussians, 64 px) counted on the card
    and on the CPU: the counts must be equal, total and op by op. (c)
    ``launch/dryrun.py`` ``run_dryrun`` of Qwen3-0.6B's prefill at 4 x 4096
    on ``card1`` (meta tensors) beside phase 7's measured prefill."""
    from repro_torch.configs.gs_datasets import paper_gs_config
    from repro_torch.core import gaussians as G
    from repro_torch.core.train import init_state, make_train_step
    from repro_torch.data.views import ViewDataset
    from repro_torch.launch.dryrun import run_dryrun
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_FP32
    from repro_torch.volume.cameras import camera_slice, orbit_cameras

    t_phase = time.perf_counter()
    # ---- a. the 4M step
    cfg = paper_gs_config(res)
    data = ViewDataset(vol, n_views=cfg.batch_size, img_h=cfg.img_h, img_w=cfg.img_w, radius=3.0, device=dev)
    cams, gt = next(iter(data.batches(cfg.batch_size, steps=1)))
    step = make_train_step(cfg)
    state, m = step(init_state(G.from_numpy(host, dev)), cams, gt)  # warm-up
    float(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    state, r = count_step(step, state, cams, gt)
    count_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    terms = {"compute": r["flops"] / PEAK_FLOPS_FP32 * 1e3, "memory": r["bytes"] / HBM_BW * 1e3}
    dom = max(terms, key=terms.get)
    top = list(r["by_op"].items())[:8]
    log(f"cost train step {host.means.shape[0]} Gaussians {cfg.img_h} px batch {cfg.batch_size} ({card}): "
        f"flops {r['flops']:.6e}, bytes {r['bytes']:.6e}, collective bytes {r['coll_total_moved_bytes']}, "
        f"host<->device bytes {r['transfer_bytes']}; counted in {count_s:.2f} s")
    log(f"cost train step: roofline compute {terms['compute']:.3f} ms (float32 peak 67 TFLOP/s), memory "
        f"{terms['memory']:.3f} ms (3.35 TB/s), dominant {dom}; phase 5's step p50 {step_ms_p50:.3f} ms -> roofline "
        f"share {terms[dom] / step_ms_p50:.4f}")
    log(f"cost train step: peak live bytes above the arguments {r['peak_live_bytes']} + arguments {base} = "
        f"{r['peak_live_bytes'] + base} B against max_memory_allocated {peak} B")
    log("cost train step, bytes by op: " + "; ".join(
        f"{k} x{v['count']} {v['bytes']:.4e} B ({v['bytes'] / r['bytes']:.4f}), {v['flops']:.4e} flops" for k, v in top))
    log("cost train step, largest sites: " + "; ".join(
        f"{t['kind']} {t['shape']} x{t['count']} {t['bytes']:.4e} B" for t in r["top_bytes"][:8]))
    del data, state, gt, step
    torch.cuda.empty_cache()

    # ---- b. the same small step counted on the card and on the CPU
    small = host._replace(**{f: getattr(host, f)[:COST_SMALL_POINTS] for f in host._fields})
    scfg = paper_gs_config(COST_SMALL_RES)
    scams = camera_slice(orbit_cameras(12, img_h=COST_SMALL_RES, img_w=COST_SMALL_RES, radius=3.0), torch.arange(4))
    sgt = ViewDataset(vol, n_views=12, img_h=COST_SMALL_RES, img_w=COST_SMALL_RES, radius=3.0, device=dev).gt[:4]
    c, c_cpu = (count_step(make_train_step(scfg), init_state(G.from_numpy(small, d)), scams,
                           torch.tensor(sgt, device=d))[1] for d in (dev, torch.device("cpu")))
    diff = count_diff(c, c_cpu)
    log(f"cost small step {COST_SMALL_POINTS} Gaussians {COST_SMALL_RES} px, card vs CPU: flops {c['flops']:.6e} vs "
        f"{c_cpu['flops']:.6e}, bytes {c['bytes']:.6e} vs {c_cpu['bytes']:.6e}, {len(c['by_op'])} op kinds; "
        + ("equal, total and op by op" if not diff else "DIFFER: " + "; ".join(diff[:12])))
    if diff:
        raise SystemExit("the operation count of the small step differs between the card and the CPU")

    # ---- c. the LM prefill's dry run beside phase 7's measured prefill
    dr = run_dryrun("qwen3_0_6b", "prefill_32k", mesh="card1", seq_len=LM_SEQ, global_batch=LM_BATCH)
    rf = dr["roofline"]
    lm_terms = {k: rf[f"{k}_s"] * 1e3 for k in ("compute", "memory")}
    log(f"cost dry run qwen3-0.6b prefill {LM_BATCH} x {LM_SEQ} on card1 (meta tensors, counted in {dr['count_s']} s): "
        f"flops {dr['flops']:.6e}, bytes {dr['bytes']:.6e}, roofline compute {lm_terms['compute']:.3f} ms (bf16 peak "
        f"989 TFLOP/s), memory {lm_terms['memory']:.3f} ms, dominant {rf['dominant']}, useful flop ratio "
        f"{dr['useful_flop_ratio']:.4f}, peak estimate {dr['memory_analysis']['peak_estimate_bytes']} B; phase 7's "
        f"measured prefill p50 {prefill_ms:.3f} ms -> roofline share {max(lm_terms.values()) / prefill_ms:.4f}")
    log(f"cost phase ({card}): {time.perf_counter() - t_phase:.1f} s")
    return {"train_flops": r["flops"], "train_bytes": r["bytes"], "train_share": terms[dom] / step_ms_p50,
            "prefill_share": max(lm_terms.values()) / prefill_ms}


# ---------------------------------------------------------------- phase 9: the static passes
ANALYSIS_DIR = ROOT / "build" / "repro_torch_analysis"


def analysis_phase(card: str) -> None:
    """Phase 9: the port's static-analysis CLI (``src/repro_torch/launch/analyze.py``)
    over this checkout, as a user runs it, in its own process on this
    machine, which has no JAX: it must exit 0 against the committed
    ``ANALYSIS_baseline.json``. Prints the findings, the pragma-allowed
    ones, the CLI's own elapsed ms and the process's wall ms; fails on any
    other exit code."""
    ANALYSIS_DIR.mkdir(parents=True, exist_ok=True)
    report = ANALYSIS_DIR / "report.json"
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.analyze", "-q", "--report", str(report)],
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, capture_output=True,
                         text=True, timeout=300)
    wall = (time.perf_counter() - t0) * 1e3
    if out.returncode != 0:
        raise SystemExit(f"analysis CLI exited {out.returncode}:\n{out.stdout}\n{out.stderr}")
    rep = json.loads(report.read_text())
    log(f"analysis CLI ({card}): exit 0, {rep['findings']} findings ({rep['allowed']} pragma-allowed; by rule "
        f"{rep['by_rule']}), baseline entries {rep['baseline']['entries']}, new {rep['baseline']['new']}; elapsed "
        f"{rep['elapsed_s'] * 1e3:.0f} ms (the CLI's own clock), process wall {wall:.0f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--points", type=int, default=4_000_000, help="Gaussians (the paper's Kingsnake: 4M)")
    ap.add_argument("--res", type=int, default=512, help="served image side (paper_gs_config)")
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--requests", type=int, default=3, help="requests per client")
    ap.add_argument("--train-steps", type=int, default=6, help="train steps (one densify round at step 3)")
    ap.add_argument("--train-views", type=int, default=8, help="ray-marched orbit views to train on")
    ap.add_argument("--eval-views", type=int, default=2)
    ap.add_argument("--ranks-only", action="store_true",
                    help="build, make the scene and its training views, run phases 4b (serve ranks, with its own "
                         "one-device server) and 5b (ranks), then Miranda 18.18M and in situ across cards, alone, "
                         "and print their result as JSON on the last line")
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

    from repro_torch.configs.gs_datasets import paper_gs_config, paper_scene
    from repro_torch.core import gaussians as G
    from repro_torch.core import projection as P
    from repro_torch.core import render as R
    from repro_torch.core.sharding import distributed_gs_loss
    from repro_torch.core.densify import densify_and_rebalance
    from repro_torch.core.train import (
        init_state,
        make_batched_eval_render,
        make_tile_row_render,
        make_train_step,
        state_from_numpy,
        state_to_numpy,
    )
    from repro_torch.data.views import ViewDataset
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _lib
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.gsproject import ops as gp_ops
    from repro_torch.kernels.gsproject.ref import project_ref
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_FP32
    from repro_torch.kernels.tile_raster import ops as tr_ops
    from repro_torch.kernels.tile_raster.ref import (
        composite_bwd_ref,
        composite_ref,
        composited_counts,
        contrib_counts,
    )
    from repro_torch.launch.train import GSTrainer
    from repro_torch.obs import Obs
    from repro_torch.optim.adam import adam_update
    from repro_torch.serve_gs import RenderServer, stack_cameras
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
        if "registers" in line or "Compiling entry" in line or "spill" in line or "warning" in line:
            log(f"  ptxas: {line.strip()}")
    for entry, e in ptxas_entries(build.log).items():
        if "tile_raster" in entry:
            which = "backward" if "bwd_kernel" in entry else "forward"
            log(f"ptxas: tile_raster {which}: {e.get('registers')} registers, spill stores "
                f"{e.get('spill_stores')} B, spill loads {e.get('spill_loads')} B")
        if "attention_tc_kernel" in entry:
            hd = re.search(r"attention_tc_kernelILi(\d+)E", entry).group(1)
            log(f"ptxas: bf16 tensor-core attention, hd {hd}: {e.get('registers')} registers at entry (setmaxnreg: "
                f"consumers 240, producer 24), spill stores {e.get('spill_stores')} B, spill loads "
                f"{e.get('spill_loads')} B")
    _lib.library()

    # ---------------------------------------------------------- scene
    t0 = time.perf_counter()
    host, n_surface, vol = paper_scene("kingsnake", args.points, args.seed)
    log(f"scene: kingsnake {n_surface} surface points -> {host.means.shape[0]} Gaussians "
        f"({time.perf_counter() - t0:.1f} s)")
    cfg = paper_gs_config(args.res)
    fwd_ctas, bwd_ctas, fwd_threads, bwd_threads = tr_ops.occupancy(cfg.tile_h, cfg.tile_w)
    log(f"occupancy at {cfg.tile_h}x{cfg.tile_w} tiles: resident CTAs per SM: tile_raster forward {fwd_ctas} of "
        f"{fwd_threads} threads, backward {bwd_ctas} of {bwd_threads} threads (two pixels a thread forward, one backward)")
    g_dev = G.from_numpy(host, dev)
    cams = orbit_cameras(12, img_h=cfg.img_h, img_w=cfg.img_w, radius=3.0)
    cam = camera_slice(cams, 0)
    # the training views, ray-marched on the card; view 0 is the camera above
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = ViewDataset(vol, n_views=args.train_views, img_h=cfg.img_h, img_w=cfg.img_w, radius=3.0, device=dev)
    torch.cuda.synchronize()
    log(f"ground truth: {args.train_views} orbit views ray-marched at {cfg.img_h} px on the card "
        f"({time.perf_counter() - t0:.2f} s), covered share {float((data.gt.max(-1) > 0).mean()):.4f}")
    counters = {"gsproject": gp_ops.launch_count, "tile_raster_fwd": tr_ops.launch_count,
                "tile_raster_bwd": tr_ops.bwd_launch_count, "flash_attention": fa_ops.launch_count}
    if args.ranks_only:
        result = {"serve_ranks": serve_ranks_phase(dev, card, host, cfg, args, counters, None),
                  "ranks": ranks_phase(dev, card, host, data, counters)}
        del data
        result["paper_scale_ranks"] = paper_ranks_phase(dev, card, args.seed, counters)
        result["insitu_ranks"] = insitu_ranks_phase(dev, card, args.res)
        torch.distributed.destroy_process_group()
        print(json.dumps(result), flush=True)
        return 0

    # ---------------------------------------------------------- 2. compare
    proj_k = gp_ops.project_packed(g_dev, cam)
    proj_p = project_ref(g_dev, cam)
    gp_err, gp_bad = allclose_report(proj_k, proj_p, 2e-5, 2e-5)
    log(f"compare gsproject N={g_dev.n}: max_abs_err {gp_err:.3e}, entries outside atol 2e-5/rtol 2e-5: {gp_bad}")
    if gp_bad:
        raise SystemExit("gsproject disagrees with its plain version")
    # SH degrees 1-3: the same scene with random higher bands from the seed
    sh_models, sh_err = sh_scene_models(g_dev, args.seed, dev), {}
    for d, g_sh in sh_models.items():
        k_sh = gp_ops.project_packed(g_sh, cam)
        err, bad = allclose_report(k_sh, project_ref(g_sh, cam), 2e-5, 2e-5)
        same = torch.equal(gp_ops.project_packed(g_sh, cam), k_sh)
        log(f"compare gsproject SH degree {d} ({g_sh.sh.shape[1]} coefficients) N={g_sh.n}: max_abs_err {err:.3e}, "
            f"entries outside atol 2e-5/rtol 2e-5: {bad}; two launches bitwise equal: {same}")
        if bad or not same:
            raise SystemExit(f"gsproject at SH degree {d} disagrees with its plain version or with itself")
        sh_err[d] = err
    del k_sh

    pk_sorted, _ = P.sort_by_depth(proj_k)
    tiles_x = cfg.img_w // cfg.tile_w
    # the main path's lists (the paper config's hierarchical binning), a strip
    # at row_offset != 0, the flat lists of the same frame, which are far
    # denser (at 4M Gaussians the hierarchical lists leave most tiles empty),
    # a dense slab at the paper config's tiles and K, the view an isosurface
    # fills, and one at K 250, whose rows are not 16-byte aligned: the
    # kernels stage it with 4-byte cp.async copies in place of 16-byte ones
    idx, valid = R.bin_tiles(pk_sorted, img_h=cfg.img_h, img_w=cfg.img_w, tile_h=cfg.tile_h,
                             tile_w=cfg.tile_w, k_per_tile=cfg.k_per_tile, binning=cfg.binning)
    row = (cfg.img_h // cfg.tile_h) // 2 + 1
    idx_r, valid_r = R.bin_tile_row(pk_sorted, row=row, img_h=cfg.img_h, img_w=cfg.img_w, tile_h=cfg.tile_h,
                                    tile_w=cfg.tile_w, k_per_tile=cfg.k_per_tile, binning=cfg.binning)
    fidx, fvalid = R.build_tile_lists(pk_sorted, img_h=cfg.img_h, img_w=cfg.img_w, tile_h=cfg.tile_h,
                                      tile_w=cfg.tile_w, k_per_tile=cfg.k_per_tile)
    slab = dense_slab(dev, args.seed, tiles_x, cfg.img_h // cfg.tile_h, cfg.tile_h, cfg.k_per_tile)
    slab_250 = dense_slab(dev, args.seed, tiles_x, cfg.img_h // cfg.tile_h, cfg.tile_h, 250)

    def slab_of(ix, vd):  # the kernel's (T, 11, K) input and its float valid mask
        return pk_sorted[ix.long()].transpose(1, 2).contiguous(), vd.to(torch.float32).contiguous()

    raster_cases = [("frame", *slab_of(idx, valid), 0), (f"row {row}", *slab_of(idx_r, valid_r), row * cfg.tile_h),
                    ("frame, flat lists", *slab_of(fidx, fvalid), 0), ("dense slab", *slab, 0),
                    ("dense slab, K 250", *slab_250, 0)]

    def fwd(splats_t, vf, kw):  # the forward kernel as training runs it: (rgb, t_final, n_contrib)
        return tr_ops.composite(splats_t, vf, **kw)

    def bwd(splats_t, vf, gout, gtfin, kw, res):  # the backward kernel, from the forward's (t_final, n_contrib)
        return tr_ops.composite_bwd(splats_t, vf, gout, gtfin, *res, **kw)

    tr_err = 0.0
    raster_inputs = {}
    for label, splats_t, vf, roff in raster_cases:
        kw = dict(tiles_x=tiles_x, tile_h=cfg.tile_h, tile_w=cfg.tile_w, row_offset=roff)
        out_k, t_k, nc_k = fwd(splats_t, vf, kw)
        out_p, t_p = composite_ref(splats_t, vf, **kw)
        counts = composited_counts(splats_t, vf, **kw)
        err, bad, lines = raster_fwd_report(out_k, t_k, out_p, t_p, counts)
        tr_err = max(tr_err, err)
        nc_bad = int((nc_k != contrib_counts(splats_t, vf, **kw)).sum())
        log(f"compare tile_raster {label} T={splats_t.shape[0]} K={splats_t.shape[2]} P={t_k.shape[1]}: "
            f"max_abs_err {err:.3e}, entries outside atol {RASTER_ATOL:g}/rtol {RASTER_RTOL:g}: {bad} of "
            f"{out_k.numel() + t_k.numel()} (every pixel and channel of rgb and t_final); n_contrib unequal to the "
            f"plain version's: {nc_bad}")
        for line in lines:
            log(f"  outside: {line}")
        if bad or nc_bad:
            raise SystemExit(f"tile_raster disagrees with its plain version ({label})")
        again = fwd(splats_t, vf, kw)
        if not all(torch.equal(a, b) for a, b in zip(again, (out_k, t_k, nc_k))):
            raise SystemExit(f"tile_raster: two launches on the same inputs differ ({label})")
        if roff == 0:
            raster_inputs[label] = (splats_t, vf, kw, counts)

    # the backward, on the frame's hierarchical (main path) and flat lists,
    # with d(out) from a real loss (L1 + D-SSIM against the ray-marched view;
    # black background, so d(t_final) is 0) and a random d(out), d(t_final);
    # on the dense slabs with the random one
    bwd_err = 0.0
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for label, (splats_t, vf, kw, counts) in raster_inputs.items():
        raw, tfin, *res = fwd(splats_t, vf, kw)
        g_rand = (torch.randn(raw.shape, device=dev, generator=gen), torch.randn(tfin.shape, device=dev, generator=gen))
        kinds = [("random", g_rand)]
        if not label.startswith("dense slab"):
            raw.requires_grad_()
            tfin.requires_grad_()
            img, tmap = image_layout(raw, tfin, cfg.img_h, cfg.img_w, cfg.tile_h, cfg.tile_w)
            img = img + tmap[..., None] * torch.zeros(3, device=dev)  # the config's black background
            loss = distributed_gs_loss(img[None], data.view(0)[1][None])
            kinds.insert(0, ("real loss", torch.autograd.grad(loss, [raw, tfin])))
        res = (tfin.detach(), *res)
        for kind, (gout, gtfin) in kinds:
            got = bwd(splats_t, vf, gout.contiguous(), gtfin.contiguous(), kw, res)
            want = composite_bwd_ref(splats_t, vf, gout, gtfin, **kw)
            err, bad = grad_report(got, want)
            bwd_err = max(bwd_err, err)
            log(f"compare tile_raster_bwd {label}, {kind} d(out): max_abs_err {err:.3e} (max |g| "
                f"{float(want.abs().max()):.3e}), entries outside atol 2e-5*max|g|/rtol 2e-4: {bad} of {want.numel()}")
            if bad or not torch.isfinite(got).all():
                raise SystemExit(f"tile_raster_bwd disagrees with its plain version ({label}, {kind})")
            if not torch.equal(bwd(splats_t, vf, gout.contiguous(), gtfin.contiguous(), kw, res), got):
                raise SystemExit(f"tile_raster_bwd: two launches on the same inputs differ ({label}, {kind})")
        raster_inputs[label] = (splats_t, vf, kw, counts, g_rand, res)

    # ---------------------------------------------------------- 3. time
    cam_vec = gp_ops.cam_vector(cam)
    gp_ms = cuda_ms(lambda: gp_ops.launch(g_dev, cam_vec), 20, "gsproject kernel")
    cam_dev = P.Camera(*[torch.as_tensor(x).to(dev) for x in cam])  # no host copy per call
    gp_plain_ms = cuda_ms(lambda: project_ref(g_dev, cam_dev), 5, "gsproject plain")
    n = g_dev.n
    gp_ops_n, gp_bytes_n = kcost.gsproject_cost(n)
    gp_bound, gp_bound_by = kcost.bound_ms(gp_ops_n, gp_bytes_n, PEAK_FLOPS_FP32, HBM_BW)
    log(f"time gsproject N={n}: kernel {gp_ms:.4f} ms (host {host_us(lambda: gp_ops.launch(g_dev, cam_vec)):.1f} us "
        f"per launch), plain {gp_plain_ms:.4f} ms, bound {gp_bound:.4f} ms "
        f"({gp_bound_by}; {gp_bytes_n} B), no library call")
    sh_rows = {}
    for d, g_sh in sh_models.items():
        sh_ms = cuda_ms(lambda: gp_ops.launch(g_sh, cam_vec), 20, f"gsproject SH degree {d} kernel")
        sh_plain_ms = cuda_ms(lambda: project_ref(g_sh, cam_dev), 5, f"gsproject SH degree {d} plain")
        sh_ops, sh_bytes = kcost.gsproject_cost(n, g_sh.sh.shape[1])
        sh_bound, sh_bound_by = kcost.bound_ms(sh_ops, sh_bytes, PEAK_FLOPS_FP32, HBM_BW)
        sh_rows[d] = dict(max_abs_err=sh_err[d], ms=sh_ms, plain_ms=sh_plain_ms, bound_ms=sh_bound,
                          bound_by=sh_bound_by)
        log(f"time gsproject SH degree {d} ({g_sh.sh.shape[1]} coefficients) N={n} ({card}): kernel {sh_ms:.4f} ms, "
            f"plain {sh_plain_ms:.4f} ms, bound {sh_bound:.4f} ms ({sh_bound_by}; {sh_bytes} B, {sh_ops} operations), "
            f"kernel / bound {sh_ms / sh_bound:.3f}, no library call")
    del sh_models

    # each rasterizer kernel against its bound and its plain version, the
    # per-tile load, and the densest tile alone (every other tile's valid row
    # zeroed): if it takes about the whole input's time, its serial walk
    # sets the pace
    tr = {}
    trb = {}
    p_tile = cfg.tile_h * cfg.tile_w
    for label, (splats_t, vf, kw, counts, (gout, gtfin), res) in raster_inputs.items():
        kv, tile_evals = tile_load(vf, counts)
        hits_px = composited_counts(splats_t, vf, **kw, live_only=True)
        densest = int(tile_evals.argmax())
        alone = torch.zeros_like(vf)
        alone[densest] = vf[densest]
        _, t_alone, *res_alone = fwd(splats_t, alone, kw)
        res_alone = (t_alone, *res_alone)
        log(f"load tile_raster {label}: per tile valid entries {stats_line(kv)}; alpha evaluations "
            f"{stats_line(tile_evals)}; composited (pixel, splat) pairs {int(hits_px.sum())}; densest tile "
            f"{densest} ({int(kv[densest])} valid, {int(tile_evals[densest])} evaluations)")
        ms = cuda_ms(lambda: fwd(splats_t, vf, kw), 20, f"tile_raster {label} kernel")
        ms_alone = cuda_ms(lambda: fwd(splats_t, alone, kw), 20, f"tile_raster {label} densest tile alone")
        plain_ms = cuda_ms(lambda: composite_ref(splats_t, vf, **kw), 3, f"tile_raster {label} plain")
        evals = kcost.raster_evals(vf, counts)
        ops, nbytes = kcost.raster_fwd_cost(vf, counts, p_tile)
        bound, bound_by = kcost.bound_ms(ops, nbytes, PEAK_FLOPS_FP32, HBM_BW)
        tr[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
        full_evals = splats_t.shape[0] * splats_t.shape[2] * p_tile
        log(f"time tile_raster {label} T={splats_t.shape[0]} K={splats_t.shape[2]} ({card}): kernel {ms:.4f} ms (host "
            f"{host_us(lambda: fwd(splats_t, vf, kw)):.1f} us per launch), densest tile alone {ms_alone:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}; "
            f"{int(kv.sum())} valid entries, {evals} alpha evaluations of {full_evals} before early exit, "
            f"{nbytes} B), no library call")
        ms = cuda_ms(lambda: bwd(splats_t, vf, gout, gtfin, kw, res), 20, f"tile_raster_bwd {label}")
        ms_alone = cuda_ms(lambda: bwd(splats_t, alone, gout, gtfin, kw, res_alone), 20,
                           f"tile_raster_bwd {label} densest tile alone")
        plain_ms = cuda_ms(lambda: composite_bwd_ref(splats_t, vf, gout, gtfin, **kw), 3,
                           f"tile_raster_bwd {label} plain")
        hits = int(hits_px.sum())
        ops, nbytes = kcost.raster_bwd_cost(vf, hits, p_tile)
        bound, bound_by = kcost.bound_ms(ops, nbytes, PEAK_FLOPS_FP32, HBM_BW)
        trb[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
        log(f"time tile_raster_bwd {label} ({card}): kernel {ms:.4f} ms (host "
            f"{host_us(lambda: bwd(splats_t, vf, gout, gtfin, kw, res)):.1f} us per launch), densest tile alone "
            f"{ms_alone:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}; "
            f"{hits} composited (pixel, splat) pairs, {nbytes} B), no library call")

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
    del proj_k, proj_p, pk_sorted, raster_inputs, raster_cases, slab, fidx, fvalid, img_h_, img_f_

    # ---------------------------------------------------------- 4. serve
    n_req = args.clients * args.requests
    server = RenderServer(host, cfg, device=dev, obs=Obs(), n_levels=3, keep_ratio=0.5,
                          max_batch=4, pipeline_depth=2, frames_capacity=4 * n_req)
    log(f"serve: levels live {list(server.pyramid.live_counts)}, "
        f"warmup {server.warmup(buckets=(1,)):.2f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    # orbit clients, then a localized update (two tile rows dropped) and two
    # revisited poses -> partial hits render only those rows (the strip path)
    served = serve_load(server, cfg, args.clients, args.requests, counters)
    serve_launches = tuple(served["launches"].values())
    gp_launches, tr_launches = serve_launches[:2]
    report = served["report"]
    peak = torch.cuda.max_memory_allocated(dev)
    done = report["completed"]
    if done != n_req + len(served["revisit"]):
        raise SystemExit(f"served {done} of {n_req + len(served['revisit'])} requests")
    frames = served["frames"]
    for f in frames + served["revisit"]:
        if f.shape != (cfg.img_h, cfg.img_w, 3) or not np.isfinite(f).all() or f.min() < -1e-6 or f.max() > 1 + 1e-6:
            raise SystemExit(f"bad frame: shape {f.shape}, range [{f.min()}, {f.max()}]")
    if gp_launches == 0 or tr_launches == 0 or serve_launches[2] or serve_launches[3]:
        raise SystemExit(f"serving path launches (gsproject, tile_raster_fwd, tile_raster_bwd, flash_attention) "
                         f"{serve_launches}: want both forward kernels, no backward and no attention")
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
    serve_profile(server, cfg, "serve micro-batch (one device)")
    server.close()

    # ---------------------------------------------------------- 4b. serve ranks
    serve_ranks = serve_ranks_phase(dev, card, host, cfg, args, counters, served)

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

    # ---------------------------------------------------------- 5. train
    del g_dev
    tcfg = paper_gs_config(args.res, densify_from=3, densify_interval=3, densify_until=3,
                           max_steps=max(args.train_steps, 1))
    trainer = GSTrainer(tcfg, device=dev, params=host, obs=Obs(), verbose=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gp_ops.launch_count.n = tr_ops.launch_count.n = tr_ops.bwd_launch_count.n = fa_ops.launch_count.n = 0
    losses = trainer.fit(data, steps=args.train_steps, log_every=1)
    metrics = trainer.evaluate(data, range(args.eval_views))
    torch.cuda.synchronize()
    train_launches = (gp_ops.launch_count.n, tr_ops.launch_count.n, tr_ops.bwd_launch_count.n,
                      fa_ops.launch_count.n)
    train_peak = torch.cuda.max_memory_allocated(dev)
    step_ms = trainer.step_ms_log
    log(f"train {name} ({card}): {trainer.state.params.n} Gaussians after {args.train_steps} steps at batch "
        f"{tcfg.batch_size}, {cfg.img_h} px; losses {[round(x, 6) for x in losses]}; step ms "
        f"{[round(x, 3) for x in step_ms]}, p50 {float(np.median(step_ms)):.3f} ms "
        f"({1e3 / float(np.median(step_ms)):.3f} steps/s); eval {metrics}; max_memory_allocated {train_peak} B")
    log(f"densify rounds: {trainer.densify_reports}")
    for r_ in trainer.densify_reports:
        log(f"densify round at {r_.n_before} Gaussians: {r_.n_cloned} cloned, {r_.n_split} split, "
            f"{r_.n_pruned} pruned -> {r_.n_after} live, {r_.n_padded} allocated (live set changed: "
            f"{r_.n_cloned + r_.n_split + r_.n_pruned > 0})")
    want = (4 * args.train_steps + args.eval_views,) * 2 + (4 * args.train_steps, 0)
    log(f"launches on the training path: gsproject {train_launches[0]}, tile_raster_fwd {train_launches[1]}, "
        f"tile_raster_bwd {train_launches[2]}, flash_attention {train_launches[3]} (want {want}: 4 per step each, "
        "plus one forward per eval view, and no attention)")
    if not np.isfinite(losses).all() or len(losses) != args.train_steps:
        raise SystemExit(f"training losses not finite: {losses}")
    if train_launches != want:
        raise SystemExit(f"training path launches {train_launches}, want {want}")
    if len(trainer.densify_reports) != 1:
        raise SystemExit(f"want one densify round, got {trainer.densify_reports}")

    # where a train step's device time goes, stage by stage at the step's
    # shapes (per-view stages times the batch), then the whole step
    params = trainer.state.params
    cams_b, gt_b = next(iter(data.batches(tcfg.batch_size, steps=1)))
    b = tcfg.batch_size
    view = camera_slice(cams_b, 0)
    leaves = [x.detach().requires_grad_() for x in params]
    packed = P.project(G.GaussianModel(*leaves), view)
    gpacked = torch.randn(packed.shape, device=dev, generator=gen)
    pk_leaf = packed.detach().requires_grad_()
    pk_sorted, order = P.sort_by_depth(pk_leaf)
    bkw = dict(img_h=tcfg.img_h, img_w=tcfg.img_w, tile_h=tcfg.tile_h, tile_w=tcfg.tile_w, k_per_tile=tcfg.k_per_tile,
               binning=tcfg.binning)
    idx, valid = R.bin_tiles(pk_sorted.detach(), **bkw)
    ras = dict(img_h=tcfg.img_h, img_w=tcfg.img_w, tile_h=tcfg.tile_h, tile_w=tcfg.tile_w,
               bg=torch.zeros(3, device=dev))
    img, _ = tr_ops.rasterize_tiles(pk_sorted, idx, valid, **ras)
    gimg = torch.randn(img.shape, device=dev, generator=gen)
    imgs = img.detach()[None].expand(b, -1, -1, -1).contiguous().requires_grad_()
    step_grads = G.GaussianModel(*[torch.randn(x.shape, device=dev, generator=gen) for x in params])
    lrs = G.GaussianModel(*[1e-3] * 5)
    with torch.no_grad():
        stages = {
            "projection": b * cuda_ms(lambda: P.project(params, view), 5, "stage projection"),
            "sort and binning": b * cuda_ms(lambda: R.bin_tiles(P.sort_by_depth(packed.detach())[0], **bkw), 3,
                                            "stage sort and binning"),
            "rasterizer forward": b * cuda_ms(lambda: tr_ops.rasterize_tiles(pk_sorted.detach(), idx, valid, **ras),
                                              5, "stage rasterizer forward"),
        }
    stages["loss forward and backward"] = cuda_ms(
        lambda: torch.autograd.grad(distributed_gs_loss(imgs, gt_b), imgs), 5, "stage loss")
    stages["rasterizer backward and gather transposes"] = b * cuda_ms(
        lambda: torch.autograd.grad(img, pk_leaf, gimg, retain_graph=True), 5, "stage rasterizer backward")
    stages["projection backward (plain VJP)"] = b * cuda_ms(
        lambda: torch.autograd.grad(packed, leaves, gpacked, retain_graph=True), 3, "stage projection backward")
    stages["Adam"] = cuda_ms(lambda: adam_update(step_grads, trainer.state.adam, params, lrs), 5, "stage Adam")
    whole = cuda_ms(lambda: trainer.step_fn(trainer.state, cams_b, gt_b), 3, "whole train step")
    log(f"train step breakdown N={params.n} {tcfg.img_h}px batch {b} ({card}): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.3f} ms; whole step {whole:.3f} ms")
    profile_step(lambda: trainer.step_fn(trainer.state, cams_b, gt_b), float(np.median(step_ms)))
    del packed, pk_leaf, pk_sorted, img, imgs, leaves, gpacked, step_grads, trainer

    # a small train step on the card against the same step on the CPU
    small = host._replace(**{f: getattr(host, f)[: 20000] for f in host._fields})
    scfg = paper_gs_config(64)
    scams = camera_slice(orbit_cameras(12, img_h=64, img_w=64, radius=3.0), torch.arange(4))
    sgt = ViewDataset(vol, n_views=12, img_h=64, img_w=64, radius=3.0, device=dev).gt[:4]
    res_small = []
    for d in (dev, torch.device("cpu")):
        st, m = make_train_step(scfg)(init_state(G.from_numpy(small, d)), scams, torch.tensor(sgt, device=d))
        res_small.append((float(m["loss"]), [x.cpu() / 0.1 for x in st.adam.m]))  # m = 0.1 g after one step
    (l_k, g_k), (l_c, g_c) = res_small
    gerr = max(grad_report(a, b)[0] for a, b in zip(g_k, g_c))
    gbad = sum(grad_report(a, b)[1] for a, b in zip(g_k, g_c))
    log(f"small train step 20000 Gaussians at 64 px, card vs CPU path: loss {l_k:.7f} vs {l_c:.7f}, "
        f"gradients max_abs_err {gerr:.3e}, entries outside atol 2e-5*max|g|/rtol 2e-4: {gbad}")
    if abs(l_k - l_c) > 1e-5 * abs(l_c) or gbad:
        raise SystemExit("card train step disagrees with the CPU path on a small input")

    # a densify round that resizes, then one more step on the card and on the
    # CPU. The round above keeps its real statistics, and at 4M Gaussians they
    # may resize nothing (the saturated lists keep the view-space gradients
    # small). Here the CPU step's gradient statistics are drawn from the seed
    # around the threshold, 5% of the Gaussians are made transparent and the
    # scene extent puts the clone/split boundary at the median size, so the
    # round clones, splits and prunes; both devices densify the same numbers
    # with the same generator. The step's gradient is read back from Adam's
    # first moment, g = (m' - 0.9 m) / 0.1.
    h = state_to_numpy(st)  # the CPU's state after its step
    n_s = h.params.means.shape[0]
    r = np.random.default_rng(args.seed)
    logit = h.params.opacity_logit.copy()
    logit[r.random(n_s) < 0.05] = -8.0
    h = h._replace(params=h.params._replace(opacity_logit=logit),
                   grad2d_accum=(h.vis_count * r.uniform(0, 2 * scfg.densify_grad_thresh, n_s)).astype(np.float32))
    extent = float(np.median(np.exp(h.params.log_scales).max(axis=1))) / scfg.densify_scale_thresh
    res_dens = []
    for d in (dev, torch.device("cpu")):
        st_d, rep_d = densify_and_rebalance(state_from_numpy(h, d), scfg, scene_extent=extent,
                                            rng=np.random.default_rng(args.seed + 1))
        m_old = [x.cpu() for x in st_d.adam.m]
        st2, m = make_train_step(scfg)(st_d, scams, torch.tensor(sgt, device=d))
        res_dens.append((rep_d, float(m["loss"]), [(x.cpu() - 0.9 * mo) / 0.1 for x, mo in zip(st2.adam.m, m_old)],
                         st2.params.n))
    (rep_k, l_k, g_k, n_k), (rep_c, l_c, g_c, n_c) = res_dens
    gerr = max(grad_report(a, b)[0] for a, b in zip(g_k, g_c))
    gbad = sum(grad_report(a, b)[1] for a, b in zip(g_k, g_c))
    log(f"densify round on {n_s} Gaussians: card {tuple(rep_k)}, CPU {tuple(rep_c)}; next step at {n_k} Gaussians, "
        f"card vs CPU path: loss {l_k:.7f} vs {l_c:.7f}, gradients max_abs_err {gerr:.3e}, entries outside "
        f"atol 2e-5*max|g|/rtol 2e-4: {gbad}")
    resized = rep_k.n_cloned and rep_k.n_split and rep_k.n_pruned and n_k == n_c == rep_k.n_padded != n_s
    if rep_k != rep_c or not resized:
        raise SystemExit("the small densify round did not resize alike on the card and on the CPU")
    if abs(l_k - l_c) > 1e-5 * abs(l_c) or gbad:
        raise SystemExit("card train step after a resizing densify round disagrees with the CPU path")

    # ---------------------------------------------------------- 5b. ranks
    ranks = ranks_phase(dev, card, host, data, counters)
    ranks_launches = ranks["launches"]
    log(f"ranks ({card}): world-1 sharded step p50 {ranks['step_ms']} ms, one-device step in the same phase "
        f"{ranks['one_device_step_ms']} ms, phase 5's one-device p50 {float(np.median(step_ms)):.3f} ms; launches "
        f"{ranks_launches}")

    # ---------------------------------------------------------- 5f. SH degrees 1-3
    sh_launches = sh_phase(dev, card, args.seed, host, vol, data, args.res, counters)
    del data

    # ---------------------------------------------------------- 5c. in situ
    insitu_launches = insitu_phase(dev, card, counters, args.res, float(np.median(step_ms)))
    torch.distributed.destroy_process_group()  # the world-1 group of phases 4b, 5b and 5c

    # ---------------------------------------------------------- 5d. frontend
    frontend_launches = frontend_phase(dev, card, host, cfg, counters, INSITU_DIR / "seq")

    # ---------------------------------------------------------- 5e. paper scale
    paper_launches = paper_scale_phase(dev, card, counters, args.seed, host, vol)

    # ---------------------------------------------------------- 7. lm
    lm_res = lm_phase(dev, card, args.seed, get_arch("qwen3-0.6b").config(), LM_BATCH, LM_SEQ,
                      ["--arch", "qwen3-0.6b", "--device", "cuda", "--seed", str(args.seed)], counters)

    # ---------------------------------------------------------- 7b. lm training
    log(f"before phase 7b: memory_allocated {torch.cuda.memory_allocated(dev)} B")
    lm_train_launches = lm_train_phase(dev, card, args.seed, get_arch("qwen3-0.6b").config(), LM_TRAIN_BATCH,
                                       LM_SEQ, counters)

    # ---------------------------------------------------------- 7c. moe
    moe_res = moe_phase(dev, card, args.seed, get_arch("granite-moe-3b-a800m").config(), LM_BATCH, LM_SEQ,
                        ["--arch", "granite-moe-3b-a800m", "--device", "cuda", "--seed", str(args.seed)], counters)

    # ---------------------------------------------------------- 7d-7g. zamba2-7b, xlstm-350m, whisper-tiny, qwen2-vl-72b
    fam_launches, fam_rows = {}, []
    for label, kw in family_runs(args.seed):
        got = family_phase(dev, card, args.seed, label, counters=counters, **kw)
        fam_launches.update(got["launches"])
        fam_rows += got["rows"]

    # ---------------------------------------------------------- 8. the operation counter
    cost_phase(dev, card, host, vol, args.res, float(np.median(step_ms)), lm_res["prefill_ms"])

    # ---------------------------------------------------------- 9. the static passes
    analysis_phase(card)

    # ---------------------------------------------------------- 6. result
    log(f"total {time.perf_counter() - t_all:.1f} s")

    def by_path(i: int, name: str) -> dict:
        return {"serve": serve_launches[i], "serve_ranks": serve_ranks["launches"][name],
                "train": train_launches[i], "ranks": ranks_launches[name], "insitu": insitu_launches[name],
                "frontend": frontend_launches[name], "paper_scale": paper_launches[name],
                "lm_prefill": lm_res["lm_prefill"][name], "lm_serve_cli": lm_res["lm_serve_cli"][name],
                "lm_train": lm_train_launches[name], **{path: moe_res[path][name] for path in moe_res},
                **{path: fam_launches[path][name] for path in fam_launches}}

    kernels = [
        {"name": "gsproject", "route": "cuda", "source": "src/repro_torch/kernels/gsproject/gsproject.cu",
         "replaces": "src/repro/kernels/gsproject/gsproject.py:24", "launches": train_launches[0],
         "launches_by_path": by_path(0, "gsproject"),
         "max_abs_err": gp_err, "ms": gp_ms, "plain_ms": gp_plain_ms,
         "bound_ms": gp_bound, "bound_by": gp_bound_by, "library_ms": None},
        {"name": "tile_raster_fwd", "route": "cuda", "source": "src/repro_torch/kernels/tile_raster/tile_raster.cu",
         "replaces": "src/repro/kernels/tile_raster/tile_raster.py:102", "launches": train_launches[1],
         "launches_by_path": by_path(1, "tile_raster_fwd"),
         "max_abs_err": tr_err, **tr["frame"], "library_ms": None},
        {"name": "tile_raster_bwd", "route": "cuda", "source": "src/repro_torch/kernels/tile_raster/tile_raster.cu",
         "replaces": "src/repro/kernels/tile_raster/tile_raster.py:117", "launches": train_launches[2],
         "launches_by_path": by_path(2, "tile_raster_bwd"),
         "max_abs_err": bwd_err, **trb["frame"], "library_ms": None},
        {**lm_res["entry"], "launches_by_path": by_path(3, "flash_attention"), "family_shapes": fam_rows},
    ]
    # the projection at SH degrees 1-3: each degree's launches from its own
    # path (phase 5f: the 4M trainer at degree 3, the small steps at 1 and 2)
    for d in (1, 2, 3):
        kernels.insert(d, {
            "name": f"gsproject_sh{d}", "route": "cuda", "source": "src/repro_torch/kernels/gsproject/gsproject.cu",
            "replaces": "src/repro/kernels/gsproject/gsproject.py:24", "sh_degree": d,
            "launches": sh_launches[d]["gsproject"], "launches_by_path": {"sh_train": sh_launches[d]["gsproject"]},
            **sh_rows[d], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
