"""Kernel micro-benchmark of the port: the tile rasterizer and the attention
kernel against their plain versions (the mirror of
``benchmarks/raster_kernel.py``), at the JAX file's shapes.

Backends: ``plain`` runs the plain PyTorch version (``tile_raster/ref.py``
``composite_ref``, ``flash_attention/ref.py`` ``attention_ref``) on
``--device``, timed as wall time per call (the device drained after each);
``cuda`` runs the hand kernel and needs a CUDA device (it raises on any
other), timed by CUDA events while a spin kernel holds the stream, so the
time is the device's and not the host's launch rate. The raster rows time
the compositor on the frame's binned tile lists (binning is done once, as
the kernel's input). ``derived`` is ``h100_bound_us``: the least time an
H100 SXM (700 W) could take for the same work, from the shared formulas
(``src/repro_torch/kernels/cost.py``): the larger of the bytes over HBM3's
3.35 TB/s and the operations over the float32 peak (67 TFLOP/s; the inputs
are float32, as in the JAX file). CSV: name,us_per_call,derived.

  PYTHONPATH=src python benchmarks/raster_kernel_torch.py                  # on the card, both backends
  PYTHONPATH=src python benchmarks/raster_kernel_torch.py --device cpu --backends plain
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.core import gaussians as G  # noqa: E402
from repro_torch.core import projection as P  # noqa: E402
from repro_torch.core import render as R  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.tile_raster import ops as tr_ops  # noqa: E402
from repro_torch.kernels.tile_raster.ref import composite_ref, composited_counts  # noqa: E402
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_FP32  # noqa: E402

RASTER_CASES = [(500, 64, 64, 256), (2000, 128, 128, 256)]
FLASH_CASES = [(1, 512, 4, 64), (1, 1024, 8, 128)]
SPIN_CYCLES = 100_000_000  # ~0.05 s at the H100's clock, longer than the timed enqueues


def wall_us(fn, n: int = 3) -> float:
    """Wall microseconds per call, the device drained after each."""
    fn()
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    total = 0.0
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        total += time.perf_counter() - t0
    return total / n * 1e6


def cuda_us(fn, n: int = 20) -> float:
    """Device microseconds per call by CUDA events, the stream held by a spin
    kernel while the host enqueues the ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(SPIN_CYCLES)
    ev[0].record()
    for _ in range(n):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / n * 1e3


def _timer(backend: str, dev: torch.device):
    if backend == "cuda":
        if dev.type != "cuda":
            raise ValueError(f"the cuda backend runs the hand kernel on a CUDA device, got {dev}")
        return cuda_us
    return wall_us


def _bound_us(flops: float, nbytes: float) -> str:
    ms, by = cost.bound_ms(flops, nbytes, PEAK_FLOPS_FP32, HBM_BW)
    return f"h100_bound_us={ms * 1e3:.1f} ({by})"


def rows(device="cuda", backends=("plain", "cuda")) -> list:
    dev = torch.device(device)
    out = []
    rng = np.random.default_rng(0)
    for n, h, w, k in RASTER_CASES:
        pts = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
        g = G.init_from_points(pts, init_scale=0.05, device=dev)
        cam = P.look_at_camera([0, 0, -3], [0, 0, 0], [0, 1, 0], w * 1.2, w * 1.2, w / 2, h / 2)
        packed, _ = P.sort_by_depth(P.project(g, cam))
        idx, valid = R.bin_tiles(packed, img_h=h, img_w=w, tile_h=16, tile_w=16, k_per_tile=k)
        splats_t = packed[idx.long()].transpose(1, 2).contiguous()
        vf = valid.to(torch.float32).contiguous()
        kw = dict(tiles_x=w // 16, tile_h=16, tile_w=16)
        derived = _bound_us(*cost.raster_fwd_cost(vf, composited_counts(splats_t, vf, **kw), 256))
        for backend in backends:
            fn = (lambda: tr_ops.composite(splats_t, vf, **kw)) if backend == "cuda" else \
                (lambda: composite_ref(splats_t, vf, **kw))
            out.append((f"raster_{backend}_{n}g_{h}px", _timer(backend, dev)(fn), derived))
    return out


def flash_rows(device="cuda", backends=("plain", "cuda")) -> list:
    dev = torch.device(device)
    out = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, s, h, hd in FLASH_CASES:
        q, k, v = (torch.randn((b, s, h, hd), generator=gen, device=dev) for _ in range(3))
        derived = _bound_us(*cost.attention_cost(q, k, v, causal=True))
        for backend in backends:
            fn = (lambda: fa_ops.launch(q, k, v)) if backend == "cuda" else (lambda: attention_ref(q, k, v))
            out.append((f"flashattn_{backend}_{s}s_{h}h_{hd}d", _timer(backend, dev)(fn), derived))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--backends", nargs="+", default=["plain", "cuda"], choices=["plain", "cuda"])
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("raster_kernel_torch: no CUDA device; pass --device cpu --backends plain")
    print("name,us_per_call,derived")
    for name, us, derived in rows(args.device, args.backends) + flash_rows(args.device, args.backends):
        print(f"{name},{us:.1f},{derived}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
