#!/usr/bin/env python3
"""Side-by-side timing of design variants of the tile rasterizer kernels
(``src/repro_torch/kernels/tile_raster/tile_raster.cu``) on one card.

Each variant is the committed source with a few text substitutions
(``VARIANTS`` below), built by its own ``nvcc`` (all started together) into
``build/repro_torch_kernels/ab/`` and loaded with ``ctypes``. For the
4M-Gaussian Kingsnake frame of ``chip_smoke.py`` (its hierarchical lists,
its flat lists) and ``chip_smoke.dense_slab``, every variant is first held
to the card gates (forward atol 3e-6 / rtol 1e-5 on every pixel, n_contrib
equal to the plain version's, backward atol 2e-5*max|g| / rtol 2e-4, two
backward launches bitwise equal), then timed with CUDA events, whole input
and densest tile alone, in two rounds whose order is reversed.

    python3 scripts/raster_ab.py                 # every variant
    python3 scripts/raster_ab.py base cp_async  # some of them

Run from the root of a checkout on a machine with one NVIDIA H100; it takes
~2 minutes. Exit 1 if a variant fails a gate, 2 without a card.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "tile_raster" / "tile_raster.cu"

# Staging by cp.async alone: every thread issues 16-byte copies where the
# rows are aligned (4-byte ones otherwise), one commit group per thread,
# waited with wait_all and a CTA barrier; no mbarriers.
_CP_ASYNC_STAGING = r"""// ---------------------------------------------------------------- staging
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stage slots [base, base + n) of the tile's nine field rows (s, row stride
// k) and of its valid row v into `dst` (kRows rows of `batch` floats): every
// thread issues cp.async copies, 16 bytes where the rows are aligned (then
// base and k are multiples of 4, and the last copy of a row may read up to
// three slots past n, still inside the row), 4 bytes otherwise; one commit
// group per thread.
__device__ __forceinline__ void stage_issue(float* dst, int batch, const float* s, const float* v, int k, int base,
                                            int n, bool aligned) {
  const int width = aligned ? 4 : 1;  // floats per copy
  const int per_row = (n + width - 1) / width;
  for (int i = threadIdx.x; i < kRows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int j = (i - r * per_row) * width;
    const float* src = (r < kRows - 1 ? s + static_cast<size_t>(r) * k : v) + base + j;
    if (aligned) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst + r * batch + j)), "l"(src)
                   : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst + r * batch + j)), "l"(src)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies, then (the barrier) for every other thread's.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

"""

_MBAR_INIT = """  if (bulk && tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
"""


def _cp_async_staging(src: str) -> str:
    start = src.index("// ---------------------------------------------------------------- staging\n")
    end = src.index("__device__ __forceinline__ float4 ld4(")
    src = src[:start] + _CP_ASYNC_STAGING + src[end:]
    for old, new, count in [
        ("  __shared__ __align__(8) uint64_t bars[2];\n", "", 2),
        (_MBAR_INIT, "", 2),
        # forward
        ("  // the first batch is in flight while the extent is found (block_max syncs)\n  int issued = 0;\n"
         "  if (k > 0) {\n    stage_issue(stage, kBatch, smem_u32(&bars[0]), s, v, k, 0, min(kBatch, k), bulk);\n"
         "    issued = 1;\n  }\n",
         "  if (k > 0) stage_issue(stage, kBatch, s, v, k, 0, min(kBatch, k), bulk);\n", 1),
        ("  int waited = 0;\n  for (int b = 0; b < n_batches; ++b) {\n    const int buf = b & 1;\n"
         "    stage_wait(smem_u32(&bars[buf]), (b >> 1) & 1, bulk);\n    waited = b + 1;\n",
         "  for (int b = 0; b < n_batches; ++b) {\n    const int buf = b & 1;\n    stage_wait();\n", 1),
        ("      stage_issue(stage + (buf ^ 1) * kRows * kBatch, kBatch, smem_u32(&bars[buf ^ 1]), s, v, k, nb,\n"
         "                  min(kBatch, k_live - nb), bulk);\n      issued = b + 2;\n",
         "      stage_issue(stage + (buf ^ 1) * kRows * kBatch, kBatch, s, v, k, nb, min(kBatch, k_live - nb), bulk);\n",
         1),
        ("  if (issued > waited) {  // a copy still in flight must land before the CTA exits\n"
         "    stage_wait(smem_u32(&bars[(issued - 1) & 1]), ((issued - 1) >> 1) & 1, bulk);\n  }\n",
         '  asm volatile("cp.async.wait_all;\\n" ::: "memory");  // no copy may land after the CTA exits\n', 1),
        # backward
        ("    stage_issue(stage, kBwdBatch, smem_u32(&bars[0]), s, v, k, last_base, min(kBwdBatch, k_end - last_base), "
         "bulk);\n",
         "    stage_issue(stage, kBwdBatch, s, v, k, last_base, min(kBwdBatch, k_end - last_base), bulk);\n", 1),
        ("    stage_wait(smem_u32(&bars[buf]), (it >> 1) & 1, bulk);\n", "    stage_wait();\n", 1),
        ("      stage_issue(stage + (buf ^ 1) * kRows * kBwdBatch, kBwdBatch, smem_u32(&bars[buf ^ 1]), s, v, k,\n"
         "                  base - kBwdBatch, kBwdBatch, bulk);\n",
         "      stage_issue(stage + (buf ^ 1) * kRows * kBwdBatch, kBwdBatch, s, v, k, base - kBwdBatch, kBwdBatch, bulk);\n",
         1),
    ]:
        if src.count(old) != count:
            raise SystemExit(f"variant cp_async: '{old}' is not in the source {count} time(s)")
        src = src.replace(old, new)
    return src


# name -> (what it changes, [(text, replacement)] or a function of the source)
VARIANTS = {
    "base": ("the committed source", []),
    "cp_async": ("staging by cp.async copies of every thread instead of TMA bulk copies", _cp_async_staging),
    "fwd_null_skip": ("forward that skips the n_contrib store on a null pointer",
                      [("      n_contrib[static_cast<size_t>(tile) * p_count + p] = nc[h];",
                        "      if (n_contrib != nullptr) n_contrib[static_cast<size_t>(tile) * p_count + p] = nc[h];")]),
    "bwd_1px_c4": ("backward chunks of 4 splats", [("constexpr int kBwdChunk = 2;", "constexpr int kBwdChunk = 4;")]),
    "bwd_2px_c4": ("backward two pixels a thread, chunks of 4 splats",
                   [("constexpr int kBwdPix = 1;", "constexpr int kBwdPix = 2;"),
                    ("constexpr int kBwdChunk = 2;", "constexpr int kBwdChunk = 4;")]),
}


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    change = VARIANTS[name][1]
    if callable(change):
        return change(src)
    for old, new in change:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: '{old}' is not in the source exactly once")
        src = src.replace(old, new)
    return src


def build(names) -> dict:
    from repro_torch.kernels import _lib
    out_dir = _lib.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _lib.find_nvcc()
    procs = {}
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(name))
        procs[name] = subprocess.Popen([nvcc, *_lib.NVCC_FLAGS, "-shared", "-o", str(out_dir / f"{name}.so"), str(cu)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} does not build:\n{log[-3000:]}")
        for entry, e in cs.ptxas_entries(log).items():
            if "tile_raster" in entry:
                print(f"{name}: ptxas {'backward' if 'bwd' in entry else 'forward'}: {e}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn in ("tile_raster_fwd", "tile_raster_bwd", "tile_raster_occupancy"):
            getattr(lib, fn).argtypes = list(_lib.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        occ = (ctypes.c_int * 4)()
        lib.tile_raster_occupancy(16, 16, occ)
        print(f"{name}: {VARIANTS[name][0]}; resident CTAs per SM at 16x16 tiles: forward {occ[0]} of {occ[2]} "
              f"threads, backward {occ[1]} of {occ[3]} threads", flush=True)
        libs[name] = lib
    return libs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("raster_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.gs_datasets import paper_gs_config
    from repro_torch.core import gaussians as G, projection as P, render as R
    from repro_torch.kernels.tile_raster.ref import (composite_bwd_ref, composite_ref, composited_counts,
                                                     contrib_counts)
    from repro_torch.volume.cameras import camera_slice, orbit_cameras

    names = argv or list(VARIANTS)
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    libs = build(names)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def fwd(lib, st, vf, kw):
        t, _, k = st.shape
        p = kw["tile_h"] * kw["tile_w"]
        out = torch.empty((t, 3, p), device=dev)
        tf = torch.empty((t, p), device=dev)
        nc = torch.empty((t, p), dtype=torch.int32, device=dev)
        assert lib.tile_raster_fwd(st.data_ptr(), vf.data_ptr(), out.data_ptr(), tf.data_ptr(), nc.data_ptr(), t, k,
                                   kw["tiles_x"], kw["tile_h"], kw["tile_w"], 0, stream()) == 0
        return out, tf, nc

    def bwd(lib, st, vf, go, gt, tf, nc, kw):
        t, _, k = st.shape
        d = torch.empty_like(st)
        assert lib.tile_raster_bwd(st.data_ptr(), vf.data_ptr(), go.data_ptr(), gt.data_ptr(), tf.data_ptr(),
                                   nc.data_ptr(), d.data_ptr(), t, k, kw["tiles_x"], kw["tile_h"], kw["tile_w"], 0,
                                   stream()) == 0
        return d

    host, _, _ = cs.kingsnake_scene(4_000_000, 0)
    cfg = paper_gs_config(512)
    g = G.from_numpy(host, dev)
    cam = camera_slice(orbit_cameras(12, img_h=512, img_w=512, radius=3.0), 0)
    pk, _ = P.sort_by_depth(P.project(g, cam))
    del g
    lists = dict(img_h=512, img_w=512, tile_h=16, tile_w=16, k_per_tile=256)
    idx, valid = R.bin_tiles(pk, **lists, binning=cfg.binning)
    fidx, fvalid = R.build_tile_lists(pk, **lists)
    cases = {"frame": (pk[idx.long()].transpose(1, 2).contiguous(), valid.float().contiguous()),
             "flat": (pk[fidx.long()].transpose(1, 2).contiguous(), fvalid.float().contiguous()),
             "dense": cs.dense_slab(dev, 0, 32, 32, 16, 256)}
    kw = dict(tiles_x=32, tile_h=16, tile_w=16, row_offset=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    times, failed = {}, False
    for label, (st, vf) in cases.items():
        out_p, t_p = composite_ref(st, vf, **kw)
        nc_p = contrib_counts(st, vf, **kw)
        counts = composited_counts(st, vf, **kw)
        go = torch.randn(out_p.shape, device=dev, generator=gen)
        gt = torch.randn(t_p.shape, device=dev, generator=gen)
        d_p = composite_bwd_ref(st, vf, go, gt, **kw)
        _, tile_evals = cs.tile_load(vf, counts)
        alone = torch.zeros_like(vf)
        densest = int(tile_evals.argmax())
        alone[densest] = vf[densest]
        for name in names:
            lib = libs[name]
            out, tf, nc = fwd(lib, st, vf, kw)
            err, bad, _ = cs.raster_fwd_report(out, tf, out_p, t_p, counts)
            d = bwd(lib, st, vf, go, gt, tf, nc, kw)
            gerr, gbad = cs.grad_report(d, d_p)
            ok = not bad and torch.equal(nc, nc_p) and not gbad and torch.equal(bwd(lib, st, vf, go, gt, tf, nc, kw), d)
            failed |= not ok
            print(f"check {label} {name}: forward max_abs_err {err:.3e}, outside {bad}, n_contrib equal "
                  f"{torch.equal(nc, nc_p)}; backward max_abs_err {gerr:.3e}, outside {gbad}; ok {ok}", flush=True)
        for order in (names, names[::-1]):
            for name in order:
                lib = libs[name]
                _, tf, nc = fwd(lib, st, vf, kw)
                _, tfa, nca = fwd(lib, st, alone, kw)
                times.setdefault((label, name), []).append((
                    cs.cuda_ms(lambda: fwd(lib, st, vf, kw), 20, f"{label} {name} fwd"),
                    cs.cuda_ms(lambda: fwd(lib, st, alone, kw), 20, f"{label} {name} fwd alone"),
                    cs.cuda_ms(lambda: bwd(lib, st, vf, go, gt, tf, nc, kw), 20, f"{label} {name} bwd"),
                    cs.cuda_ms(lambda: bwd(lib, st, alone, go, gt, tfa, nca, kw), 20, f"{label} {name} bwd alone")))
    print("ms per launch, round 1 then round 2 (reversed order):")
    for (label, name), r in times.items():
        col = lambda i: " ".join(f"{x[i]:.4f}" for x in r)  # noqa: E731
        print(f"time {label:5s} {name:13s} forward {col(0)} | densest alone {col(1)} | backward {col(2)} | "
              f"densest alone {col(3)}")
    print(cs.card_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
