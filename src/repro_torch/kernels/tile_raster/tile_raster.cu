// Tile rasterizer: front-to-back alpha compositing of each screen tile's K
// depth-sorted splats over its P pixels (forward), and its vector-Jacobian
// product (backward, at the end of this file).
//
// The forward replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/tile_raster/tile_raster.py::_fwd_kernel (with
// _alpha_and_trans and _pixel_coords; launched by make_composite._run_fwd).
//
// What bounds it on an H100: operations. A 512-px view that an isosurface
// fills is T=1024 tiles of P=256 pixels with K=256 splats each: T*K*P = 67M
// alpha evaluations (~15 flops and one expf each) before early termination,
// against ~16.5 MB of input and output. That is ~60 flop/B, above the
// float32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/B), so the CUDA cores
// and the SFU's exp bound it, not the memory. A sparse frame (most tiles
// empty) is bound by its densest tiles' walks instead: one tile is one CTA,
// and its pixels' transmittance products are sequential in list order.
//
// Design. One CTA per tile, two pixels per thread (pixels p and
// p + blockDim.x: two independent chains, and each staged splat read from
// shared memory once for both). The tile's splats are staged in batches of
// kBatch slots, double-buffered: while one batch is walked, the next one's
// nine field rows and its valid row are in flight. The input slab is
// (T, 11, K), so each field row of a batch is contiguous: one elected thread
// issues ten 1-D TMA bulk copies that complete on the buffer's mbarrier.
// Bulk copies need 16-byte-aligned rows; where K is not a multiple of 4 (or a
// pointer is not aligned) every thread issues 4-byte cp.async copies
// instead, into the same layout. (16-byte cp.async copies by every thread in
// place of the bulk copies made the forward slower and the backward faster,
// about even over a train step: PERF.md, scripts/raster_ab.py.) Shared
// memory keeps the field-row layout, so one float4 load reads one field of
// four consecutive slots.
//
// The walk takes kChunk splats at a time. It first evaluates power and alpha
// of all of them, for both pixels, with no branch: a dead splat (invalid,
// power > 0 or alpha < 1/255) gets alpha = 0. Then it runs the short
// dependent chain over the chunk in list order: t_next = T * (1 - alpha),
// the stop test (a live splat is composited iff the transmittance after it
// stays >= 1e-4, the plain version's rule in kernels/tile_raster/ref.py), the
// three colour terms and the update of T, each a select on "composited". A
// dead splat is never composited: T and the colour keep their values, and no
// field of it (nor a stale slot past the batch's end) reaches them. So each
// pixel's product is the same sequential product in list order as a walk
// that skips dead splats: the stop decision and t_final do not depend on the
// chunking. A thread leaves the walk when both its pixels are done, and the
// CTA leaves its batch loop when every pixel is (__syncthreads_count); the
// loop also
// ends at the tile's last valid slot, so an empty tile reads its valid row
// and its first batch and no more. The TPU's log-space scan and (3,K)x(K,P)
// matrix product are workarounds for the lack of a sequential loop per pixel
// and are not carried over.
//
// With a buffer for it, the forward also writes each pixel's n_contrib (one
// past its last composited slot, as the 3D-GS CUDA rasterizer does), which
// the backward starts from.
//
// Each tile writes only its own pixels: no atomics, so the output is
// deterministic and a strip render (row_offset != 0) is bitwise equal to the
// same rows of a full frame. row_offset is a kernel argument.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr int kRows = 10;         // staged rows: mx, my, conic a/b/c, opacity, r, g, b, valid
constexpr int kMaxPixels = 1024;  // pixels per tile (one CTA)
constexpr int kPix = 2;           // forward: pixels per thread
constexpr int kBwdPix = 1;        // backward: pixels per thread
constexpr int kBatch = 128;       // forward: slots per staged batch
constexpr int kBwdBatch = 64;     // backward: slots per staged batch
constexpr int kChunk = 8;         // forward: splats evaluated ahead of the dependent chain
constexpr int kBwdChunk = 2;      // backward: the same
constexpr int kGradFields = 9;    // mx, my, conic a/b/c, opacity, r, g, b
constexpr int kLanePad = 33;      // a row of the backward's per-warp scratch: 32 lanes + 1

// ---------------------------------------------------------------- staging
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a lost byte count) traps after ~2^30 polls rather than hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 30)) __trap();
  }
}

// Stage slots [base, base + n) of the tile's nine field rows (s, row stride
// k) and of its valid row v into `dst` (kRows rows of `batch` floats).
// Aligned rows: thread 0 issues ten bulk copies that complete on `bar`;
// otherwise every thread issues 4-byte cp.async copies, one group.
__device__ __forceinline__ void stage_issue(float* dst, int batch, uint32_t bar, const float* s, const float* v,
                                            int k, int base, int n, bool bulk) {
  if (bulk) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>((n + 3) & ~3) * 4u;  // base and k are multiples of 4
      mbar_expect_tx(bar, kRows * bytes);
      for (int r = 0; r < kRows; ++r) {
        const float* src = (r < kRows - 1 ? s + static_cast<size_t>(r) * k : v) + base;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                smem_u32(dst + r * batch)),
            "l"(src), "r"(bytes), "r"(bar)
            : "memory");
      }
    }
  } else {
    for (int i = threadIdx.x; i < kRows * n; i += blockDim.x) {
      const int r = i / n;
      const int j = i - r * n;
      const float* src = (r < kRows - 1 ? s + static_cast<size_t>(r) * k : v) + base + j;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst + r * batch + j)), "l"(src)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

// Wait for a staged batch: the buffer's mbarrier phase, or this thread's
// cp.async group and then every other thread's.
__device__ __forceinline__ void stage_wait(uint32_t bar, uint32_t parity, bool bulk) {
  if (bulk) {
    mbar_wait(bar, parity);
  } else {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
}

__device__ __forceinline__ float4 ld4(const float* row, int i) { return *reinterpret_cast<const float4*>(row + i); }

__device__ __forceinline__ float elem(const float4& v, int e) {  // e is a constant after unrolling
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

__device__ __forceinline__ float splat_power(float dx, float dy, float ca, float cb, float cc) {
  return -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
}

// Max of a non-negative int over the CTA (blockDim.x a multiple of 32).
__device__ int block_max(int v, int* scratch) {
  v = static_cast<int>(__reduce_max_sync(0xffffffffu, static_cast<unsigned>(v)));
  __syncthreads();  // scratch may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) m = max(m, scratch[w]);
  return m;
}

// The tile's live extent: one past its last valid slot. Binning puts the
// valid entries first, so this is the tile's valid count; any other mask
// stays correct, since the slots inside the extent are still tested one by
// one. No atomics: the result does not depend on the order of the threads.
__device__ int live_extent(const float* v, int k, int* scratch) {
  int extent = 0;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    if (v[j] > 0.5f) extent = j + 1;
  }
  return block_max(extent, scratch);
}

// Pixel-centre coordinates of pixel p of tile `tile`.
__device__ __forceinline__ void pixel_xy(int tile, int p, int tiles_x, int tile_h, int tile_w, int row_offset,
                                         float& px, float& py) {
  const int yy = p / tile_w;
  const int xx = p - yy * tile_w;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  px = static_cast<float>(tx * tile_w + xx) + 0.5f;
  py = static_cast<float>(ty * tile_h + row_offset + yy) + 0.5f;
}

// At most 96 registers (enough for 512 threads): left to itself ptxas keeps
// the forward at 64 and spills; with 96 a chunk's alphas and staged fields
// stay in registers, which measured faster on dense lists (PERF.md). The
// store of n_contrib is unconditional: skipping it on a null pointer made
// the forward slower on every input (PERF.md).
__global__ void __maxnreg__(96)
    tile_raster_fwd_kernel(const float* __restrict__ splats_t, const float* __restrict__ valid,
                           float* __restrict__ out, float* __restrict__ t_final, int* __restrict__ n_contrib, int k,
                           int tiles_x, int tile_h, int tile_w, int row_offset, bool bulk) {
  __shared__ __align__(16) float stage[2 * kRows * kBatch];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ int scratch[32];
  const int p_count = tile_h * tile_w;
  const int n_thr = blockDim.x;  // ceil(P / kPix) rounded up to whole warps
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float* s = splats_t + static_cast<size_t>(tile) * 11 * k;
  const float* v = valid + static_cast<size_t>(tile) * k;

  if (bulk && tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the first batch is in flight while the extent is found (block_max syncs)
  int issued = 0;
  if (k > 0) {
    stage_issue(stage, kBatch, smem_u32(&bars[0]), s, v, k, 0, min(kBatch, k), bulk);
    issued = 1;
  }
  const int k_live = live_extent(v, k, scratch);
  const int n_batches = (k_live + kBatch - 1) / kBatch;

  // this thread's pixels, h = 0 .. kPix-1: p + h * blockDim.x
  float px[kPix], py[kPix], tr[kPix], cr[kPix], cg[kPix], cb[kPix];
  int nc[kPix];
  bool done[kPix];
#pragma unroll
  for (int h = 0; h < kPix; ++h) {
    pixel_xy(tile, tid + h * n_thr, tiles_x, tile_h, tile_w, row_offset, px[h], py[h]);
    tr[h] = 1.0f;
    cr[h] = cg[h] = cb[h] = 0.0f;
    nc[h] = 0;
    done[h] = tid + h * n_thr >= p_count;
  }
  auto all_done = [&]() {
    bool d = true;
#pragma unroll
    for (int h = 0; h < kPix; ++h) d = d && done[h];
    return d;
  };

  int waited = 0;
  for (int b = 0; b < n_batches; ++b) {
    const int buf = b & 1;
    stage_wait(smem_u32(&bars[buf]), (b >> 1) & 1, bulk);
    waited = b + 1;
    if (b + 1 < n_batches) {  // the other buffer was released by the last iteration's barrier
      const int nb = (b + 1) * kBatch;
      stage_issue(stage + (buf ^ 1) * kRows * kBatch, kBatch, smem_u32(&bars[buf ^ 1]), s, v, k, nb,
                  min(kBatch, k_live - nb), bulk);
      issued = b + 2;
    }
    const float* sb = stage + buf * kRows * kBatch;
    const int base = b * kBatch;
    const int n = min(kBatch, k_live - base);
    for (int c0 = 0; c0 < n && !all_done(); c0 += kChunk) {
      // ahead: alpha of every splat of the chunk at each pixel, no branch
      float a[kPix][kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; q += 4) {
        const float4 mx = ld4(sb + 0 * kBatch, c0 + q), my = ld4(sb + 1 * kBatch, c0 + q);
        const float4 ca = ld4(sb + 2 * kBatch, c0 + q), cbn = ld4(sb + 3 * kBatch, c0 + q);
        const float4 cc = ld4(sb + 4 * kBatch, c0 + q), op = ld4(sb + 5 * kBatch, c0 + q);
        const float4 vv = ld4(sb + 9 * kBatch, c0 + q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = c0 + q + e < n && elem(vv, e) > 0.5f;
#pragma unroll
          for (int h = 0; h < kPix; ++h) {
            const float pw = splat_power(px[h] - elem(mx, e), py[h] - elem(my, e), elem(ca, e), elem(cbn, e),
                                         elem(cc, e));
            const float al = fminf(elem(op, e) * expf(fminf(pw, 0.0f)), kAlphaMax);
            a[h][q + e] = ok && pw <= 0.0f && al >= kAlphaMin ? al : 0.0f;
          }
        }
      }
      // the chain, in list order: T, the stop rule, the colour
#pragma unroll
      for (int q = 0; q < kChunk; q += 4) {
        const float4 sr = ld4(sb + 6 * kBatch, c0 + q), sg = ld4(sb + 7 * kBatch, c0 + q);
        const float4 sbl = ld4(sb + 8 * kBatch, c0 + q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int h = 0; h < kPix; ++h) {
            const float al = a[h][q + e];
            const float tn = tr[h] * (1.0f - al);
            // composited: live (alpha > 0) and T after it stays >= eps; a dead
            // splat leaves T and the colour as they are, whatever its fields hold
            const bool take = !done[h] && al > 0.0f && tn >= kTEps;
            done[h] = done[h] || !(tn >= kTEps);
            const float w = al * tr[h];
            cr[h] = take ? cr[h] + w * elem(sr, e) : cr[h];
            cg[h] = take ? cg[h] + w * elem(sg, e) : cg[h];
            cb[h] = take ? cb[h] + w * elem(sbl, e) : cb[h];
            tr[h] = take ? tn : tr[h];
            nc[h] = take ? base + c0 + q + e + 1 : nc[h];
          }
        }
      }
    }
    // uniform exit once every pixel of the tile has terminated; the barrier
    // also releases this buffer to the copy issued next iteration
    if (__syncthreads_count(all_done() ? 0 : 1) == 0) break;
  }
  if (issued > waited) {  // a copy still in flight must land before the CTA exits
    stage_wait(smem_u32(&bars[(issued - 1) & 1]), ((issued - 1) >> 1) & 1, bulk);
  }

  float* o = out + static_cast<size_t>(tile) * 3 * p_count;
#pragma unroll
  for (int h = 0; h < kPix; ++h) {
    const int p = tid + h * n_thr;
    if (p < p_count) {
      o[p] = cr[h];
      o[p_count + p] = cg[h];
      o[2 * p_count + p] = cb[h];
      t_final[static_cast<size_t>(tile) * p_count + p] = tr[h];
      n_contrib[static_cast<size_t>(tile) * p_count + p] = nc[h];
    }
  }
}

// ---------------------------------------------------------------- backward
//
// Replaces src/repro/kernels/tile_raster/tile_raster.py::_bwd_kernel
// (launched by make_composite._run_bwd; the custom VJP pairs it with the
// forward). From d(rgb) (T,3,P) and d(t_final) (T,P), and the forward's
// t_final and n_contrib, it writes each tile's d(splats) (T,11,K): mean x/y,
// conic a/b/c, opacity, rgb; zeros for depth and radius, which carry no
// gradient.
//
// What bounds it on an H100: operations, like the forward: per composited
// (pixel, splat) the alpha recomputed, the gradient terms, and the sums of
// nine gradients over the tile's pixels. Bytes are the forward's inputs, the
// cotangents and the (T,11,K) slab, plus the forward's two residuals that
// this design reads.
//
// Design. The Pallas kernel builds (K,P) matrices, a log-space scan and two
// MXU products; a CTA cannot hold those, so it is not carried over block by
// block. One CTA per tile and one pixel per thread (two a thread, the
// forward's layout, was slower on the training frame's lists and faster only
// on a dense slab: PERF.md, scripts/raster_ab.py). Each pixel starts from
// its forward's t_final and n_contrib, so there is no forward re-walk: it
// walks back from its last composited slot to the front, recovering the T
// before each splat by multiplying with 1/(1 - alpha) (as the 3D-GS CUDA
// rasterizer divides) and keeping the running B = sum over later splats of
// dw*w, plus d(t_final)*t_final, of tile_raster.py:146. The staged batches
// (kBwdBatch slots, back to front, double-buffered, the forward's copies) are
// walked in chunks of kBwdChunk splats: alpha, e and the reciprocal of each
// chunk are evaluated ahead, then the T and B chains run back to front
// through the chunk. The gradient masks are the Pallas kernel's: none
// through the 0.99 alpha clamp (alpha_raw < 0.99) nor through min(power, 0)
// (power < 0).
//
// Each splat's nine gradients are sums over the tile's pixels, reduced
// inside the CTA in a fixed order with no atomics, so the slab is
// deterministic and no sum crosses tiles (the per-Gaussian sum across tiles
// is the transpose of the wrapper's gather). Each thread writes a chunk's
// 9 * kBwdChunk gradients at its pixel (with kBwdPix > 1, their sum over its
// pixels, p, then p + blockDim.x) to its warp's padded scratch (row =
// (splat, field), column = lane); then lane i sums row i (and i + 32) in lane
// order, one shared load and one add per (splat, field, lane), into the
// warp's partials of the batch: no shuffle tree. A chunk that none of a
// warp's pixels composites costs the warp zero stores only. After the batch,
// one thread per (field, slot) sums the warps' partials in warp order. Shared
// memory: 2 * 10 * 64 floats of staging, per warp 18 * 33 floats of scratch
// and 9 * 64 of partials; 42,560 B for a 16x16 tile (8 warps), so shared
// memory and registers each allow 5 CTAs of 256 threads on an SM. The walk
// ends at the last slot any pixel composited (k_end); the slots behind it
// get zeros.

// Where row r = (splat j, field f) of a chunk at slot c0 lands in a warp's
// partials ([field][slot of the batch]).
__device__ __forceinline__ int partial_at(int c0, int r) {
  return (r % kGradFields) * kBwdBatch + c0 + r / kGradFields;
}

// A chunk that none of the warp's pixels composites: its partials are zero.
__device__ __forceinline__ void zero_chunk(float* part, int c0, int lane) {
  for (int r = lane; r < kBwdChunk * kGradFields; r += 32) part[partial_at(c0, r)] = 0.0f;
}

__global__ void __launch_bounds__(kMaxPixels / kBwdPix)
    tile_raster_bwd_kernel(const float* __restrict__ splats_t, const float* __restrict__ valid,
                           const float* __restrict__ gout, const float* __restrict__ gtfin,
                           const float* __restrict__ t_final, const int* __restrict__ n_contrib,
                           float* __restrict__ dsplats, int k, int tiles_x, int tile_h, int tile_w, int row_offset,
                           bool bulk) {
  extern __shared__ __align__(16) float smem[];
  const int n_thr = blockDim.x;
  const int n_warps = n_thr >> 5;
  float* stage = smem;                                                // [2][kRows][kBwdBatch]
  float* partial = smem + 2 * kRows * kBwdBatch;                      // [warp][field][slot of the batch]
  float* scr_all = partial + n_warps * kGradFields * kBwdBatch;       // [warp][splat*9 + field][lane]
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ int scratch[32];

  const int p_count = tile_h * tile_w;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* scr = scr_all + warp * (kBwdChunk * kGradFields * kLanePad);
  const float* s = splats_t + static_cast<size_t>(tile) * 11 * k;
  const float* v = valid + static_cast<size_t>(tile) * k;
  float* ds = dsplats + static_cast<size_t>(tile) * 11 * k;

  if (bulk && tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // this thread's pixels, h = 0 .. kBwdPix-1: p + h * blockDim.x
  float px[kBwdPix], py[kBwdPix], gr[kBwdPix], gg[kBwdPix], gb[kBwdPix], tc[kBwdPix], bs[kBwdPix];
  int nc[kBwdPix];
#pragma unroll
  for (int h = 0; h < kBwdPix; ++h) {
    const int p = tid + h * n_thr;
    const bool has = p < p_count;
    pixel_xy(tile, p, tiles_x, tile_h, tile_w, row_offset, px[h], py[h]);
    const size_t at = static_cast<size_t>(tile) * p_count + p;
    gr[h] = has ? gout[static_cast<size_t>(tile) * 3 * p_count + p] : 0.0f;
    gg[h] = has ? gout[static_cast<size_t>(tile) * 3 * p_count + p_count + p] : 0.0f;
    gb[h] = has ? gout[static_cast<size_t>(tile) * 3 * p_count + 2 * p_count + p] : 0.0f;
    tc[h] = has ? t_final[at] : 1.0f;           // T after the current splat
    bs[h] = has ? gtfin[at] * tc[h] : 0.0f;     // B of the current splat
    nc[h] = has ? n_contrib[at] : 0;
  }
  int nc_max = 0;
#pragma unroll
  for (int h = 0; h < kBwdPix; ++h) nc_max = max(nc_max, nc[h]);
  const int warp_end = static_cast<int>(__reduce_max_sync(0xffffffffu, static_cast<unsigned>(nc_max)));
  const int k_end = block_max(warp_end, scratch);  // also publishes the mbarrier init
  const int last_base = k_end > 0 ? ((k_end - 1) / kBwdBatch) * kBwdBatch : 0;
  if (k_end > 0) {
    stage_issue(stage, kBwdBatch, smem_u32(&bars[0]), s, v, k, last_base, min(kBwdBatch, k_end - last_base), bulk);
  }

  // depth and radius rows, and every slot no pixel composited: zero
  for (int j = tid; j < k; j += n_thr) {
    ds[9 * static_cast<size_t>(k) + j] = 0.0f;
    ds[10 * static_cast<size_t>(k) + j] = 0.0f;
    if (j >= k_end) {
#pragma unroll
      for (int f = 0; f < kGradFields; ++f) ds[static_cast<size_t>(f) * k + j] = 0.0f;
    }
  }
  if (k_end == 0) return;

  for (int it = 0, base = last_base; base >= 0; ++it, base -= kBwdBatch) {
    const int buf = it & 1;
    stage_wait(smem_u32(&bars[buf]), (it >> 1) & 1, bulk);
    if (base > 0) {  // the other buffer was released by the last iteration's closing barrier
      stage_issue(stage + (buf ^ 1) * kRows * kBwdBatch, kBwdBatch, smem_u32(&bars[buf ^ 1]), s, v, k,
                  base - kBwdBatch, kBwdBatch, bulk);
    }
    const float* sb = stage + buf * kRows * kBwdBatch;
    const int n = min(kBwdBatch, k_end - base);
    float* part = partial + warp * kGradFields * kBwdBatch;
    for (int c0 = ((n - 1) / kBwdChunk) * kBwdChunk; c0 >= 0; c0 -= kBwdChunk) {
      if (base + c0 >= warp_end) {  // no pixel of this warp composites a splat of the chunk
        zero_chunk(part, c0, lane);
        continue;
      }
      // ahead: alpha, e and 1/(1 - alpha) of every splat of the chunk at both pixels
      float al[kBwdPix][kBwdChunk], ee[kBwdPix][kBwdChunk], rc[kBwdPix][kBwdChunk];
      bool hit[kBwdPix][kBwdChunk], unclamped[kBwdPix][kBwdChunk], inside[kBwdPix][kBwdChunk];
      bool any_hit = false;
#pragma unroll
      for (int j = 0; j < kBwdChunk; ++j) {
        const int i = c0 + j;
        const float mx = sb[0 * kBwdBatch + i], my = sb[1 * kBwdBatch + i];
        const float ca = sb[2 * kBwdBatch + i], cb = sb[3 * kBwdBatch + i], cc = sb[4 * kBwdBatch + i];
        const float op = sb[5 * kBwdBatch + i];
        const bool ok = sb[9 * kBwdBatch + i] > 0.5f;
#pragma unroll
        for (int h = 0; h < kBwdPix; ++h) {
          const float pw = splat_power(px[h] - mx, py[h] - my, ca, cb, cc);
          const float e = expf(fminf(pw, 0.0f));
          const float alpha_raw = op * e;
          const float alpha = fminf(alpha_raw, kAlphaMax);
          const bool live = ok && base + i < nc[h] && pw <= 0.0f && alpha >= kAlphaMin;
          al[h][j] = alpha;
          ee[h][j] = e;
          rc[h][j] = 1.0f / (1.0f - alpha);
          hit[h][j] = live;
          unclamped[h][j] = alpha_raw < kAlphaMax;
          inside[h][j] = pw < 0.0f;
          any_hit = any_hit || live;
        }
      }
      if (!__any_sync(0xffffffffu, any_hit)) {
        zero_chunk(part, c0, lane);
        continue;
      }
      // the chains, back to front, and each splat's gradients at both pixels
#pragma unroll
      for (int j = kBwdChunk - 1; j >= 0; --j) {
        const int i = c0 + j;
        const float mx = sb[0 * kBwdBatch + i], my = sb[1 * kBwdBatch + i];
        const float ca = sb[2 * kBwdBatch + i], cb = sb[3 * kBwdBatch + i], cc = sb[4 * kBwdBatch + i];
        const float op = sb[5 * kBwdBatch + i];
        const float cr = sb[6 * kBwdBatch + i], cg = sb[7 * kBwdBatch + i], cbl = sb[8 * kBwdBatch + i];
        float g[kBwdPix][kGradFields];
#pragma unroll
        for (int h = 0; h < kBwdPix; ++h) {
          const bool hh = hit[h][j];
          const float dx = px[h] - mx, dy = py[h] - my;
          const float alpha = al[h][j], e = ee[h][j], rcp = rc[h][j];
          const float t_excl = tc[h] * rcp;
          const float w = alpha * t_excl;
          const float dw = cr * gr[h] + cg * gg[h] + cbl * gb[h];
          const float dalpha = dw * t_excl - bs[h] * rcp;
          bs[h] = hh ? bs[h] + dw * w : bs[h];
          tc[h] = hh ? t_excl : tc[h];
          const bool d_op = hh && unclamped[h][j];
          const bool d_geo = d_op && inside[h][j];
          const float dpower = dalpha * op * e;
          g[h][6] = hh ? gr[h] * w : 0.0f;
          g[h][7] = hh ? gg[h] * w : 0.0f;
          g[h][8] = hh ? gb[h] * w : 0.0f;
          g[h][5] = d_op ? dalpha * e : 0.0f;
          g[h][2] = d_geo ? dpower * (-0.5f * dx * dx) : 0.0f;
          g[h][3] = d_geo ? dpower * (-dx * dy) : 0.0f;
          g[h][4] = d_geo ? dpower * (-0.5f * dy * dy) : 0.0f;
          g[h][0] = d_geo ? -(dpower * (-ca * dx - cb * dy)) : 0.0f;
          g[h][1] = d_geo ? -(dpower * (-cc * dy - cb * dx)) : 0.0f;
        }
#pragma unroll
        for (int f = 0; f < kGradFields; ++f) {
          float sum = g[0][f];
#pragma unroll
          for (int h = 1; h < kBwdPix; ++h) sum += g[h][f];
          scr[(j * kGradFields + f) * kLanePad + lane] = sum;
        }
      }
      __syncwarp();
      // lane i: rows i, i + 32, i + 64, each summed over the lanes in order
      for (int r = lane; r < kBwdChunk * kGradFields; r += 32) {
        const float* row = scr + r * kLanePad;
        float acc = row[0];
#pragma unroll
        for (int l = 1; l < 32; ++l) acc += row[l];
        part[partial_at(c0, r)] = acc;
      }
      __syncwarp();  // the scratch is rewritten by the next chunk
    }
    __syncthreads();
    // one thread per (field, slot) sums the warps' partials in warp order
    for (int idx = tid; idx < kGradFields * n; idx += n_thr) {
      const int f = idx / n;
      const int j = idx - f * n;
      float acc = 0.0f;
      for (int w = 0; w < n_warps; ++w) acc += partial[(w * kGradFields + f) * kBwdBatch + j];
      ds[static_cast<size_t>(f) * k + base + j] = acc;
    }
    __syncthreads();  // partials and this buffer are consumed
  }
}

bool rows_aligned(const float* splats_t, const float* valid, int k) {
  return k % 4 == 0 && reinterpret_cast<uintptr_t>(splats_t) % 16 == 0 && reinterpret_cast<uintptr_t>(valid) % 16 == 0;
}

int threads_for(int tile_h, int tile_w, int pix) { return ((tile_h * tile_w + pix - 1) / pix + 31) / 32 * 32; }

size_t bwd_smem(int n_threads) {
  const int n_warps = n_threads / 32;
  return sizeof(float) * (static_cast<size_t>(2 * kRows * kBwdBatch) + n_warps * kGradFields * kBwdBatch +
                          static_cast<size_t>(n_warps) * kBwdChunk * kGradFields * kLanePad);
}

}  // namespace

// Plain C launcher (bound with ctypes): one CTA of ceil(P/2) threads, rounded
// up to whole warps, per tile. Writes rgb (T, 3, P), t_final (T, P) and
// n_contrib (T, P) int32. Returns cudaGetLastError().
extern "C" int tile_raster_fwd(const float* splats_t, const float* valid, float* out, float* t_final, int* n_contrib,
                               int n_tiles, int k, int tiles_x, int tile_h, int tile_w, int row_offset,
                               void* stream) {
  const int n_threads = threads_for(tile_h, tile_w, kPix);
  const bool bulk = rows_aligned(splats_t, valid, k);
  auto st = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    tile_raster_fwd_kernel<<<n_tiles, n_threads, 0, st>>>(splats_t, valid, out, t_final, n_contrib, k, tiles_x,
                                                          tile_h, tile_w, row_offset, bulk);
  }
  return static_cast<int>(cudaGetLastError());
}

// Plain C launcher of the backward: one CTA of P threads, rounded up to
// whole warps, per tile. t_final and n_contrib are the forward's. Returns the
// first CUDA error.
extern "C" int tile_raster_bwd(const float* splats_t, const float* valid, const float* gout, const float* gtfin,
                               const float* t_final, const int* n_contrib, float* dsplats, int n_tiles, int k,
                               int tiles_x, int tile_h, int tile_w, int row_offset, void* stream) {
  const int n_threads = threads_for(tile_h, tile_w, kBwdPix);
  const size_t smem = bwd_smem(n_threads);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(tile_raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_raster_bwd_kernel<<<n_tiles, n_threads, smem, static_cast<cudaStream_t>(stream)>>>(
      splats_t, valid, gout, gtfin, t_final, n_contrib, dsplats, k, tiles_x, tile_h, tile_w, row_offset,
      rows_aligned(splats_t, valid, k));
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM of each kernel at a tile size, from the occupancy
// calculator (registers, shared memory, threads): out[0] the forward,
// out[1] the backward, out[2] and out[3] their threads per CTA.
extern "C" int tile_raster_occupancy(int tile_h, int tile_w, int* out) {
  out[2] = threads_for(tile_h, tile_w, kPix);
  out[3] = threads_for(tile_h, tile_w, kBwdPix);
  const size_t smem = bwd_smem(out[3]);
  cudaError_t err = cudaFuncSetAttribute(tile_raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], tile_raster_fwd_kernel, out[2], 0);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], tile_raster_bwd_kernel, out[3], smem);
  }
  return static_cast<int>(err);
}
