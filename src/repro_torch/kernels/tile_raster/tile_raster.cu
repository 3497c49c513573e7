// Tile rasterizer: front-to-back alpha compositing of each screen tile's K
// depth-sorted splats over its P pixels (forward), and its vector-Jacobian
// product (backward, at the end of this file).
//
// The forward replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/tile_raster/tile_raster.py::_fwd_kernel (with
// _alpha_and_trans and _pixel_coords; launched by make_composite._run_fwd).
//
// What bounds it on an H100: operations. A 512-px view is T=1024 tiles of
// P=256 pixels with K=256 splats each: T*K*P = 67M alpha evaluations (~15
// flops and one expf each) before early termination, against ~16.5 MB of
// input and output. That is ~60 flop/B, above the float32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20 flop/B), so the CUDA cores and the SFU's exp bound it,
// not the memory.
//
// Design: the CUDA 3D-GS structure that the Pallas version works around.
// One CTA per tile and one thread per pixel. The tile's splats are staged
// through shared memory in batches of P (one coalesced load of each field
// row per batch: the input slab is (T, 11, K), so field f of splats
// [base, base+P) is contiguous), then each thread walks the batch front to
// back with a running transmittance T *= (1 - alpha), skipping dead splats
// and stopping once T would fall below 1e-4, the same stop rule as the
// plain version (kernels/tile_raster/ref.py): a splat is composited iff the
// transmittance after it stays >= 1e-4, and t_final is T after the last
// composited splat. Work saved by early termination is real here: the CTA
// leaves its batch loop as soon as __syncthreads_count finds every pixel
// done, where the TPU version evaluates all K x P alphas and masks. The
// TPU's log-space scan and (3,K)x(K,P) matrix product are workarounds for
// the lack of a sequential loop per pixel and are not carried over. The
// batch loop also ends at the tile's last valid slot, so a tile with few
// or no splats (most tiles of a sparse frame) costs one read of its valid
// row and no more.
//
// Each tile writes only its own pixels: no atomics, so the output is
// deterministic and a strip render (row_offset != 0) is bitwise equal to
// the same rows of a full frame. row_offset is a kernel argument.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr int kFields = 10;  // mx, my, conic a/b/c, opacity, r, g, b, valid

__global__ void tile_raster_fwd_kernel(const float* __restrict__ splats_t, const float* __restrict__ valid,
                                       float* __restrict__ out, float* __restrict__ t_final, int k,
                                       int tiles_x, int tile_h, int tile_w, int row_offset) {
  extern __shared__ float smem[];  // kFields rows of blockDim.x floats
  const int p_count = blockDim.x;  // = tile_h * tile_w
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int yy = p / tile_w;
  const int xx = p - yy * tile_w;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const float px = static_cast<float>(tx * tile_w + xx) + 0.5f;
  const float py = static_cast<float>(ty * tile_h + row_offset + yy) + 0.5f;

  const float* s = splats_t + static_cast<size_t>(tile) * 11 * k;
  const float* v = valid + static_cast<size_t>(tile) * k;

  // The tile's live extent: one past its last valid slot. Binning puts the
  // valid entries first, so this is the tile's valid count and an empty
  // tile stages and walks nothing; any other mask stays correct, since the
  // slots inside the extent are still tested one by one. A max over warps
  // (shuffle reduction, then one value per warp in shared memory): no
  // atomics, and the result does not depend on the order of the threads.
  __shared__ int warp_extent[32];
  int extent = 0;
  for (int j = p; j < k; j += p_count) {
    if (v[j] > 0.5f) extent = j + 1;
  }
  const int lanes = min(32, p_count - (p & ~31));
  const unsigned lane_mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  extent = static_cast<int>(__reduce_max_sync(lane_mask, static_cast<unsigned>(extent)));
  if ((p & 31) == 0) warp_extent[p >> 5] = extent;
  __syncthreads();
  const int n_warps = (p_count + 31) >> 5;
  int k_live = 0;
  for (int w = 0; w < n_warps; ++w) k_live = max(k_live, warp_extent[w]);

  float trans = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  bool done = false;

  for (int base = 0; base < k_live; base += p_count) {
    // uniform exit: every pixel of the tile has terminated
    if (__syncthreads_count(done ? 0 : 1) == 0) break;
    const int j = base + p;
    if (j < k_live) {
#pragma unroll
      for (int f = 0; f < 9; ++f) smem[f * p_count + p] = s[static_cast<size_t>(f) * k + j];
      smem[9 * p_count + p] = v[j];
    }
    __syncthreads();
    const int nb = min(p_count, k_live - base);
    for (int i = 0; i < nb && !done; ++i) {
      if (!(smem[9 * p_count + i] > 0.5f)) continue;
      const float dx = px - smem[0 * p_count + i];
      const float dy = py - smem[1 * p_count + i];
      const float ca = smem[2 * p_count + i];
      const float cbn = smem[3 * p_count + i];
      const float cc = smem[4 * p_count + i];
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cbn * dx * dy;
      float alpha = smem[5 * p_count + i] * expf(fminf(power, 0.0f));
      alpha = fminf(alpha, kAlphaMax);
      if (!(power <= 0.0f && alpha >= kAlphaMin)) continue;  // dead splat: T unchanged
      const float t_next = trans * (1.0f - alpha);
      if (t_next < kTEps) {  // stop rule: this splat and all later ones are dropped
        done = true;
        break;
      }
      const float w = alpha * trans;
      cr += w * smem[6 * p_count + i];
      cg += w * smem[7 * p_count + i];
      cb += w * smem[8 * p_count + i];
      trans = t_next;
    }
    __syncthreads();  // the batch's shared rows are rewritten next round
  }

  float* o = out + static_cast<size_t>(tile) * 3 * p_count;
  o[p] = cr;
  o[p_count + p] = cg;
  o[2 * p_count + p] = cb;
  t_final[static_cast<size_t>(tile) * p_count + p] = trans;
}

// ---------------------------------------------------------------- backward
//
// Replaces src/repro/kernels/tile_raster/tile_raster.py::_bwd_kernel
// (launched by make_composite._run_bwd; the custom VJP pairs it with the
// forward). From d(rgb) (T,3,P) and d(t_final) (T,P) it writes each tile's
// d(splats) (T,11,K): mean x/y, conic a/b/c, opacity, rgb; zeros for depth
// and radius, which carry no gradient.
//
// What bounds it on an H100: operations, like the forward, plus the
// reduction of nine gradients per splat over the tile's pixels. Bytes are
// the forward's inputs and outputs plus the (T,11,K) slab.
//
// Design. The Pallas kernel builds (K,P) matrices, a log-space scan and two
// MXU products; a CTA cannot hold those, so it is not carried over block by
// block. One CTA per tile and one thread per pixel, as in the forward:
//   pass 1  each thread re-walks its tile's valid prefix front to back with
//           the forward's running product and 1e-4 stop rule, which gives
//           its pixel's last composited splat and its final T;
//   pass 2  it walks back from there to the front, recovering the T before
//           each splat by dividing by (1 - alpha) (as the 3D-GS CUDA
//           rasterizer does) and keeping the running B = sum over later
//           splats of dw*w, plus d(t_final)*t_final, of tile_raster.py:146.
// The gradient masks are the Pallas kernel's: none through the 0.99 alpha
// clamp (alpha_raw < 0.99) nor through min(power, 0) (power < 0).
// Each splat's nine gradients are sums over the tile's pixels, reduced
// inside the CTA: a shuffle tree per warp, then per-warp partials in shared
// memory summed in warp order by one thread per splat. No atomics at all,
// so the slab is deterministic and no sum crosses tiles (the per-Gaussian
// sum across tiles is the transpose of the wrapper's gather). The splats
// are staged and reduced in batches of `batch` slots; the per-warp partials
// of a batch take n_warps * 9 * batch floats, which the launcher keeps at
// 9 * 2048 floats (73,728 B; above 48 KB, so it opts in with
// cudaFuncSetAttribute): 256 slots for a 256-pixel tile, 64 for 1,024.
// Both walks end at the tile's last valid slot, and pass 2 at the last slot
// any pixel composited; the slots behind it get zeros.

constexpr int kGradFields = 9;       // mx, my, conic a/b/c, opacity, r, g, b
constexpr int kPartialSlots = 2048;  // n_warps * batch: per-warp partials budget

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // lane 0 holds the warp's sum
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

// 1,024 threads (a 32x32 tile) must fit the SM's 64K registers: at most 64 each
__global__ void __launch_bounds__(1024)
    tile_raster_bwd_kernel(const float* __restrict__ splats_t, const float* __restrict__ valid,
                           const float* __restrict__ gout, const float* __restrict__ gtfin,
                           float* __restrict__ dsplats, int k, int tiles_x, int tile_h, int tile_w, int row_offset,
                           int batch) {
  extern __shared__ float smem[];
  float* stage = smem;                    // kFields rows of `batch` floats
  float* partial = smem + kFields * batch;  // [warp][field][slot of the batch]
  __shared__ int scratch[32];

  const int p_count = tile_h * tile_w;
  const int n_threads = blockDim.x;  // p_count rounded up to whole warps
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = n_threads >> 5;
  const bool pix = p < p_count;  // the padding threads of the last warp own no pixel
  const int yy = p / tile_w;
  const int xx = p - yy * tile_w;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const float px = static_cast<float>(tx * tile_w + xx) + 0.5f;
  const float py = static_cast<float>(ty * tile_h + row_offset + yy) + 0.5f;

  const float* s = splats_t + static_cast<size_t>(tile) * 11 * k;
  const float* v = valid + static_cast<size_t>(tile) * k;
  float* ds = dsplats + static_cast<size_t>(tile) * 11 * k;

  int extent = 0;
  for (int j = p; j < k; j += n_threads) {
    if (v[j] > 0.5f) extent = j + 1;
  }
  const int k_live = block_max(extent, scratch);

  float gr = 0.0f, gg = 0.0f, gb = 0.0f, gt = 0.0f;
  if (pix) {
    const float* go = gout + static_cast<size_t>(tile) * 3 * p_count;
    gr = go[p];
    gg = go[p_count + p];
    gb = go[2 * p_count + p];
    gt = gtfin[static_cast<size_t>(tile) * p_count + p];
  }

  // ---- pass 1: the forward walk, for the last composited splat and final T
  float trans = 1.0f;
  int last = -1;
  bool done = !pix;
  for (int base = 0; base < k_live; base += batch) {
    if (__syncthreads_count(done ? 0 : 1) == 0) break;
    const int nb = min(batch, k_live - base);
    if (p < nb) {
#pragma unroll
      for (int f = 0; f < 9; ++f) stage[f * batch + p] = s[static_cast<size_t>(f) * k + base + p];
      stage[9 * batch + p] = v[base + p];
    }
    __syncthreads();
    for (int i = 0; i < nb && !done; ++i) {
      if (!(stage[9 * batch + i] > 0.5f)) continue;
      const float dx = px - stage[0 * batch + i];
      const float dy = py - stage[1 * batch + i];
      const float power = -0.5f * (stage[2 * batch + i] * dx * dx + stage[4 * batch + i] * dy * dy) -
                          stage[3 * batch + i] * dx * dy;
      float alpha = stage[5 * batch + i] * expf(fminf(power, 0.0f));
      alpha = fminf(alpha, kAlphaMax);
      if (!(power <= 0.0f && alpha >= kAlphaMin)) continue;
      const float t_next = trans * (1.0f - alpha);
      if (t_next < kTEps) {
        done = true;
        break;
      }
      trans = t_next;
      last = base + i;
    }
    __syncthreads();
  }
  const int k_end = block_max(last + 1, scratch);

  // depth and radius rows, and every slot no pixel composited: zero
  for (int j = p; j < k; j += n_threads) {
    ds[9 * static_cast<size_t>(k) + j] = 0.0f;
    ds[10 * static_cast<size_t>(k) + j] = 0.0f;
    if (j >= k_end) {
#pragma unroll
      for (int f = 0; f < kGradFields; ++f) ds[static_cast<size_t>(f) * k + j] = 0.0f;
    }
  }

  // ---- pass 2: back to front
  float t_cur = trans;      // T after the current splat
  float bsum = gt * trans;  // B of the current splat
  for (int base = ((k_end - 1) / batch) * batch; base >= 0 && k_end > 0; base -= batch) {
    const int nb = min(batch, k_end - base);
    __syncthreads();  // the previous batch's stage and partials are consumed
    if (p < nb) {
#pragma unroll
      for (int f = 0; f < 9; ++f) stage[f * batch + p] = s[static_cast<size_t>(f) * k + base + p];
      stage[9 * batch + p] = v[base + p];
    }
    __syncthreads();
    for (int i = nb - 1; i >= 0; --i) {
      float g[kGradFields];
#pragma unroll
      for (int f = 0; f < kGradFields; ++f) g[f] = 0.0f;
      bool hit = false;
      if (pix && base + i <= last && stage[9 * batch + i] > 0.5f) {
        const float dx = px - stage[0 * batch + i];
        const float dy = py - stage[1 * batch + i];
        const float ca = stage[2 * batch + i];
        const float cbn = stage[3 * batch + i];
        const float cc = stage[4 * batch + i];
        const float op = stage[5 * batch + i];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cbn * dx * dy;
        const float e = expf(fminf(power, 0.0f));
        const float alpha_raw = op * e;
        const float alpha = fminf(alpha_raw, kAlphaMax);
        if (power <= 0.0f && alpha >= kAlphaMin) {  // composited (every live splat up to `last` is)
          hit = true;
          const float one_minus = 1.0f - alpha;
          const float t_excl = t_cur / one_minus;
          const float w = alpha * t_excl;
          const float dw = stage[6 * batch + i] * gr + stage[7 * batch + i] * gg + stage[8 * batch + i] * gb;
          g[6] = gr * w;
          g[7] = gg * w;
          g[8] = gb * w;
          const float dalpha = dw * t_excl - bsum / one_minus;
          bsum += dw * w;
          t_cur = t_excl;
          if (alpha_raw < kAlphaMax) {
            g[5] = dalpha * e;
            if (power < 0.0f) {
              const float dpower = dalpha * op * e;
              g[2] = dpower * (-0.5f * dx * dx);
              g[3] = dpower * (-dx * dy);
              g[4] = dpower * (-0.5f * dy * dy);
              g[0] = -(dpower * (-ca * dx - cbn * dy));
              g[1] = -(dpower * (-cc * dy - cbn * dx));
            }
          }
        }
      }
      float* part = partial + static_cast<size_t>(warp) * kGradFields * batch + i;
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int f = 0; f < kGradFields; ++f) {
          const float r = warp_sum(g[f]);
          if (lane == 0) part[f * batch] = r;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kGradFields; ++f) part[f * batch] = 0.0f;
      }
    }
    __syncthreads();
    if (p < nb) {  // one thread per slot sums the warps' partials in warp order
#pragma unroll
      for (int f = 0; f < kGradFields; ++f) {
        float acc = 0.0f;
        for (int w = 0; w < n_warps; ++w) acc += partial[(static_cast<size_t>(w) * kGradFields + f) * batch + p];
        ds[static_cast<size_t>(f) * k + base + p] = acc;
      }
    }
  }
}

}  // namespace

// Plain C launcher (bound with ctypes): one CTA of tile_h*tile_w threads per
// tile. Returns cudaGetLastError().
extern "C" int tile_raster_fwd(const float* splats_t, const float* valid, float* out, float* t_final,
                               int n_tiles, int k, int tiles_x, int tile_h, int tile_w, int row_offset,
                               void* stream) {
  const int p_count = tile_h * tile_w;
  const size_t smem = static_cast<size_t>(kFields) * p_count * sizeof(float);
  if (n_tiles > 0) {
    tile_raster_fwd_kernel<<<n_tiles, p_count, smem, static_cast<cudaStream_t>(stream)>>>(
        splats_t, valid, out, t_final, k, tiles_x, tile_h, tile_w, row_offset);
  }
  return static_cast<int>(cudaGetLastError());
}

// Plain C launcher of the backward: one CTA per tile of tile_h*tile_w
// pixels rounded up to whole warps. Returns the first CUDA error.
extern "C" int tile_raster_bwd(const float* splats_t, const float* valid, const float* gout, const float* gtfin,
                               float* dsplats, int n_tiles, int k, int tiles_x, int tile_h, int tile_w,
                               int row_offset, void* stream) {
  const int n_threads = (tile_h * tile_w + 31) / 32 * 32;
  const int n_warps = n_threads / 32;
  const int batch = n_threads < kPartialSlots / n_warps ? n_threads : kPartialSlots / n_warps;
  const size_t smem = static_cast<size_t>(kFields + n_warps * kGradFields) * batch * sizeof(float);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(tile_raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_raster_bwd_kernel<<<n_tiles, n_threads, smem, static_cast<cudaStream_t>(stream)>>>(
      splats_t, valid, gout, gtfin, dsplats, k, tiles_x, tile_h, tile_w, row_offset, batch);
  return static_cast<int>(cudaGetLastError());
}
