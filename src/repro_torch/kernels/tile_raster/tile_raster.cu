// Tile rasterizer forward: front-to-back alpha compositing of each screen
// tile's K depth-sorted splats over its P pixels.
//
// Replaces the JAX package's Pallas TPU kernel
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
