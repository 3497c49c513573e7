// The rasterizer's input gather, (T, 11, K) slabs of the splats each tile
// lists, and its transpose (the gather's backward).
//
// Replaces no TPU kernel. The JAX package gathers each tile's K splats with
// jnp.take (src/repro/kernels/tile_raster/ops.py, rasterize_tiles) and leaves
// the transpose, a scatter-add, to XLA. The port's train step ran that
// transpose as two PyTorch index_put(accumulate=True) passes, one for the
// slab's gather from the depth-sorted splats and one for the depth sort's
// permutation. Each pass sorts every index it is given and gives each
// distinct row to one warp, which walks that row's duplicates one after the
// other, so a pass takes as long as its longest run of one index. Binning
// points every padding slot of a list at one row (its superblock's first
// candidate, or row 0), and ~95% of a 512-px view's slots are padding: a few
// rows carry runs of 16,000 to 146,000 slots, where the valid slots alone
// repeat a row at most 4 times.
//
// Forward (slab_gather_kernel): slab[t, f, k] = packed[order[tile_idx[t, k]], f]
// (packed[tile_idx[t, k], f] without an order), one thread a slot, straight
// from the unsorted splats into the field-row layout the compositor reads. A
// copy: bitwise what the permutation, the gather and the transpose it
// replaces give.
//
// Backward (slab_bwd): d(packed)[r, f] is the sum over the VALID slots that
// list row r of d(slab)[t, f, k], in ascending slot order t*K + k and starting
// from 0, as PyTorch's sort-based accumulate sums. The compositor's backward
// writes exactly 0 into every padding slot, so leaving them out changes no
// sum, at most the sign of a zero. Three steps on the caller's stream, no
// atomics and no host synchronisation (every size follows from T, K and N):
//   1. slab_keys_kernel: each slot's key is its row if valid, else n (past
//      the last row), its value the slot id; the padding's rows are not read;
//   2. CUB's stable radix sort of the T*K (key, slot) pairs over the bits n
//      needs: equal keys keep ascending slot order, the padding sorts last;
//   3. slab_sum_kernel: one thread a (sorted position, field); the first
//      position of each run sums its run in order and writes the row's field.
//      A run is one splat's valid slots, as long as the tiles it overlaps;
//      the padding keys end every thread after one load.
// Unlisted rows and the depth and radius fields (9, 10) keep the wrapper's
// zero fill.
//
// What bounds it on an H100: bytes. Per view the transpose must read the
// valid mask (T*K bytes) and the valid slots' rows and 9 gradient fields,
// and write the (N, 11) gradient: at N = 4M that is ~176 MB, ~0.05 ms at
// 3.35 TB/s, and the zero fill of d(packed) is most of it. The sort moves
// 16 B a slot a pass, four 8-bit passes for 25-bit keys: ~17 MB at 512 px
// (262,144 slots), ~270 MB at 2048 px.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kFields = 11;      // mx, my, conic a/b/c, opacity, r, g, b, depth, radius
constexpr int kGradFields = 9;   // the compositor's gradient is 0 in depth and radius
constexpr int kThreads = 256;
constexpr size_t kAlign = 256;

size_t align_up(size_t x) { return (x + kAlign - 1) / kAlign * kAlign; }

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// the key bits that hold 0..n_rows (n_rows is the padding's key)
int key_bits(unsigned n_rows) {
  int b = 1;
  while (b < 32 && (n_rows >> b) != 0) ++b;
  return b;
}

__global__ void __launch_bounds__(kThreads)
slab_gather_kernel(const float* __restrict__ packed, const int64_t* __restrict__ order,
                   const int* __restrict__ tile_idx, float* __restrict__ slab, int64_t n_slots, int k) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n_slots) return;
  const int64_t t = s / k;
  const int64_t i = tile_idx[s];
  const float* src = packed + (order != nullptr ? order[i] : i) * kFields;
  float* dst = slab + t * kFields * k + (s - t * k);
#pragma unroll
  for (int f = 0; f < kFields; ++f) dst[f * static_cast<int64_t>(k)] = src[f];
}

__global__ void __launch_bounds__(kThreads)
slab_keys_kernel(const uint8_t* __restrict__ valid, const int64_t* __restrict__ order,
                 const int* __restrict__ tile_idx, unsigned* __restrict__ keys, int* __restrict__ slots,
                 int64_t n_slots, unsigned n_rows) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n_slots) return;
  unsigned key = n_rows;
  if (valid[s]) {
    const int64_t i = tile_idx[s];
    key = static_cast<unsigned>(order != nullptr ? order[i] : i);
  }
  keys[s] = key;
  slots[s] = static_cast<int>(s);
}

__global__ void __launch_bounds__(kThreads)
slab_sum_kernel(const float* __restrict__ dslab, const unsigned* __restrict__ keys, const int* __restrict__ slots,
                float* __restrict__ dpacked, int64_t n_slots, int k, unsigned n_rows) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t i = g / kGradFields;
  if (i >= n_slots) return;
  const int f = static_cast<int>(g - i * kGradFields);
  const unsigned key = keys[i];
  if (key >= n_rows || (i > 0 && keys[i - 1] == key)) return;  // padding, or inside a run
  float sum = 0.0f;
  for (int64_t j = i; j < n_slots && keys[j] == key; ++j) {
    const int64_t s = slots[j];
    const int64_t t = s / k;
    sum += dslab[(t * kFields + f) * k + (s - t * k)];
  }
  dpacked[static_cast<int64_t>(key) * kFields + f] = sum;
}

cudaError_t sort_temp_bytes(int n_slots, int bits, size_t* bytes) {
  cub::DoubleBuffer<unsigned> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> vals(nullptr, nullptr);
  return cub::DeviceRadixSort::SortPairs(nullptr, *bytes, keys, vals, n_slots, 0, bits);
}

}  // namespace

extern "C" int slab_gather_fwd(const float* packed, const int64_t* order, const int* tile_idx, float* slab,
                               int n_tiles, int k, void* stream) {
  const int64_t n_slots = static_cast<int64_t>(n_tiles) * k;
  if (n_slots == 0) return 0;
  slab_gather_kernel<<<blocks_for(n_slots), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, order, tile_idx, slab, n_slots, k);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the backward's scratch for n_slots = T*K slots over n_rows rows:
// two key and two slot buffers (the sort's double buffers) and CUB's own.
extern "C" int slab_bwd_scratch_bytes(int n_slots, int n_rows, long long* out) {
  size_t temp = 0;
  const cudaError_t err = sort_temp_bytes(n_slots, key_bits(static_cast<unsigned>(n_rows)), &temp);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<long long>(4 * align_up(static_cast<size_t>(n_slots) * 4) + align_up(temp));
  return 0;
}

extern "C" int slab_bwd(const float* dslab, const uint8_t* valid, const int* tile_idx, const int64_t* order,
                        float* dpacked, void* scratch, long long scratch_bytes, int n_tiles, int k, int n_rows,
                        void* stream) {
  const int64_t n_slots = static_cast<int64_t>(n_tiles) * k;
  if (n_slots == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t a = align_up(static_cast<size_t>(n_slots) * 4);
  char* base = static_cast<char*>(scratch);
  unsigned* keys0 = reinterpret_cast<unsigned*>(base);
  unsigned* keys1 = reinterpret_cast<unsigned*>(base + a);
  int* slots0 = reinterpret_cast<int*>(base + 2 * a);
  int* slots1 = reinterpret_cast<int*>(base + 3 * a);
  if (static_cast<size_t>(scratch_bytes) < 4 * a) return static_cast<int>(cudaErrorInvalidValue);
  size_t temp_bytes = static_cast<size_t>(scratch_bytes) - 4 * a;
  const unsigned rows = static_cast<unsigned>(n_rows);

  slab_keys_kernel<<<blocks_for(n_slots), kThreads, 0, st>>>(valid, order, tile_idx, keys0, slots0, n_slots, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cub::DoubleBuffer<unsigned> keys(keys0, keys1);
  cub::DoubleBuffer<int> vals(slots0, slots1);
  err = cub::DeviceRadixSort::SortPairs(base + 4 * a, temp_bytes, keys, vals, static_cast<int>(n_slots), 0,
                                        key_bits(rows), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  slab_sum_kernel<<<blocks_for(n_slots * kGradFields), kThreads, 0, st>>>(dslab, keys.Current(), vals.Current(),
                                                                          dpacked, n_slots, k, rows);
  return static_cast<int>(cudaGetLastError());
}
