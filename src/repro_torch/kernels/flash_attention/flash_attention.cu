// Attention forward: softmax(q k^T / sqrt(hd), causal / window / q_offset
// mask) v per (batch, head), with grouped-query heads and the output in the
// input type (float32 or bfloat16).
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::_kernel (launched
// by make_flash.run; wrapper flash_attention/ops.py), whose oracle is the
// chunked online-softmax attention of models/common.py. It computes that
// function, not the Pallas kernel's block structure:
//
// - The Pallas kernel keeps one head's whole K and V resident in VMEM and
//   takes the softmax of a full (128, Skv) score block, so its wrapper falls
//   back to the oracle above Skv 8192. Here K and V stream through shared
//   memory in key blocks with an online softmax (running max m, running sum
//   l, float32 accumulators), as the oracle does with its 1024-key chunks,
//   so there is no length limit.
// - GQA is an index (kv head = h / group), not a repeated copy of K and V.
// - The tensors are read and written in the model's own (B, S, H, hd)
//   layout: a row of one head is hd contiguous elements, rows H*hd apart.
// - Masked scores are -1e30, not -inf, and the output is
//   acc / max(l, 1e-30), as in the oracle (the bf16 kernel multiplies by
//   the reciprocal, then rounds once to bf16). Key blocks that lie wholly
//   outside every row's causal or window range are skipped: with -1e30
//   masking that is exact for a row that has at least one unmasked key
//   (the wrapper refuses arguments that leave a row without one).
// - No atomics: two launches give bitwise-equal output.
//
// What bounds it on an H100: operations. At the LM prefill shape (B 4,
// S = Skv 4096, 16 query and 8 KV heads, hd 128, causal) the work is
// 4*hd flops for each of 537M unmasked (q, k) pairs, 2.75e11 flops,
// against 201 MB of q, k, v and o: over a thousand flops per byte, far
// above the ridge. Two kernels:
//
// bfloat16, hd 32, 64, 112 and 128 (what the models run): the tensor cores.
//   One CTA of three warpgroups per (batch*head, block of kBQ = 128 query
//   rows), launched heaviest causal block first. One thread of the third
//   warpgroup (the producer, 24 registers after setmaxnreg) issues TMA
//   loads: the CTA's Q tile once, then K and V blocks of kBK = 128 keys
//   into a 2-stage ring in shared memory, each stage guarded by a "full"
//   mbarrier for K, one for V (the TMA's byte count) and an "empty" one
//   (the 256 consumer threads' arrivals). The tensor maps are 4-D over
//   (hd, heads, seq, batch), so each (batch, head)'s sequence edge is the
//   map's own bound: rows past S or Skv are zero-filled by the hardware.
//   Boxes are 64 (hd 32: 32) elements wide, so a tile lands as hd/64
//   regions of 128-byte (64-byte) rows in the 128B (64B) swizzle that
//   wgmma's descriptors read. Two consumer warpgroups (240 registers) own
//   64 query rows each. Per key block: S = Q K^T by wgmma m64n128k16 from
//   shared memory (raw bf16 q and k, float32 accumulators); masks only
//   where the block crosses the causal diagonal, a window edge or Skv
//   (blocks wholly inside run with no mask arithmetic); the online softmax
//   on the accumulator registers, p = exp2(s * scale*log2e - m *
//   scale*log2e) with an explicit fma (the library builds with
//   --fmad=false), row max and sum over the four lanes that share a row;
//   P rounded to bf16 in registers, where the S accumulator's layout is
//   the A operand's; O += P V by wgmma m64n{hd}k16 with V read as an
//   MN-major operand (the descriptor's transpose bit). The row sums l are
//   taken from the unrounded p. Shared memory at hd 128: Q 32 KB + 2 x
//   (K 32 KB + V 32 KB) = 160 KB, one CTA per SM. The two products and
//   the softmax of one warpgroup run in sequence (the other warpgroup's
//   work fills the gaps); overlapping them, ping-pong scheduling of the
//   two warpgroups and a persistent grid are later work.
//   hd 112 (zamba2-7b's shared attention) keeps hd 128's shared-memory
//   tiles and swizzle: its tensor maps declare the true width, 112, so the
//   second 64-wide box of a row reads columns 64-111 and the hardware fills
//   columns 112-127 with zeros. Q K^T runs 7 reduction steps of 16 (the
//   zero columns are never read); P V runs at n 128 over V's zero columns,
//   whose output columns stay 0 and are not stored. The global rows stay
//   16-byte multiples (224 B), and the scale is 1/sqrt(112).
//
// float32 (what the float32 tests and cross-checks run, at atol 2e-5,
//   which TF32 tensor cores cannot hold): the CUDA cores. One CTA of 128
//   threads per (batch*head, block of 64 query rows), heaviest causal
//   block first. The CTA's scaled Q tile stays in shared memory; each
//   64-key block is loaded K first, then V into the same buffer (two CTAs
//   fit an SM). Thread t owns query rows 4*(t/8) .. +3; for the scores it
//   computes those rows against keys t%8 + 8j (j < 8), for the output
//   those rows at columns t%8 + 8c (c < hd/8). The eight threads of a row
//   group are neighbouring lanes, so the row max and row sum are three
//   shuffle steps. Rows of the tiles are padded by one float and rows of P
//   by two, so a warp's strided reads fall in distinct banks. q is cast to
//   float32 and then scaled, as the oracle does.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched with cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;

// ============================================================ float32: CUDA cores
namespace f32 {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 64;       // keys per streamed block
constexpr int kThreads = 128;
constexpr int kRows = 4;      // query rows per thread
constexpr int kLanes = 8;     // threads per row group

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBQ * (kBK + 2);
}

// rows [0, n) of one head's (n, HD) slice, row stride `stride` elements,
// into a (kBK or kBQ, HD + 1) float tile; rows past n are zero
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src, size_t stride, int n,
                                          float scale) {
#pragma unroll 8
  for (int i = threadIdx.x; i < ROWS * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    tile[r * (HD + 1) + d] = r < n ? src[static_cast<size_t>(r) * stride + d] * scale : 0.0f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ o,
    int s_q, int s_kv, int n_heads, int n_kv_heads, int causal, int window, int q_offset, float scale) {
  constexpr int LD = HD + 1;
  constexpr int LDP = kBK + 2;
  constexpr int CPT = HD / kLanes;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // [kBQ][LD], q * scale
  float* kvs = qs + kBQ * LD;    // [kBK][LD], K, then V
  float* ps = kvs + kBK * LD;    // [kBQ][LDP], probabilities of the block

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal blocks first
  const int b = blockIdx.y / n_heads;
  const int h = blockIdx.y - b * n_heads;
  const int kvh = h / (n_heads / n_kv_heads);
  const int rg = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int n_q = min(kBQ, s_q - q0);

  const size_t q_stride = static_cast<size_t>(n_heads) * HD;
  const size_t kv_stride = static_cast<size_t>(n_kv_heads) * HD;
  const float* qb = q + (static_cast<size_t>(b) * s_q + q0) * q_stride + static_cast<size_t>(h) * HD;
  float* ob = o + (static_cast<size_t>(b) * s_q + q0) * q_stride + static_cast<size_t>(h) * HD;
  const size_t kv_head = static_cast<size_t>(b) * s_kv * kv_stride + static_cast<size_t>(kvh) * HD;

  // keys any row of this block may see: [kv_lo, kv_hi)
  const int pos_first = q_offset + q0;
  const int pos_last = q_offset + q0 + n_q - 1;
  int kv_lo = window >= 0 ? max(pos_first - window + 1, 0) : 0;
  const int kv_hi = causal ? min(pos_last + 1, s_kv) : s_kv;
  kv_lo = (kv_lo / kBK) * kBK;

  load_tile<HD, kBQ>(qs, qb, q_stride, n_q, scale);

  float m[kRows], l[kRows], acc[kRows][CPT];
  int pos[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
    pos[i] = pos_first + rg * kRows + i;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += kBK) {
    const int n_k = min(kBK, s_kv - kv0);
    __syncthreads();  // the previous block's V reads are done (and Q is staged)
    load_tile<HD, kBK>(kvs, k + kv_head + static_cast<size_t>(kv0) * kv_stride, kv_stride, n_k, 1.0f);
    __syncthreads();

    float s[kRows][kBK / kLanes];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kBK / kLanes; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kBK / kLanes];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(rg * kRows + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kBK / kLanes; ++j) kv[j] = kvs[(lane + kLanes * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kBK / kLanes; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kBK / kLanes; ++j) {
        const int kpos = kv0 + lane + kLanes * j;
        const bool ok = kpos < s_kv && (!causal || kpos <= pos[i]) && (window < 0 || pos[i] - kpos < window);
        s[i][j] = ok ? s[i][j] : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kBK / kLanes; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(rg * kRows + i) * LDP + lane + kLanes * j] = p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread is done with K; the block's P is written
    load_tile<HD, kBK>(kvs, v + kv_head + static_cast<size_t>(kv0) * kv_stride, kv_stride, n_k, 1.0f);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(rg * kRows + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = kvs[kk * LD + lane + kLanes * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = rg * kRows + i;
    if (r >= n_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) ob[static_cast<size_t>(r) * q_stride + lane + kLanes * c] = acc[i][c] / denom;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int s_q, int s_kv,
                   int n_heads, int n_kv_heads, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_attention_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((s_q + kBQ - 1) / kBQ, batch * n_heads);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                           static_cast<const float*>(v), static_cast<float*>(o), s_q, s_kv, n_heads,
                                           n_kv_heads, causal, window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace f32

// ============================================================ bfloat16: tensor cores
namespace tc {

constexpr int kBQ = 128;        // query rows per CTA: two consumer warpgroups of 64
constexpr int kBK = 128;        // keys per streamed block
constexpr int kConsumers = 2;   // consumer warpgroups; the producer warpgroup comes after them
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kStages = 2;      // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// the width of the shared-memory tiles of head width HD: HD, or for a
// width that is not a whole number of 64-element boxes, the next one
__host__ __device__ constexpr int tile_dim(int hd) { return hd <= 32 ? hd : (hd + 63) / 64 * 64; }

template <int HD>
struct Tile {
  static constexpr int kRowBytes = HD >= 64 ? 128 : 64;     // swizzle width: one row of a region
  static constexpr int kChunk = kRowBytes / 2;              // elements per row of a region (TMA box width)
  static constexpr int kChunks = HD / kChunk;               // regions per tile
  static constexpr int kRegion = 128 * kRowBytes;           // one region: 128 rows
  static constexpr int kBytes = 128 * HD * 2;               // one Q, K or V tile
  static constexpr uint64_t kLayout = HD >= 64 ? 1 : 2;     // descriptor swizzle mode: 128B, 64B
  // 1024 B of slack to align the tiles to the swizzle atom, the tiles, 7 mbarriers
  static constexpr int kSmem = 1024 + (1 + 2 * kStages) * kBytes + 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers and TMA
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a lost arrival or byte count) traps after ~2^30 polls rather than
// hanging the card.
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

// one box of a 4-D tensor map (hd, heads, seq, batch) into shared memory at
// `dst`, its bytes counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d, int head,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(head), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// Q or K tile as a K-major operand (rows = M or N, hd = the reduction), at
// reduction step kk (16 elements): region kk*16 / kChunk, 32 B per step
// inside a swizzled row; 8-row groups kRowBytes*8 apart.
template <int HD>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using T = Tile<HD>;
  const uint32_t addr = tile + (kk * 16 / T::kChunk) * T::kRegion + (kk * 16 % T::kChunk) * 2;
  return make_desc(addr, 16, 8 * T::kRowBytes, T::kLayout);
}

// V tile as an MN-major B operand (N = hd contiguous, keys = the
// reduction), at reduction step kk (16 keys): hd regions kRegion apart
// (leading offset), 8-key groups kRowBytes*8 apart (stride offset).
template <int HD>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using T = Tile<HD>;
  return make_desc(tile + kk * 16 * T::kRowBytes, T::kRegion, 8 * T::kRowBytes, T::kLayout);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from moving accesses of accumulator registers across
// the asynchronous products (their reads and writes are invisible to it).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, float32) (+)= a (64 x 16, K-major in shared memory) * b (128 x 16, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, float32) += a (64 x 16, bf16 in registers) * b (32 x 16, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, float32) += a (64 x 16, bf16 in registers) * b (64 x 16, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, float32) += a (64 x 16, bf16 in registers) * b (128 x 16, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator layout of wgmma m64nN (per warpgroup thread t, warp w = t/32,
// g = (t%32)/4, c = t%4): d[4j + e] holds row 16w + g + 8*(e/2), column
// 8j + 2c + e%2. For reduction step kk of O += P V, the A fragment
// {d[8kk..8kk+7]} packed in pairs is exactly P's rows and keys 16kk..+15.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) attention_tc_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o, int s_q, int s_kv, int n_heads,
    int n_kv_heads, int causal, int window, int q_offset, float scale_log2) {
  constexpr int TD = tile_dim(HD);
  using T = Tile<TD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;  // Q; stage s: K at sk(s), V at sk(s) + kBytes
  const uint32_t sk = sq + T::kBytes;
  const uint32_t bars = sk + 2 * kStages * T::kBytes;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                   // + 8 s
  const uint32_t v_full = bars + 8 + 8 * kStages;     // + 8 s
  const uint32_t empty = bars + 8 + 16 * kStages;     // + 8 s

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal blocks first
  const int b = blockIdx.y / n_heads;
  const int h = blockIdx.y - b * n_heads;
  const int kvh = h / (n_heads / n_kv_heads);
  const int n_q = min(kBQ, s_q - q0);

  // key blocks any row of this CTA may see: [kv_lo, kv_hi), kv_lo on a block edge
  const int pos_first = q_offset + q0;
  const int pos_last = q_offset + q0 + n_q - 1;
  const int kv_lo = (window >= 0 ? max(pos_first - window + 1, 0) : 0) / kBK * kBK;
  const int kv_hi = causal ? min(pos_last + 1, s_kv) : s_kv;
  const int n_blocks = kv_hi > kv_lo ? (kv_hi - kv_lo + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, T::kBytes);
      for (int c = 0; c < T::kChunks; ++c) tma_load(sq + c * T::kRegion, &map_q, q_full, c * T::kChunk, h, q0, b);
      for (int it = 0; it < n_blocks; ++it) {
        const int s = it % kStages;
        const int kv0 = kv_lo + it * kBK;
        const uint32_t ks = sk + 2 * s * T::kBytes;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, T::kBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(ks + c * T::kRegion, &map_k, k_full + 8 * s, c * T::kChunk, kvh, kv0, b);
        mbar_expect_tx(v_full + 8 * s, T::kBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(ks + T::kBytes + c * T::kRegion, &map_v, v_full + 8 * s, c * T::kChunk, kvh, kv0, b);
      }
    }
  } else {
    // ---------------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x % 128;
    const int row = wg * 64 + (t / 32) * 16 + (t % 32) / 4;  // CTA row of d[4j], d[4j+1]; +8 for d[4j+2], d[4j+3]
    const int col = 2 * (t % 4);                             // column of d[4j] within its 8
    const int pos0 = q_offset + q0 + row;
    const int wg_first = q_offset + q0 + wg * 64;            // the warpgroup's first and last query positions
    const int wg_last = wg_first + 63;
    const uint32_t qa = sq + wg * 64 * T::kRowBytes;         // its 64 rows in every Q region

    float acc[TD / 2];  // columns HD..TD-1 (zero V columns) stay 0
#pragma unroll
    for (int i = 0; i < TD / 2; ++i) acc[i] = 0.0f;
    float m[2] = {kMasked, kMasked};  // in units of raw q.k; the scale enters in exp2
    float l[2] = {0.0f, 0.0f};        // this thread's share of the row sums

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_blocks; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const int kv0 = kv_lo + it * kBK;
      const uint32_t ks = sk + 2 * s * T::kBytes;

      // S = Q K^T (raw bf16 products, float32 sums)
      float sc[kBK / 2];
      mbar_wait(k_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss_n128(sc, kmajor_desc<TD>(qa, kk), kmajor_desc<TD>(ks, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // masks only where the block crosses Skv, the diagonal or a window edge for this warpgroup's rows
      if (kv0 + kBK > s_kv || (causal && kv0 + kBK - 1 > wg_first) || (window >= 0 && wg_last - kv0 >= window)) {
        // sc[i] holds key kv0 + col + (i/4)*8 + i%2: compare that constant
        // offset with the row's first and last allowed offsets
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rel = pos0 + 8 * r - kv0 - col;  // the row's position, as an offset
          hi[r] = causal ? min(rel, s_kv - 1 - kv0 - col) : s_kv - 1 - kv0 - col;
          lo[r] = window >= 0 ? rel - window + 1 : -kBK;
        }
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int off = (i / 4) * 8 + (i % 2);
          const int r = (i / 2) % 2;
          sc[i] = off >= lo[r] && off <= hi[r] ? sc[i] : kMasked;
        }
      }

      // online softmax on the two rows this thread holds
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float neg_mc[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        const float corr = exp2f((m[r] - mx[r]) * scale_log2);
        l[r] *= corr;
        m[r] = mx[r];
        neg_mc[r] = -(mx[r] * scale_log2);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc[4 * j + 2 * r] *= corr;
          acc[4 * j + 2 * r + 1] *= corr;
        }
      }
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e;  // pair (i, i+1): row (e % 2), keys 16kk + 8(e/2) + col + {0, 1}
          const float p0 = exp2f(__fmaf_rn(sc[i], scale_log2, neg_mc[e % 2]));
          const float p1 = exp2f(__fmaf_rn(sc[i + 1], scale_log2, neg_mc[e % 2]));
          sum[e % 2] += p0 + p1;
          pa[kk][e] = pack_bf16(p0, p1);
        }
      }
      l[0] += sum[0];
      l[1] += sum[1];

      // O += P V
      mbar_wait(v_full + 8 * s, parity);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs(acc, pa[kk], mnmajor_desc<TD>(ks + T::kBytes, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty + 8 * s);
    }

    // out = acc * (1 / max(l, 1e-30)), rounded once to bf16; rows past S not stored
    const size_t q_stride = static_cast<size_t>(n_heads) * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = q0 + row + 8 * r;
      const float inv = 1.0f / fmaxf(quad_sum(l[r]), 1e-30f);
      if (qr >= s_q) continue;
      __nv_bfloat16* orow = o + (static_cast<size_t>(b) * s_q + qr) * q_stride + static_cast<size_t>(h) * HD + col;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a contiguous bf16 (batch, seq, heads, HD) tensor as a 4-D map (hd,
// heads, seq, batch) read in boxes of (kChunk, 1, 128, 1) of its tile
// width, swizzled; columns past HD are out of bounds and read as zeros
template <int HD>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch, int seq, int heads) {
  using T = Tile<tile_dim(HD)>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(HD) * 2, static_cast<cuuint64_t>(heads) * HD * 2,
                                 static_cast<cuuint64_t>(seq) * heads * HD * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kChunk), 1, 128, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int s_q, int s_kv,
                   int n_heads, int n_kv_heads, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap map_q, map_k, map_v;
  if (!encode<HD>(fn, &map_q, q, batch, s_q, n_heads) || !encode<HD>(fn, &map_k, k, batch, s_kv, n_kv_heads) ||
      !encode<HD>(fn, &map_v, v, batch, s_kv, n_kv_heads))
    return cudaErrorInvalidValue;
  auto kernel = attention_tc_kernel<HD>;
  constexpr int smem = Tile<tile_dim(HD)>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_q + kBQ - 1) / kBQ, batch * n_heads);
  kernel<<<grid, kThreads, smem, stream>>>(map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), s_q,
                                                      s_kv, n_heads, n_kv_heads, causal, window, q_offset,
                                                      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

template <int HD>
cudaError_t launch(int is_bf16, const void* q, const void* k, const void* v, void* o, int batch, int s_q, int s_kv,
                   int n_heads, int n_kv_heads, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  return (is_bf16 ? tc::launch<HD> : f32::launch<HD>)(q, k, v, o, batch, s_q, s_kv, n_heads, n_kv_heads, causal,
                                                      window, q_offset, scale, stream);
}

}  // namespace

// q (B, S, H, hd), k and v (B, Skv, Hkv, hd), o (B, S, H, hd), all
// contiguous, float32 (is_bf16 = 0: the CUDA-core kernel) or bfloat16
// (is_bf16 = 1: the tensor-core kernel; 16-byte-aligned pointers); window
// < 0 means no sliding window. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch, int s_q,
                                   int s_kv, int n_heads, int n_kv_heads, int head_dim, int is_bf16, int causal,
                                   int window, int q_offset, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(is_bf16, q, k, v, o, batch, s_q, s_kv, n_heads, n_kv_heads, causal, window, q_offset, scale, st);
    case 64:
      return launch<64>(is_bf16, q, k, v, o, batch, s_q, s_kv, n_heads, n_kv_heads, causal, window, q_offset, scale, st);
    case 112:
      return launch<112>(is_bf16, q, k, v, o, batch, s_q, s_kv, n_heads, n_kv_heads, causal, window, q_offset, scale,
                         st);
    case 128:
      return launch<128>(is_bf16, q, k, v, o, batch, s_q, s_kv, n_heads, n_kv_heads, causal, window, q_offset, scale,
                         st);
    default:
      return cudaErrorInvalidValue;
  }
}
