// Attention forward: softmax(q k^T / sqrt(hd), causal / window / q_offset
// mask) v per (batch, head), with grouped-query heads, float32 arithmetic
// and the output in the input type (float32 or bfloat16).
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
//   memory in blocks of kBK keys with an online softmax (running max m,
//   running sum l, float32 accumulator), as the oracle does with its
//   1024-key chunks, so there is no length limit.
// - GQA is an index (kv head = h / group), not a repeated copy of K and V.
// - The tensors are read and written in the model's own (B, S, H, hd)
//   layout: a row of one head is hd contiguous elements, rows H*hd apart.
// - Masked scores are -1e30, not -inf, and the output is
//   acc / max(l, 1e-30), as in the oracle. q is cast to float32 and then
//   scaled, as the Pallas kernel (and the oracle, whose NumPy float64 scale
//   promotes a bfloat16 q to float32) does. Key blocks that lie wholly
//   outside every row's causal or window range are skipped: with -1e30
//   masking that is exact for a row that has at least one unmasked key
//   (the wrapper refuses arguments that leave a row without one).
//
// What bounds it on an H100: operations. At the LM prefill shape (B 4,
// S = Skv 4096, 16 query and 8 KV heads, hd 128, causal) the work is
// 4*hd flops for each of 537M unmasked (q, k) pairs, 2.75e11 flops,
// against 201 MB of q, k, v and o: over a thousand flops per byte, far
// above the ridge. This first version does them on the CUDA cores in
// float32 (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s bf16
// dense): wgmma tiles, TMA loads and warp specialisation are later work.
//
// Design: one CTA of 128 threads per (batch*head, block of kBQ = 64 query
// rows), launched heaviest causal block first. The CTA's scaled Q tile
// stays in shared memory as float32; each key block is loaded K first, then
// V into the same buffer (two CTAs fit an SM). Thread t owns query rows
// 4*(t/8) .. +3; for the scores it computes those rows against keys
// t%8 + 8j (j < 8), for the output those rows at columns t%8 + 8c
// (c < hd/8). The eight threads of a row group are eight neighbouring lanes
// of one warp, so the row max and row sum of the online softmax are three
// shuffle steps, and m, l and the rescale factor live in the registers of
// the threads that own the row's accumulators. Rows of the Q and K/V tiles
// are padded by one float and rows of P by two, so a warp's strided reads
// and writes fall in distinct shared-memory banks.
// No atomics: the output is deterministic. The dot products use fmaf
// explicitly (the library is built with --fmad=false); the plain version
// sums in another order in any case.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 64;       // keys per streamed block
constexpr int kThreads = 128;
constexpr int kRows = 4;      // query rows per thread
constexpr int kLanes = 8;     // threads per row group
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src, size_t stride, int n,
                                          float scale) {
#pragma unroll 8
  for (int i = threadIdx.x; i < ROWS * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    tile[r * (HD + 1) + d] = r < n ? to_f32(src[static_cast<size_t>(r) * stride + d]) * scale : 0.0f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o, int s_q,
    int s_kv, int n_heads, int n_kv_heads, int causal, int window, int q_offset, float scale) {
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
  const T* qb = q + (static_cast<size_t>(b) * s_q + q0) * q_stride + static_cast<size_t>(h) * HD;
  T* ob = o + (static_cast<size_t>(b) * s_q + q0) * q_stride + static_cast<size_t>(h) * HD;
  const size_t kv_head = static_cast<size_t>(b) * s_kv * kv_stride + static_cast<size_t>(kvh) * HD;

  // keys any row of this block may see: [kv_lo, kv_hi)
  const int pos_first = q_offset + q0;
  const int pos_last = q_offset + q0 + n_q - 1;
  int kv_lo = window >= 0 ? max(pos_first - window + 1, 0) : 0;
  const int kv_hi = causal ? min(pos_last + 1, s_kv) : s_kv;
  kv_lo = (kv_lo / kBK) * kBK;

  load_tile<T, HD, kBQ>(qs, qb, q_stride, n_q, scale);

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
    load_tile<T, HD, kBK>(kvs, k + kv_head + static_cast<size_t>(kv0) * kv_stride, kv_stride, n_k, 1.0f);
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
    load_tile<T, HD, kBK>(kvs, v + kv_head + static_cast<size_t>(kv0) * kv_stride, kv_stride, n_k, 1.0f);
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
    for (int c = 0; c < CPT; ++c) store(ob + static_cast<size_t>(r) * q_stride + lane + kLanes * c, acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int s_q, int s_kv,
                   int n_heads, int n_kv_heads, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((s_q + kBQ - 1) / kBQ, batch * n_heads);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), s_q, s_kv, n_heads,
                                           n_kv_heads, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int head_dim, const void* q, const void* k, const void* v, void* o, int batch, int s_q,
                     int s_kv, int n_heads, int n_kv_heads, int causal, int window, int q_offset, float scale,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, o, batch, s_q, s_kv, n_heads, n_kv_heads, causal, window, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, s_q, s_kv, n_heads, n_kv_heads, causal, window, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, s_q, s_kv, n_heads, n_kv_heads, causal, window, q_offset, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, hd), k and v (B, Skv, Hkv, hd), o (B, S, H, hd), all
// contiguous, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); window < 0
// means no sliding window. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch, int s_q,
                                   int s_kv, int n_heads, int n_kv_heads, int head_dim, int is_bf16, int causal,
                                   int window, int q_offset, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(dispatch<__nv_bfloat16>(head_dim, q, k, v, o, batch, s_q, s_kv, n_heads, n_kv_heads,
                                                    causal, window, q_offset, scale, st));
  return static_cast<int>(dispatch<float>(head_dim, q, k, v, o, batch, s_q, s_kv, n_heads, n_kv_heads, causal,
                                          window, q_offset, scale, st));
}
