// Adam's update of one parameter field in one pass: read p, g, m and v once,
// write fresh p', m' and v' once.
//
// Replaces no TPU kernel. The JAX package leaves the update
// (src/repro/optim/adam.py) to XLA, which fuses it; the port ran it as
// ~14 PyTorch elementwise ops a field (kernels/adam/ref.py), each a full
// pass over the field that leaves a temporary behind.
//
// The update is functional, as the reference's is: p, g, m and v are only
// read, and the three outputs are new buffers. It rounds as the plain
// version does on the card, one correctly rounded float32 operation per
// PyTorch op, in the same order (the __f*_rn intrinsics are never merged
// into FMAs):
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + ((1-b2)*g)*g
//   p' = p - (lr*(m'/bc1)) / (sqrt(v'/bc2) + eps)
// The constants arrive rounded to float32 as PyTorch rounds a Python scalar
// (1-b1 and 1-b2 formed in double first). bc1 and bc2, the bias
// corrections, are 0-d device tensors made from the device step count, and
// lr is either a float argument or a 0-d device tensor (the position
// schedule): the kernel reads those by pointer, so nothing waits on the host.
//
// What bounds it on an H100: bytes, 28 a float (4 read, 3 written). The
// SH-degree-3 field of 18,180,096 Gaussians (872.6M floats) moves 24.4 GB,
// 7.3 ms at 3.35 TB/s. One thread a float, a grid of ceil(n / 256) blocks:
// a warp's loads and stores are 128 contiguous bytes, and the kernel makes
// no assumption on the pointers' alignment (gradients that are views into
// one packed vector, as on the mesh after the fused all-reduce, are not
// 16-byte aligned). Against 16-byte loads in a grid-stride loop sized to
// the resident blocks, it was as fast or faster on every field size the
// cells run, aligned or not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float b1, omb1, b2, omb2, eps, lr;
};

__global__ void __launch_bounds__(kThreads)
adam_kernel(const float* __restrict__ p, const float* __restrict__ g, const float* __restrict__ m,
            const float* __restrict__ v, float* __restrict__ po, float* __restrict__ mo, float* __restrict__ vo,
            int64_t n, const float* __restrict__ bc1p, const float* __restrict__ bc2p,
            const float* __restrict__ lrp, Hyper h) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float bc1 = *bc1p, bc2 = *bc2p;
  const float lr = lrp != nullptr ? *lrp : h.lr;
  const float gi = g[i];
  const float mi = __fadd_rn(__fmul_rn(h.b1, m[i]), __fmul_rn(h.omb1, gi));
  const float vi = __fadd_rn(__fmul_rn(h.b2, v[i]), __fmul_rn(__fmul_rn(h.omb2, gi), gi));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, bc2)), h.eps);
  po[i] = __fsub_rn(p[i], __fdiv_rn(__fmul_rn(lr, __fdiv_rn(mi, bc1)), den));
  mo[i] = mi;
  vo[i] = vi;
}

}  // namespace

// One field's update: p, g, m, v (n floats each) read; p_out, m_out, v_out
// written. bc1, bc2: 0-d device tensors; lr_ptr: a 0-d device tensor, or
// null to use lr. Returns a cudaError_t.
extern "C" int adam_update(const float* p, const float* g, const float* m, const float* v, float* p_out,
                           float* m_out, float* v_out, long long n, const float* bc1, const float* bc2,
                           const float* lr_ptr, float lr, float b1, float one_minus_b1, float b2, float one_minus_b2,
                           float eps, void* stream) {
  if (n <= 0) return 0;
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, eps, lr};
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, g, m, v, p_out, m_out, v_out, n, bc1,
                                                                        bc2, lr_ptr, h);
  return static_cast<int>(cudaGetLastError());
}
