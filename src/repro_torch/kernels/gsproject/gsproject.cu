// EWA projection of 3D Gaussians to packed screen-space splats (SH degrees 0-3).
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/gsproject/gsproject.py::_kernel (launched by make_project.run),
// which covers SH degree 0; the JAX wrapper sends degrees 1-3 to its oracle,
// and this kernel computes those too.
//
// What bounds it on an H100: bytes. Each Gaussian reads 14 floats (means 3,
// log-scales 3, quats 4, opacity logit 1, SH DC 3) and writes 11, i.e. 100 B,
// against ~100 flops of elementwise math: far below the card's ~20 flop/B
// ridge for float32. At 4M Gaussians that is 400 MB, about 0.12 ms at
// 3.35 TB/s.
//
// Design: one thread per Gaussian, reading the model's own rows: means
// (N,3), log-scales (N,3), quats (N,4), opacity logit (N,) and the DC term
// of the SH coefficients (N,C,3), so a view costs no layout copy of the
// parameters. A warp's 32 loads of one field span 384-512 contiguous bytes
// and its loads of the other fields of those rows hit the same lines in L1,
// so every byte fetched from memory is used. The block's (256, 11) outputs
// are staged in shared memory (row stride 11 is odd: no bank conflicts) and
// written back as one contiguous run of 256*11 floats, fully coalesced,
// straight into the (N, 11) packed layout. The camera (viewmat,
// intrinsics, near plane, camera position) rides in a 128-byte by-value
// kernel argument, which lands in the constant bank: no device buffer, no
// host->device copy per view. The ragged last block is masked, so N needs
// no padding. The arithmetic follows the plain PyTorch version
// (kernels/gsproject/ref.py) operation for operation; the library is built
// without FMA contraction so both round alike.
//
// SH degrees 1-3: the number of coefficients per channel (1, 4, 9 or 16) is
// a template parameter, one instantiation per degree, so degree 0 compiles
// to the code it always was. Above degree 0 the thread that writes a row
// also evaluates its view-dependent color from the model's own (N, C, 3)
// rows through `sh_stride` (no layout copy): the direction from the camera
// position to the mean, normalized as (means - campos) / (norm + 1e-12),
// then the bands summed term by term in core/gaussians.py eval_sh's order,
// + 0.5 and the clamp to [0, 1]. The bytes grow by 12 (C - 1) per Gaussian.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct CamArgs {
  float v[32];  // viewmat(16, row-major), fx, fy, cx, cy, near, campos(3), pad
};

constexpr int kThreads = 256;
constexpr int kFields = 11;  // MX, MY, conic a/b/c, opacity, r, g, b, depth, radius
// the SH basis constants as PyTorch rounds eval_sh's Python floats: the
// double literal cast to float
constexpr float kShC0 = static_cast<float>(0.28209479177387814);
constexpr float kShC1 = static_cast<float>(0.4886025119029199);
constexpr float kShC2a = static_cast<float>(1.0925484305920792);
constexpr float kShC2b = static_cast<float>(-1.0925484305920792);
constexpr float kShC2c = static_cast<float>(0.31539156525252005);
constexpr float kShC2d = static_cast<float>(0.5462742152960396);
constexpr float kShC3a = static_cast<float>(-0.5900435899266435);
constexpr float kShC3b = static_cast<float>(2.890611442640554);
constexpr float kShC3c = static_cast<float>(-0.4570457994644658);
constexpr float kShC3d = static_cast<float>(0.3731763325901154);
constexpr float kShC3e = static_cast<float>(1.445305721320277);

// rgb[c] = eval_sh(sh row, dir)[c] before the clamp, for kCoeffs
// coefficients per channel. `row` is the Gaussian's (kCoeffs, 3) block.
// Each product and sum is written in eval_sh's association order; the
// per-Gaussian factors (the basis functions times their constants) are
// formed once and shared by the three channels, as eval_sh's (N, 1)
// factors broadcast over them.
template <int kCoeffs>
__device__ __forceinline__ void eval_sh_color(const float* __restrict__ row, float mx, float my, float mz,
                                              float px, float py, float pz, float rgb[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[c] = kShC0 * row[c];
  if constexpr (kCoeffs > 1) {
    float x = mx - px, y = my - py, z = mz - pz;
    const float nrm = sqrtf(x * x + y * y + z * z) + static_cast<float>(1e-12);
    x = x / nrm;
    y = y / nrm;
    z = z / nrm;
    const float ny = -y;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t = ny * row[3 + c] + z * row[6 + c] - x * row[9 + c];
      rgb[c] = rgb[c] + kShC1 * t;
    }
    if constexpr (kCoeffs > 4) {
      const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
      const float f4 = kShC2a * xy;
      const float f5 = kShC2b * yz;
      const float f6 = kShC2c * (2.0f * zz - xx - yy);
      const float f7 = kShC2b * xz;
      const float f8 = kShC2d * (xx - yy);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t = f4 * row[12 + c] + f5 * row[15 + c] + f6 * row[18 + c] + f7 * row[21 + c] +
                        f8 * row[24 + c];
        rgb[c] = rgb[c] + t;
      }
      if constexpr (kCoeffs > 9) {
        const float zz4 = 4.0f * zz - xx - yy;
        const float f9 = kShC3a * y * (3.0f * xx - yy);
        const float f10 = kShC3b * x * y * z;
        const float f11 = kShC3c * y * zz4;
        const float f12 = kShC3d * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
        const float f13 = kShC3c * x * zz4;
        const float f14 = kShC3e * z * (xx - yy);
        const float f15 = kShC3a * x * (xx - 3.0f * yy);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float t = f9 * row[27 + c] + f10 * row[30 + c] + f11 * row[33 + c] + f12 * row[36 + c] +
                          f13 * row[39 + c] + f14 * row[42 + c] + f15 * row[45 + c];
          rgb[c] = rgb[c] + t;
        }
      }
    }
  }
}

template <int kCoeffs>
__global__ void __launch_bounds__(kThreads)
gsproject_fwd_kernel(const float* __restrict__ means, const float* __restrict__ log_scales,
                     const float* __restrict__ quats, const float* __restrict__ opac_logit,
                     const float* __restrict__ sh, int sh_stride, const CamArgs cam,
                     float* __restrict__ out, int n, float blur) {
  __shared__ float staged[kThreads * kFields];
  const int first = blockIdx.x * kThreads;
  const int t = threadIdx.x;
  const int i = first + t;
  if (i < n) {
    float rv[3][4];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) rv[r][c] = cam.v[4 * r + c];
    const float fx = cam.v[16], fy = cam.v[17], cx = cam.v[18], cy = cam.v[19], near_z = cam.v[20];

    const float mx = means[3 * i], my = means[3 * i + 1], mz = means[3 * i + 2];
    const float sx = expf(log_scales[3 * i]);
    const float sy = expf(log_scales[3 * i + 1]);
    const float sz = expf(log_scales[3 * i + 2]);
    float qw = quats[4 * i], qx = quats[4 * i + 1], qy = quats[4 * i + 2], qz = quats[4 * i + 3];
    const float qn = rsqrtf(qw * qw + qx * qx + qy * qy + qz * qz + 1e-24f);
    qw = qw * qn;
    qx = qx * qn;
    qy = qy * qn;
    qz = qz * qn;

    // rotation matrix R (rows); column k scaled by s_k^2 below
    const float r[3][3] = {
        {1.0f - 2.0f * (qy * qy + qz * qz), 2.0f * (qx * qy - qw * qz), 2.0f * (qx * qz + qw * qy)},
        {2.0f * (qx * qy + qw * qz), 1.0f - 2.0f * (qx * qx + qz * qz), 2.0f * (qy * qz - qw * qx)},
        {2.0f * (qx * qz - qw * qy), 2.0f * (qy * qz + qw * qx), 1.0f - 2.0f * (qx * qx + qy * qy)},
    };
    const float s2[3] = {sx * sx, sy * sy, sz * sz};
    // cov3d_ij = sum_k s_k^2 r[i][k] r[j][k]   (six unique entries)
    float cov[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = a; b < 3; ++b) {
        const float v = s2[0] * r[a][0] * r[b][0] + s2[1] * r[a][1] * r[b][1] + s2[2] * r[a][2] * r[b][2];
        cov[a][b] = v;
        cov[b][a] = v;
      }

    // camera-space position
    const float x = rv[0][0] * mx + rv[0][1] * my + rv[0][2] * mz + rv[0][3];
    const float y = rv[1][0] * mx + rv[1][1] * my + rv[1][2] * mz + rv[1][3];
    const float z = rv[2][0] * mx + rv[2][1] * my + rv[2][2] * mz + rv[2][3];
    const bool valid = z > near_z;
    const float zc = valid ? z : 1.0f;
    const float inv_z = 1.0f / zc;
    const float inv_z2 = inv_z * inv_z;

    const float mean_x = fx * x * inv_z + cx;
    const float mean_y = fy * y * inv_z + cy;

    // J·W rows: jw[a][k] = J[a,:] @ Rv[:,k]
    float jw0[3], jw1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      jw0[k] = fx * inv_z * rv[0][k] - fx * x * inv_z2 * rv[2][k];
      jw1[k] = fy * inv_z * rv[1][k] - fy * y * inv_z2 * rv[2][k];
    }
    float v0[3], v1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v0[k] = cov[k][0] * jw0[0] + cov[k][1] * jw0[1] + cov[k][2] * jw0[2];
      v1[k] = cov[k][0] * jw1[0] + cov[k][1] * jw1[1] + cov[k][2] * jw1[2];
    }
    const float a = jw0[0] * v0[0] + jw0[1] * v0[1] + jw0[2] * v0[2] + blur;
    const float b = jw1[0] * v0[0] + jw1[1] * v0[1] + jw1[2] * v0[2];
    const float c = jw1[0] * v1[0] + jw1[1] * v1[1] + jw1[2] * v1[2] + blur;

    const float det = fmaxf(a * c - b * b, 1e-12f);
    const float inv_det = 1.0f / det;
    const float conic_a = c * inv_det;
    const float conic_b = -b * inv_det;
    const float conic_c = a * inv_det;
    const float mid = 0.5f * (a + c);
    const float lam1 = mid + sqrtf(fmaxf(mid * mid - det, 0.0f));
    const float radius = fminf(ceilf(3.0f * sqrtf(fmaxf(lam1, 0.0f))), 1e4f);

    const float opac = 1.0f / (1.0f + expf(-opac_logit[i]));
    float rgb[3];
    eval_sh_color<kCoeffs>(sh + static_cast<size_t>(i) * sh_stride, mx, my, mz, cam.v[21], cam.v[22], cam.v[23],
                           rgb);
    const float cr = fminf(fmaxf(rgb[0] + 0.5f, 0.0f), 1.0f);
    const float cg = fminf(fmaxf(rgb[1] + 0.5f, 0.0f), 1.0f);
    const float cb = fminf(fmaxf(rgb[2] + 0.5f, 0.0f), 1.0f);

    float* o = staged + t * kFields;
    o[0] = mean_x;
    o[1] = mean_y;
    o[2] = conic_a;
    o[3] = conic_b;
    o[4] = conic_c;
    o[5] = valid ? opac : 0.0f;
    o[6] = cr;
    o[7] = cg;
    o[8] = cb;
    o[9] = valid ? z : INFINITY;
    o[10] = valid ? radius : 0.0f;
  }
  __syncthreads();
  // the block's rows [first, first + count) are one contiguous run of floats
  const int count = min(kThreads, n - first) * kFields;
  float* dst = out + static_cast<size_t>(first) * kFields;
  for (int j = t; j < count; j += kThreads) dst[j] = staged[j];
}

}  // namespace

// Plain C launcher (bound with ctypes). `cam` is a HOST pointer to 32 floats,
// copied into the by-value kernel argument; `sh_stride` is the float stride
// between two Gaussians' SH rows (3 * coefficients per channel: 3, 12, 27 or
// 48 for degrees 0-3; any other stride is refused with
// cudaErrorInvalidValue). Returns cudaGetLastError().
extern "C" int gsproject_fwd(const float* means, const float* log_scales, const float* quats,
                             const float* opac_logit, const float* sh, int sh_stride, const float* cam,
                             float* out, int n, float blur, void* stream) {
  CamArgs args;
  for (int k = 0; k < 32; ++k) args.v[k] = cam[k];
  const int blocks = (n + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sh_stride) {
    case 3:
      gsproject_fwd_kernel<1><<<blocks, kThreads, 0, st>>>(means, log_scales, quats, opac_logit, sh, sh_stride,
                                                           args, out, n, blur);
      break;
    case 12:
      gsproject_fwd_kernel<4><<<blocks, kThreads, 0, st>>>(means, log_scales, quats, opac_logit, sh, sh_stride,
                                                           args, out, n, blur);
      break;
    case 27:
      gsproject_fwd_kernel<9><<<blocks, kThreads, 0, st>>>(means, log_scales, quats, opac_logit, sh, sh_stride,
                                                           args, out, n, blur);
      break;
    case 48:
      gsproject_fwd_kernel<16><<<blocks, kThreads, 0, st>>>(means, log_scales, quats, opac_logit, sh, sh_stride,
                                                            args, out, n, blur);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
