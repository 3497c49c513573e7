// EWA projection of 3D Gaussians to packed screen-space splats (SH degrees
// 0-3), forward and backward.
//
// The forward replaces the JAX package's Pallas TPU kernel
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
//
// The backward (gsproject_bwd_kernel, at the end of the file) replaces no
// TPU kernel: the JAX package differentiates its oracle
// (src/repro/kernels/gsproject/ops.py). It is the vector-Jacobian product of
// kernels/gsproject/ref.py project_ref, masks included, in one launch a
// view where the plain VJP runs ~800 PyTorch ops. It too is bound by bytes:
// at degree 0 each Gaussian reads its 14 parameter floats and the 11 floats
// of its splat's gradient and writes 14 gradient floats, 156 B, so 624 MB
// and ~0.19 ms at 4,000,768 Gaussians at 3.35 TB/s; with C coefficients a
// channel, 156 + 24 (C - 1) B. Its ~600 flops a Gaussian stay far under the
// ridge. So the design moves each byte once, coalesced: one thread a
// Gaussian recomputes the forward's intermediates in registers (the same
// shared code as the forward, so the masks agree with it bit for bit),
// the block's 256 x 11 gradient rows come in through shared memory as one
// contiguous run (the forward's store turned around), and each of the five
// gradient arrays goes out the same way, a block's rows staged at an odd
// row stride and written as one contiguous run. There are no atomics and no
// sums across threads: two launches are bitwise equal.

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

// The forward's intermediates of one Gaussian, from its parameters to the
// 2D covariance (a, b, c) and its unclamped determinant, in the plain
// version's order of operations. Both kernels compute them here, so the
// backward's masks (near plane, determinant clamp) are the forward's.
struct Geometry {
  float s[3];         // exp(log-scales)
  float qn;           // rsqrt(|q|^2 + 1e-24)
  float q[4];         // the normalized quaternion (w, x, y, z)
  float r[3][3];      // its rotation matrix (rows)
  float s2[3];        // squared scales
  float cov[3][3];    // cov3d, symmetric
  float x, y, z;      // camera-space position
  bool valid;         // z > near
  float inv_z, inv_z2;
  float jw0[3], jw1[3];  // the rows of J·W
  float v0[3], v1[3];    // cov3d · jw0, cov3d · jw1
  float a, b, c;         // the 2D covariance, blur added
  float det_raw;         // a c - b^2, before the clamp at 1e-12
};

__device__ __forceinline__ Geometry geometry(const CamArgs& cam, float mx, float my, float mz,
                                             const float* __restrict__ ls, const float* __restrict__ qv,
                                             float blur) {
  Geometry p;
  float rv[3][4];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) rv[r][c] = cam.v[4 * r + c];
  const float fx = cam.v[16], fy = cam.v[17], near_z = cam.v[20];

#pragma unroll
  for (int k = 0; k < 3; ++k) p.s[k] = expf(ls[k]);
  const float qw0 = qv[0], qx0 = qv[1], qy0 = qv[2], qz0 = qv[3];
  p.qn = rsqrtf(qw0 * qw0 + qx0 * qx0 + qy0 * qy0 + qz0 * qz0 + 1e-24f);
  const float qw = qw0 * p.qn, qx = qx0 * p.qn, qy = qy0 * p.qn, qz = qz0 * p.qn;
  p.q[0] = qw;
  p.q[1] = qx;
  p.q[2] = qy;
  p.q[3] = qz;

  // rotation matrix R (rows); column k scaled by s_k^2 below
  p.r[0][0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  p.r[0][1] = 2.0f * (qx * qy - qw * qz);
  p.r[0][2] = 2.0f * (qx * qz + qw * qy);
  p.r[1][0] = 2.0f * (qx * qy + qw * qz);
  p.r[1][1] = 1.0f - 2.0f * (qx * qx + qz * qz);
  p.r[1][2] = 2.0f * (qy * qz - qw * qx);
  p.r[2][0] = 2.0f * (qx * qz - qw * qy);
  p.r[2][1] = 2.0f * (qy * qz + qw * qx);
  p.r[2][2] = 1.0f - 2.0f * (qx * qx + qy * qy);
#pragma unroll
  for (int k = 0; k < 3; ++k) p.s2[k] = p.s[k] * p.s[k];
  // cov3d_ij = sum_k s_k^2 r[i][k] r[j][k]   (six unique entries)
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = a; b < 3; ++b) {
      const float v = p.s2[0] * p.r[a][0] * p.r[b][0] + p.s2[1] * p.r[a][1] * p.r[b][1] +
                      p.s2[2] * p.r[a][2] * p.r[b][2];
      p.cov[a][b] = v;
      p.cov[b][a] = v;
    }

  // camera-space position
  p.x = rv[0][0] * mx + rv[0][1] * my + rv[0][2] * mz + rv[0][3];
  p.y = rv[1][0] * mx + rv[1][1] * my + rv[1][2] * mz + rv[1][3];
  p.z = rv[2][0] * mx + rv[2][1] * my + rv[2][2] * mz + rv[2][3];
  p.valid = p.z > near_z;
  const float zc = p.valid ? p.z : 1.0f;
  p.inv_z = 1.0f / zc;
  p.inv_z2 = p.inv_z * p.inv_z;

  // J·W rows: jw[a][k] = J[a,:] @ Rv[:,k]
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.jw0[k] = fx * p.inv_z * rv[0][k] - fx * p.x * p.inv_z2 * rv[2][k];
    p.jw1[k] = fy * p.inv_z * rv[1][k] - fy * p.y * p.inv_z2 * rv[2][k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.v0[k] = p.cov[k][0] * p.jw0[0] + p.cov[k][1] * p.jw0[1] + p.cov[k][2] * p.jw0[2];
    p.v1[k] = p.cov[k][0] * p.jw1[0] + p.cov[k][1] * p.jw1[1] + p.cov[k][2] * p.jw1[2];
  }
  p.a = p.jw0[0] * p.v0[0] + p.jw0[1] * p.v0[1] + p.jw0[2] * p.v0[2] + blur;
  p.b = p.jw1[0] * p.v0[0] + p.jw1[1] * p.v0[1] + p.jw1[2] * p.v0[2];
  p.c = p.jw1[0] * p.v1[0] + p.jw1[1] * p.v1[1] + p.jw1[2] * p.v1[2] + blur;
  p.det_raw = p.a * p.c - p.b * p.b;
  return p;
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
    const float fx = cam.v[16], fy = cam.v[17], cx = cam.v[18], cy = cam.v[19];
    const float mx = means[3 * i], my = means[3 * i + 1], mz = means[3 * i + 2];
    const Geometry p = geometry(cam, mx, my, mz, log_scales + 3 * i, quats + 4 * i, blur);

    const float mean_x = fx * p.x * p.inv_z + cx;
    const float mean_y = fy * p.y * p.inv_z + cy;
    const float det = fmaxf(p.det_raw, 1e-12f);
    const float inv_det = 1.0f / det;
    const float conic_a = p.c * inv_det;
    const float conic_b = -p.b * inv_det;
    const float conic_c = p.a * inv_det;
    const float mid = 0.5f * (p.a + p.c);
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
    o[5] = p.valid ? opac : 0.0f;
    o[6] = cr;
    o[7] = cg;
    o[8] = cb;
    o[9] = p.valid ? p.z : INFINITY;
    o[10] = p.valid ? radius : 0.0f;
  }
  __syncthreads();
  // the block's rows [first, first + count) are one contiguous run of floats
  const int count = min(kThreads, n - first) * kFields;
  float* dst = out + static_cast<size_t>(first) * kFields;
  for (int j = t; j < count; j += kThreads) dst[j] = staged[j];
}

// ---------------------------------------------------------------- backward

// The SH color's backward for kCoeffs coefficients a channel: given the
// color's gradient `dcol` (zero where the clamp to [0, 1] passed none), the
// per-Gaussian factor of each coefficient (`basis`, so d sh[k][c] =
// basis[k] * dcol[c]) and the gradient that reaches the means through the
// normalized direction, added to `dm`. The direction, the factors and their
// derivatives follow eval_sh term by term; the direction's gradient goes
// back through dir = u / (|u| + 1e-12), u = means - campos, as autograd
// takes the division and torch.linalg.norm (0 where |u| is 0).
template <int kCoeffs>
__device__ __forceinline__ void sh_backward(const float* __restrict__ row, float mx, float my, float mz, float px,
                                            float py, float pz, const float dcol[3], float basis[kCoeffs],
                                            float dm[3]) {
  basis[0] = kShC0;
  if constexpr (kCoeffs > 1) {
    const float ux = mx - px, uy = my - py, uz = mz - pz;
    const float nraw = sqrtf(ux * ux + uy * uy + uz * uz);
    const float nrm = nraw + static_cast<float>(1e-12);
    const float x = ux / nrm, y = uy / nrm, z = uz / nrm;
    // s(k) = sum over the channels of dcol[c] * sh[k][c]: the gradient of
    // the factor of coefficient k
    auto s = [&](int k) { return dcol[0] * row[3 * k] + dcol[1] * row[3 * k + 1] + dcol[2] * row[3 * k + 2]; };
    basis[1] = kShC1 * -y;
    basis[2] = kShC1 * z;
    basis[3] = kShC1 * -x;
    float gx = -kShC1 * s(3), gy = -kShC1 * s(1), gz = kShC1 * s(2);
    if constexpr (kCoeffs > 4) {
      const float xx = x * x, yy = y * y, zz = z * z;
      basis[4] = kShC2a * (x * y);
      basis[5] = kShC2b * (y * z);
      basis[6] = kShC2c * (2.0f * zz - xx - yy);
      basis[7] = kShC2b * (x * z);
      basis[8] = kShC2d * (xx - yy);
      const float s4 = s(4), s5 = s(5), s6 = s(6), s7 = s(7), s8 = s(8);
      gx += kShC2a * y * s4 - 2.0f * kShC2c * x * s6 + kShC2b * z * s7 + 2.0f * kShC2d * x * s8;
      gy += kShC2a * x * s4 + kShC2b * z * s5 - 2.0f * kShC2c * y * s6 - 2.0f * kShC2d * y * s8;
      gz += kShC2b * y * s5 + 4.0f * kShC2c * z * s6 + kShC2b * x * s7;
      if constexpr (kCoeffs > 9) {
        const float zz4 = 4.0f * zz - xx - yy;
        basis[9] = kShC3a * y * (3.0f * xx - yy);
        basis[10] = kShC3b * x * y * z;
        basis[11] = kShC3c * y * zz4;
        basis[12] = kShC3d * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
        basis[13] = kShC3c * x * zz4;
        basis[14] = kShC3e * z * (xx - yy);
        basis[15] = kShC3a * x * (xx - 3.0f * yy);
        const float s9 = s(9), s10 = s(10), s11 = s(11), s12 = s(12), s13 = s(13), s14 = s(14), s15 = s(15);
        gx += kShC3a * 6.0f * x * y * s9 + kShC3b * y * z * s10 - kShC3c * 2.0f * x * y * s11 -
              kShC3d * 6.0f * x * z * s12 + kShC3c * (zz4 - 2.0f * xx) * s13 + kShC3e * 2.0f * x * z * s14 +
              kShC3a * 3.0f * (xx - yy) * s15;
        gy += kShC3a * 3.0f * (xx - yy) * s9 + kShC3b * x * z * s10 + kShC3c * (zz4 - 2.0f * yy) * s11 -
              kShC3d * 6.0f * y * z * s12 - kShC3c * 2.0f * x * y * s13 - kShC3e * 2.0f * y * z * s14 -
              kShC3a * 6.0f * x * y * s15;
        gz += kShC3b * x * y * s10 + kShC3c * 8.0f * y * z * s11 +
              kShC3d * (6.0f * zz - 3.0f * xx - 3.0f * yy) * s12 + kShC3c * 8.0f * x * z * s13 +
              kShC3e * (xx - yy) * s14;
      }
    }
    // dir = u / nrm: u gets g / nrm directly, and -(g . u) / nrm^2 through
    // nrm = |u| + 1e-12, whose gradient is u / |u|
    dm[0] += gx / nrm;
    dm[1] += gy / nrm;
    dm[2] += gz / nrm;
    if (nraw > 0.0f) {
      const float dn = -(gx * ux + gy * uy + gz * uz) / (nrm * nrm) / nraw;
      dm[0] += dn * ux;
      dm[1] += dn * uy;
      dm[2] += dn * uz;
    }
  }
}

// Write W gradient floats a row for the block's `count` rows [first, first +
// count) as contiguous runs: the rows are staged in `buf` at an odd stride
// (a warp's row writes hit distinct banks), as many rows a pass as the
// buffer holds (a multiple of 32), and each pass is copied out by the whole
// block. value(j) is the calling thread's j-th float; every thread of the
// block calls this (it synchronizes).
template <int W, int kBuf, typename Value>
__device__ __forceinline__ void store_rows(float* __restrict__ buf, float* __restrict__ dst, int first, int count,
                                           int t, Value value) {
  constexpr int kStride = W | 1;
  constexpr int kFit = kBuf / kStride / 32 * 32;
  constexpr int kRows = kFit < kThreads ? kFit : kThreads;
  static_assert(kRows >= 32, "the staging buffer holds too few rows");
  for (int r0 = 0; r0 < count; r0 += kRows) {
    const int rows = min(kRows, count - r0);
    __syncthreads();  // the buffer's last readers are done
    if (t >= r0 && t < r0 + rows) {
#pragma unroll
      for (int j = 0; j < W; ++j) buf[(t - r0) * kStride + j] = value(j);
    }
    __syncthreads();
    float* d = dst + (static_cast<size_t>(first) + r0) * W;
    for (int j = t; j < rows * W; j += kThreads) d[j] = buf[(j / W) * kStride + j % W];
  }
}

template <int kCoeffs>
__global__ void __launch_bounds__(kThreads)
gsproject_bwd_kernel(const float* __restrict__ means, const float* __restrict__ log_scales,
                     const float* __restrict__ quats, const float* __restrict__ opac_logit,
                     const float* __restrict__ sh, int sh_stride, const CamArgs cam,
                     const float* __restrict__ gpacked, float* __restrict__ dmeans,
                     float* __restrict__ dlog_scales, float* __restrict__ dquats,
                     float* __restrict__ dopac_logit, float* __restrict__ dsh, int n, float blur) {
  // staging floats: the (256, 11) gradient rows in, and the gradient rows
  // of up to 12 floats out at stride 13 in one pass (the SH's 27 or 48 at
  // degrees 2 and 3 in two passes of 128 rows)
  constexpr int kBuf = kThreads * (kCoeffs > 4 ? 25 : 13);
  __shared__ float buf[kBuf];
  const int first = blockIdx.x * kThreads;
  const int t = threadIdx.x;
  const int i = first + t;
  const int count = min(kThreads, n - first);

  // the block's gradient rows [first, first + count): one contiguous run
  const float* src = gpacked + static_cast<size_t>(first) * kFields;
  for (int j = t; j < count * kFields; j += kThreads) buf[j] = src[j];
  __syncthreads();

  float dm[3] = {0.0f, 0.0f, 0.0f}, dls[3] = {0.0f, 0.0f, 0.0f}, dq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dop = 0.0f, dcol[3] = {0.0f, 0.0f, 0.0f}, basis[kCoeffs] = {};
  if (i < n) {
    float g[kFields];
#pragma unroll
    for (int k = 0; k < kFields; ++k) g[k] = buf[t * kFields + k];
    const float fx = cam.v[16], fy = cam.v[17];
    const float mx = means[3 * i], my = means[3 * i + 1], mz = means[3 * i + 2];
    const float* ls = log_scales + 3 * i;
    const float* qv = quats + 4 * i;
    const Geometry p = geometry(cam, mx, my, mz, ls, qv, blur);

    // opacity = where(valid, sigmoid(logit), 0)
    if (p.valid) {
      const float s = 1.0f / (1.0f + expf(-opac_logit[i]));
      dop = g[5] * (1.0f - s) * s;
    }
    // color = clamp(eval_sh + 0.5, 0, 1): the gradient passes where 0 <= it <= 1
    const float* row = sh + static_cast<size_t>(i) * sh_stride;
    float rgb[3];
    eval_sh_color<kCoeffs>(row, mx, my, mz, cam.v[21], cam.v[22], cam.v[23], rgb);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = rgb[c] + 0.5f;
      dcol[c] = (v >= 0.0f && v <= 1.0f) ? g[6 + c] : 0.0f;
    }
    sh_backward<kCoeffs>(row, mx, my, mz, cam.v[21], cam.v[22], cam.v[23], dcol, basis, dm);

    // means2d = f * (x, y) * inv_z + (cx, cy); depth = where(valid, z, inf)
    float dx = g[0] * p.inv_z * fx;
    float dy = g[1] * p.inv_z * fy;
    float dz = p.valid ? g[9] : 0.0f;
    float dinv_z = g[0] * (fx * p.x) + g[1] * (fy * p.y);

    // conic = (c, -b, a) / max(det, 1e-12): the clamp passes det's gradient
    // where det >= 1e-12
    const float inv_det = 1.0f / fmaxf(p.det_raw, 1e-12f);
    float da = g[4] * inv_det, db = -g[3] * inv_det, dc = g[2] * inv_det;
    if (p.det_raw >= 1e-12f) {
      const float ddet = -(g[2] * p.c - g[3] * p.b + g[4] * p.a) * inv_det * inv_det;
      da += ddet * p.c;
      dc += ddet * p.a;
      db -= 2.0f * ddet * p.b;
    }

    // a = jw0' C jw0 + blur, b = jw1' C jw0, c = jw1' C jw1 + blur
    float djw0[3], djw1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      djw0[k] = 2.0f * da * p.v0[k] + db * p.v1[k];
      djw1[k] = db * p.v0[k] + 2.0f * dc * p.v1[k];
    }
    // h[a][b]: the gradient of cov3d's unique entry (a, b), twice over on the
    // diagonal, so that d r = s^2 (h r) and d s^2 = diag(r' h r) / 2
    float h[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = a; b < 3; ++b) {
        const float v = 2.0f * da * p.jw0[a] * p.jw0[b] + db * (p.jw1[a] * p.jw0[b] + p.jw1[b] * p.jw0[a]) +
                        2.0f * dc * p.jw1[a] * p.jw1[b];
        h[a][b] = v;
        h[b][a] = v;
      }

    // jw0[k] = fx inv_z rv[0][k] - fx x inv_z2 rv[2][k] (jw1: fy, y, rv[1])
    float w0 = 0.0f, w1 = 0.0f, w2a = 0.0f, w2b = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w0 += djw0[k] * cam.v[k];
      w1 += djw1[k] * cam.v[4 + k];
      w2a += djw0[k] * cam.v[8 + k];
      w2b += djw1[k] * cam.v[8 + k];
    }
    dinv_z += fx * w0 + fy * w1;
    dx -= fx * p.inv_z2 * w2a;
    dy -= fy * p.inv_z2 * w2b;
    const float dinv_z2 = -(fx * p.x) * w2a - (fy * p.y) * w2b;
    dinv_z += 2.0f * p.inv_z * dinv_z2;
    // inv_z = 1 / where(valid, z, 1): z gets nothing where invalid
    if (p.valid) dz -= dinv_z * p.inv_z * p.inv_z;
    // (x, y, z) = Rv m + t
#pragma unroll
    for (int k = 0; k < 3; ++k) dm[k] += cam.v[k] * dx + cam.v[4 + k] * dy + cam.v[8 + k] * dz;

    // cov3d = R diag(s^2) R'
    float dr[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float ds2 = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float hr = h[a][0] * p.r[0][k] + h[a][1] * p.r[1][k] + h[a][2] * p.r[2][k];
        dr[a][k] = p.s2[k] * hr;
        ds2 += p.r[a][k] * hr;
      }
      // ds2 is twice d(s^2) (h's doubled diagonal), and d l = 2 s^2 d(s^2)
      // for s^2 = exp(l)^2
      dls[k] = ds2 * p.s[k] * p.s[k];
    }

    // R from the normalized quaternion (w, x, y, z)
    const float qw = p.q[0], qx = p.q[1], qy = p.q[2], qz = p.q[3];
    const float dqw = 2.0f * (-dr[0][1] * qz + dr[0][2] * qy + dr[1][0] * qz - dr[1][2] * qx - dr[2][0] * qy +
                              dr[2][1] * qx);
    const float dqx = 2.0f * (dr[0][1] * qy + dr[0][2] * qz + dr[1][0] * qy - 2.0f * dr[1][1] * qx -
                              dr[1][2] * qw + dr[2][0] * qz + dr[2][1] * qw - 2.0f * dr[2][2] * qx);
    const float dqy = 2.0f * (-2.0f * dr[0][0] * qy + dr[0][1] * qx + dr[0][2] * qw + dr[1][0] * qx +
                              dr[1][2] * qz - dr[2][0] * qw + dr[2][1] * qz - 2.0f * dr[2][2] * qy);
    const float dqz = 2.0f * (-2.0f * dr[0][0] * qz - dr[0][1] * qw + dr[0][2] * qx + dr[1][0] * qw -
                              2.0f * dr[1][1] * qz + dr[1][2] * qy + dr[2][0] * qx + dr[2][1] * qy);
    // q = q_raw * rsqrt(|q_raw|^2 + 1e-24)
    const float dot = dqw * qv[0] + dqx * qv[1] + dqy * qv[2] + dqz * qv[3];
    const float k3 = -dot * p.qn * p.qn * p.qn;
    dq[0] = dqw * p.qn + k3 * qv[0];
    dq[1] = dqx * p.qn + k3 * qv[1];
    dq[2] = dqy * p.qn + k3 * qv[2];
    dq[3] = dqz * p.qn + k3 * qv[3];
  }

  store_rows<3, kBuf>(buf, dmeans, first, count, t, [&](int j) { return dm[j]; });
  store_rows<3, kBuf>(buf, dlog_scales, first, count, t, [&](int j) { return dls[j]; });
  store_rows<4, kBuf>(buf, dquats, first, count, t, [&](int j) { return dq[j]; });
  store_rows<1, kBuf>(buf, dopac_logit, first, count, t, [&](int) { return dop; });
  store_rows<3 * kCoeffs, kBuf>(buf, dsh, first, count, t, [&](int j) { return basis[j / 3] * dcol[j % 3]; });
}

template <int kCoeffs>
void launch_bwd(int blocks, cudaStream_t st, const float* means, const float* log_scales, const float* quats,
                const float* opac_logit, const float* sh, int sh_stride, const CamArgs& args,
                const float* gpacked, float* dmeans, float* dlog_scales, float* dquats, float* dopac_logit,
                float* dsh, int n, float blur) {
  gsproject_bwd_kernel<kCoeffs><<<blocks, kThreads, 0, st>>>(means, log_scales, quats, opac_logit, sh, sh_stride,
                                                             args, gpacked, dmeans, dlog_scales, dquats,
                                                             dopac_logit, dsh, n, blur);
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

// The backward's launcher, with the forward's arguments plus `gpacked`, the
// (N, 11) gradient of the packed splats, and the five gradients it writes:
// means (N,3), log-scales (N,3), quats (N,4), opacity logit (N,) and SH
// (N,C,3), contiguous (the SH gradient at stride 3C whatever `sh_stride`
// reads). Returns cudaGetLastError().
extern "C" int gsproject_bwd(const float* means, const float* log_scales, const float* quats,
                             const float* opac_logit, const float* sh, int sh_stride, const float* cam,
                             const float* gpacked, float* dmeans, float* dlog_scales, float* dquats,
                             float* dopac_logit, float* dsh, int n, float blur, void* stream) {
  CamArgs args;
  for (int k = 0; k < 32; ++k) args.v[k] = cam[k];
  const int blocks = (n + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sh_stride) {
    case 3:
      launch_bwd<1>(blocks, st, means, log_scales, quats, opac_logit, sh, sh_stride, args, gpacked, dmeans,
                    dlog_scales, dquats, dopac_logit, dsh, n, blur);
      break;
    case 12:
      launch_bwd<4>(blocks, st, means, log_scales, quats, opac_logit, sh, sh_stride, args, gpacked, dmeans,
                    dlog_scales, dquats, dopac_logit, dsh, n, blur);
      break;
    case 27:
      launch_bwd<9>(blocks, st, means, log_scales, quats, opac_logit, sh, sh_stride, args, gpacked, dmeans,
                    dlog_scales, dquats, dopac_logit, dsh, n, blur);
      break;
    case 48:
      launch_bwd<16>(blocks, st, means, log_scales, quats, opac_logit, sh, sh_stride, args, gpacked, dmeans,
                     dlog_scales, dquats, dopac_logit, dsh, n, blur);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
