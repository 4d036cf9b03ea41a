// Small fixed-size linear algebra and SE(3) maps as __device__ functions,
// shared by the fused ICP kernel (icp_fused.cu) and the LM kernel (lm.cu).
//
// Port of pgslam_tpu/ops/rowmath.py (the TPU kernels' scalar row math) with
// the operation order of the port's plain PyTorch versions:
//   * 4x4 transforms are row-major float[16]; 6x6 blocks float[36];
//   * twists are [tx, ty, tz, rx, ry, rz];
//   * inv3 is the adjugate by cross products and schur_inv6 the closed-form
//     inverse of an SPD 6x6 block via the Schur complement of its leading
//     3x3 block (pgo.spd_inverse6);
//   * se3_exp / se3_log use the Taylor branch below theta^2 < 1e-3 and the
//     Shepperd quaternion with the largest pivot (first one on ties);
//   * polar3 is Higham's Newton iteration X <- (X + X^-T) / 2 (12 steps),
//     chosen over an SVD: the ICP cross-covariance of sane matches is well
//     conditioned, and the iteration is a handful of 3x3 inverses.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pgs {

__device__ __forceinline__ void mat4_mul(const float* A, const float* B,
                                         float* C) {
  float out[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += A[4 * i + k] * B[4 * k + j];
      out[4 * i + j] = acc;
    }
#pragma unroll
  for (int i = 0; i < 16; ++i) C[i] = out[i];
}

// Rigid inverse: [R^T, -R^T t].
__device__ __forceinline__ void se3_inv(const float* T, float* out) {
  float o[16];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o[4 * i + j] = T[4 * j + i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o[4 * i + 3] = -(T[i] * T[3] + T[4 + i] * T[7] + T[8 + i] * T[11]);
  o[12] = 0.f; o[13] = 0.f; o[14] = 0.f; o[15] = 1.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = o[i];
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// Adjugate inverse of a row-major 3x3 (assumes invertible).
__device__ __forceinline__ void inv3(const float* A, float* out) {
  float c1[3], c2[3], c3[3];
  cross3(A + 3, A + 6, c1);
  cross3(A + 6, A + 0, c2);
  cross3(A + 0, A + 3, c3);
  float det = A[0] * c1[0] + A[1] * c1[1] + A[2] * c1[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[3 * i + 0] = c1[i] / det;
    out[3 * i + 1] = c2[i] / det;
    out[3 * i + 2] = c3[i] / det;
  }
}

__device__ __forceinline__ float det3(const float* A) {
  return A[0] * (A[4] * A[8] - A[5] * A[7]) -
         A[1] * (A[3] * A[8] - A[5] * A[6]) +
         A[2] * (A[3] * A[7] - A[4] * A[6]);
}

__device__ __forceinline__ void mm3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}

// Closed-form inverse of an SPD 6x6 via the Schur complement.
__device__ __forceinline__ void schur_inv6(const float* M, float* out) {
  float A[9], B[9], C[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[3 * i + j] = M[6 * i + j];
      B[3 * i + j] = M[6 * i + j + 3];
      C[3 * i + j] = M[6 * (i + 3) + j + 3];
    }
  float Ai[9], AiB[9], S[9], Si[9], AiBSi[9];
  inv3(A, Ai);
  mm3(Ai, B, AiB);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      S[3 * i + j] = C[3 * i + j] - (B[i] * AiB[j] + B[3 + i] * AiB[3 + j] +
                                     B[6 + i] * AiB[6 + j]);
  inv3(S, Si);
  mm3(AiB, Si, AiBSi);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float tl = AiBSi[3 * i] * AiB[3 * j] + AiBSi[3 * i + 1] * AiB[3 * j + 1] +
                 AiBSi[3 * i + 2] * AiB[3 * j + 2];
      out[6 * i + j] = Ai[3 * i + j] + tl;
      out[6 * i + j + 3] = -AiBSi[3 * i + j];
      out[6 * (i + 3) + j] = -AiBSi[3 * j + i];
      out[6 * (i + 3) + j + 3] = Si[3 * i + j];
    }
}

__device__ __forceinline__ void sinc_coeffs(float t2, float& A, float& B,
                                            float& C) {
  bool small = t2 < 1e-3f;
  float safe_t2 = small ? 1.f : t2;
  float ts = sqrtf(safe_t2);
  float t4 = t2 * t2;
  A = small ? 1.f - t2 / 6.f + t4 / 120.f : sinf(ts) / ts;
  B = small ? 0.5f - t2 / 24.f + t4 / 720.f : (1.f - cosf(ts)) / safe_t2;
  C = small ? 1.f / 6.f - t2 / 120.f + t4 / 5040.f : (1.f - A) / safe_t2;
}

__device__ __forceinline__ void hat3(const float* w, float* W) {
  W[0] = 0.f;   W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.f;   W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.f;
}

// Twist [v; w] -> row-major 4x4.
__device__ __forceinline__ void se3_exp(const float* x, float* T) {
  const float* v = x;
  const float* w = x + 3;
  float theta = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  float A, B, C;
  sinc_coeffs(theta * theta, A, B, C);
  float W[9], WW[9];
  hat3(w, W);
  mm3(W, W, WW);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float I = (i == j) ? 1.f : 0.f;
      T[4 * i + j] = I + A * W[3 * i + j] + B * WW[3 * i + j];
      t += (I + B * W[3 * i + j] + C * WW[3 * i + j]) * v[j];
    }
    T[4 * i + 3] = t;
  }
  T[12] = 0.f; T[13] = 0.f; T[14] = 0.f; T[15] = 1.f;
}

// Row-major 4x4 -> twist [v; w].
__device__ __forceinline__ void se3_log(const float* T, float* x) {
  float m00 = T[0], m11 = T[5], m22 = T[10];
  float r01 = T[1], r02 = T[2], r10 = T[4];
  float r12 = T[6], r20 = T[8], r21 = T[9];
  float tr = m00 + m11 + m22;
  // Largest pivot of [tr, m00, m11, m22], first on ties.
  int best = 0;
  float pv = tr;
  if (m00 > pv) { best = 1; pv = m00; }
  if (m11 > pv) { best = 2; pv = m11; }
  if (m22 > pv) { best = 3; pv = m22; }
  float q[4], s;
  if (best == 0) {
    s = 2.f * sqrtf(fmaxf(1.f + tr, 1e-12f));
    q[0] = 0.25f * s; q[1] = (r21 - r12) / s; q[2] = (r02 - r20) / s;
    q[3] = (r10 - r01) / s;
  } else if (best == 1) {
    s = 2.f * sqrtf(fmaxf(1.f + m00 - m11 - m22, 1e-12f));
    q[0] = (r21 - r12) / s; q[1] = 0.25f * s; q[2] = (r01 + r10) / s;
    q[3] = (r02 + r20) / s;
  } else if (best == 2) {
    s = 2.f * sqrtf(fmaxf(1.f - m00 + m11 - m22, 1e-12f));
    q[0] = (r02 - r20) / s; q[1] = (r01 + r10) / s; q[2] = 0.25f * s;
    q[3] = (r12 + r21) / s;
  } else {
    s = 2.f * sqrtf(fmaxf(1.f - m00 - m11 + m22, 1e-12f));
    q[0] = (r10 - r01) / s; q[1] = (r02 + r20) / s; q[2] = (r12 + r21) / s;
    q[3] = 0.25f * s;
  }
  float sign = q[0] < 0.f ? -1.f : 1.f;
  float qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = sign * q[i] / qn;
  float n = sqrtf(q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  float angle = 2.f * atan2f(n, q[0]);
  bool small_n = n < 1e-8f;
  float factor = small_n ? 2.f / fmaxf(q[0], 1e-12f) : angle / n;
  float w[3] = {factor * q[1], factor * q[2], factor * q[3]};
  float theta = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  float t2 = theta * theta;
  float A, B, C;
  sinc_coeffs(t2, A, B, C);
  bool small = t2 < 1e-3f;
  float coef = small ? 1.f / 12.f + t2 / 720.f + t2 * t2 / 30240.f
                     : (1.f - A / (2.f * B)) / t2;
  float W[9], WW[9];
  hat3(w, W);
  mm3(W, W, WW);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float I = (i == j) ? 1.f : 0.f;
      acc += (I - 0.5f * W[3 * i + j] + coef * WW[3 * i + j]) * T[4 * j + 3];
    }
    x[i] = acc;
    x[3 + i] = w[i];
  }
}

// Orthogonal polar factor of a 3x3 (row-major), scale-initialized.
__device__ __forceinline__ void polar3(const float* G, float* X) {
  float fro = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) fro += G[i] * G[i];
  fro = sqrtf(fro + 1e-30f);
#pragma unroll
  for (int i = 0; i < 9; ++i) X[i] = G[i] / fro;
  for (int it = 0; it < 12; ++it) {
    float Xi[9];
    inv3(X, Xi);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        X[3 * i + j] = 0.5f * (X[3 * i + j] + Xi[3 * j + i]);
  }
}

// Adjoint of a row-major 4x4 for [t; r] twists: [[R, hat(t) R], [0, R]].
__device__ __forceinline__ void adjoint(const float* T, float* Ad) {
  float R[9], t[3] = {T[3], T[7], T[11]}, H[9], HR[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[3 * i + j] = T[4 * i + j];
  hat3(t, H);
  mm3(H, R, HR);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Ad[6 * i + j] = R[3 * i + j];
      Ad[6 * i + j + 3] = HR[3 * i + j];
      Ad[6 * (i + 3) + j] = 0.f;
      Ad[6 * (i + 3) + j + 3] = R[3 * i + j];
    }
}

__device__ __forceinline__ void mm6(const float* A, const float* B, float* C) {
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += A[6 * i + k] * B[6 * k + j];
      C[6 * i + j] = acc;
    }
}

// C = A^T B for 6x6.
__device__ __forceinline__ void mm6_tn(const float* A, const float* B,
                                       float* C) {
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += A[6 * k + i] * B[6 * k + j];
      C[6 * i + j] = acc;
    }
}

// Inverse right Jacobian of SE(3), 2nd order: I + ad(e)/2 + ad(e)^2/12,
// with ad(e) = [[hat w, hat v], [0, hat w]].
__device__ __forceinline__ void jr_inv(const float* e, float* J) {
  float a[36], hv[9], hw[9];
  hat3(e, hv);
  hat3(e + 3, hw);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[6 * i + j] = hw[3 * i + j];
      a[6 * i + j + 3] = hv[3 * i + j];
      a[6 * (i + 3) + j] = 0.f;
      a[6 * (i + 3) + j + 3] = hw[3 * i + j];
    }
  float aa[36];
  mm6(a, a, aa);
  for (int i = 0; i < 36; ++i)
    J[i] = ((i % 7 == 0) ? 1.f : 0.f) + 0.5f * a[i] + (1.f / 12.f) * aa[i];
}

// ---- block reductions (fixed order: warp tree, then warps in order) ----

template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red,
                                          float* out) {
  // red: [32 * N] shared floats; out: [N] shared floats.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    v[k] = x;
  }
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
  __syncthreads();
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[w * N + k];
    out[k] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ int block_count(int c, int* red) {
  // red: [33] shared ints.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  __syncthreads();
  if (lane == 0) red[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < nwarps; ++w) s += red[w];
    red[32] = s;
  }
  __syncthreads();
  return red[32];
}

}  // namespace pgs
