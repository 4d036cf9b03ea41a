// K2: a whole ICP registration in one thread block.
//
// Replaces pgslam_tpu/ops/icp_pallas.py::fused_icp_register_prepped (body
// _icp_kernel). The semantics are those of the port's plain version,
// pgslam_tpu_torch/ops/icp_fused.py::fused_icp_register_plain:
//   match   exact 1-NN of the transformed reading by the expanded squared
//           distance; the matched point and normal are averaged over exact
//           ties of that distance;
//   weigh   hit mask, TrimmedDist threshold = the exact kth-smallest squared
//           distance (binary search on the float bits: non-negative floats
//           order as their bit patterns), MaxDist;
//   step    point-to-plane: 6x6 normal equations + 1e-6 I, closed-form Schur
//           inverse; point-to-point: polar factor of the weighted
//           cross-covariance; identity step below MIN_SUPPORT;
//   check   iteration cap and the smoothed differential checker;
//   final   overlap, residual and the 6x6 covariance at the solution.
// An optional coarse stage runs first on reading[::coarse_div]. With
// anderson_m in 2..4 both stages run the Anderson-accelerated update
// (icp_pallas.py::run_stage_aa, the plain version's _stage_aa): type-II AA
// on the window of the last m se3-log twists relative to the stage entry,
// the (m-1)x(m-1) system solved in closed form, the extrapolation kept only
// within twice the plain step once the window has filled; the checker then
// reads dTm = T_new T^-1. The bound checker and NaN guard run in the Python
// wrapper.
//
// Design: blockIdx.x is the registration. 512 threads; each thread owns up
// to PPT reading points per pass, keeping their running best match in
// registers while map tiles of TILE points stream through shared memory.
// Per-point results go to global scratch; weighted moments are fixed-order
// block reductions; thread 0 does the 6x6 solve and the SE(3) update. The
// AA update is thread 0's too: two twist logs, a 3x3 solve and one exp per
// iteration, a few hundred flops beside the matcher's NQ x NR pair
// evaluations, which still bound the kernel. Blocks share nothing, so a
// batch of B registrations is B independent blocks (the fleet launches 16
// and 128); scratch and outputs are indexed by blockIdx.x alone.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rowmath.cuh"

namespace {

constexpr int NT = 512;
constexpr int PPT = 4;
constexpr int CHUNK = NT * PPT;
constexpr int TILE = NT;
constexpr int MAXL = 8;
constexpr int MAXM = 4;  // Anderson window
constexpr float MIN_SUPPORT = 6.0f;
constexpr int SCR = 10;  // per point: pp[3], q[3], n[3], d2

struct Shared {
  float4 pos[TILE];   // x, y, z, |r|^2 (inf when masked)
  float4 nrm[TILE];   // nx, ny, nz, 0
  float T[16];
  float red[32 * 29];
  float sums[29];
  int ired[33];
  int flag;
};

struct Problem {
  const float* rd;     // [NQ, 3]
  const bool* rdm;     // [NQ]
  int nq;
  const float* ref;    // [NR, 3]
  const float* nrm;    // [NR, 3]
  const bool* refm;    // [NR]
  int nr;
  float* scr;          // [NQ, SCR]
  float trans_eps, rot_eps, trim, maxd2;
  int p2plane, max_it, coarse_it, L, aa_m;
};

__device__ __forceinline__ float sqn(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Match the n points rd[0], rd[stride], ... at the transform in sh.T and
// write pp, matched point/normal and the direct d2 (inf = no hit) to
// scratch slot i.
__device__ void match(const Problem& P, Shared& sh, int stride, int n) {
  const int tid = threadIdx.x;
  const float* T = sh.T;
  for (int base = 0; base < n; base += CHUNK) {
    float px[PPT], py[PPT], pz[PPT], psq[PPT], best[PPT], cnt[PPT];
    float s[PPT][6];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      int i = base + k * NT + tid;
      float x = 0.f, y = 0.f, z = 0.f;
      if (i < n) {
        const float* p = P.rd + 3 * (size_t)(i * stride);
        x = p[0]; y = p[1]; z = p[2];
      }
      px[k] = __fadd_rn(fmaf(T[2], z, fmaf(T[1], y, __fmul_rn(T[0], x))), T[3]);
      py[k] = __fadd_rn(fmaf(T[6], z, fmaf(T[5], y, __fmul_rn(T[4], x))), T[7]);
      pz[k] = __fadd_rn(fmaf(T[10], z, fmaf(T[9], y, __fmul_rn(T[8], x))),
                        T[11]);
      psq[k] = sqn(px[k], py[k], pz[k]);
      best[k] = INFINITY;
      cnt[k] = 0.f;
#pragma unroll
      for (int c = 0; c < 6; ++c) s[k][c] = 0.f;
    }
    for (int t0 = 0; t0 < P.nr; t0 += TILE) {
      __syncthreads();
      {
        int j = t0 + tid;
        float4 a = make_float4(0.f, 0.f, 0.f, INFINITY);
        float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < P.nr) {
          const float* r = P.ref + 3 * (size_t)j;
          const float* m = P.nrm + 3 * (size_t)j;
          a = make_float4(r[0], r[1], r[2],
                          P.refm[j] ? sqn(r[0], r[1], r[2]) : INFINITY);
          b = make_float4(m[0], m[1], m[2], 0.f);
        }
        sh.pos[tid] = a;
        sh.nrm[tid] = b;
      }
      __syncthreads();
      const int m = min(TILE, P.nr - t0);
      for (int j = 0; j < m; ++j) {
        const float4 a = sh.pos[j];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          float cross = fmaf(pz[k], a.z, fmaf(py[k], a.y, __fmul_rn(px[k], a.x)));
          float d2 = __fadd_rn(__fsub_rn(psq[k], __fmul_rn(2.f, cross)), a.w);
          if (d2 < best[k]) {
            const float4 b = sh.nrm[j];
            best[k] = d2; cnt[k] = 1.f;
            s[k][0] = a.x; s[k][1] = a.y; s[k][2] = a.z;
            s[k][3] = b.x; s[k][4] = b.y; s[k][5] = b.z;
          } else if (d2 == best[k] && d2 < INFINITY) {
            const float4 b = sh.nrm[j];
            cnt[k] += 1.f;
            s[k][0] += a.x; s[k][1] += a.y; s[k][2] += a.z;
            s[k][3] += b.x; s[k][4] += b.y; s[k][5] += b.z;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      int i = base + k * NT + tid;
      if (i >= n) continue;
      float c = fmaxf(cnt[k], 1.f);
      float q[3] = {s[k][0] / c, s[k][1] / c, s[k][2] / c};
      float nn[3] = {s[k][3] / c, s[k][4] / c, s[k][5] / c};
      bool hit = isfinite(best[k]) && P.rdm[i * stride];
      float d2 = hit ? sqn(__fsub_rn(px[k], q[0]), __fsub_rn(py[k], q[1]),
                           __fsub_rn(pz[k], q[2]))
                     : INFINITY;
      float* o = P.scr + (size_t)i * SCR;
      o[0] = px[k]; o[1] = py[k]; o[2] = pz[k];
      o[3] = q[0]; o[4] = q[1]; o[5] = q[2];
      o[6] = nn[0]; o[7] = nn[1]; o[8] = nn[2];
      o[9] = d2;
    }
  }
  __syncthreads();
}

// Threshold of the weights: the kth-smallest hit d2 (exact), or inf.
__device__ float trim_threshold(const Problem& P, Shared& sh, int n) {
  int c = 0;
  for (int i = threadIdx.x; i < n; i += NT)
    c += isfinite(P.scr[(size_t)i * SCR + 9]) ? 1 : 0;
  const int n_valid = pgs::block_count(c, sh.ired);
  if (P.trim < 0.f) return INFINITY;
  const float k_keep = ceilf(P.trim * (float)n_valid);
  if (k_keep < 1.f) return INFINITY;
  const int kk = (int)k_keep;
  uint32_t lo = 0u, hi = 0x7f800000u;  // count(d2 <= +inf) = n_valid >= k
  while (lo < hi) {
    uint32_t mid = lo + (hi - lo) / 2;
    int cc = 0;
    for (int i = threadIdx.x; i < n; i += NT) {
      float d2 = P.scr[(size_t)i * SCR + 9];
      cc += (isfinite(d2) && __float_as_uint(d2) <= mid) ? 1 : 0;
    }
    if (pgs::block_count(cc, sh.ired) >= kk) hi = mid; else lo = mid + 1;
  }
  return __uint_as_float(lo);
}

__device__ __forceinline__ float weight_of(const Problem& P, float d2,
                                           float thresh) {
  if (!isfinite(d2)) return 0.f;
  float w = (d2 <= thresh) ? 1.f : 0.f;
  if (P.maxd2 >= 0.f && !(d2 <= P.maxd2)) w = 0.f;
  return w;
}

// Point-to-plane moments into sh.sums: A (21 upper entries), b (6), ssr,
// wsum.
__device__ void p2plane_moments(const Problem& P, Shared& sh, int n,
                                float thresh) {
  float v[29];
#pragma unroll
  for (int k = 0; k < 29; ++k) v[k] = 0.f;
  for (int i = threadIdx.x; i < n; i += NT) {
    const float* o = P.scr + (size_t)i * SCR;
    float w = weight_of(P, o[9], thresh);
    if (w == 0.f) continue;
    float r = (o[6] * (o[0] - o[3]) + o[7] * (o[1] - o[4])) +
              o[8] * (o[2] - o[5]);
    float J[6] = {o[6], o[7], o[8], o[1] * o[8] - o[2] * o[7],
                  o[2] * o[6] - o[0] * o[8], o[0] * o[7] - o[1] * o[6]};
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b) v[k++] += w * J[a] * J[b];
#pragma unroll
    for (int a = 0; a < 6; ++a) v[21 + a] -= w * J[a] * r;
    v[27] += w * r * r;
    v[28] += w;
  }
  pgs::block_sum<29>(v, sh.red, sh.sums);
}

__device__ void unpack_A(const float* s, float* A) {
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) {
      A[6 * a + b] = s[k];
      A[6 * b + a] = s[k];
      ++k;
    }
}

// Point-to-point step: writes the 4x4 delta (thread 0 only).
__device__ void p2point_delta(const Problem& P, Shared& sh, int n,
                              float thresh, float* delta) {
  float v[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) v[k] = 0.f;
  for (int i = threadIdx.x; i < n; i += NT) {
    const float* o = P.scr + (size_t)i * SCR;
    float w = weight_of(P, o[9], thresh);
    if (w == 0.f) continue;
    v[0] += w;
#pragma unroll
    for (int c = 0; c < 3; ++c) { v[1 + c] += w * o[c]; v[4 + c] += w * o[3 + c]; }
  }
  pgs::block_sum<7>(v, sh.red, sh.sums);
  const float wsum_raw = sh.sums[0];
  const float wsum = fmaxf(wsum_raw, 1e-12f);
  float mup[3], muq[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mup[c] = sh.sums[1 + c] / wsum;
    muq[c] = sh.sums[4 + c] / wsum;
  }
  float g[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) g[k] = 0.f;
  for (int i = threadIdx.x; i < n; i += NT) {
    const float* o = P.scr + (size_t)i * SCR;
    float w = weight_of(P, o[9], thresh);
    if (w == 0.f) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        g[3 * a + b] += w * (o[3 + a] - muq[a]) * (o[b] - mup[b]);
  }
  pgs::block_sum<9>(g, sh.red, sh.sums);
  if (threadIdx.x == 0) {
    float G[9], R[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) G[k] = sh.sums[k];
    bool ok = wsum_raw >= MIN_SUPPORT && pgs::det3(G) > 1e-12f;
    pgs::polar3(G, R);
    for (int a = 0; a < 3; ++a) {
      float t = muq[a] - (R[3 * a] * mup[0] + R[3 * a + 1] * mup[1] +
                          R[3 * a + 2] * mup[2]);
      for (int b = 0; b < 3; ++b)
        delta[4 * a + b] = ok ? R[3 * a + b] : (a == b ? 1.f : 0.f);
      delta[4 * a + 3] = ok ? t : 0.f;
    }
    delta[12] = 0.f; delta[13] = 0.f; delta[14] = 0.f; delta[15] = 1.f;
  }
}

// Sum of a[i] * b[i], each product rounded and added left to right (the
// plain version's order, no contraction into FMAs).
__device__ __forceinline__ float dot_rn(const float* a, const float* b,
                                       int n) {
  float acc = __fmul_rn(a[0], b[0]);
  for (int i = 1; i < n; ++i) acc = __fadd_rn(acc, __fmul_rn(a[i], b[i]));
  return acc;
}

// The Anderson window of one stage (thread 0): newest twist first.
struct Anderson {
  float X[MAXM * 6], GX[MAXM * 6];
  float T0[16], Tinv0[16];
};

// Closed-form solve of the n x n (n <= 3) system A g = r, A row-major 3x3.
__device__ void solve_small(const float* A, const float* r, int n, float* g) {
  if (n == 1) {
    g[0] = r[0] / A[0];
  } else if (n == 2) {
    const float rdet =
        1.f / __fsub_rn(__fmul_rn(A[0], A[4]), __fmul_rn(A[1], A[3]));
    g[0] = __fmul_rn(__fsub_rn(__fmul_rn(A[4], r[0]), __fmul_rn(A[1], r[1])),
                     rdet);
    g[1] = __fmul_rn(__fsub_rn(__fmul_rn(A[0], r[1]), __fmul_rn(A[3], r[0])),
                     rdet);
  } else {
    float Ai[9];
    pgs::inv3(A, Ai);
    for (int i = 0; i < 3; ++i) g[i] = dot_rn(Ai + 3 * i, r, 3);
  }
}

// One AA update: from the current T and the plain step's T_plain, write
// T_new and the checker's translation and rotation sizes of T_new T^-1.
__device__ void anderson_update(Anderson& aa, int m, int it, const float* T,
                                const float* Tp, float* Tn, float* dt,
                                float* dr) {
  float M[16], xk[6], gk[6];
  pgs::mat4_mul(T, aa.Tinv0, M);
  pgs::se3_log(M, xk);
  pgs::mat4_mul(Tp, aa.Tinv0, M);
  pgs::se3_log(M, gk);
  for (int i = m - 1; i > 0; --i)
    for (int d = 0; d < 6; ++d) {
      aa.X[6 * i + d] = aa.X[6 * (i - 1) + d];
      aa.GX[6 * i + d] = aa.GX[6 * (i - 1) + d];
    }
  for (int d = 0; d < 6; ++d) { aa.X[d] = xk[d]; aa.GX[d] = gk[d]; }
  float Fr[MAXM][6], dF[MAXM - 1][6], dGt[6][MAXM - 1];
  for (int i = 0; i < m; ++i)
    for (int d = 0; d < 6; ++d)
      Fr[i][d] = __fsub_rn(aa.GX[6 * i + d], aa.X[6 * i + d]);
  const int n = m - 1;
  for (int i = 0; i < n; ++i)
    for (int d = 0; d < 6; ++d) {
      dF[i][d] = __fsub_rn(Fr[0][d], Fr[i + 1][d]);
      dGt[d][i] = __fsub_rn(aa.GX[d], aa.GX[6 * (i + 1) + d]);
    }
  float A[9], rhs[3], gamma[3];
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j)
      A[3 * i + j] = __fadd_rn(dot_rn(dF[i], dF[j], 6), i == j ? 1e-10f : 0.f);
    rhs[i] = dot_rn(dF[i], Fr[0], 6);
  }
  solve_small(A, rhs, n, gamma);
  float xacc[6], dp[6], da[6];
  for (int d = 0; d < 6; ++d) {
    xacc[d] = __fsub_rn(gk[d], dot_rn(gamma, dGt[d], n));
    dp[d] = __fsub_rn(gk[d], xk[d]);
    da[d] = __fsub_rn(xacc[d], gk[d]);
  }
  const float plain_sz = sqrtf(dot_rn(dp, dp, 6));
  const float acc_sz = sqrtf(dot_rn(da, da, 6));
  const bool ok = acc_sz <= __fadd_rn(__fmul_rn(2.f, plain_sz), 1e-9f) &&
                  it + 1 >= m;
  float xn[6], E[16], Ti[16], dT[16], dl[6];
  for (int d = 0; d < 6; ++d) xn[d] = ok ? xacc[d] : gk[d];
  pgs::se3_exp(xn, E);
  pgs::mat4_mul(E, aa.T0, Tn);
  pgs::se3_inv(T, Ti);
  pgs::mat4_mul(Tn, Ti, dT);
  pgs::se3_log(dT, dl);
  *dt = sqrtf(sqn(dT[3], dT[7], dT[11]));
  *dr = sqrtf(sqn(dl[3], dl[4], dl[5]));
}

// One stage of the iterate loop on reading[::stride]; updates sh.T.
__device__ int run_stage(const Problem& P, Shared& sh, int stride, int n,
                         int max_it, int* converged) {
  float dts[MAXL], drs[MAXL];  // meaningful in thread 0
#pragma unroll
  for (int k = 0; k < MAXL; ++k) { dts[k] = INFINITY; drs[k] = INFINITY; }
  int it = 0;
  Anderson aa;  // thread 0's, used when P.aa_m > 1
  if (threadIdx.x == 0) {
    sh.flag = 0;
    if (P.aa_m > 1) {
      for (int k = 0; k < 16; ++k) aa.T0[k] = sh.T[k];
      pgs::se3_inv(aa.T0, aa.Tinv0);
      for (int k = 0; k < MAXM * 6; ++k) { aa.X[k] = 0.f; aa.GX[k] = 0.f; }
    }
  }
  __syncthreads();
  while (it < max_it && !sh.flag) {
    match(P, sh, stride, n);
    float thresh = trim_threshold(P, sh, n);
    float delta[16], x[6];
    if (P.p2plane) {
      p2plane_moments(P, sh, n, thresh);
      if (threadIdx.x == 0) {
        const float wsum = sh.sums[28];
        float A[36], Ai[36];
        unpack_A(sh.sums, A);
        for (int a = 0; a < 6; ++a) A[7 * a] += 1e-6f;
        pgs::schur_inv6(A, Ai);
        for (int a = 0; a < 6; ++a) {
          float acc = 0.f;
          for (int b = 0; b < 6; ++b) acc += Ai[6 * a + b] * sh.sums[21 + b];
          x[a] = wsum >= MIN_SUPPORT ? acc : 0.f;
        }
        pgs::se3_exp(x, delta);
      }
    } else {
      p2point_delta(P, sh, n, thresh, delta);
      if (threadIdx.x == 0) pgs::se3_log(delta, x);
    }
    if (threadIdx.x == 0) {
      float dt, dr;
      if (P.aa_m > 1) {
        float Tp[16], Tn[16];
        pgs::mat4_mul(delta, sh.T, Tp);
        anderson_update(aa, P.aa_m, it, sh.T, Tp, Tn, &dt, &dr);
        for (int k = 0; k < 16; ++k) sh.T[k] = Tn[k];
      } else {
        pgs::mat4_mul(delta, sh.T, sh.T);
        dt = sqrtf(sqn(delta[3], delta[7], delta[11]));
        dr = sqrtf(sqn(x[3], x[4], x[5]));
      }
      for (int k = P.L - 1; k > 0; --k) { dts[k] = dts[k - 1]; drs[k] = drs[k - 1]; }
      dts[0] = dt;
      drs[0] = dr;
      float st = 0.f, sr = 0.f;
      for (int k = 0; k < P.L; ++k) { st += dts[k]; sr += drs[k]; }
      sh.flag = (st / (float)P.L < P.trans_eps) && (sr / (float)P.L < P.rot_eps);
    }
    __syncthreads();
    ++it;
  }
  *converged = sh.flag;
  __syncthreads();
  return it;
}

__global__ void __launch_bounds__(NT)
icp_fused_kernel(const float* __restrict__ reading, const bool* rdmask, int nq,
                 int coarse_div, const float* __restrict__ ref,
                 const float* __restrict__ nrm, const bool* refmask, int nr,
                 const float* __restrict__ T0, const float* params,
                 const int* iparams, float* scratch, float* out) {
  __shared__ Shared sh;
  const int b = blockIdx.x;
  Problem P;
  P.rd = reading + (size_t)b * nq * 3;
  P.rdm = rdmask + (size_t)b * nq;
  P.nq = nq;
  P.ref = ref + (size_t)b * nr * 3;
  P.nrm = nrm + (size_t)b * nr * 3;
  P.refm = refmask + (size_t)b * nr;
  P.nr = nr;
  P.scr = scratch + (size_t)b * nq * SCR;
  P.trans_eps = params[0];
  P.rot_eps = params[1];
  P.trim = params[2];
  P.maxd2 = params[3];
  P.p2plane = iparams[0];
  P.max_it = iparams[1];
  P.coarse_it = iparams[2];
  P.L = iparams[3];
  P.aa_m = iparams[4];
  if (threadIdx.x < 16) sh.T[threadIdx.x] = T0[(size_t)b * 16 + threadIdx.x];
  __syncthreads();

  int conv = 0;
  if (coarse_div > 1 && P.coarse_it > 0)
    run_stage(P, sh, coarse_div, (nq + coarse_div - 1) / coarse_div,
              P.coarse_it, &conv);
  const int iters = run_stage(P, sh, 1, nq, P.max_it, &conv);

  // Final introspection at the solution.
  match(P, sh, 1, nq);
  const float thresh = trim_threshold(P, sh, nq);
  int nvr = 0;
  for (int i = threadIdx.x; i < nq; i += NT) nvr += P.rdm[i] ? 1 : 0;
  const int n_valid_reading = pgs::block_count(nvr, sh.ired);
  float A[36], ssr, dof, wsum;
  if (P.p2plane) {
    p2plane_moments(P, sh, nq, thresh);
    unpack_A(sh.sums, A);
    ssr = sh.sums[27];
    wsum = sh.sums[28];
    dof = fmaxf(wsum - 6.f, 1.f);
  } else {
    // ssr, wsum, Sp[3], Spp[9]
    float v[14];
#pragma unroll
    for (int k = 0; k < 14; ++k) v[k] = 0.f;
    for (int i = threadIdx.x; i < nq; i += NT) {
      const float* o = P.scr + (size_t)i * SCR;
      float w = weight_of(P, o[9], thresh);
      if (w == 0.f) continue;
      v[0] += w * sqn(o[0] - o[3], o[1] - o[4], o[2] - o[5]);
      v[1] += w;
#pragma unroll
      for (int a = 0; a < 3; ++a) v[2 + a] += w * o[a];
      int k = 5;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) v[k++] += w * o[a] * o[c];
    }
    pgs::block_sum<14>(v, sh.red, sh.sums);
    ssr = sh.sums[0];
    wsum = sh.sums[1];
    const float* Sp = sh.sums + 2;
    const float* Spp = sh.sums + 5;
    const float tr = Spp[0] + Spp[4] + Spp[8];
    float hS[9];
    pgs::hat3(Sp, hS);
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c) {
        A[6 * a + c] = (a == c) ? wsum : 0.f;
        A[6 * a + c + 3] = -hS[3 * a + c];
        A[6 * (a + 3) + c] = -hS[3 * c + a];
        A[6 * (a + 3) + c + 3] = ((a == c) ? tr : 0.f) - Spp[3 * a + c];
      }
    dof = fmaxf(3.f * wsum - 6.f, 1.f);
  }
  if (threadIdx.x == 0) {
    float* o = out + (size_t)b * 56;
    for (int k = 0; k < 16; ++k) o[k] = sh.T[k];
    o[16] = (float)iters;
    o[17] = (float)conv;
    o[18] = wsum / fmaxf((float)n_valid_reading, 1.f);
    o[19] = ssr;
    for (int a = 0; a < 6; ++a) A[7 * a] += 1e-9f;
    float Ai[36];
    pgs::schur_inv6(A, Ai);
    const float sigma2 = ssr / dof;
    for (int k = 0; k < 36; ++k)
      o[20 + k] = sigma2 * Ai[k] + ((k % 7 == 0) ? 1e-12f : 0.f);
  }
}

}  // namespace

extern "C" int pgs_icp_fused(const float* reading, const bool* rdmask, int nq,
                             int coarse_div, const float* ref,
                             const float* nrm, const bool* refmask, int nr,
                             const float* T0, const float* params,
                             const int* iparams, float* scratch, float* out,
                             int batch, void* stream) {
  icp_fused_kernel<<<batch, NT, 0, (cudaStream_t)stream>>>(
      reading, rdmask, nq, coarse_div, ref, nrm, refmask, nr, T0, params,
      iparams, scratch, out);
  return (int)cudaGetLastError();
}
