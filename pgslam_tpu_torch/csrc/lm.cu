// K3: a whole Levenberg-Marquardt pose-graph optimize in one thread block.
//
// Replaces pgslam_tpu/optim/lm_pallas.py::lm_optimize_pallas (body
// _lm_kernel). The semantics are those of the port's plain version,
// pgslam_tpu_torch/optim/pgo.py::lm_optimize_plain (itself the port of
// pgo._optimize_xla):
//   residual   e = log(Z^-1 Xf^-1 Xt) per edge, information = cov^-1;
//   Jacobians  Jt = Jr^-1(e) (2nd order), Jf = -Jt Ad((Xf^-1 Xt)^-1);
//   robust     IRLS weights (huber / cauchy / gm) on robust-mask edges;
//   prior      prior_info * I on the fixed vertex (sigma = 1e-6 by default);
//   solve      block-Jacobi PCG on (H + lambda diag(D)) x = -b;
//   update     X <- X exp(x), accept if the cost drops, lambda down / up,
//              stop on a small step or a small relative decrease.
//
// Design: one block of NT threads. Threads stride over edges for the
// per-edge blocks (global scratch) and over vertices for the sums; each
// vertex gathers its edges through the CSR order the wrapper builds (its
// 'from' ends, then its 'to' ends, each in edge order), so every sum has a
// fixed order and repeated runs take the same decisions. Dot products are
// fixed-order block reductions; the LM scalars are uniform across the block.

#include <cuda_runtime.h>
#include <math.h>

#include "rowmath.cuh"

namespace {

constexpr int NT = 512;
// Scratch strides (floats); must match optim/lm.py.
constexpr int ES = 36 + 16 + 108 + 12 + 12;
constexpr int E_INFO = 0, E_ZINV = 36, E_HFF = 52, E_HTT = 88, E_HFT = 124,
              E_BF = 160, E_BT = 166, E_YF = 172, E_YT = 178;
constexpr int VS = 32 + 6 + 36 + 36 + 30;
constexpr int V_CUR = 0, V_CAND = 16, V_B = 32, V_D = 38, V_PINV = 74,
              V_X = 110, V_R = 116, V_Z = 122, V_P = 128, V_AP = 134;

struct Graph {
  int V, E, fixed;
  const bool* vmask;
  const int* ef;
  const int* et;
  const bool* emask;
  const bool* rmask;
  const int* ptr;
  const int* ent;
  float* es;   // edge scratch
  float* vs;   // vertex scratch
  float prior_info, robust_delta;
  int robust;
};

struct Shared {
  float red[32 * 4];
  float sums[4];
  float prior_Tinv[16];
  float prior_X0[16];
};

__device__ __forceinline__ int clampv(int v, int V) {
  return v < 0 ? 0 : (v >= V ? V - 1 : v);
}

// e = log(Zinv Xf^-1 Xt); also returns M = Xf^-1 Xt.
__device__ void edge_residual(const Graph& g, int e, int pose_off, float* err,
                              float* M) {
  const float* Xf = g.vs + (size_t)clampv(g.ef[e], g.V) * VS + pose_off;
  const float* Xt = g.vs + (size_t)clampv(g.et[e], g.V) * VS + pose_off;
  float Xfi[16], ZM[16];
  pgs::se3_inv(Xf, Xfi);
  pgs::mat4_mul(Xfi, Xt, M);
  pgs::mat4_mul(g.es + (size_t)e * ES + E_ZINV, M, ZM);
  pgs::se3_log(ZM, err);
}

__device__ float quad6(const float* e, const float* info) {
  float c = 0.f;
  for (int i = 0; i < 6; ++i) {
    float row = 0.f;
    for (int j = 0; j < 6; ++j) row += info[6 * i + j] * e[j];
    c += e[i] * row;
  }
  return c;
}

__device__ float robust_w(const Graph& g, int e, float chi2) {
  if (g.robust == 0 || !g.rmask[e]) return 1.f;
  const float d = g.robust_delta;
  if (g.robust == 1) return fminf(d / sqrtf(fmaxf(chi2, 1e-30f)), 1.f);
  if (g.robust == 2) return 1.f / (1.f + chi2 / (d * d));
  const float t = d * d / (d * d + chi2);
  return t * t;
}

__device__ float robust_rho(const Graph& g, int e, float chi2) {
  if (g.robust == 0 || !g.rmask[e]) return chi2;
  const float d = g.robust_delta;
  if (g.robust == 1) {
    const float r = sqrtf(fmaxf(chi2, 1e-30f));
    return r <= d ? chi2 : 2.f * d * r - d * d;
  }
  if (g.robust == 2) return d * d * log1pf(chi2 / (d * d));
  return d * d * chi2 / (d * d + chi2);
}

__device__ float prior_sq(const Graph& g, Shared& sh, int pose_off,
                          float* rp) {
  // log(X0^-1 X) as log(I + X0^-1 (X - X0)): exactly 0 at the anchor's
  // initial pose, so the 1e12 prior information does not amplify the fp32
  // rounding of X0^-1 X (see pgo.prior_residual).
  const float* X = g.vs + (size_t)g.fixed * VS + pose_off;
  float Dx[16], PX[16];
  for (int k = 0; k < 16; ++k) Dx[k] = X[k] - sh.prior_X0[k];
  pgs::mat4_mul(sh.prior_Tinv, Dx, PX);
  for (int k = 0; k < 16; k += 5) PX[k] += 1.f;
  pgs::se3_log(PX, rp);
  float s = 0.f;
  for (int i = 0; i < 6; ++i) s += rp[i] * rp[i];
  return s;
}

__device__ float cost_fn(const Graph& g, Shared& sh, int pose_off) {
  float v[1] = {0.f};
  for (int e = threadIdx.x; e < g.E; e += NT) {
    if (!g.emask[e]) continue;
    float err[6], M[16];
    edge_residual(g, e, pose_off, err, M);
    v[0] += robust_rho(g, e, quad6(err, g.es + (size_t)e * ES + E_INFO));
  }
  pgs::block_sum<1>(v, sh.red, sh.sums);
  float rp[6];
  return sh.sums[0] + g.prior_info * prior_sq(g, sh, pose_off, rp);
}

// Per-edge Hessian blocks and gradients at the current poses.
__device__ void build_edges(const Graph& g) {
  for (int e = threadIdx.x; e < g.E; e += NT) {
    float* s = g.es + (size_t)e * ES;
    float err[6], M[16], Mi[16], Ad[36], Jt[36], Jf[36], info[36];
    edge_residual(g, e, V_CUR, err, M);
    const float rw = robust_w(g, e, quad6(err, s + E_INFO));
    for (int k = 0; k < 36; ++k) info[k] = s[E_INFO + k] * rw;
    pgs::jr_inv(err, Jt);
    pgs::se3_inv(M, Mi);
    pgs::adjoint(Mi, Ad);
    pgs::mm6(Jt, Ad, Jf);
    for (int k = 0; k < 36; ++k) Jf[k] = -Jf[k];
    float JtO[36], JfO[36];
    pgs::mm6_tn(Jt, info, JtO);
    pgs::mm6_tn(Jf, info, JfO);
    pgs::mm6(JtO, Jt, s + E_HTT);
    pgs::mm6(JfO, Jf, s + E_HFF);
    pgs::mm6(JfO, Jt, s + E_HFT);
    for (int i = 0; i < 6; ++i) {
      float bf = 0.f, bt = 0.f;
      for (int j = 0; j < 6; ++j) {
        bf += JfO[6 * i + j] * err[j];
        bt += JtO[6 * i + j] * err[j];
      }
      s[E_BF + i] = bf;
      s[E_BT + i] = bt;
    }
  }
}

// out[0:n] = sum over v's 'from' ends of es[off_f] + sum over its 'to'
// ends of es[off_t], each in edge order.
template <int N>
__device__ void gather(const Graph& g, int v, int off_f, int off_t,
                       float* out) {
  float sf[N], st[N];
  for (int k = 0; k < N; ++k) { sf[k] = 0.f; st[k] = 0.f; }
  for (int q = g.ptr[v]; q < g.ptr[v + 1]; ++q) {
    const int code = g.ent[q];
    const float* s = g.es + (size_t)(code >> 1) * ES;
    if (code & 1)
      for (int k = 0; k < N; ++k) st[k] += s[off_t + k];
    else
      for (int k = 0; k < N; ++k) sf[k] += s[off_f + k];
  }
  for (int k = 0; k < N; ++k) out[k] = sf[k] + st[k];
}

// y = (H + prior + lam diag(D)) p at vertex v, into V_AP.
__device__ void edges_matvec(const Graph& g) {
  for (int e = threadIdx.x; e < g.E; e += NT) {
    float* s = g.es + (size_t)e * ES;
    const float* pf = g.vs + (size_t)clampv(g.ef[e], g.V) * VS + V_P;
    const float* pt = g.vs + (size_t)clampv(g.et[e], g.V) * VS + V_P;
    for (int i = 0; i < 6; ++i) {
      float yf = 0.f, yf2 = 0.f, yt = 0.f, yt2 = 0.f;
      for (int j = 0; j < 6; ++j) {
        yf += s[E_HFF + 6 * i + j] * pf[j];
        yf2 += s[E_HFT + 6 * i + j] * pt[j];
        yt += s[E_HTT + 6 * i + j] * pt[j];
        yt2 += s[E_HFT + 6 * j + i] * pf[j];
      }
      s[E_YF + i] = yf + yf2;
      s[E_YT + i] = yt + yt2;
    }
  }
}

__global__ void __launch_bounds__(NT)
lm_kernel(const float* __restrict__ poses, const bool* vmask, int V,
          const int* ef, const int* et, const float* __restrict__ edge_T,
          const float* __restrict__ cov, const bool* emask, const bool* rmask,
          int E, int fixed, const int* ptr, const int* ent,
          const float* params, const int* iparams, float* scratch,
          float* out_poses, float* out_stats) {
  __shared__ Shared sh;
  Graph g;
  g.V = V; g.E = E; g.fixed = fixed;
  g.vmask = vmask; g.ef = ef; g.et = et; g.emask = emask; g.rmask = rmask;
  g.ptr = ptr; g.ent = ent;
  g.es = scratch;
  g.vs = scratch + (size_t)E * ES;
  const float lambda_init = params[0], lambda_up = params[1],
              lambda_down = params[2];
  g.prior_info = params[3];
  const float min_step = params[4], min_dec = params[5], cg_tol = params[6];
  g.robust_delta = params[7];
  const int max_it = iparams[0], cg_it_max = iparams[1];
  g.robust = iparams[2];

  // Setup: poses, measurement inverses, information matrices.
  for (int v = threadIdx.x; v < V; v += NT)
    for (int k = 0; k < 16; ++k) g.vs[(size_t)v * VS + V_CUR + k] = poses[16 * (size_t)v + k];
  for (int e = threadIdx.x; e < E; e += NT) {
    float* s = g.es + (size_t)e * ES;
    pgs::se3_inv(edge_T + 16 * (size_t)e, s + E_ZINV);
    float C[36];
    for (int k = 0; k < 36; ++k)
      C[k] = emask[e] ? cov[36 * (size_t)e + k] : ((k % 7 == 0) ? 1.f : 0.f);
    pgs::schur_inv6(C, s + E_INFO);
    if (!emask[e])
      for (int k = 0; k < 36; ++k) s[E_INFO + k] = 0.f;
  }
  if (threadIdx.x == 0) pgs::se3_inv(poses + 16 * (size_t)fixed, sh.prior_Tinv);
  if (threadIdx.x < 16) sh.prior_X0[threadIdx.x] = poses[16 * (size_t)fixed + threadIdx.x];
  __syncthreads();

  float cost = cost_fn(g, sh, V_CUR);
  const float init_cost = cost;
  float lam = lambda_init;
  int it = 0;
  bool done = false;
  while (it < max_it && !done) {
    // Linear system at the current poses.
    build_edges(g);
    __syncthreads();
    for (int v = threadIdx.x; v < V; v += NT) {
      float* vv = g.vs + (size_t)v * VS;
      gather<6>(g, v, E_BF, E_BT, vv + V_B);
      gather<36>(g, v, E_HFF, E_HTT, vv + V_D);
      if (v == fixed) {
        float rp[6];
        prior_sq(g, sh, V_CUR, rp);
        for (int i = 0; i < 6; ++i) vv[V_B + i] += g.prior_info * rp[i];
        for (int i = 0; i < 6; ++i) vv[V_D + 7 * i] += g.prior_info;
      }
      // Block-Jacobi preconditioner and the PCG start (x = 0, r = -b).
      float P[36];
      for (int k = 0; k < 36; ++k) P[k] = vv[V_D + k];
      for (int i = 0; i < 6; ++i) P[7 * i] += lam * vv[V_D + 7 * i];
      if (!vmask[v])
        for (int k = 0; k < 36; ++k) P[k] = (k % 7 == 0) ? 1.f : 0.f;
      for (int i = 0; i < 6; ++i) P[7 * i] += 1e-10f;
      pgs::schur_inv6(P, vv + V_PINV);
      for (int i = 0; i < 6; ++i) {
        vv[V_X + i] = 0.f;
        vv[V_R + i] = -vv[V_B + i];
      }
      for (int i = 0; i < 6; ++i) {
        float z = 0.f;
        for (int j = 0; j < 6; ++j) z += vv[V_PINV + 6 * i + j] * vv[V_R + j];
        vv[V_Z + i] = z;
        vv[V_P + i] = z;
      }
    }
    float d2[2] = {0.f, 0.f};  // r.z, rhs.rhs
    for (int v = threadIdx.x; v < V; v += NT) {
      const float* vv = g.vs + (size_t)v * VS;
      for (int i = 0; i < 6; ++i) {
        d2[0] += vv[V_R + i] * vv[V_Z + i];
        d2[1] += vv[V_R + i] * vv[V_R + i];
      }
    }
    pgs::block_sum<2>(d2, sh.red, sh.sums);
    float rz = sh.sums[0];
    float rr = sh.sums[1];
    const float rhs_norm2 = fmaxf(rr, 1e-30f);
    int cg = 0;
    while (cg < cg_it_max && rr > cg_tol * rhs_norm2) {
      edges_matvec(g);
      __syncthreads();
      float pap[1] = {0.f};
      for (int v = threadIdx.x; v < V; v += NT) {
        float* vv = g.vs + (size_t)v * VS;
        float y[6];
        gather<6>(g, v, E_YF, E_YT, y);
        if (v == fixed)
          for (int i = 0; i < 6; ++i) y[i] += g.prior_info * vv[V_P + i];
        for (int i = 0; i < 6; ++i) {
          y[i] += lam * vv[V_D + 7 * i] * vv[V_P + i];
          vv[V_AP + i] = y[i];
          pap[0] += vv[V_P + i] * y[i];
        }
      }
      pgs::block_sum<1>(pap, sh.red, sh.sums);
      const float alpha = rz / fmaxf(sh.sums[0], 1e-30f);
      float acc[2] = {0.f, 0.f};  // r.z, r.r
      for (int v = threadIdx.x; v < V; v += NT) {
        float* vv = g.vs + (size_t)v * VS;
        for (int i = 0; i < 6; ++i) {
          vv[V_X + i] += alpha * vv[V_P + i];
          vv[V_R + i] -= alpha * vv[V_AP + i];
        }
        for (int i = 0; i < 6; ++i) {
          float z = 0.f;
          for (int j = 0; j < 6; ++j) z += vv[V_PINV + 6 * i + j] * vv[V_R + j];
          vv[V_Z + i] = z;
          acc[0] += vv[V_R + i] * z;
          acc[1] += vv[V_R + i] * vv[V_R + i];
        }
      }
      pgs::block_sum<2>(acc, sh.red, sh.sums);
      const float rz_new = sh.sums[0];
      rr = sh.sums[1];
      const float beta = rz_new / fmaxf(rz, 1e-30f);
      for (int v = threadIdx.x; v < V; v += NT) {
        float* vv = g.vs + (size_t)v * VS;
        for (int i = 0; i < 6; ++i) vv[V_P + i] = vv[V_Z + i] + beta * vv[V_P + i];
      }
      rz = rz_new;
      ++cg;
      __syncthreads();
    }
    // Candidate X exp(delta) and its cost.
    float sq[1] = {0.f};
    for (int v = threadIdx.x; v < V; v += NT) {
      float* vv = g.vs + (size_t)v * VS;
      float dl[6], Ex[16];
      for (int i = 0; i < 6; ++i) {
        dl[i] = vmask[v] ? vv[V_X + i] : 0.f;
        sq[0] += dl[i] * dl[i];
      }
      if (vmask[v]) {
        pgs::se3_exp(dl, Ex);
        pgs::mat4_mul(vv + V_CUR, Ex, vv + V_CAND);
      } else {
        for (int k = 0; k < 16; ++k) vv[V_CAND + k] = vv[V_CUR + k];
      }
    }
    pgs::block_sum<1>(sq, sh.red, sh.sums);
    const float step_norm = sqrtf(sh.sums[0]);
    const float new_cost = cost_fn(g, sh, V_CAND);
    const bool accept = new_cost < cost;
    const float rel = (cost - new_cost) / fmaxf(cost, 1e-30f);
    if (accept) {
      for (int v = threadIdx.x; v < V; v += NT)
        for (int k = 0; k < 16; ++k)
          g.vs[(size_t)v * VS + V_CUR + k] = g.vs[(size_t)v * VS + V_CAND + k];
      cost = new_cost;
      lam = lam * lambda_down;
      done = step_norm < min_step || rel < min_dec;
    } else {
      lam = lam * lambda_up;
    }
    lam = fminf(fmaxf(lam, 1e-12f), 1e10f);
    ++it;
    __syncthreads();
  }
  for (int v = threadIdx.x; v < V; v += NT)
    for (int k = 0; k < 16; ++k)
      out_poses[16 * (size_t)v + k] = g.vs[(size_t)v * VS + V_CUR + k];
  if (threadIdx.x == 0) {
    out_stats[0] = init_cost;
    out_stats[1] = cost;
    out_stats[2] = (float)it;
    out_stats[3] = lam;
  }
}

}  // namespace

extern "C" int pgs_lm(const float* poses, const bool* vmask, int V,
                      const int* ef, const int* et, const float* edge_T,
                      const float* cov, const bool* emask, const bool* rmask,
                      int E, int fixed, const int* ptr, const int* ent,
                      const float* params, const int* iparams, float* scratch,
                      float* out_poses, float* out_stats, void* stream) {
  lm_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      poses, vmask, V, ef, et, edge_T, cov, emask, rmask, E, fixed, ptr, ent,
      params, iparams, scratch, out_poses, out_stats);
  return (int)cudaGetLastError();
}
