// K3: a whole Levenberg-Marquardt pose-graph optimize in one thread-block
// cluster.
//
// Replaces pgslam_tpu/optim/lm_pallas.py::lm_optimize_pallas (body
// _lm_kernel). The semantics are those of the port's plain version,
// pgslam_tpu_torch/optim/pgo.py::lm_optimize_plain (itself the port of
// pgo._optimize_xla):
//   residual   e = log(Z^-1 Xf^-1 Xt) per edge, information = cov^-1;
//   Jacobians  Jt = Jr^-1(e) (2nd order), Jf = -Jt Ad((Xf^-1 Xt)^-1);
//   robust     IRLS weights (huber / cauchy / gm) on robust-mask edges;
//   prior      prior_info * I on the fixed vertex (sigma = 1e-6 by default),
//              residual log(I + X0^-1 (X - X0));
//   solve      block-Jacobi PCG on (H + lambda diag(D)) x = -b;
//   update     X <- X exp(x), accept if the cost drops, lambda down / up,
//              stop on a small step or a small relative decrease.
//
// What bounded the one-block design it replaces: latency. One 512-thread
// block on one SM of 132 ran every CG step through global scratch in an
// array-of-structs layout (184 floats per edge, 140 per vertex, so each
// warp load touched 32 lines), walked each vertex's edges one at a time,
// and took about eight block barriers per step: 59 us per CG step at 500
// poses + 500 edges, 15,000x its bound.
//
// This design: one problem per cluster of C CTAs (C = 1..16, chosen by the
// wrapper, optim/lm.py::cluster_layout, as the smallest cluster whose
// shared memory holds the working set and that gives each CTA at most
// NT incidence slots on average: with more, each thread runs several
// slots' products in every CG step one after another, and a larger
// cluster was faster on the H100 in spite of its wider reductions).
// CTA r owns a contiguous range of
// vertices and, for each, its incidence slots: every unmasked edge has one
// slot at each end. The CG working set lives in the owner's shared memory
// as structure-of-arrays (neighbouring threads, neighbouring words):
//   per vertex  D (the summed diagonal block) 36, P^-1 36, x r z 6 each,
//               p 2 x 6 (double-buffered), Ap 6             = 108 floats;
//   per slot    the off-diagonal 6x6 block oriented for this end, and
//               its product with the other end's p           = 42 floats.
// A CG step is vertex-centric: each slot forms the other end's direction
// p = z + beta p_prev from the owner's shared memory (distributed shared
// memory through the cluster), multiplies it by its block, and each
// vertex sums D p, its slots' products and the damping and prior. The
// double-buffered p lets the step run on two cluster barriers (after the
// p.Ap partials and after the r.z, r.r partials) and needs no per-edge
// scratch in global memory.
//
// Each edge is built at both of its ends rather than once and copied to
// the other end's CTA: every slot computes the edge's residual and
// Jacobians and keeps its own end's diagonal block, gradient and oriented
// off-diagonal block, so the build writes nothing to another CTA and each
// vertex sums its slots in one fixed order. The fixed per-edge data (Z^-1, the information matrix) and
// the per-iteration diagonal blocks and gradients, touched once per LM
// iteration, stay in a global per-CTA slice; poses (current and candidate)
// are global [V, 16] buffers, read through L2 (ld.global.cg).
//
// Scalars: each CTA writes its partial sums (warp tree, warps in order) to
// its own shared slot; after the cluster barrier every thread of every CTA
// adds the C slots in rank order. So alpha, beta, the CG stop test, the
// cost and every LM decision are bitwise equal in all CTAs (they leave
// every loop together) and a run repeats bit for bit. No float atomics.
// Each kind of partial has its own slot, and each slot is rewritten only
// after a later cluster barrier than the one its readers wait on.
//
// Where the working set does not fit the largest cluster that schedules,
// the same code runs with the per-CTA arrays in a global scratch slice
// (in_smem = 0), each CTA's slice laid out as its shared memory would be.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rowmath.cuh"

namespace cgrp = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int MAX_CLUSTER = 16;
// Offsets of the meta table (ints); must match optim/lm.py.
constexpr int META_CODE = 20;  // vstart[C + 1] comes first
// Per-slot global fields (floats, structure of arrays over NS slots).
constexpr int G_ZINV = 0, G_INFO = 16, G_DIAG = 52, G_B = 88, G_FIELDS = 94;
// The packed location of a slot's other end: rank << 24 | local vertex.
constexpr int LOC_SHIFT = 24;

struct Args {
  const float* poses;   // [V, 16] input
  const bool* vmask;    // [V]
  const int* ef;        // [E]
  const int* et;
  const float* edge_T;  // [E, 16]
  const float* cov;     // [E, 36]
  const bool* rmask;    // [E]
  const int* meta;      // vstart, code [C*NS], other [C*NS], vptr [C*(NV+4)]
  float* pose_buf;      // [2, V, 16]: current and candidate poses
  float* gslot;         // [C, G_FIELDS, NS]
  float* gwork;         // [C, work floats] when in_smem == 0
  float* out_poses;     // [V, 16]
  float* out_stats;     // [4]
  int V, fixed, C;
  int NV, NS;  // the largest strides over the CTAs (meta and global slices)
  int in_smem;
  float lambda_init, lambda_up, lambda_down, prior_info, min_step, min_dec,
      cg_tol, robust_delta;
  int max_it, cg_max, robust;
};

// A CTA's vertex or slot count rounded up to the stride of its arrays;
// must match optim/lm.py::_ceil4.
__host__ __device__ __forceinline__ int ceil4(int n) {
  return n < 4 ? 4 : (n + 3) / 4 * 4;
}

// Offsets in one CTA's working set (floats, then ints) for its own NV
// vertices and NS slots (strides, multiples of 4). Must match
// optim/lm.py::cta_bytes.
struct Off {
  int NV, NS, D, PINV, X, R, Z, P, AP, H, Y, OTHER, VPTR;
  __device__ Off(int NV_, int NS_) : NV(NV_), NS(NS_) {
    D = 0;
    PINV = 36 * NV;
    X = 72 * NV;
    R = 78 * NV;
    Z = 84 * NV;  // z and p are read by other CTAs at these offsets
    P = 90 * NV;  // two buffers of 6 * NV
    AP = 102 * NV;
    H = 108 * NV;
    Y = H + 36 * NS;
    OTHER = Y + 6 * NS;
    VPTR = OTHER + NS;
  }
};

struct Shared {
  float red[NWARP * 2];
  float part_pap[1];
  float part_rz[2];
  float part_sq[1];
  float part_cost[1];
  float X0[16];
  float X0inv[16];
  float* base[MAX_CLUSTER];  // each CTA's working set
  int nvs[MAX_CLUSTER];      // and its vertex stride
};

__device__ __forceinline__ int clampv(int v, int V) {
  return v < 0 ? 0 : (v >= V ? V - 1 : v);
}

// A load of data another CTA wrote during this launch (global memory is
// read through L2, shared memory through the cluster).
__device__ __forceinline__ float ld_shared_data(const float* p, bool in_smem) {
  return in_smem ? *p : __ldcg(p);
}

__device__ __forceinline__ void load_pose(const float* P, float* X) {
#pragma unroll
  for (int k = 0; k < 16; ++k) X[k] = __ldcg(P + k);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// This CTA's partial sums into its slot (warp tree, then warps in order),
// a cluster barrier, then the C slots added in rank order: every thread of
// every CTA gets the same bits.
template <int N>
__device__ void cluster_sum(cgrp::cluster_group& cl, Shared& sh,
                            const float* v, float* slot, int C, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float x = warp_sum(v[k]);
    if (lane == 0) sh.red[warp * N + k] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = 0.f;
      for (int w = 0; w < NWARP; ++w) s += sh.red[w * N + k];
      slot[k] = s;
    }
  cl.sync();
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = 0.f;
  for (int r = 0; r < C; ++r) {
    const float* s = cl.map_shared_rank(slot, r);
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] += s[k];
  }
}

// ---- 6x6 products, fully unrolled ----

__device__ __forceinline__ void mm6u(const float* A, const float* B,
                                     float* C) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += A[6 * i + k] * B[6 * k + j];
      C[6 * i + j] = acc;
    }
}

// C = A^T B.
__device__ __forceinline__ void mtm6u(const float* A, const float* B,
                                      float* C) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += A[6 * k + i] * B[6 * k + j];
      C[6 * i + j] = acc;
    }
}

__device__ __forceinline__ float quad6(const float* e, const float* info) {
  float c = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float row = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) row += info[6 * i + j] * e[j];
    c += e[i] * row;
  }
  return c;
}

__device__ float robust_w(const Args& a, int e, float chi2) {
  if (a.robust == 0 || !a.rmask[e]) return 1.f;
  const float d = a.robust_delta;
  if (a.robust == 1) return fminf(d / sqrtf(fmaxf(chi2, 1e-30f)), 1.f);
  if (a.robust == 2) return 1.f / (1.f + chi2 / (d * d));
  const float t = d * d / (d * d + chi2);
  return t * t;
}

__device__ float robust_rho(const Args& a, int e, float chi2) {
  if (a.robust == 0 || !a.rmask[e]) return chi2;
  const float d = a.robust_delta;
  if (a.robust == 1) {
    const float r = sqrtf(fmaxf(chi2, 1e-30f));
    return r <= d ? chi2 : 2.f * d * r - d * d;
  }
  if (a.robust == 2) return d * d * log1pf(chi2 / (d * d));
  return d * d * chi2 / (d * d + chi2);
}

// The anchor's prior residual log(I + X0^-1 (X - X0)): exactly 0 at the
// anchor's initial pose, so the 1e12 prior information does not amplify
// the fp32 rounding of X0^-1 X (see pgo.prior_residual). Returns |rp|^2.
__device__ float prior_residual(const Shared& sh, const float* Xg,
                                float* rp) {
  float X[16], Dx[16], PX[16];
  load_pose(Xg, X);
#pragma unroll
  for (int k = 0; k < 16; ++k) Dx[k] = X[k] - sh.X0[k];
  pgs::mat4_mul(sh.X0inv, Dx, PX);
#pragma unroll
  for (int k = 0; k < 16; k += 5) PX[k] += 1.f;
  pgs::se3_log(PX, rp);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) s += rp[i] * rp[i];
  return s;
}

// One CTA's view: its vertex range, its working set, its global slice.
struct Cta {
  int rank, v0, nv, ns;
  float* w;         // own working set (shared memory or global slice)
  float* gs;        // own global slot fields
  const int* code;  // own slot codes
};

// Residual of edge e at the poses in buffer P; returns M = Xf^-1 Xt.
__device__ void edge_residual(const Args& a, const Cta& c, int s, int e,
                              const float* P, float* err, float* M) {
  float Xf[16], Xt[16], Xfi[16], Z[16], ZM[16];
  load_pose(P + 16 * (size_t)clampv(a.ef[e], a.V), Xf);
  load_pose(P + 16 * (size_t)clampv(a.et[e], a.V), Xt);
  pgs::se3_inv(Xf, Xfi);
  pgs::mat4_mul(Xfi, Xt, M);
#pragma unroll
  for (int k = 0; k < 16; ++k) Z[k] = c.gs[(G_ZINV + k) * a.NS + s];
  pgs::mat4_mul(Z, M, ZM);
  pgs::se3_log(ZM, err);
}

__device__ __forceinline__ void load_info(const Args& a, const Cta& c, int s,
                                          float* O) {
#pragma unroll
  for (int k = 0; k < 36; ++k) O[k] = c.gs[(G_INFO + k) * a.NS + s];
}

// Slot s's end of its edge at the current poses: this end's diagonal block
// and gradient (global slice) and the off-diagonal block oriented for this
// end (working set): from end Jf^T O Jf, Jf^T O e, Jf^T O Jt; to end
// Jt^T O Jt, Jt^T O e, Jt^T O Jf.
__device__ void build_slot(const Args& a, const Cta& c, const Off& off,
                           int s, const float* cur) {
  const int code = c.code[s];
  const int e = code >> 1;
  const bool to_end = code & 1;
  float err[6], M[16], O[36];
  edge_residual(a, c, s, e, cur, err, M);
  load_info(a, c, s, O);
  const float rw = robust_w(a, e, quad6(err, O));
#pragma unroll
  for (int k = 0; k < 36; ++k) O[k] *= rw;
  float Jt[36], Jf[36], Mi[16], Ad[36];
  pgs::jr_inv(err, Jt);
  pgs::se3_inv(M, Mi);
  pgs::adjoint(Mi, Ad);
  mm6u(Jt, Ad, Jf);
  float own[36], oth[36];
#pragma unroll
  for (int k = 0; k < 36; ++k) {
    own[k] = to_end ? Jt[k] : -Jf[k];
    oth[k] = to_end ? -Jf[k] : Jt[k];
  }
  float JO[36], blk[36];
  mtm6u(own, O, JO);
  mm6u(JO, own, blk);
#pragma unroll
  for (int k = 0; k < 36; ++k) c.gs[(G_DIAG + k) * a.NS + s] = blk[k];
  mm6u(JO, oth, blk);
#pragma unroll
  for (int k = 0; k < 36; ++k) c.w[off.H + k * off.NS + s] = blk[k];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float b = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) b += JO[6 * i + j] * err[j];
    c.gs[(G_B + i) * a.NS + s] = b;
  }
}

// This CTA's share of the cost at the poses in buffer P: each edge once,
// at its 'from' slot.
__device__ float cost_partial(const Args& a, const Cta& c, const float* P) {
  float acc = 0.f;
  for (int s = threadIdx.x; s < c.ns; s += NT) {
    const int code = c.code[s];
    if (code & 1) continue;
    float err[6], M[16], O[36];
    edge_residual(a, c, s, code >> 1, P, err, M);
    load_info(a, c, s, O);
    acc += robust_rho(a, code >> 1, quad6(err, O));
  }
  return acc;
}

__device__ __forceinline__ float direction(float z, float p_prev,
                                           float beta) {
  return fmaf(beta, p_prev, z);
}

__global__ void __launch_bounds__(NT) lm_kernel(Args a) {
  __shared__ Shared sh;
  extern __shared__ float4 dyn4[];
  cgrp::cluster_group cl = cgrp::this_cluster();
  const int C = a.C, V = a.V;
  const bool in_smem = a.in_smem != 0;
  // Global slices are strided for the largest CTA.
  const int stride = 109 * a.NV + 43 * a.NS + 4;

  Cta c;
  c.rank = (int)cl.block_rank();
  c.v0 = a.meta[c.rank];
  c.nv = a.meta[c.rank + 1] - c.v0;
  c.code = a.meta + META_CODE + (size_t)c.rank * a.NS;
  const int* g_other =
      a.meta + META_CODE + (size_t)C * a.NS + (size_t)c.rank * a.NS;
  const int* g_vptr = a.meta + META_CODE + 2 * (size_t)C * a.NS +
                      (size_t)c.rank * (a.NV + 4);
  c.ns = g_vptr[c.nv];
  const Off off(ceil4(c.nv), ceil4(c.ns));
  const int NV = off.NV, NS = off.NS;
  float* dyn = reinterpret_cast<float*>(dyn4);
  if (threadIdx.x < C) {
    const int r = threadIdx.x;
    sh.base[r] = !in_smem ? a.gwork + (size_t)r * stride
                 : r == c.rank ? dyn : cl.map_shared_rank(dyn, r);
    sh.nvs[r] = ceil4(a.meta[r + 1] - a.meta[r]);
  }
  c.w = in_smem ? dyn : a.gwork + (size_t)c.rank * stride;
  c.gs = a.gslot + (size_t)c.rank * G_FIELDS * a.NS;
  int* other = reinterpret_cast<int*>(c.w + off.OTHER);
  int* vptr = reinterpret_cast<int*>(c.w + off.VPTR);
  for (int s = threadIdx.x; s < NS; s += NT) other[s] = s < c.ns ? g_other[s] : 0;
  for (int i = threadIdx.x; i < NV + 4; i += NT)
    vptr[i] = g_vptr[i <= c.nv ? i : c.nv];
  if (threadIdx.x < 16) sh.X0[threadIdx.x] = a.poses[16 * (size_t)a.fixed + threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) pgs::se3_inv(sh.X0, sh.X0inv);

  const float prior_info = a.prior_info;
  float* cur = a.pose_buf;
  float* cand = a.pose_buf + 16 * (size_t)V;
  // Setup: own poses into the current buffer; each slot's Z^-1 and
  // information (its own copy: the thread that writes it reads it).
  for (int i = threadIdx.x; i < c.nv; i += NT)
    for (int k = 0; k < 16; ++k)
      cur[16 * (size_t)(c.v0 + i) + k] = a.poses[16 * (size_t)(c.v0 + i) + k];
  for (int s = threadIdx.x; s < c.ns; s += NT) {
    const int e = c.code[s] >> 1;
    float Zi[16], info[36];
    pgs::se3_inv(a.edge_T + 16 * (size_t)e, Zi);
    pgs::schur_inv6(a.cov + 36 * (size_t)e, info);
    for (int k = 0; k < 16; ++k) c.gs[(G_ZINV + k) * a.NS + s] = Zi[k];
    for (int k = 0; k < 36; ++k) c.gs[(G_INFO + k) * a.NS + s] = info[k];
  }
  cl.sync();

  float tot[2];
  float part[2] = {cost_partial(a, c, cur), 0.f};
  cluster_sum<1>(cl, sh, part, sh.part_cost, C, tot);
  float rp[6];
  float cost = tot[0] + prior_info * prior_residual(sh, cur + 16 * (size_t)a.fixed, rp);
  const float init_cost = cost;
  float lam = a.lambda_init;
  int it = 0;
  bool done = false;
  float* w = c.w;
  while (it < a.max_it && !done) {
    // Linear system at the current poses: slots, then vertices.
    for (int s = threadIdx.x; s < c.ns; s += NT) build_slot(a, c, off, s, cur);
    __syncthreads();
    float d2[2] = {0.f, 0.f};  // r.z, r.r
    for (int i = threadIdx.x; i < c.nv; i += NT) {
      const int v = c.v0 + i;
      float Dv[36], bv[6];
#pragma unroll
      for (int k = 0; k < 36; ++k) Dv[k] = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) bv[k] = 0.f;
      for (int s = vptr[i]; s < vptr[i + 1]; ++s) {
#pragma unroll
        for (int k = 0; k < 36; ++k) Dv[k] += c.gs[(G_DIAG + k) * a.NS + s];
#pragma unroll
        for (int k = 0; k < 6; ++k) bv[k] += c.gs[(G_B + k) * a.NS + s];
      }
#pragma unroll
      for (int k = 0; k < 36; ++k) w[off.D + k * NV + i] = Dv[k];
      float P[36];
#pragma unroll
      for (int k = 0; k < 36; ++k) P[k] = Dv[k];
      if (v == a.fixed) {
        float r6[6];
        prior_residual(sh, cur + 16 * (size_t)v, r6);
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          bv[k] += prior_info * r6[k];
          P[7 * k] += prior_info;
        }
      }
      // Block-Jacobi preconditioner of the damped block and the PCG start
      // (x = 0, r = -b, p_prev = 0).
#pragma unroll
      for (int k = 0; k < 6; ++k) P[7 * k] += lam * P[7 * k];
      if (!a.vmask[v])
#pragma unroll
        for (int k = 0; k < 36; ++k) P[k] = (k % 7 == 0) ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) P[7 * k] += 1e-10f;
      float Pi[36];
      pgs::schur_inv6(P, Pi);
#pragma unroll
      for (int k = 0; k < 36; ++k) w[off.PINV + k * NV + i] = Pi[k];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        float z = 0.f;
#pragma unroll
        for (int j = 0; j < 6; ++j) z += Pi[6 * k + j] * -bv[j];
        w[off.X + k * NV + i] = 0.f;
        w[off.R + k * NV + i] = -bv[k];
        w[off.Z + k * NV + i] = z;
        w[off.P + k * NV + i] = 0.f;
        d2[0] += -bv[k] * z;
        d2[1] += bv[k] * bv[k];
      }
    }
    cluster_sum<2>(cl, sh, d2, sh.part_rz, C, tot);
    float rz = tot[0], rr = tot[1];
    const float rhs_norm2 = fmaxf(rr, 1e-30f);
    float beta = 0.f;
    int prev = 0, cg = 0;
    while (cg < a.cg_max && rr > a.cg_tol * rhs_norm2) {
      const int P_prev = off.P + 6 * NV * prev;
      const int P_cur = off.P + 6 * NV * (prev ^ 1);
      // Each slot: its block times the other end's direction (z and p at
      // the owner's offsets for its own vertex stride).
      for (int s = threadIdx.x; s < c.ns; s += NT) {
        const int loc = other[s];
        const int ro = loc >> LOC_SHIFT;
        const int nvo = sh.nvs[ro];
        const float* B = sh.base[ro] + (loc & ((1 << LOC_SHIFT) - 1));
        const float* Bz = B + 84 * nvo;
        const float* Bp = B + (90 + 6 * prev) * nvo;
        float po[6];
#pragma unroll
        for (int j = 0; j < 6; ++j)
          po[j] = direction(ld_shared_data(Bz + j * nvo, in_smem),
                            ld_shared_data(Bp + j * nvo, in_smem), beta);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          float y = 0.f;
#pragma unroll
          for (int j = 0; j < 6; ++j) y += w[off.H + (6 * i + j) * NS + s] * po[j];
          w[off.Y + i * NS + s] = y;
        }
      }
      __syncthreads();
      // Each vertex: Ap = D p + its slots' products + prior + damping.
      float pap[1] = {0.f};
      for (int i = threadIdx.x; i < c.nv; i += NT) {
        const bool fixed = c.v0 + i == a.fixed;
        float p[6], y[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          p[j] = direction(w[off.Z + j * NV + i], w[P_prev + j * NV + i], beta);
          w[P_cur + j * NV + i] = p[j];
        }
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < 6; ++j) acc += w[off.D + (6 * k + j) * NV + i] * p[j];
          y[k] = acc;
        }
        for (int s = vptr[i]; s < vptr[i + 1]; ++s)
#pragma unroll
          for (int k = 0; k < 6; ++k) y[k] += w[off.Y + k * NS + s];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          float dk = w[off.D + 7 * k * NV + i];
          if (fixed) {
            y[k] += prior_info * p[k];
            dk += prior_info;
          }
          y[k] += lam * dk * p[k];
          w[off.AP + k * NV + i] = y[k];
          pap[0] += p[k] * y[k];
        }
      }
      cluster_sum<1>(cl, sh, pap, sh.part_pap, C, tot);
      const float alpha = rz / fmaxf(tot[0], 1e-30f);
      float acc[2] = {0.f, 0.f};  // r.z, r.r
      for (int i = threadIdx.x; i < c.nv; i += NT) {
        float r[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          w[off.X + k * NV + i] += alpha * w[P_cur + k * NV + i];
          r[k] = w[off.R + k * NV + i] - alpha * w[off.AP + k * NV + i];
          w[off.R + k * NV + i] = r[k];
        }
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          float z = 0.f;
#pragma unroll
          for (int j = 0; j < 6; ++j) z += w[off.PINV + (6 * k + j) * NV + i] * r[j];
          w[off.Z + k * NV + i] = z;
          acc[0] += r[k] * z;
          acc[1] += r[k] * r[k];
        }
      }
      cluster_sum<2>(cl, sh, acc, sh.part_rz, C, tot);
      beta = tot[0] / fmaxf(rz, 1e-30f);
      rz = tot[0];
      rr = tot[1];
      prev ^= 1;
      ++cg;
    }
    // Candidate X exp(delta), the step norm and the candidate's cost.
    float sq = 0.f;
    for (int i = threadIdx.x; i < c.nv; i += NT) {
      const int v = c.v0 + i;
      const bool valid = a.vmask[v];
      float dl[6], X[16], Ex[16], Xn[16];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        dl[k] = valid ? w[off.X + k * NV + i] : 0.f;
        sq += dl[k] * dl[k];
      }
      load_pose(cur + 16 * (size_t)v, X);
      if (valid) {
        pgs::se3_exp(dl, Ex);
        pgs::mat4_mul(X, Ex, Xn);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) Xn[k] = X[k];
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) cand[16 * (size_t)v + k] = Xn[k];
    }
    part[0] = sq;
    cluster_sum<1>(cl, sh, part, sh.part_sq, C, tot);
    const float step_norm = sqrtf(tot[0]);
    part[0] = cost_partial(a, c, cand);
    cluster_sum<1>(cl, sh, part, sh.part_cost, C, tot);
    const float new_cost =
        tot[0] + prior_info * prior_residual(sh, cand + 16 * (size_t)a.fixed, rp);
    const bool accept = new_cost < cost;
    const float rel = (cost - new_cost) / fmaxf(cost, 1e-30f);
    if (accept) {
      float* t = cur;
      cur = cand;
      cand = t;
      cost = new_cost;
      lam = lam * a.lambda_down;
      done = step_norm < a.min_step || rel < a.min_dec;
    } else {
      lam = lam * a.lambda_up;
    }
    lam = fminf(fmaxf(lam, 1e-12f), 1e10f);
    ++it;
  }
  for (int i = threadIdx.x; i < c.nv; i += NT)
    for (int k = 0; k < 16; ++k)
      a.out_poses[16 * (size_t)(c.v0 + i) + k] = __ldcg(cur + 16 * (size_t)(c.v0 + i) + k);
  if (c.rank == 0 && threadIdx.x == 0) {
    a.out_stats[0] = init_cost;
    a.out_stats[1] = cost;
    a.out_stats[2] = (float)it;
    a.out_stats[3] = lam;
  }
  // No CTA leaves while another may still read its shared memory.
  cl.sync();
}

cudaError_t schedulable(int C, int smem, int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, (const void*)lm_kernel,
                                        &cfg);
}

// The largest cluster size in 1..16 of which at least one cluster with
// smem bytes of dynamic shared memory per CTA schedules; 0 if none.
int largest_cluster(int smem) {
  for (int C = MAX_CLUSTER; C >= 1; --C) {
    int n = 0;
    if (schedulable(C, smem, &n) == cudaSuccess && n >= 1) return C;
    cudaGetLastError();
  }
  return 0;
}

cudaError_t set_attributes(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      lm_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return err;
}

}  // namespace

// out[0]: the dynamic shared memory a CTA may hold; out[1]: the largest
// cluster that schedules with that much per CTA; out[2]: the largest that
// schedules with none (the global-memory placement).
extern "C" int pgs_lm_limits(int* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, lm_kernel);
  if (err != cudaSuccess) return (int)err;
  const int budget = optin - (int)fa.sharedSizeBytes;
  err = set_attributes(budget);
  if (err != cudaSuccess) return (int)err;
  out[0] = budget;
  out[1] = largest_cluster(budget);
  out[2] = largest_cluster(0);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch, or -2 when no cluster of C
// CTAs with this shared memory schedules.
// smem: the dynamic shared memory of each CTA, 0 for the global-scratch
// placement; NV, NS: the largest vertex and slot strides over the CTAs.
extern "C" int pgs_lm(const float* poses, const bool* vmask, int V,
                      const int* ef, const int* et, const float* edge_T,
                      const float* cov, const bool* rmask, int fixed,
                      const int* meta, int C, int NV, int NS, int smem,
                      const float* params, const int* iparams,
                      float* scratch, float* out_poses, float* out_stats,
                      void* stream) {
  cudaError_t err = set_attributes(smem);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  err = schedulable(C, smem, &clusters);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return -2;
  Args a;
  a.poses = poses; a.vmask = vmask; a.ef = ef; a.et = et; a.edge_T = edge_T;
  a.cov = cov; a.rmask = rmask; a.meta = meta;
  a.V = V; a.fixed = fixed; a.C = C; a.NV = NV; a.NS = NS;
  a.in_smem = smem > 0;
  a.pose_buf = scratch;
  a.gslot = scratch + 32 * (size_t)V;
  a.gwork = a.gslot + (size_t)C * G_FIELDS * NS;
  a.out_poses = out_poses;
  a.out_stats = out_stats;
  // Host copies of the scalars (params, iparams are host arrays).
  a.lambda_init = params[0]; a.lambda_up = params[1];
  a.lambda_down = params[2]; a.prior_info = params[3];
  a.min_step = params[4]; a.min_dec = params[5]; a.cg_tol = params[6];
  a.robust_delta = params[7];
  a.max_it = iparams[0]; a.cg_max = iparams[1]; a.robust = iparams[2];

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lm_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
