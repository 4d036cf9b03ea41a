// K4: the block-Jacobi PCG solve of one LM step, spread over the card.
//
// Replaces pgslam_tpu/optim/pcg_pallas.py::pcg_solve_pallas. Solves
//   (H + prior_info I_fixed + diag(damp)) x = -b
// from x = 0, with H applied matrix-free from the per-edge blocks H_ff,
// H_tt, H_ft (H_tf = H_ft^T) and z = P_inv r. It stops after max_it steps or
// once |r|^2 <= tol |b|^2, the stop test of the TPU kernel (whose later steps
// change nothing). Semantics and operation order are those of the plain
// version, pgslam_tpu_torch/optim/pgo.py::pcg_solve_plain.
//
// What bounds it: one CG step at V=1024 / E=2048 reads ~1.3 MB, ~0.4 us at
// 3.35 TB/s, and does ~0.8 MFLOP; the three grid barriers per step, not bytes
// or FLOPs, set its time. Design: one cooperative launch (the whole solve)
// of as many 256-thread blocks as are resident at once on the card, capped
// at one thread per edge or vertex; grid-stride loops over edges and
// vertices between cooperative_groups grid syncs. Per step:
//   A  each edge: yf = H_ff pf + H_ft pt, yt = H_tt pt + H_ft^T pf, with the
//      search direction p = z + beta p formed on the fly at both ends;
//   B  each vertex: stores its p, sums its edges' yf / yt in the CSR order
//      of optim/lm.py::edge_csr, adds prior and damping: Ap, and p.Ap;
//   C  each vertex: x += alpha p, r -= alpha Ap, z = P_inv r; r.z and r.r.
// No float atomics: each block writes its partial dot products to its own
// slot, and after the barrier every block sums all slots in the same fixed
// order, so the scalars (and the stop decision) are equal in every block and
// a solve repeats bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "rowmath.cuh"

namespace cgrp = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int MAX_GRID = 4096;  // partial-sum slots; must match optim/pcg.py

struct Args {
  const float* Hff;    // [E, 36]
  const float* Htt;
  const float* Hft;
  const float* Pinv;   // [V, 36]
  const float* damp;   // [V, 6]
  const float* b;      // [V, 6]
  const float* prior;  // [1]
  const int* ef;
  const int* et;
  const int* ptr;      // [V + 1]
  const int* ent;      // [2E], 2 * edge + side
  int V, E, fixed, max_it;
  float tol;
  float* x;            // [V, 6] output
  float* r;            // [V, 6] scratch, then z, p, Ap
  float* z;
  float* p;
  float* Ap;
  float* y;            // [E, 12]: yf, yt
  float* part;         // [3 * MAX_GRID]: p.Ap, then (r.z, r.r) pairs
  int* steps;          // [1]
};

__device__ __forceinline__ int clampv(int v, int V) {
  return v < 0 ? 0 : (v >= V ? V - 1 : v);
}

// The search direction at vertex v: z + beta p (p = 0 before the first step).
__device__ __forceinline__ void direction(const Args& a, int v, float beta,
                                          float* out) {
#pragma unroll
  for (int i = 0; i < 6; ++i) out[i] = a.z[6 * v + i] + beta * a.p[6 * v + i];
}

// Sum of the per-block partials [G, N] in a fixed order; every block gets
// the same values in sums[0:N].
template <int N>
__device__ void grid_total(const float* part, int G, float* red,
                           float* sums) {
  float v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = 0.f;
  for (int g = threadIdx.x; g < G; g += NT)
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += part[N * g + k];
  pgs::block_sum<N>(v, red, sums);
}

// z = P_inv r at vertex v; returns r.z and r.r in acc.
__device__ __forceinline__ void precondition(const Args& a, int v,
                                             const float* r, float* acc) {
  const float* P = a.Pinv + 36 * (size_t)v;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float z = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) z += P[6 * i + j] * r[j];
    a.z[6 * v + i] = z;
    acc[0] += r[i] * z;
    acc[1] += r[i] * r[i];
  }
}

__global__ void __launch_bounds__(NT) pcg_kernel(Args a) {
  __shared__ float red[32 * 2];
  __shared__ float sums[2];
  cgrp::grid_group grid = cgrp::this_grid();
  const int G = gridDim.x;
  const int first = blockIdx.x * NT + threadIdx.x, stride = G * NT;
  float* part_pap = a.part;
  float* part_rz = a.part + MAX_GRID;
  const float prior = a.prior[0];

  // x = 0, r = -b, z = P_inv r, p = 0.
  float acc[2] = {0.f, 0.f};
  for (int v = first; v < a.V; v += stride) {
    float r[6];
    for (int i = 0; i < 6; ++i) {
      r[i] = -a.b[6 * v + i];
      a.r[6 * v + i] = r[i];
      a.x[6 * v + i] = 0.f;
      a.p[6 * v + i] = 0.f;
    }
    precondition(a, v, r, acc);
  }
  pgs::block_sum<2>(acc, red, sums);
  if (threadIdx.x == 0) {
    part_rz[2 * blockIdx.x] = sums[0];
    part_rz[2 * blockIdx.x + 1] = sums[1];
  }
  grid.sync();
  grid_total<2>(part_rz, G, red, sums);
  float rz = sums[0], rr = sums[1];
  const float rhs_norm2 = fmaxf(rr, 1e-30f);
  float beta = 0.f;
  int it = 0;
  while (it < a.max_it && rr > a.tol * rhs_norm2) {
    // A: per-edge block products.
    for (int e = first; e < a.E; e += stride) {
      float pf[6], pt[6];
      direction(a, clampv(a.ef[e], a.V), beta, pf);
      direction(a, clampv(a.et[e], a.V), beta, pt);
      const float* Hff = a.Hff + 36 * (size_t)e;
      const float* Htt = a.Htt + 36 * (size_t)e;
      const float* Hft = a.Hft + 36 * (size_t)e;
      float* y = a.y + 12 * (size_t)e;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float yf = 0.f, yf2 = 0.f, yt = 0.f, yt2 = 0.f;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          yf += Hff[6 * i + j] * pf[j];
          yf2 += Hft[6 * i + j] * pt[j];
          yt += Htt[6 * i + j] * pt[j];
          yt2 += Hft[6 * j + i] * pf[j];
        }
        y[i] = yf + yf2;
        y[6 + i] = yt + yt2;
      }
    }
    grid.sync();
    // B: Ap = sum of the vertex's edge terms + prior + damping; p.Ap.
    float pap[1] = {0.f};
    for (int v = first; v < a.V; v += stride) {
      float pv[6], sf[6], st[6];
      direction(a, v, beta, pv);
      for (int i = 0; i < 6; ++i) {
        a.p[6 * v + i] = pv[i];
        sf[i] = 0.f;
        st[i] = 0.f;
      }
      for (int q = a.ptr[v]; q < a.ptr[v + 1]; ++q) {
        const int code = a.ent[q];
        const float* y = a.y + 12 * (size_t)(code >> 1);
        if (code & 1)
          for (int i = 0; i < 6; ++i) st[i] += y[6 + i];
        else
          for (int i = 0; i < 6; ++i) sf[i] += y[i];
      }
      for (int i = 0; i < 6; ++i) {
        float yv = sf[i] + st[i];
        if (v == a.fixed) yv += prior * pv[i];
        yv += a.damp[6 * v + i] * pv[i];
        a.Ap[6 * v + i] = yv;
        pap[0] += pv[i] * yv;
      }
    }
    pgs::block_sum<1>(pap, red, sums);
    if (threadIdx.x == 0) part_pap[blockIdx.x] = sums[0];
    grid.sync();
    grid_total<1>(part_pap, G, red, sums);
    const float alpha = rz / fmaxf(sums[0], 1e-30f);
    // C: x, r, z; r.z and r.r.
    acc[0] = 0.f;
    acc[1] = 0.f;
    for (int v = first; v < a.V; v += stride) {
      float r[6];
      for (int i = 0; i < 6; ++i) {
        a.x[6 * v + i] += alpha * a.p[6 * v + i];
        r[i] = a.r[6 * v + i] - alpha * a.Ap[6 * v + i];
        a.r[6 * v + i] = r[i];
      }
      precondition(a, v, r, acc);
    }
    pgs::block_sum<2>(acc, red, sums);
    if (threadIdx.x == 0) {
      part_rz[2 * blockIdx.x] = sums[0];
      part_rz[2 * blockIdx.x + 1] = sums[1];
    }
    grid.sync();
    grid_total<2>(part_rz, G, red, sums);
    beta = sums[0] / fmaxf(rz, 1e-30f);
    rz = sums[0];
    rr = sums[1];
    ++it;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) a.steps[0] = it;
}

}  // namespace

extern "C" int pgs_pcg(const float* Hff, const float* Htt, const float* Hft,
                       const float* Pinv, const float* damp, const float* b,
                       const float* prior, const int* ef, const int* et,
                       const int* ptr, const int* ent, int V, int E,
                       int fixed, int max_it, float tol, float* x,
                       float* scratch, int* grid_out, void* stream) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_kernel,
                                                        NT, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int need = ((V > E ? V : E) + NT - 1) / NT;
  int G = per_sm * sms;
  if (G > MAX_GRID) G = MAX_GRID;
  if (G > need) G = need;
  if (G < 1) G = 1;
  *grid_out = G;

  Args a;
  a.Hff = Hff; a.Htt = Htt; a.Hft = Hft; a.Pinv = Pinv; a.damp = damp;
  a.b = b; a.prior = prior; a.ef = ef; a.et = et; a.ptr = ptr; a.ent = ent;
  a.V = V; a.E = E; a.fixed = fixed; a.max_it = max_it; a.tol = tol;
  a.x = x;
  a.r = scratch;
  a.z = a.r + 6 * (size_t)V;
  a.p = a.z + 6 * (size_t)V;
  a.Ap = a.p + 6 * (size_t)V;
  a.y = a.Ap + 6 * (size_t)V;
  a.part = a.y + 12 * (size_t)E;
  a.steps = reinterpret_cast<int*>(a.part + 3 * MAX_GRID);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)pcg_kernel, dim3(G),
                                    dim3(NT), params, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
