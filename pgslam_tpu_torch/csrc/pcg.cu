// K4: the block-Jacobi PCG solve of one LM step, spread over the card.
//
// Replaces pgslam_tpu/optim/pcg_pallas.py::pcg_solve_pallas. Solves
//   (H + prior_info I_fixed + diag(damp)) x = -b
// from x = 0, with H applied matrix-free from the per-edge blocks H_ff,
// H_tt, H_ft (H_tf = H_ft^T) and z = P_inv r. It stops after max_it steps or
// once |r|^2 <= tol |b|^2, the stop test of the TPU kernel (whose later steps
// change nothing). Semantics are those of the plain version,
// pgslam_tpu_torch/optim/pgo.py::pcg_solve_plain; the order of operations
// is that of optim/pcg.py::pcg_solve_tiled.
//
// What bounds it: latency. One CG step at pgo_16k (V = 16384, E = 20479)
// touches about 17 MB of blocks and vectors and does about 8 MFLOP; the
// design it replaces read them again from global memory in every step,
// array-of-structs, through three grid barriers, on at most one thread
// per edge (8 of 132 SMs at pgo_1k).
//
// This design. CTA g owns a contiguous range of whole vertex tiles (TILE =
// 32 vertices, one warp) and, for each of its vertices, its incidence
// slots in the CSR order of optim/lm.py::edge_csr (each unmasked edge once
// at each end; optim/pcg.py::k4_layout splits the tiles by bytes). Its
// working set lives in its shared memory from the start of the launch to
// the end (struct Off):
//   per slot    this end's diagonal block (H_ff or H_tt) and the edge's
//               H_ft, each a 144-byte row copied with 16-byte cp.async
//               from [E, 36] into slot order; its product [6]; its far
//               end (CTA, local vertex) and its own vertex and side;
//   per vertex  P_inv (a 144-byte row, cp.async), and x, r, Ap, damping,
//               z and p (double-buffered) as structure-of-arrays.
// A CG step is vertex-centric and takes two barriers over all CTAs:
//   1  each slot forms p = z + beta p_prev at both ends (the far end's z and
//      p_prev from its own CTA, through distributed shared memory inside
//      the cluster, or from the copy its owner publishes in global memory
//      for other clusters), y = D_s p_own + O_s p_far with O_s = H_ft at
//      the from end and H_ft^T at the to end; each vertex stores its p,
//      sums its slots' y in CSR order, adds the prior and the damping: Ap,
//      and p.Ap;                                             barrier;
//   2  each vertex: x += alpha p, r -= alpha Ap, z = P_inv r; r.z, r.r;
//                                                            barrier.
// The double-buffered p lets step k+1 write p while no CTA can still read
// step k's (read before the first barrier of step k, written after the
// second). Dot products: each vertex sums its six terms in order, a warp
// tree sums each tile (shfl_down 16, 8, 4, 2, 1), the tile partials go to
// global memory, and after the barrier every CTA adds them in one fixed
// order (totals: a warp tree over each group of 32 tiles, the groups l,
// l + 32, ... in order in lane l, a warp tree over the lanes). So alpha,
// beta and the stop test are bitwise equal in every CTA, and x is the same
// at every CTA count, cluster size, barrier and placement. No float
// atomics.
//
// Barriers (optim/pcg.py::BARRIERS): "grid" is cooperative_groups'
// grid.sync() of a cooperative launch; "cluster" is a cluster barrier,
// then one arrival per cluster on a global word whose top bit the
// arrivals flip, then a second cluster barrier (all_sync). A single
// cluster takes the cluster barrier alone.
// Every CTA must be resident at once: the wrapper asks pgs_pcg_resident
// and raises before it launches a layout that would not be.
//
// Where the working set exceeds the card's shared memory, the same code
// keeps each CTA's arrays in a global scratch slice of the same layout
// (in_smem = 0) and reads other CTAs' z and p from their slices.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cgrp = cooperative_groups;

namespace {

constexpr int NT = 512;  // must match optim/pcg.py
constexpr int TILE = 32;
constexpr int MAX_CLUSTER = 16;
constexpr int LOC_SHIFT = 20;  // a slot's far end: CTA << 20 | local vertex
constexpr int LOC_MASK = (1 << LOC_SHIFT) - 1;
constexpr int NWARP = NT / 32;
static_assert(32 % NWARP == 0, "the second level of the sums maps warps onto lanes");
constexpr int BARRIER_GRID = 0, BARRIER_CLUSTER = 1;
// Kinds of tile partials: p.Ap, r.z, r.r.
constexpr int K_PAP = 0, K_RZ = 1, K_RR = 2;

struct Args {
  const float* Hff;    // [E, 36]
  const float* Htt;
  const float* Hft;
  const float* Pinv;   // [V, 36]
  const float* damp;   // [V, 6]
  const float* b;      // [V, 6]
  const float* prior;  // [1]
  const int* ptr;      // [V + 1], CSR order
  const int* ent;      // [2E], 2 * edge + side
  const int* meta;     // vstart [G + 1], far [S], own [S]
  int V, G, C, NV, NS, in_smem, publish, fixed, max_it, ntiles;
  float tol;
  float* part;         // [3, ntiles]: p.Ap, r.z, r.r tile partials
  unsigned* bar;       // [1]: the cluster barrier's arrivals
  float* gpub;         // [G, 18 NV]: each CTA's z, p0, p1 (publish)
  float* gwork;        // [G, words]: the working sets (in_smem == 0)
  float* x;            // [V, 6] out
  int* steps;          // [1] out
  unsigned long long* total;  // [1]: every launch adds its steps
};

// Offsets in one CTA's working set, in 4-byte words, for vertex stride NV
// (a multiple of TILE) and slot stride NS (a multiple of 4). The blocks
// are rows of 36 floats (16-byte aligned: cp.async targets, read as
// float4); the vectors are structure-of-arrays [6][NV]. Z, P0 and P1 are
// consecutive, as in the published copy. Must match
// optim/pcg.py::cta_words.
struct Off {
  int NV, NS, HD, HO, PINV, X, R, AP, DAMP, Z, P, Y, FAR, OWN, VPTR, words;
  __host__ __device__ Off(int NV_, int NS_) : NV(NV_), NS(NS_) {
    HD = 0;
    HO = 36 * NS;
    PINV = 72 * NS;
    X = PINV + 36 * NV;
    R = X + 6 * NV;
    AP = R + 6 * NV;
    DAMP = AP + 6 * NV;
    Z = DAMP + 6 * NV;
    P = Z + 6 * NV;  // two buffers of 6 * NV
    Y = P + 12 * NV;
    FAR = Y + 6 * NS;
    OWN = FAR + NS;
    VPTR = OWN + NS;
    words = VPTR + NV + 4;
  }
};

struct Shared {
  const float* zp[MAX_CLUSTER];  // each cluster rank's z (then p0, p1)
  float lanes[3][32];            // per kind, the second level's lane sums
};

// A load of data another CTA wrote during this launch: global memory is
// read through L2 (its L1 lines may be stale), shared memory directly.
__device__ __forceinline__ float ld_other(const float* p, bool global) {
  return global ? __ldcg(p) : *p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

// 16 bytes of a block row into the working set: cp.async into shared
// memory, or a plain copy into the global slice.
__device__ __forceinline__ void copy_chunk(float* dst, const float* src,
                                           bool in_smem) {
  if (in_smem)
    cp_async16(dst, src);
  else
    *reinterpret_cast<float4*>(dst) = __ldg(reinterpret_cast<const float4*>(src));
}

// The warp tree of a tile: lane 0 gets the sum of the 32 lanes' values.
__device__ __forceinline__ float tile_tree(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ unsigned ld_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

// All CTAs of the launch meet here; what each wrote before is visible to
// every other after. "cluster": a cluster barrier, then rank 0 of each
// cluster adds to a global word (CTA 0 adds 2^31 - (clusters - 1), the
// others 1, so each barrier flips its top bit and leaves the rest as it
// was, across launches too) and waits for the flip, then a second cluster
// barrier releases the cluster.
template <int BARRIER>
__device__ __forceinline__ void all_sync(const Args& a,
                                         cgrp::cluster_group& cl) {
  if (BARRIER == BARRIER_GRID) {
    cgrp::this_grid().sync();
    return;
  }
  cl.sync();
  const unsigned nclusters = (unsigned)(a.G / a.C);
  if (nclusters == 1) return;
  if (cl.block_rank() == 0 && threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (nclusters - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(a.bar, add);
    while (((old ^ ld_volatile(a.bar)) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  cl.sync();
}

// A warp's tile partials v[k] (valid in lane 0) of kinds kind..kind+N-1 for
// tile t.
template <int N>
__device__ __forceinline__ void put_tiles(const Args& a, int kind, int t,
                                          const float* v) {
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) a.part[(size_t)(kind + k) * a.ntiles + t] = v[k];
}

// After the barrier, every CTA's tile partials of kinds kind..kind+N-1
// summed in a fixed order: group j of 32 tiles is the warp tree of its
// partials (warp j mod NWARP reads it), lane l of the second level adds
// groups l, l + 32, ... in order, and the warp tree of the 32 lane sums is
// the total, which every warp takes, so every thread of every CTA gets the
// same bits in out.
template <int BARRIER, int N>
__device__ __forceinline__ void totals(const Args& a, cgrp::cluster_group& cl,
                                       int kind, Shared& sh, float* out) {
  all_sync<BARRIER>(a, cl);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ngroups = (a.ntiles + 31) / 32;
  // Warp w feeds the lane sums w + NWARP m, m < SLOTS: group j adds to
  // lane j mod 32.
  constexpr int SLOTS = 32 / NWARP;
  float sum[SLOTS][N];
#pragma unroll
  for (int m = 0; m < SLOTS; ++m)
#pragma unroll
    for (int k = 0; k < N; ++k) sum[m][k] = 0.f;
  for (int j0 = warp; j0 < ngroups; j0 += 32)
#pragma unroll
    for (int m = 0; m < SLOTS; ++m) {
      const int j = j0 + NWARP * m;
      if (j >= ngroups) break;
      const int t = 32 * j + lane;
      float v[N];
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = 0.f;
      if (t < a.ntiles)
#pragma unroll
        for (int k = 0; k < N; ++k)
          v[k] = __ldcg(a.part + (size_t)(kind + k) * a.ntiles + t);
#pragma unroll
      for (int k = 0; k < N; ++k) sum[m][k] += tile_tree(v[k]);
    }
  if (lane == 0)
#pragma unroll
    for (int m = 0; m < SLOTS; ++m)
#pragma unroll
      for (int k = 0; k < N; ++k) sh.lanes[kind + k][warp + NWARP * m] = sum[m][k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k)
    out[k] = __shfl_sync(0xffffffffu, tile_tree(sh.lanes[kind + k][lane]), 0);
}

// z = P_inv r for the vertex whose P_inv row starts at P (rows read two at
// a time as float4), each entry a sum over its six terms in order.
__device__ __forceinline__ void precondition(const float* P, const float* r,
                                             float* z) {
  const float4* P4 = reinterpret_cast<const float4*>(P);
#pragma unroll
  for (int i = 0; i < 6; i += 2) {
    float row[12];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 v = P4[3 * (i / 2) + q];
      row[4 * q] = v.x;
      row[4 * q + 1] = v.y;
      row[4 * q + 2] = v.z;
      row[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) acc += row[6 * h + j] * r[j];
      z[i + h] = acc;
    }
  }
}

template <int BARRIER>
__global__ void __launch_bounds__(NT, 1) pcg_kernel(Args a) {
  __shared__ Shared sh;
  extern __shared__ float4 dyn4[];
  cgrp::cluster_group cl = cgrp::this_cluster();
  const int g = blockIdx.x;
  const bool in_smem = a.in_smem != 0;
  const int v0 = a.meta[g];
  const int nv = a.meta[g + 1] - v0;
  const int s0 = a.ptr[v0];
  const int ns = a.ptr[v0 + nv] - s0;
  const int nvt = (nv + TILE - 1) / TILE * TILE;
  const Off off(a.NV, a.NS);
  const int NV = off.NV, NS = off.NS;
  float* dyn = reinterpret_cast<float*>(dyn4);
  float* w = in_smem ? dyn : a.gwork + (size_t)g * off.words;
  const int* far_tab = a.meta + a.G + 1;
  const int* own_tab = far_tab + a.ptr[a.V];
  int* far = reinterpret_cast<int*>(w + off.FAR);
  int* own = reinterpret_cast<int*>(w + off.OWN);
  int* vptr = reinterpret_cast<int*>(w + off.VPTR);
  float* pub = a.publish ? a.gpub + (size_t)g * 18 * NV : nullptr;
  const int cluster0 = g - (int)cl.block_rank();
  if (in_smem && threadIdx.x < a.C)
    sh.zp[threadIdx.x] = cl.map_shared_rank(dyn + off.Z, (int)threadIdx.x);

  // Load: the slots' blocks and the vertices' P_inv rows (16-byte copies),
  // the slot tables, then the vectors.
  for (int c = threadIdx.x; c < 9 * ns; c += NT) {
    const int s = c / 9, q = 4 * (c - 9 * s);
    const int code = __ldg(a.ent + s0 + s);
    const size_t e = (size_t)(code >> 1);
    copy_chunk(w + off.HD + 36 * s + q, ((code & 1) ? a.Htt : a.Hff) + 36 * e + q,
               in_smem);
    copy_chunk(w + off.HO + 36 * s + q, a.Hft + 36 * e + q, in_smem);
  }
  for (int c = threadIdx.x; c < 9 * nv; c += NT) {
    const int i = c / 9, q = 4 * (c - 9 * i);
    copy_chunk(w + off.PINV + 36 * i + q, a.Pinv + 36 * (size_t)(v0 + i) + q,
               in_smem);
  }
  if (in_smem) asm volatile("cp.async.commit_group;" ::: "memory");
  for (int s = threadIdx.x; s < ns; s += NT) {
    far[s] = far_tab[s0 + s];
    own[s] = own_tab[s0 + s];
  }
  for (int i = threadIdx.x; i < NV + 4; i += NT)
    vptr[i] = a.ptr[v0 + (i < nv ? i : nv)] - s0;
  for (int i = threadIdx.x; i < nv; i += NT) {
    const size_t v = (size_t)(v0 + i);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float r = -a.b[6 * v + k];
      w[off.X + k * NV + i] = 0.f;
      w[off.R + k * NV + i] = r;
      w[off.DAMP + k * NV + i] = a.damp[6 * v + k];
      w[off.P + k * NV + i] = 0.f;  // p_prev of the first step
      if (pub) pub[6 * NV + k * NV + i] = 0.f;
    }
  }
  if (in_smem) asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // x = 0, r = -b, z = P_inv r; r.z and r.r by tiles.
  for (int i = threadIdx.x; i < nvt; i += NT) {
    float crz = 0.f, crr = 0.f;
    if (i < nv) {
      float r[6], z[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) r[k] = w[off.R + k * NV + i];
      precondition(w + off.PINV + 36 * i, r, z);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        w[off.Z + k * NV + i] = z[k];
        if (pub) pub[k * NV + i] = z[k];
        crz += r[k] * z[k];
        crr += r[k] * r[k];
      }
    }
    const float v[2] = {tile_tree(crz), tile_tree(crr)};
    put_tiles<2>(a, K_RZ, (v0 + i) / TILE, v);
  }
  float tot[2];
  totals<BARRIER, 2>(a, cl, K_RZ, sh, tot);
  float rz = tot[0], rr = tot[1];
  const float rhs_norm2 = fmaxf(rr, 1e-30f);
  const float prior = a.prior[0];
  float beta = 0.f;
  int it = 0;
  while (it < a.max_it && rr > a.tol * rhs_norm2) {
    const int prev = it & 1;
    const int P_prev = off.P + 6 * NV * prev;
    const int P_cur = off.P + 6 * NV * (prev ^ 1);
    // 1: each slot's product, then each vertex's sum; p.Ap by tiles.
    for (int s = threadIdx.x; s < ns; s += NT) {
      const int o = own[s];
      const int li = o >> 1;
      const bool to_end = o & 1;
      float po[6], pf[6];
#pragma unroll
      for (int j = 0; j < 6; ++j)
        po[j] = fmaf(beta, w[P_prev + j * NV + li], w[off.Z + j * NV + li]);
      const int loc = far[s];
      const int fc = loc >> LOC_SHIFT, fl = loc & LOC_MASK;
      const float* src;
      bool global = false;
      if (fc == g) {
        src = w + off.Z;
      } else if (in_smem && fc - cluster0 >= 0 && fc - cluster0 < a.C) {
        src = sh.zp[fc - cluster0];
      } else {
        src = in_smem ? a.gpub + (size_t)fc * 18 * NV
                      : a.gwork + (size_t)fc * off.words + off.Z;
        global = true;
      }
#pragma unroll
      for (int j = 0; j < 6; ++j)
        pf[j] = fmaf(beta, ld_other(src + (6 + 6 * prev) * NV + j * NV + fl, global),
                     ld_other(src + j * NV + fl, global));
      // y = D p_own + O p_far: D by rows; O by rows at the from end (O p)
      // and at the to end (O^T p, the rows weighted by p_far), each output
      // a sum over its six terms in order.
      const float4* D4 = reinterpret_cast<const float4*>(w + off.HD + 36 * s);
      const float4* O4 = reinterpret_cast<const float4*>(w + off.HO + 36 * s);
      float y1[6], yr[6], yc[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) yc[k] = 0.f;
#pragma unroll
      for (int i = 0; i < 6; i += 2) {
        float d[12], q[12];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const float4 dv = D4[3 * (i / 2) + m], ov = O4[3 * (i / 2) + m];
          d[4 * m] = dv.x; d[4 * m + 1] = dv.y; d[4 * m + 2] = dv.z; d[4 * m + 3] = dv.w;
          q[4 * m] = ov.x; q[4 * m + 1] = ov.y; q[4 * m + 2] = ov.z; q[4 * m + 3] = ov.w;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float acc = 0.f, acc2 = 0.f;
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            acc += d[6 * h + j] * po[j];
            acc2 += q[6 * h + j] * pf[j];
            yc[j] += q[6 * h + j] * pf[i + h];
          }
          y1[i + h] = acc;
          yr[i + h] = acc2;
        }
      }
#pragma unroll
      for (int k = 0; k < 6; ++k)
        w[off.Y + k * NS + s] = y1[k] + (to_end ? yc[k] : yr[k]);
    }
    __syncthreads();
    const float* Y = w + off.Y;
    for (int i = threadIdx.x; i < nvt; i += NT) {
      float c = 0.f;
      if (i < nv) {
        const bool fixed = v0 + i == a.fixed;
        float p[6], y[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          p[k] = fmaf(beta, w[P_prev + k * NV + i], w[off.Z + k * NV + i]);
          w[P_cur + k * NV + i] = p[k];
          if (pub) pub[(6 + 6 * (prev ^ 1)) * NV + k * NV + i] = p[k];
          y[k] = 0.f;
        }
        for (int s = vptr[i]; s < vptr[i + 1]; ++s)
#pragma unroll
          for (int k = 0; k < 6; ++k) y[k] += Y[k * NS + s];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          if (fixed) y[k] += prior * p[k];
          y[k] += w[off.DAMP + k * NV + i] * p[k];
          w[off.AP + k * NV + i] = y[k];
          c += p[k] * y[k];
        }
      }
      c = tile_tree(c);
      put_tiles<1>(a, K_PAP, (v0 + i) / TILE, &c);
    }
    totals<BARRIER, 1>(a, cl, K_PAP, sh, tot);
    const float alpha = rz / fmaxf(tot[0], 1e-30f);
    // 2: x, r, z; r.z and r.r by tiles.
    for (int i = threadIdx.x; i < nvt; i += NT) {
      float crz = 0.f, crr = 0.f;
      if (i < nv) {
        float r[6], z[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          w[off.X + k * NV + i] += alpha * w[P_cur + k * NV + i];
          r[k] = w[off.R + k * NV + i] - alpha * w[off.AP + k * NV + i];
          w[off.R + k * NV + i] = r[k];
        }
        precondition(w + off.PINV + 36 * i, r, z);
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          w[off.Z + k * NV + i] = z[k];
          if (pub) pub[k * NV + i] = z[k];
          crz += r[k] * z[k];
          crr += r[k] * r[k];
        }
      }
      const float v[2] = {tile_tree(crz), tile_tree(crr)};
      put_tiles<2>(a, K_RZ, (v0 + i) / TILE, v);
    }
    totals<BARRIER, 2>(a, cl, K_RZ, sh, tot);
    beta = tot[0] / fmaxf(rz, 1e-30f);
    rz = tot[0];
    rr = tot[1];
    ++it;
  }
  for (int c = threadIdx.x; c < 6 * nv; c += NT) {
    const int i = c / 6, k = c - 6 * i;
    a.x[6 * (size_t)(v0 + i) + k] = w[off.X + k * NV + i];
  }
  if (g == 0 && threadIdx.x == 0) {
    a.steps[0] = it;
    atomicAdd(a.total, (unsigned long long)it);
  }
  // No CTA leaves while another may still read its shared memory.
  cl.sync();
}

const void* kernel_of(int barrier) {
  return barrier == BARRIER_GRID ? (const void*)pcg_kernel<BARRIER_GRID>
                                 : (const void*)pcg_kernel<BARRIER_CLUSTER>;
}

void set_cluster(cudaLaunchAttribute& attr, int C) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
}

}  // namespace

// out[0]: the dynamic shared memory a CTA may hold; out[1]: the SMs;
// out[2]: the largest cluster of which one schedules with that much per CTA.
// Sets both kernels' shared-memory and cluster-size attributes (once per
// device, from optim/pcg.py::device_limits).
extern "C" int pgs_pcg_limits(int* out) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int budget = optin;
  for (int b = 0; b < 2 && err == cudaSuccess; ++b) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel_of(b));
    if (err == cudaSuccess && optin - (int)fa.sharedSizeBytes < budget)
      budget = optin - (int)fa.sharedSizeBytes;
  }
  for (int b = 0; b < 2 && err == cudaSuccess; ++b) {
    err = cudaFuncSetAttribute(
        kernel_of(b), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel_of(b), cudaFuncAttributeMaxDynamicSharedMemorySize, budget);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = budget;
  out[1] = sms;
  out[2] = 0;
  for (int C = MAX_CLUSTER; C >= 1 && !out[2]; --C) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = budget;
    cudaLaunchAttribute attr[1];
    set_cluster(attr[0], C);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel_of(BARRIER_CLUSTER), &cfg) ==
            cudaSuccess &&
        n >= 1)
      out[2] = C;
    cudaGetLastError();
  }
  return (int)cudaGetLastError();
}

// out[0]: how many CTAs of NT threads with smem bytes of dynamic shared
// memory each, in clusters of C, the card holds at once.
extern "C" int pgs_pcg_resident(int G, int C, int smem, int barrier,
                                int* out) {
  cudaError_t err;
  int n = 0;
  if (C == 1) {
    int sms = 0, dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel_of(barrier), NT, smem);
    n *= sms;
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(G);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    set_cluster(attr[0], C);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&n, kernel_of(barrier), &cfg);
    n *= C;
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = n;
  return 0;
}

// One solve. meta: optim/pcg.py::slot_tables; scratch: optim/pcg.py::
// _scratch_words (tile partials at 0, the barrier words at bar_off, the
// published copies at pub_off, the global working sets at work_off);
// out: x [V, 6], then the step count (int); total: a running sum of the
// step counts (int64), added to. Returns cudaGetLastError() after the
// launch.
extern "C" int pgs_pcg(const float* Hff, const float* Htt, const float* Hft,
                       const float* Pinv, const float* damp, const float* b,
                       const float* prior, const int* ptr, const int* ent,
                       const int* meta, int V, int G, int C, int NV, int NS,
                       int smem, int in_smem, int barrier, int publish,
                       int fixed, int max_it, float tol, float* scratch,
                       int bar_off, int pub_off, int work_off, float* out,
                       unsigned long long* total, void* stream) {
  Args a;
  a.Hff = Hff; a.Htt = Htt; a.Hft = Hft; a.Pinv = Pinv; a.damp = damp;
  a.b = b; a.prior = prior; a.ptr = ptr; a.ent = ent; a.meta = meta;
  a.V = V; a.G = G; a.C = C; a.NV = NV; a.NS = NS; a.in_smem = in_smem;
  a.publish = publish; a.fixed = fixed; a.max_it = max_it;
  a.ntiles = (V + TILE - 1) / TILE;
  a.tol = tol;
  a.part = scratch;
  a.bar = reinterpret_cast<unsigned*>(scratch + bar_off);
  a.gpub = scratch + pub_off;
  a.gwork = scratch + work_off;
  a.x = out;
  a.steps = reinterpret_cast<int*>(out + 6 * (size_t)V);
  a.total = total;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[2];
  set_cluster(attr[0], C);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (barrier == BARRIER_GRID) {
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.numAttrs = 2;
    err = cudaLaunchKernelEx(&cfg, pcg_kernel<BARRIER_GRID>, a);
  } else {
    err = cudaLaunchKernelEx(&cfg, pcg_kernel<BARRIER_CLUSTER>, a);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
