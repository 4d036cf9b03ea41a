// K2: a whole ICP registration in one thread-block cluster.
//
// Replaces pgslam_tpu/ops/icp_pallas.py::fused_icp_register_prepped (body
// _icp_kernel). The semantics are those of the port's plain version,
// pgslam_tpu_torch/ops/icp_fused.py::fused_icp_register_plain:
//   match   exact 1-NN of the transformed reading by the expanded squared
//           distance; the matched point and normal are averaged over exact
//           ties of that distance;
//   weigh   hit mask, TrimmedDist threshold = the exact kth-smallest squared
//           distance, MaxDist;
//   step    point-to-plane: 6x6 normal equations + 1e-6 I, closed-form Schur
//           inverse; point-to-point: polar factor of the weighted
//           cross-covariance; identity step below MIN_SUPPORT;
//   check   iteration cap and the smoothed differential checker over a
//           window of L = smooth_length steps (any L);
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
// What bounds it on the H100: fp32 instruction issue in the matcher, NQ x NR
// (reading, map) pairs per iteration at ~7-10 instructions each, and at
// small batches the latency of each iteration's reductions. Bytes are
// negligible (an 8192-point map is 128 KB and is read once per launch).
//
// Design. One registration per cluster of C CTAs (C = 1, 2, 4, 8 or 16,
// chosen by the wrapper, ops/icp_fused.py::k2_layout, so that batch x C
// fills the card):
//   * points: the stage's reading points fall into chunks of CHUNK = 32
//     consecutive indices; chunk c belongs to CTA c % C. A warp matches up
//     to KMAX chunks at once (one point of each per lane) against one of S
//     contiguous slices of the map; only chunks that exist are evaluated.
//   * map: each CTA holds the map as float4 (x, y, z, |r|^2 or inf when
//     masked) in shared memory, loaded once per launch; a map too large for
//     the CTA's room streams through it in passes.
//   * the best match of each (point, slice) is the least expanded distance
//     (the same FMA chain wherever it is computed), the last index that
//     reached it, and the least distance before that index, which equals the
//     least when it was reached more than once: four ALU operations a pair
//     beside the distance's five, without branches. Slices merge by the
//     least d2 and the highest last index, exact in any order; equal least
//     distances from two slices are ties too. For a point with ties one warp
//     sums the points and normals in map order over [0, last], starting from
//     the first tie, in a second pass only for those points; any other point
//     takes map point last.
//   * per-point state (transformed point, matched point and normal, d2)
//     stays in the owner CTA's shared memory between the match and the
//     reductions; nothing per point goes to global memory.
//   * every weighted moment is summed in one fixed tree that depends on the
//     point index alone (cluster_reduce), so the bits are the same whatever
//     C, S or the batch: the order of 512 threads sweeping the points, the
//     order phase k2's limits were first measured in. The slot-chunk sums
//     are read across the cluster through distributed shared memory after a
//     cluster barrier and every CTA adds them itself: every CTA holds the
//     same scalars, and thread 0 of each CTA does the 6x6 solve, the SE(3)
//     update, the AA update and the checker redundantly, with no broadcast;
//     all CTAs leave the loop together. No float atomics.
//   * the TrimmedDist threshold is a radix select on the bit patterns of the
//     hit d2 (non-negative floats order as their bits): four passes of 8
//     bits, each a 256-bin integer histogram summed over the cluster, which
//     finds exactly the kth-smallest value.
//   * each cluster exchange uses one of two buffers in turn, and every
//     exchange holds one cluster barrier, so a buffer is rewritten only
//     after every CTA has passed the barrier that follows its last read.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rowmath.cuh"

namespace cgrp = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr int CHUNK = 32;    // points per chunk (one per lane)
constexpr int TREE = 512;    // slots of the moment tree
constexpr int NSLOT = TREE / CHUNK;
constexpr int KMAX = 8;      // chunks a warp matches at once
constexpr int MAX_CLUSTER = 16;
constexpr int MAXM = 4;      // Anderson window
constexpr int NSUM = 29;     // the widest moment vector
constexpr int HIST = 256;
constexpr int MISC_WORDS = 128;
constexpr int MIN_SLICE = 256;  // fewest map points a coarse slice takes
constexpr float MIN_SUPPORT = 6.0f;

// Per-point state, structure of arrays with stride pmax.
enum { PX, PY, PZ, QX, QY, QZ, NX, NY, NZ, D2, NFIELD };
// Shared integer scalars.
enum { FLAG, BIN, KK };

struct Args {
  const float* rd;     // [B, NQ, 3]
  const bool* rdm;     // [B, NQ]
  const float* ref;    // [B, NR, 3]
  const float* nrm;    // [B, NR, 3]
  const bool* refm;    // [B, NR]
  const float* T0;     // [B, 16]
  float* window;       // [B * C, 2L]: each CTA's checker windows
  float* out;          // [B, 56]
  int nq, nr, coarse_div;
  float trans_eps, rot_eps, trim, maxd2;
  int p2plane, max_it, coarse_it, L, aa_m;
  int C, S, map_cap, lcmax;
};

// Words of shared memory per CTA (ops/icp_fused.py::cta_bytes).
constexpr int XBUF_WORDS = NSUM * NSLOT > HIST ? NSUM * NSLOT : HIST;
__host__ __device__ long long cta_words(int map_cap, int lcmax, int S) {
  const long long pmax = (long long)lcmax * CHUNK;
  return 4LL * map_cap + (NFIELD + 3LL * S) * pmax + 2LL * XBUF_WORDS +
         HIST + MISC_WORDS;
}

struct Smem {
  float* st;     // [NFIELD][pmax]
  float* sbest;  // [S][pmax]: each slice's best d2 (slice 0: merged)
  float* sprev;  // [S][pmax]: the best d2 before the last index reached it
                 // (slice 0 after the merge: NaN marks a point with ties)
  int* slast;    // [S][pmax]
  float* xbuf[2];  // cluster exchanges: slot-chunk sums or a histogram
  int* htot;     // [HIST]
  float* T;      // [16]
  float* sums;   // [32]
  int* ired;     // [40]
  int* scal;     // [8]
};

struct Ctx {
  Args a;
  Smem s;
  const float* rd;
  const bool* rdm;
  const float* ref;
  const float* nrm;
  const bool* refm;
  float* win;
  int b, r, pmax, npasses, parity;
};

// One stage's geometry in this CTA: n points, nchunks chunks, lc of them
// this CTA's, matched against S map slices with staging rows of ss words.
// The fine stage takes the layout's S; the coarse stage, with fewer
// chunks, as many slices as fill the warps and the staging arrays.
struct Stage {
  int stride, n, nchunks, lc, S, ss;
};

__device__ Stage make_stage(const Ctx& x, int stride, int n) {
  Stage g;
  g.stride = stride;
  g.n = n;
  g.nchunks = (n + CHUNK - 1) / CHUNK;
  g.lc = g.nchunks > x.r ? (g.nchunks - x.r + x.a.C - 1) / x.a.C : 0;
  g.ss = max(1, g.lc) * CHUNK;
  if (stride == 1) {
    g.S = x.a.S;
  } else {
    const int units = max(1, (g.lc + KMAX - 1) / KMAX);
    g.S = max(1, min(min(NWARP / units, (x.a.S * x.pmax) / g.ss),
                     (x.a.nr + MIN_SLICE - 1) / MIN_SLICE));
  }
  return g;
}

// The stage index of this CTA's local point li.
__device__ __forceinline__ int global_index(const Ctx& x, int li) {
  return (x.r + (li / CHUNK) * x.a.C) * CHUNK + (li % CHUNK);
}

__device__ __forceinline__ float sqn(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ void transform(const float* T, float x, float y,
                                          float z, float& px, float& py,
                                          float& pz) {
  px = __fadd_rn(fmaf(T[2], z, fmaf(T[1], y, __fmul_rn(T[0], x))), T[3]);
  py = __fadd_rn(fmaf(T[6], z, fmaf(T[5], y, __fmul_rn(T[4], x))), T[7]);
  pz = __fadd_rn(fmaf(T[10], z, fmaf(T[9], y, __fmul_rn(T[8], x))), T[11]);
}

// Map point j as the matcher reads it: x, y, z, |r|^2 (inf when masked).
__device__ __forceinline__ float4 map_point(const Ctx& x, int j) {
  const float* r = x.ref + 3 * (size_t)j;
  const float a = r[0], b = r[1], c = r[2];
  return make_float4(a, b, c, x.refm[j] ? sqn(a, b, c) : INFINITY);
}

// The expanded squared distance |p|^2 - 2 p.r + |r|^2. 2 * cross is exact,
// so fmaf(-2, cross, psq) rounds as psq - 2 * cross does.
__device__ __forceinline__ float pair_d2(float px, float py, float pz,
                                         float psq, float4 a) {
  const float cross = fmaf(pz, a.z, fmaf(py, a.y, __fmul_rn(px, a.x)));
  return __fadd_rn(fmaf(-2.f, cross, psq), a.w);
}

__device__ void load_map(const Ctx& x, int j0, int m);

// ---- match ----

// The dynamic shared memory of a CTA; the map is its first map_cap float4.
extern __shared__ float4 k2_smem[];

// One map point against a lane's K points, without branches: the running
// least d2, the last index that reached it, and the least d2 before that
// index (equal to the least when it was reached more than once).
template <int K>
__device__ __forceinline__ void track(float4 a, int j, const float (&px)[K],
                                      const float (&py)[K],
                                      const float (&pz)[K],
                                      const float (&psq)[K], float (&best)[K],
                                      float (&prev)[K], int (&last)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float d2 = pair_d2(px[k], py[k], pz[k], psq[k], a);
    const bool le = d2 <= best[k];
    last[k] = le ? j : last[k];
    prev[k] = le ? best[k] : prev[k];
    best[k] = fminf(best[k], d2);
  }
}

// Warp work item: K chunks (unit u) against map slice sl of pass p. Lane l
// holds point l of each chunk; the running (d2, prev, last) of each point
// carries over passes in the slice's staging row.
template <int K>
__device__ void scan_item(const Ctx& x, const Stage& g, int u, int sl,
                          int p) {
  const int lane = threadIdx.x & 31;
  const int pm = x.pmax;
  float px[K], py[K], pz[K], psq[K], best[K], prev[K];
  int last[K];
  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = x.s.T[k];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int li = (u * KMAX + k) * CHUNK + lane;
    const int i = global_index(x, li);
    float a = 0.f, b = 0.f, c = 0.f;
    if (i < g.n) {
      const float* q = x.rd + 3 * (size_t)i * g.stride;
      a = q[0]; b = q[1]; c = q[2];
    }
    transform(T, a, b, c, px[k], py[k], pz[k]);
    psq[k] = sqn(px[k], py[k], pz[k]);
    if (sl == 0 && p == 0 && i < g.n) {
      x.s.st[PX * pm + li] = px[k];
      x.s.st[PY * pm + li] = py[k];
      x.s.st[PZ * pm + li] = pz[k];
    }
    if (p == 0) {
      best[k] = INFINITY; prev[k] = INFINITY; last[k] = -1;
    } else {
      best[k] = x.s.sbest[sl * g.ss + li];
      prev[k] = x.s.sprev[sl * g.ss + li];
      last[k] = x.s.slast[sl * g.ss + li];
    }
  }
  const int p0 = p * x.a.map_cap;
  const int m = min(x.a.map_cap, x.a.nr - p0);
  const int lo = p0 + (int)(((long long)sl * m) / g.S);
  const int hi = p0 + (int)(((long long)(sl + 1) * m) / g.S);
  const float4* mp = k2_smem - p0;
  int j = lo;
  for (; j + 2 <= hi; j += 2) {
    const float4 a0 = mp[j], a1 = mp[j + 1];
    track<K>(a0, j, px, py, pz, psq, best, prev, last);
    track<K>(a1, j + 1, px, py, pz, psq, best, prev, last);
  }
  if (j < hi) track<K>(mp[j], j, px, py, pz, psq, best, prev, last);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int li = (u * KMAX + k) * CHUNK + lane;
    x.s.sbest[sl * g.ss + li] = best[k];
    x.s.sprev[sl * g.ss + li] = prev[k];
    x.s.slast[sl * g.ss + li] = last[k];
  }
}

// The matched point and normal of local point li, and its d2 (inf unless
// a hit).
__device__ void finish_point(const Ctx& x, const Stage& g, int li, float best,
                             const float* q, const float* n) {
  const int pm = x.pmax;
  float* st = x.s.st;
  const int i = global_index(x, li);
  const bool hit = isfinite(best) && x.rdm[(size_t)i * g.stride];
  const float px = st[PX * pm + li], py = st[PY * pm + li],
              pz = st[PZ * pm + li];
  st[QX * pm + li] = q[0]; st[QY * pm + li] = q[1]; st[QZ * pm + li] = q[2];
  st[NX * pm + li] = n[0]; st[NY * pm + li] = n[1]; st[NZ * pm + li] = n[2];
  st[D2 * pm + li] = hit ? sqn(__fsub_rn(px, q[0]), __fsub_rn(py, q[1]),
                               __fsub_rn(pz, q[2]))
                         : INFINITY;
}

// Points and normals of a tied point's matches summed in map order over
// [0, last] (one warp), s starting from the first tie's values.
__device__ void tie_point(const Ctx& x, const Stage& g, int li) {
  const int lane = threadIdx.x & 31;
  const int pm = x.pmax;
  const float px = x.s.st[PX * pm + li], py = x.s.st[PY * pm + li],
              pz = x.s.st[PZ * pm + li];
  const float psq = sqn(px, py, pz);
  const float best = x.s.sbest[li];
  const int last = x.s.slast[li];
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, cnt = 0.f;
  for (int j0 = 0; j0 <= last; j0 += 32) {
    const int j = j0 + lane;
    const bool tie =
        j <= last && pair_d2(px, py, pz, psq, map_point(x, j)) == best;
    unsigned mask = __ballot_sync(0xffffffffu, tie);
    if (lane == 0)
      while (mask) {
        const int jj = j0 + __ffs(mask) - 1;
        mask &= mask - 1;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float r = x.ref[3 * (size_t)jj + c];
          const float n = x.nrm[3 * (size_t)jj + c];
          s[c] = cnt > 0.f ? s[c] + r : r;
          s[3 + c] = cnt > 0.f ? s[3 + c] + n : n;
        }
        cnt += 1.f;
      }
  }
  if (lane == 0) {
    const float q[3] = {s[0] / cnt, s[1] / cnt, s[2] / cnt};
    const float n[3] = {s[3] / cnt, s[4] / cnt, s[5] / cnt};
    finish_point(x, g, li, best, q, n);
  }
}

__device__ void match(const Ctx& x, const Stage& g) {
  const int warp = threadIdx.x >> 5;
  const int S = g.S, ss = g.ss;
  const int units = (g.lc + KMAX - 1) / KMAX;
  const int items = units * S;
  for (int p = 0; p < x.npasses; ++p) {
    if (x.npasses > 1) {
      __syncthreads();
      load_map(x, p * x.a.map_cap, min(x.a.map_cap, x.a.nr - p * x.a.map_cap));
      __syncthreads();
    }
    for (int it = warp; it < items; it += NWARP) {
      const int u = it / S, sl = it % S;
      switch (min(KMAX, g.lc - u * KMAX)) {
        case 1: scan_item<1>(x, g, u, sl, p); break;
        case 2: scan_item<2>(x, g, u, sl, p); break;
        case 3: scan_item<3>(x, g, u, sl, p); break;
        case 4: scan_item<4>(x, g, u, sl, p); break;
        case 5: scan_item<5>(x, g, u, sl, p); break;
        case 6: scan_item<6>(x, g, u, sl, p); break;
        case 7: scan_item<7>(x, g, u, sl, p); break;
        default: scan_item<8>(x, g, u, sl, p); break;
      }
    }
  }
  __syncthreads();
  for (int li = threadIdx.x; li < g.lc * CHUNK; li += NT) {
    if (global_index(x, li) >= g.n) continue;
    float best = x.s.sbest[li];
    int last = x.s.slast[li];
    bool tie = x.s.sprev[li] == best;
    for (int sl = 1; sl < S; ++sl) {
      const float b = x.s.sbest[sl * ss + li];
      if (b < best) {
        best = b;
        last = x.s.slast[sl * ss + li];
        tie = x.s.sprev[sl * ss + li] == b;
      } else if (b == best) {  // another slice, another index
        last = max(last, x.s.slast[sl * ss + li]);
        tie = true;
      }
    }
    if (isfinite(best) && tie) {
      x.s.sbest[li] = best;
      x.s.slast[li] = last;
      x.s.sprev[li] = NAN;  // never a running distance
    } else {
      float q[3] = {0.f, 0.f, 0.f}, n[3] = {0.f, 0.f, 0.f};
      if (isfinite(best))
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          q[c] = x.ref[3 * (size_t)last + c];
          n[c] = x.nrm[3 * (size_t)last + c];
        }
      finish_point(x, g, li, best, q, n);
    }
  }
  __syncthreads();
  // Each warp finds the tied points of its chunks by ballot and sums
  // each one's matches with all its lanes.
  const int lane = threadIdx.x & 31;
  for (int lc = warp; lc < g.lc; lc += NWARP) {
    const int li = lc * CHUNK + lane;
    unsigned tied = __ballot_sync(
        0xffffffffu, global_index(x, li) < g.n && isnan(x.s.sprev[li]));
    while (tied) {
      const int l = __ffs(tied) - 1;
      tied &= tied - 1;
      tie_point(x, g, lc * CHUNK + l);
    }
  }
  __syncthreads();
}

// ---- cluster exchanges ----

// The N sums of f's per-point terms over the stage's points, into out[N]
// (shared), in the tree of TREE threads sweeping the points: slot s =
// i mod TREE takes the points i = s, s + TREE, ... in order, each term
// added with f's own expressions (v += w * a * b contracts to one FMA per
// term); the 32 slots of each slot chunk are summed by a warp shuffle tree;
// the NSLOT slot-chunk sums are added in order from 0. Slot chunk c0 holds
// the point chunks c0, c0 + NSLOT, ..., all owned by CTA c0 % C since C
// divides NSLOT, so the tree depends on the point index alone and every CTA
// adds the same partials, read through distributed shared memory, to the
// same bits.
template <int N, class F>
__device__ void cluster_reduce(Ctx& x, const Stage& g, const F& f,
                               float* out) {
  cgrp::cluster_group cl = cgrp::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = x.a.C;
  float* xb = x.s.xbuf[x.parity];
  x.parity ^= 1;
  for (int q = warp; q < NSLOT / C; q += NWARP) {
    const int c0 = x.r + q * C;
    float v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = 0.f;
    for (int c = c0; c < g.nchunks; c += NSLOT)
      if (c * CHUNK + lane < g.n) f(((c - x.r) / C) * CHUNK + lane, v);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float t = v[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        t += __shfl_down_sync(0xffffffffu, t, o);
      if (lane == 0) xb[q * N + k] = t;
    }
  }
  cl.sync();
  if (threadIdx.x < N) {
    float v[NSLOT];  // all loads in flight, then the adds in order
#pragma unroll
    for (int c0 = 0; c0 < NSLOT; ++c0)
      v[c0] = cl.map_shared_rank(xb, c0 % C)[(c0 / C) * N + threadIdx.x];
    float s = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < NSLOT; ++c0) s += v[c0];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// Threshold of the weights: the kth-smallest hit d2 (exact), or inf. Radix
// select over the bit patterns, 8 bits per pass, histograms summed over
// the cluster; the first pass's total is the hit count.
__device__ float trim_threshold(Ctx& x, const Stage& g) {
  if (x.a.trim < 0.f) return INFINITY;
  cgrp::cluster_group cl = cgrp::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pm = x.pmax;
  uint32_t prefix = 0;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    int* h = (int*)x.s.xbuf[x.parity];
    x.parity ^= 1;
    for (int t = threadIdx.x; t < HIST; t += NT) h[t] = 0;
    __syncthreads();
    for (int li = threadIdx.x; li < g.lc * CHUNK; li += NT) {
      if (global_index(x, li) >= g.n) continue;
      const float d2 = x.s.st[D2 * pm + li];
      if (!isfinite(d2)) continue;
      const uint32_t bits = __float_as_uint(d2);
      if (pass > 0 && (bits >> (shift + 8)) != (prefix >> (shift + 8)))
        continue;
      atomicAdd(&h[(bits >> shift) & 255u], 1);
    }
    cl.sync();
    for (int t = threadIdx.x; t < HIST; t += NT) {
      int v[MAX_CLUSTER], s = 0;  // all loads in flight, then the sum
#pragma unroll
      for (int rk = 0; rk < MAX_CLUSTER; ++rk)
        v[rk] = rk < x.a.C ? cl.map_shared_rank(h, rk)[t] : 0;
#pragma unroll
      for (int rk = 0; rk < MAX_CLUSTER; ++rk) s += v[rk];
      x.s.htot[t] = s;
    }
    __syncthreads();
    if (warp == 0) {
      int v[8], ls = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) { v[q] = x.s.htot[lane * 8 + q]; ls += v[q]; }
      int incl = ls;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      int kk = x.s.scal[KK];
      if (pass == 0) {
        // ceil(ratio * n_valid) in fp32, as the plain version.
        const float k_keep = ceilf(x.a.trim * (float)total);
        kk = (k_keep < 1.f || k_keep > (float)total) ? -1 : (int)k_keep;
      }
      if (kk > 0) {
        const unsigned hitm = __ballot_sync(0xffffffffu, incl >= kk);
        const int L = __ffs(hitm) - 1;
        if (lane == L) {
          int c = incl - ls, bin = 0;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (c + v[q] >= kk) { bin = q; break; } else { c += v[q]; }
          x.s.scal[BIN] = lane * 8 + bin;
          x.s.scal[KK] = kk - c;
        }
      } else if (lane == 0) {
        x.s.scal[KK] = -1;
      }
    }
    __syncthreads();
    if (x.s.scal[KK] < 0) return INFINITY;
    prefix |= (uint32_t)x.s.scal[BIN] << shift;
  }
  return __uint_as_float(prefix);
}

// Per-point terms of the moments, added into v (o: pp[3], q[3], n[3], d2;
// weights are 0 or 1).
struct PointRef {
  const float* st;
  int pm;
  float thresh, maxd2;
  // The point's fields, and its weight (0: leave v as it is).
  __device__ float load(int li, float* o) const {
#pragma unroll
    for (int f = 0; f < NFIELD; ++f) o[f] = st[f * pm + li];
    if (!isfinite(o[D2])) return 0.f;
    float w = (o[D2] <= thresh) ? 1.f : 0.f;
    if (maxd2 >= 0.f && !(o[D2] <= maxd2)) w = 0.f;
    return w;
  }
};

struct P2Plane {  // A (21 upper entries), b (6), ssr, wsum
  PointRef p;
  __device__ void operator()(int li, float (&v)[29]) const {
    float o[NFIELD];
    const float w = p.load(li, o);
    if (w == 0.f) return;
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
};

struct P2PointMean {  // wsum, sum pp (3), sum q (3)
  PointRef p;
  __device__ void operator()(int li, float (&v)[7]) const {
    float o[NFIELD];
    const float w = p.load(li, o);
    if (w == 0.f) return;
    v[0] += w;
#pragma unroll
    for (int c = 0; c < 3; ++c) { v[1 + c] += w * o[c]; v[4 + c] += w * o[3 + c]; }
  }
};

struct P2PointCross {  // sum (q - muq)(pp - mup)^T
  PointRef p;
  float mup[3], muq[3];
  __device__ void operator()(int li, float (&g)[9]) const {
    float o[NFIELD];
    const float w = p.load(li, o);
    if (w == 0.f) return;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        g[3 * a + b] += w * (o[3 + a] - muq[a]) * (o[b] - mup[b]);
  }
};

struct P2PointFinal {  // ssr, wsum, Sp (3), Spp (9)
  PointRef p;
  __device__ void operator()(int li, float (&v)[14]) const {
    float o[NFIELD];
    const float w = p.load(li, o);
    if (w == 0.f) return;
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
};

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
__device__ void p2point_delta(Ctx& x, const Stage& g, float thresh,
                              float* delta) {
  const PointRef pr{x.s.st, x.pmax, thresh, x.a.maxd2};
  cluster_reduce<7>(x, g, P2PointMean{pr}, x.s.sums);
  const float wsum_raw = x.s.sums[0];
  const float wsum = fmaxf(wsum_raw, 1e-12f);
  P2PointCross cross{pr, {}, {}};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    cross.mup[c] = x.s.sums[1 + c] / wsum;
    cross.muq[c] = x.s.sums[4 + c] / wsum;
  }
  cluster_reduce<9>(x, g, cross, x.s.sums);
  if (threadIdx.x == 0) {
    float G[9], R[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) G[k] = x.s.sums[k];
    bool ok = wsum_raw >= MIN_SUPPORT && pgs::det3(G) > 1e-12f;
    pgs::polar3(G, R);
    for (int a = 0; a < 3; ++a) {
      float t = cross.muq[a] - (R[3 * a] * cross.mup[0] +
                                R[3 * a + 1] * cross.mup[1] +
                                R[3 * a + 2] * cross.mup[2]);
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

// One stage of the iterate loop on reading[::stride]; updates x.s.T. Every
// CTA of the cluster runs it with the same scalars and leaves it together.
__device__ int run_stage(Ctx& x, int stride, int n, int max_it,
                         int* converged) {
  const Stage g = make_stage(x, stride, n);
  const int L = x.a.L;
  float* dts = x.win;  // thread 0's
  float* drs = x.win + L;
  int it = 0;
  Anderson aa;  // thread 0's, used when aa_m > 1
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2 * L; ++k) x.win[k] = INFINITY;
    x.s.scal[FLAG] = 0;
    if (x.a.aa_m > 1) {
      for (int k = 0; k < 16; ++k) aa.T0[k] = x.s.T[k];
      pgs::se3_inv(aa.T0, aa.Tinv0);
      for (int k = 0; k < MAXM * 6; ++k) { aa.X[k] = 0.f; aa.GX[k] = 0.f; }
    }
  }
  __syncthreads();
  while (it < max_it && !x.s.scal[FLAG]) {
    match(x, g);
    const float thresh = trim_threshold(x, g);
    float delta[16], tw[6];
    if (x.a.p2plane) {
      cluster_reduce<29>(
          x, g, P2Plane{PointRef{x.s.st, x.pmax, thresh, x.a.maxd2}},
          x.s.sums);
      if (threadIdx.x == 0) {
        const float* s = x.s.sums;
        const float wsum = s[28];
        float A[36], Ai[36];
        unpack_A(s, A);
        for (int a = 0; a < 6; ++a) A[7 * a] += 1e-6f;
        pgs::schur_inv6(A, Ai);
        for (int a = 0; a < 6; ++a) {
          float acc = 0.f;
          for (int b = 0; b < 6; ++b) acc += Ai[6 * a + b] * s[21 + b];
          tw[a] = wsum >= MIN_SUPPORT ? acc : 0.f;
        }
        pgs::se3_exp(tw, delta);
      }
    } else {
      p2point_delta(x, g, thresh, delta);
      if (threadIdx.x == 0) pgs::se3_log(delta, tw);
    }
    if (threadIdx.x == 0) {
      float dt, dr;
      if (x.a.aa_m > 1) {
        float Tp[16], Tn[16];
        pgs::mat4_mul(delta, x.s.T, Tp);
        anderson_update(aa, x.a.aa_m, it, x.s.T, Tp, Tn, &dt, &dr);
        for (int k = 0; k < 16; ++k) x.s.T[k] = Tn[k];
      } else {
        pgs::mat4_mul(delta, x.s.T, x.s.T);
        dt = sqrtf(sqn(delta[3], delta[7], delta[11]));
        dr = sqrtf(sqn(tw[3], tw[4], tw[5]));
      }
      for (int k = L - 1; k > 0; --k) { dts[k] = dts[k - 1]; drs[k] = drs[k - 1]; }
      dts[0] = dt;
      drs[0] = dr;
      float st = 0.f, sr = 0.f;
      for (int k = 0; k < L; ++k) { st += dts[k]; sr += drs[k]; }
      x.s.scal[FLAG] =
          (st / (float)L < x.a.trans_eps) && (sr / (float)L < x.a.rot_eps);
    }
    __syncthreads();
    ++it;
  }
  *converged = x.s.scal[FLAG];
  __syncthreads();
  return it;
}

__device__ void load_map(const Ctx& x, int j0, int m) {
  for (int t = threadIdx.x; t < m; t += NT) k2_smem[t] = map_point(x, j0 + t);
}

__global__ void __launch_bounds__(NT, 1) icp_fused_kernel(const Args a) {
  float4* smem4 = k2_smem;
  cgrp::cluster_group cl = cgrp::this_cluster();
  Ctx x;
  x.a = a;
  x.r = (int)cl.block_rank();
  x.b = blockIdx.x / a.C;
  x.pmax = a.lcmax * CHUNK;
  x.npasses = a.nr > a.map_cap ? (a.nr + a.map_cap - 1) / a.map_cap : 1;
  x.parity = 0;
  const int pm = x.pmax;
  float* w = (float*)(smem4 + a.map_cap);
  x.s.st = w;            w += NFIELD * pm;
  x.s.sbest = w;         w += a.S * pm;
  x.s.sprev = w;         w += a.S * pm;
  x.s.slast = (int*)w;   w += a.S * pm;
  x.s.xbuf[0] = w;       w += XBUF_WORDS;
  x.s.xbuf[1] = w;       w += XBUF_WORDS;
  x.s.htot = (int*)w;    w += HIST;
  x.s.T = w;             w += 16;
  x.s.sums = w;          w += 32;
  x.s.ired = (int*)w;    w += 40;
  x.s.scal = (int*)w;
  const int b = x.b;
  x.rd = a.rd + (size_t)b * a.nq * 3;
  x.rdm = a.rdm + (size_t)b * a.nq;
  x.ref = a.ref + (size_t)b * a.nr * 3;
  x.nrm = a.nrm + (size_t)b * a.nr * 3;
  x.refm = a.refm + (size_t)b * a.nr;
  x.win = a.window + (size_t)blockIdx.x * 2 * a.L;
  if (threadIdx.x < 16) x.s.T[threadIdx.x] = a.T0[(size_t)b * 16 + threadIdx.x];
  if (threadIdx.x < 8) x.s.scal[threadIdx.x] = 0;
  if (x.npasses == 1) load_map(x, 0, a.nr);
  __syncthreads();

  int conv = 0;
  if (a.coarse_div > 1 && a.coarse_it > 0)
    run_stage(x, a.coarse_div, (a.nq + a.coarse_div - 1) / a.coarse_div,
              a.coarse_it, &conv);
  const int iters = run_stage(x, 1, a.nq, a.max_it, &conv);

  // Final introspection at the solution.
  const Stage g = make_stage(x, 1, a.nq);
  match(x, g);
  const float thresh = trim_threshold(x, g);
  int nvr = 0;
  for (int i = threadIdx.x; i < a.nq; i += NT) nvr += x.rdm[i] ? 1 : 0;
  const int n_valid_reading = pgs::block_count(nvr, x.s.ired);
  const PointRef pr{x.s.st, pm, thresh, x.a.maxd2};
  float A[36], ssr, dof, wsum;
  if (a.p2plane) {
    cluster_reduce<29>(x, g, P2Plane{pr}, x.s.sums);
    unpack_A(x.s.sums, A);
    ssr = x.s.sums[27];
    wsum = x.s.sums[28];
    dof = fmaxf(wsum - 6.f, 1.f);
  } else {
    cluster_reduce<14>(x, g, P2PointFinal{pr}, x.s.sums);
    ssr = x.s.sums[0];
    wsum = x.s.sums[1];
    const float* Sp = x.s.sums + 2;
    const float* Spp = x.s.sums + 5;
    const float tr = Spp[0] + Spp[4] + Spp[8];
    float hS[9];
    pgs::hat3(Sp, hS);
    for (int i = 0; i < 3; ++i)
      for (int c = 0; c < 3; ++c) {
        A[6 * i + c] = (i == c) ? wsum : 0.f;
        A[6 * i + c + 3] = -hS[3 * i + c];
        A[6 * (i + 3) + c] = -hS[3 * c + i];
        A[6 * (i + 3) + c + 3] = ((i == c) ? tr : 0.f) - Spp[3 * i + c];
      }
    dof = fmaxf(3.f * wsum - 6.f, 1.f);
  }
  if (x.r == 0 && threadIdx.x == 0) {
    float* o = a.out + (size_t)b * 56;
    for (int k = 0; k < 16; ++k) o[k] = x.s.T[k];
    o[16] = (float)iters;
    o[17] = (float)conv;
    o[18] = wsum / fmaxf((float)n_valid_reading, 1.f);
    o[19] = ssr;
    for (int i = 0; i < 6; ++i) A[7 * i] += 1e-9f;
    float Ai[36];
    pgs::schur_inv6(A, Ai);
    const float sigma2 = ssr / dof;
    for (int k = 0; k < 36; ++k)
      o[20 + k] = sigma2 * Ai[k] + ((k % 7 == 0) ? 1e-12f : 0.f);
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
  return cudaOccupancyMaxActiveClusters(clusters, (const void*)icp_fused_kernel,
                                        &cfg);
}

cudaError_t set_attributes(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      icp_fused_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        icp_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return err;
}

}  // namespace

// out[0]: the dynamic shared memory a CTA may hold; out[1..5]: how many
// clusters of 1, 2, 4, 8 and 16 CTAs with that much each the device holds
// at once (one CTA per SM; 0 where none schedules).
extern "C" int pgs_icp_fused_limits(int* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, icp_fused_kernel);
  if (err != cudaSuccess) return (int)err;
  const int budget = optin - (int)fa.sharedSizeBytes;
  err = set_attributes(budget);
  if (err != cudaSuccess) return (int)err;
  out[0] = budget;
  for (int i = 0, C = 1; C <= MAX_CLUSTER; ++i, C *= 2) {
    int n = 0;
    out[1 + i] = schedulable(C, budget, &n) == cudaSuccess ? n : 0;
    cudaGetLastError();
  }
  return (int)cudaGetLastError();
}

// Whether a cluster of C CTAs with smem bytes each schedules on the current
// device, asked once per (device, C, smem): the occupancy query costs about
// a millisecond of host time, more than a small launch's kernel.
static cudaError_t cluster_fits(int C, int smem, bool* fits) {
  struct Entry { int dev, C, smem; bool fits; };
  static Entry seen[64];
  static int n_seen = 0, attr_dev = -1, attr_smem = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].dev == dev && seen[i].C == C && seen[i].smem == smem) {
      *fits = seen[i].fits;
      return cudaSuccess;
    }
  if (dev != attr_dev || smem > attr_smem) {
    err = set_attributes(smem);
    if (err != cudaSuccess) return err;
    attr_dev = dev;
    attr_smem = smem;
  }
  int clusters = 0;
  err = schedulable(C, smem, &clusters);
  if (err != cudaSuccess) return err;
  *fits = clusters >= 1;
  if (n_seen < 64) seen[n_seen++] = Entry{dev, C, smem, *fits};
  return cudaSuccess;
}

// Returns cudaGetLastError() after the launch; -2 when no cluster of C CTAs
// with smem bytes each schedules, -3 when the layout (C a divisor of 16,
// S, map_cap, lcmax) does not cover the reading or smem is below what it
// needs.
// params (host): trans_eps, rot_eps, trim ratio (-1: none), MaxDist^2 (-1:
// none); iparams (host): point_to_plane, max_iterations, coarse
// iterations, checker window L, Anderson m (0: none).
extern "C" int pgs_icp_fused(const float* reading, const bool* rdmask, int nq,
                             int coarse_div, const float* ref,
                             const float* nrm, const bool* refmask, int nr,
                             const float* T0, const float* params,
                             const int* iparams, float* window, float* out,
                             int batch, int C, int S, int map_cap, int lcmax,
                             int smem, void* stream) {
  if (C < 1 || NSLOT % C != 0 || S < 1 || map_cap < 1 || lcmax < 1 ||
      (long long)smem < 4 * cta_words(map_cap, lcmax, S) ||
      (long long)lcmax * C * CHUNK < nq)
    return -3;
  bool fits = false;
  cudaError_t err = cluster_fits(C, smem, &fits);
  if (err != cudaSuccess) return (int)err;
  if (!fits) return -2;
  Args a;
  a.rd = reading; a.rdm = rdmask; a.ref = ref; a.nrm = nrm; a.refm = refmask;
  a.T0 = T0; a.window = window; a.out = out;
  a.nq = nq; a.nr = nr; a.coarse_div = coarse_div;
  a.trans_eps = params[0]; a.rot_eps = params[1];
  a.trim = params[2]; a.maxd2 = params[3];
  a.p2plane = iparams[0]; a.max_it = iparams[1]; a.coarse_it = iparams[2];
  a.L = iparams[3]; a.aa_m = iparams[4];
  a.C = C; a.S = S; a.map_cap = map_cap; a.lcmax = lcmax;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * C);
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
  err = cudaLaunchKernelEx(&cfg, icp_fused_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
