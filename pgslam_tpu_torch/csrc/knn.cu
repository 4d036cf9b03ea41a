// K1: exact masked k-nearest-neighbour search (k <= 16).
//
// Replaces pgslam_tpu/ops/knn_pallas.py::nn_pallas (body _kernel). The
// semantics are those of pgslam_tpu_torch/ops/knn.py::knn_plain:
//   d2 = (|q|^2 - 2 * cross) + |r|^2, clamped at 0, with
//   cross = fma(qz, rz, fma(qy, ry, qx * rx)) and the norms as rounded
//   products summed left to right; +inf for masked references and masked
//   queries; ascending by (d2, id), so the lowest id wins ties; ids of
//   non-finite slots are 0. |q|^2 - 2 * cross is one fma(-2, cross, |q|^2):
//   doubling is exact, so it rounds as the plain version's product and
//   difference do.
// The TPU kernel's precision modes ("highest", "high", "default") exist for
// the TPU's bf16 matrix unit; all three are this one fp32 path.
//
// What bounds it on the H100: fp32 instruction issue. A (query, reference)
// pair costs about 9 instructions (the distance, the clamp, the compare and
// the kept entry) and 16 bytes read from shared memory; nothing is reused
// across pairs but the staged reference. At the main path's shapes (2048
// or 512 queries) one thread per query fills 4-16 blocks of 128 threads,
// so most of the card's 132 SMs would idle.
//
// Design. The grid is (query tiles) x S. A tile is T threads, one query
// each; each of its S CTAs scans one contiguous slice of the reference ids,
// in increasing order, staging float4(x, y, z, |r|^2) tiles through shared
// memory (|r|^2 = +inf for masked points), and keeps the query's sorted
// top-k of its slice in registers (a pair is skipped unless d2 < the k-th
// kept; the new id, the largest so far, goes behind equal distances; each
// slot is set from the old list, so an insertion is k independent selects,
// not a chain). The S CTAs of a tile form one thread-block cluster: after a
// cluster barrier each CTA merges a share of the tile's queries, reading
// the S sorted lists from the CTAs' shared memory in slice order and
// keeping the k least by (d2, id). That order is total on the entries, so
// the result is the plain version's whatever S and T are and whatever
// order the blocks run in. ops/knn.py::k1_layout picks S and T so that the
// grid fills the card; ops/knn.py::merge_slices is the merge in plain
// PyTorch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cgrp = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 128;
constexpr int MAX_SLICES = 16;
constexpr int TILE_REFS = 2048;  // float4 staged per pass: 32 KB

struct Args {
  const float* q;
  const bool* qmask;
  const float* r;
  const bool* rmask;
  float* out_d;
  int* out_i;
  int nq, nr, S, tile_refs;
};

__device__ __forceinline__ float sqn(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Insert (cd, ci) into the sorted list (bd, bi), dropping the last entry,
// where ci exceeds every id in the list (a slice's scan goes up the ids,
// the merge up the slices): it goes behind every entry of distance <= cd,
// which is the (d2, id) order. The caller has checked cd < bd[K - 1]. Each
// slot is set from the old list alone, so the K steps do not chain.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float cd,
                                       int ci) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool move = bd[s - 1] > cd;      // entry s - 1 moves to s
    const bool put = !move && bd[s] > cd;  // (cd, ci) lands at s
    bd[s] = move ? bd[s - 1] : (put ? cd : bd[s]);
    bi[s] = move ? bi[s - 1] : (put ? ci : bi[s]);
  }
  if (bd[0] > cd) {
    bd[0] = cd;
    bi[0] = ci;
  }
}

template <int K>
__global__ void __launch_bounds__(MAX_THREADS)
knn_kernel(const Args a) {
  extern __shared__ float4 smem[];
  const int nt = blockDim.x, S = a.S;
  const int slice = blockIdx.x % S, tile = blockIdx.x / S;
  const int r0 = (int)((long long)a.nr * slice / S);
  const int r1 = (int)((long long)a.nr * (slice + 1) / S);

  const int qi = tile * nt + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  float qsq = INFINITY;  // a masked query's every d2 is +inf
  if (qi < a.nq && a.qmask[qi]) {
    qx = a.q[3 * (size_t)qi];
    qy = a.q[3 * (size_t)qi + 1];
    qz = a.q[3 * (size_t)qi + 2];
    qsq = sqn(qx, qy, qz);
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }

  for (int base = r0; base < r1; base += a.tile_refs) {
    const int m = min(a.tile_refs, r1 - base);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += nt) {
      const int rj = base + j;
      const float x = a.r[3 * (size_t)rj], y = a.r[3 * (size_t)rj + 1],
                  z = a.r[3 * (size_t)rj + 2];
      smem[j] = make_float4(x, y, z, a.rmask[rj] ? sqn(x, y, z) : INFINITY);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const float4 v = smem[j];
      const float cross = fmaf(qz, v.z, fmaf(qy, v.y, __fmul_rn(qx, v.x)));
      const float d2 = fmaxf(__fadd_rn(fmaf(-2.f, cross, qsq), v.w), 0.f);
      if (d2 < bd[K - 1]) insert<K>(bd, bi, d2, base + j);
    }
  }

  if (S == 1) {
    if (qi >= a.nq) return;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      a.out_d[(size_t)qi * K + s] = bd[s];
      a.out_i[(size_t)qi * K + s] = isfinite(bd[s]) ? bi[s] : 0;
    }
    return;
  }

  // This slice's lists, entry s of local query l at [s * nt + l].
  float* ld = reinterpret_cast<float*>(smem);
  int* li = reinterpret_cast<int*>(ld + K * nt);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < K; ++s) {
    ld[s * nt + threadIdx.x] = bd[s];
    li[s * nt + threadIdx.x] = bi[s];
  }
  cgrp::cluster_group cl = cgrp::this_cluster();
  cl.sync();
  // CTA `slice` merges local queries slice + S * t for t = 0, 1, ...; the
  // lists are read in slice order, so every id read is above those kept.
  for (int l = slice + S * threadIdx.x; l < nt; l += S * nt) {
    const int ql = tile * nt + l;
    if (ql >= a.nq) continue;
    float md[K];
    int mi[K];
    const float* d0 = cl.map_shared_rank(ld, 0);
    const int* i0 = cl.map_shared_rank(li, 0);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      md[s] = d0[s * nt + l];
      mi[s] = i0[s * nt + l];
    }
    for (int rk = 1; rk < S; ++rk) {
      const float* dr = cl.map_shared_rank(ld, rk);
      const int* ir = cl.map_shared_rank(li, rk);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const float cd = dr[s * nt + l];
        // The list ascends and its ids exceed every kept id: once an
        // entry does not precede the k-th kept, none after it does.
        if (!(cd < md[K - 1])) break;
        insert<K>(md, mi, cd, ir[s * nt + l]);
      }
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      a.out_d[(size_t)ql * K + s] = md[s];
      a.out_i[(size_t)ql * K + s] = isfinite(md[s]) ? mi[s] : 0;
    }
  }
  cl.sync();  // no CTA leaves while another reads its lists
}

typedef void (*Kernel)(const Args);

Kernel pick(int k) {
  switch (k) {
    case 1: return knn_kernel<1>;
    case 2: return knn_kernel<2>;
    case 3: return knn_kernel<3>;
    case 4: return knn_kernel<4>;
    case 5: return knn_kernel<5>;
    case 6: return knn_kernel<6>;
    case 7: return knn_kernel<7>;
    case 8: return knn_kernel<8>;
    case 9: return knn_kernel<9>;
    case 10: return knn_kernel<10>;
    case 11: return knn_kernel<11>;
    case 12: return knn_kernel<12>;
    case 13: return knn_kernel<13>;
    case 14: return knn_kernel<14>;
    case 15: return knn_kernel<15>;
    case 16: return knn_kernel<16>;
    default: return nullptr;
  }
}

// Clusters above 8 CTAs need the non-portable attribute, set once per
// kernel and device.
cudaError_t allow_large_clusters(Kernel kern) {
  struct Entry { Kernel kern; int dev; };
  static Entry seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kern == kern && seen[i].dev == dev) return cudaSuccess;
  err = cudaFuncSetAttribute((const void*)kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && n_seen < 64) seen[n_seen++] = Entry{kern, dev};
  return err;
}

}  // namespace

// The layout: S slices (1, 2, 4, 8 or 16; the cluster size) and T threads
// a CTA, one query each (32 or 128). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a k or
// layout outside those.
extern "C" int pgs_knn(const float* q, const bool* qmask, int nq,
                       const float* r, const bool* rmask, int nr, int k,
                       int S, int T, float* out_d, int* out_i,
                       void* stream) {
  const Kernel kern = pick(k);
  if (kern == nullptr || S < 1 || S > MAX_SLICES || (S & (S - 1)) != 0 ||
      T < 32 || T > MAX_THREADS || T % 32 != 0 || nq < 0 || nr < 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (nq + T - 1) / T;
  if (tiles == 0) return (int)cudaGetLastError();
  Args a;
  a.q = q; a.qmask = qmask; a.r = r; a.rmask = rmask;
  a.out_d = out_d; a.out_i = out_i;
  a.nq = nq; a.nr = nr; a.S = S;
  const int per_slice = (nr + S - 1) / S;
  a.tile_refs = per_slice < 1 ? 1 : (per_slice < TILE_REFS ? per_slice
                                                            : TILE_REFS);
  const int list_bytes = S > 1 ? 2 * k * T * 4 : 0;
  const int tile_bytes = 16 * a.tile_refs;
  if (S > 8) {
    const cudaError_t err = allow_large_clusters(kern);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * S);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = list_bytes > tile_bytes ? list_bytes : tile_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
