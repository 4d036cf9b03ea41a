// K1: exact masked k-nearest-neighbour search (k <= 8).
//
// Replaces pgslam_tpu/ops/knn_pallas.py::nn_pallas (body _kernel). The
// semantics are those of pgslam_tpu_torch/ops/knn.py::knn_plain:
//   d2 = (|q|^2 - 2 * cross) + |r|^2, clamped at 0, with
//   cross = fma(qz, rz, fma(qy, ry, qx * rx)) and the norms as rounded
//   products summed left to right; +inf for masked references and masked
//   queries; ascending by (d2, id), so the lowest id wins ties; ids of
//   non-finite slots are 0.
// The TPU kernel's precision modes ("highest", "high", "default") exist for
// the TPU's bf16 matrix unit; all three are this one fp32 path.
//
// Design: one thread per query keeps its sorted top-k in registers. A block
// of NT threads streams float4(x, y, z, |r|^2) reference tiles through
// shared memory in increasing id order; |r|^2 is +inf for masked points.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;
constexpr int TILE = 1024;

__device__ __forceinline__ float sqn(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

template <int K>
__global__ void __launch_bounds__(NT)
knn_kernel(const float* __restrict__ q, const bool* __restrict__ qmask, int nq,
           const float* __restrict__ r, const bool* __restrict__ rmask, int nr,
           float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 tile[TILE];
  const int qi = blockIdx.x * NT + threadIdx.x;
  const bool active = qi < nq && qmask[qi];
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * (size_t)qi];
    qy = q[3 * (size_t)qi + 1];
    qz = q[3 * (size_t)qi + 2];
  }
  const float qsq = sqn(qx, qy, qz);
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) { bd[s] = INFINITY; bi[s] = 0; }

  for (int base = 0; base < nr; base += TILE) {
    __syncthreads();
    for (int j = threadIdx.x; j < TILE; j += NT) {
      const int rj = base + j;
      float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);
      if (rj < nr) {
        const float x = r[3 * (size_t)rj], y = r[3 * (size_t)rj + 1],
                    z = r[3 * (size_t)rj + 2];
        v = make_float4(x, y, z, rmask[rj] ? sqn(x, y, z) : INFINITY);
      }
      tile[j] = v;
    }
    __syncthreads();
    if (!active) continue;
    const int m = min(TILE, nr - base);
    for (int j = 0; j < m; ++j) {
      const float4 v = tile[j];
      const float cross = fmaf(qz, v.z, fmaf(qy, v.y, __fmul_rn(qx, v.x)));
      float d2 = __fadd_rn(__fsub_rn(qsq, __fmul_rn(2.f, cross)), v.w);
      d2 = fmaxf(d2, 0.f);
      if (!(d2 < bd[K - 1])) continue;
      // Insert by (d2, id): the new id is the largest seen so far, so a
      // displaced entry moves past equal distances only by the id order.
      float cd = d2;
      int ci = base + j;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (cd < bd[s] || (cd == bd[s] && ci < bi[s])) {
          const float td = bd[s]; const int ti = bi[s];
          bd[s] = cd; bi[s] = ci;
          cd = td; ci = ti;
        }
      }
    }
  }
  if (qi < nq) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_d[(size_t)qi * K + s] = bd[s];
      out_i[(size_t)qi * K + s] = isfinite(bd[s]) ? bi[s] : 0;
    }
  }
}

template <int K>
void launch(const float* q, const bool* qm, int nq, const float* r,
            const bool* rm, int nr, float* d, int* i, cudaStream_t s) {
  const int blocks = (nq + NT - 1) / NT;
  if (blocks > 0) knn_kernel<K><<<blocks, NT, 0, s>>>(q, qm, nq, r, rm, nr, d, i);
}

}  // namespace

extern "C" int pgs_knn(const float* q, const bool* qmask, int nq,
                       const float* r, const bool* rmask, int nr, int k,
                       float* out_d, int* out_i, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: launch<1>(q, qmask, nq, r, rmask, nr, out_d, out_i, s); break;
    case 2: launch<2>(q, qmask, nq, r, rmask, nr, out_d, out_i, s); break;
    case 3: launch<3>(q, qmask, nq, r, rmask, nr, out_d, out_i, s); break;
    case 4: launch<4>(q, qmask, nq, r, rmask, nr, out_d, out_i, s); break;
    case 5: launch<5>(q, qmask, nq, r, rmask, nr, out_d, out_i, s); break;
    case 6: launch<6>(q, qmask, nq, r, rmask, nr, out_d, out_i, s); break;
    case 7: launch<7>(q, qmask, nq, r, rmask, nr, out_d, out_i, s); break;
    case 8: launch<8>(q, qmask, nq, r, rmask, nr, out_d, out_i, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
