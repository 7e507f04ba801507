// K3: fused squared-L2 distance + ascending top-k per query row.
//
// Replaces the TPU kernel `topk_l2_pallas` (src/repro/kernels/topk_l2.py:55,
// body `_kernel` :24). The retriever asks for k = N (a full ranking), so
// the kernel sorts the whole distance row rather than merging a running
// top-k.
//
// Launch: one block per query row. The query sits in shared memory; each
// warp computes d^2 = sum_d (q_d - db_d)^2 directly in fp32 for a strided
// share of the N database rows (lanes over D, so the row read is
// coalesced) -- the direct form of the reference `topk_l2_ref`, not the
// TPU kernel's |q|^2 + |db|^2 - 2 q.db, which cancels for L2-normalised near
// neighbours and reorders near-ties. Identical rows give bit-identical d^2
// (same lane order, same reduction tree). The (d^2, index) pairs, padded
// to a power of two with (+inf, INT_MAX), are bitonic-sorted in shared
// memory lexicographically, so ties go lowest index first as lax.top_k does.
#include <climits>

#include "common.cuh"

namespace repro {

__global__ void topk_l2_kernel(const float* __restrict__ db, const float* __restrict__ q,
                               float* __restrict__ out_d, int* __restrict__ out_i, int N,
                               int D, int k, int npad) {
  extern __shared__ float smem[];
  float* sq = smem;                               // D
  float* sd = sq + D;                             // npad
  int* si = reinterpret_cast<int*>(sd + npad);    // npad
  const int m = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  for (int d = threadIdx.x; d < D; d += blockDim.x) sq[d] = q[static_cast<size_t>(m) * D + d];
  __syncthreads();

  for (int r = warp; r < npad; r += nwarps) {
    if (r < N) {
      const float* row = db + static_cast<size_t>(r) * D;
      float part = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float diff = sq[d] - row[d];
        part += diff * diff;
      }
      const float s = warp_allreduce_sum(part);
      if (lane == 0) {
        sd[r] = s;
        si[r] = r;
      }
    } else if (lane == 0) {
      sd[r] = INFINITY;
      si[r] = INT_MAX;
    }
  }
  __syncthreads();

  for (int size = 2; size <= npad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < npad; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const float a = sd[i], b = sd[j];
          const int ia = si[i], ib = si[j];
          const bool greater = (a > b) || (a == b && ia > ib);
          const bool ascending = (i & size) == 0;
          if (greater == ascending) {
            sd[i] = b; sd[j] = a;
            si[i] = ib; si[j] = ia;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    out_d[static_cast<size_t>(m) * k + i] = sqrtf(fmaxf(sd[i], 0.f));
    out_i[static_cast<size_t>(m) * k + i] = si[i];
  }
}

}  // namespace repro

extern "C" int repro_topk_l2(const void* db, const void* q, void* out_d, void* out_i, int M,
                             int N, int D, int k, void* stream) {
  if (M <= 0 || N <= 0 || D <= 0 || k <= 0 || k > N) return cudaErrorInvalidValue;
  int npad = 1;
  while (npad < N) npad <<= 1;
  const size_t smem = (static_cast<size_t>(D) + 2u * npad) * sizeof(float);
  cudaError_t err = repro::allow_smem(repro::topk_l2_kernel, smem);
  if (err != cudaSuccess) return err;
  const int threads = npad >= 1024 ? 1024 : (npad < 64 ? 64 : npad);
  repro::topk_l2_kernel<<<M, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(db), static_cast<const float*>(q), static_cast<float*>(out_d),
      static_cast<int*>(out_i), N, D, k, npad);
  return cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
