// Shared helpers of the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel is exported through a plain C function that takes raw
// pointers, ints and the CUDA stream, launches on that stream, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro {

// dtype codes shared with the Python wrappers (kernels/_build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_allreduce_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_allreduce_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// Paged attention core, shared by paged decode (K1) and chunk prefill (K2).
//
// A block serves one KV head. Each warp of the block owns one query vector
// (one query head of the GQA group for decode, one query row of the tile
// for prefill) and sees the keys at logical positions [0, n_vis). The block
// walks the page-table row `table[0 .. n_pages)`, stages each page's K and
// V (ps x D, this KV head) in shared memory once for all of its warps, and
// every warp folds the page into its fp32 online-softmax state.
//
// Lane l holds elements d = l + 32 * i (i < DPL) of the query and of the
// output accumulator, so D <= 32 * DPL.
template <typename T, int DPL>
struct WarpQuery {
  float q[DPL];     // pre-scaled by 1/sqrt(D)
  float acc[DPL];
  float m;          // running max
  float l;          // running denominator
};

template <typename T, int DPL>
__device__ __forceinline__ void load_query(WarpQuery<T, DPL>& st, const T* q, int D,
                                           float scale, int lane) {
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    st.q[i] = d < D ? to_float(q[d]) * scale : 0.f;
    st.acc[i] = 0.f;
  }
  st.m = -INFINITY;
  st.l = 0.f;
}

template <typename T, int DPL>
__device__ void attend_pages(WarpQuery<T, DPL>& st, bool active, int n_vis,
                             const T* __restrict__ k_pool, const T* __restrict__ v_pool,
                             const int* __restrict__ table, int n_pages, int ps, int Hkv,
                             int kvh, int D, float* sk, float* sv) {
  const int lane = threadIdx.x & 31;
  const int tile = ps * D;
  for (int j = 0; j < n_pages; ++j) {
    const size_t page = static_cast<size_t>(table[j]);
    __syncthreads();  // previous page fully consumed
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const int t = e / D, d = e - t * D;
      const size_t off = ((page * ps + t) * Hkv + kvh) * static_cast<size_t>(D) + d;
      sk[e] = to_float(k_pool[off]);
      sv[e] = to_float(v_pool[off]);
    }
    __syncthreads();
    if (!active) continue;
    const int t_end = min(ps, n_vis - j * ps);  // warp-uniform
    for (int t = 0; t < t_end; ++t) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) part += st.q[i] * sk[t * D + d];
      }
      const float s = warp_allreduce_sum(part);
      const float m_new = fmaxf(st.m, s);
      const float alpha = expf(st.m - m_new);
      const float p = expf(s - m_new);
      st.l = st.l * alpha + p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) st.acc[i] = st.acc[i] * alpha + p * sv[t * D + d];
      }
      st.m = m_new;
    }
  }
}

template <typename T, int DPL>
__device__ __forceinline__ void store_output(const WarpQuery<T, DPL>& st, T* out, int D,
                                             int lane) {
  // no visible key: l == 0 and acc == 0, so the row is zeros
  const float inv = 1.f / fmaxf(st.l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) out[d] = from_float<T>(st.acc[i] * inv);
  }
}

}  // namespace repro
