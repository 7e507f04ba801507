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

// The two halves of a thread-block cluster's barrier (K3, K6): after
// arrive, this block's reads of its peers' shared memory are done; wait
// returns when every block of the cluster has arrived. Every thread of
// every block executes both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// cp.async staging (K1, K2, K4, K5 on the paged-attention core; K7).
namespace {  // one copy per translation unit

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with ok == false nothing is
// read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace

// ---------------------------------------------------------------------------
// The span merge of the flash-decoding split (K1, K2, K4, K5).
//
// A kernel that splits the key positions of a query row into spans writes,
// for every (row, span), the span's unnormalised online-softmax state to a
// float32 workspace: its running max and denominator at
// part_ml[2 * (row * nparts + s)] and its accumulator (D values) at
// part_acc[(row * nparts + s) * D]. A span that saw no key reports max
// -inf. The merge rescales the spans to their common max and writes
// acc / l in the output's dtype; a row whose spans all saw no key gets
// zeros. One warp per row; the row index is the flat index of the output
// row, so out[row * D + d].
//
// The tag (an empty type per caller) names each caller's kernels in a
// profile: repro::PagedDecode (K1), ChunkPrefill (K2), PagedVerify (K4),
// DenseDecode (K5).
struct PagedDecode;
struct ChunkPrefill;
struct PagedVerify;
struct DenseDecode;
struct Bidirectional;

namespace {  // one copy per translation unit: no kernel symbol is shared

constexpr int kMergeWarps = 4;    // rows per block: one warp a row

// COLS: columns a lane holds (lane + 32 c), D <= 32 COLS; BATCH: spans
// whose accumulators a lane loads at once.
template <class Tag, typename T, int COLS, int BATCH>
__global__ void __launch_bounds__(kMergeWarps * 32)
    merge_spans_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                       T* __restrict__ out, size_t rows, int D, int nparts) {
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kMergeWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* ml = part_ml + 2 * row * nparts;
  const float* acc = part_acc + row * nparts * D;
  float v[BATCH][COLS];  // a batch of spans' accumulators; an empty span's are never used
  auto load = [&](int s0) {
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = lane + 32 * c;
        v[j][c] = s0 + j < nparts && d < D ? acc[static_cast<size_t>(s0 + j) * D + d] : 0.f;
      }
  };
  load(0);  // in flight with the max and denominator's loads
  float m = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < nparts; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
#pragma unroll 8
  for (int s = 0; s < nparts; ++s)
    if (ml[2 * s] != -INFINITY) l += ml[2 * s + 1] * expf(ml[2 * s] - m);
  const float inv = 1.f / fmaxf(l, 1e-30f);   // no visible key: l == 0, a == 0
  // each column sums its spans in span order, as a serial merge would
  float a[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) a[c] = 0.f;
  for (int s0 = 0; s0 < nparts; s0 += BATCH) {
    if (s0 > 0) load(s0);
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int s = s0 + j;
      if (s < nparts && ml[2 * s] != -INFINITY) {
        const float w = expf(ml[2 * s] - m);
#pragma unroll
        for (int c = 0; c < COLS; ++c) a[c] += v[j][c] * w;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int d = lane + 32 * c;
    if (d < D) out[row * D + d] = from_float<T>(a[c] * inv);
  }
}

template <class Tag, typename T, int COLS>
void launch_merge(const float* part_ml, const float* part_acc, T* out, size_t rows, int D,
                  int nparts, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kMergeWarps - 1) / kMergeWarps);
  // Few spans (K2's whole-prompt launch: 2) take a 4-span batch: fewer
  // registers, more rows in flight; on an H100 that merge ran ~4 us faster
  // than with 16-span batches, which suit K1, K4 and K5 (16 spans a row).
  if (nparts <= 4)
    merge_spans_kernel<Tag, T, COLS, 4><<<blocks, kMergeWarps * 32, 0, stream>>>(
        part_ml, part_acc, out, rows, D, nparts);
  else
    merge_spans_kernel<Tag, T, COLS, 16><<<blocks, kMergeWarps * 32, 0, stream>>>(
        part_ml, part_acc, out, rows, D, nparts);
}

// Launch the merge of `rows` output rows (D <= 256) on `stream`; returns the
// launch's error.
template <class Tag, typename T>
cudaError_t merge_spans(const float* part_ml, const float* part_acc, void* out, size_t rows,
                        int D, int nparts, cudaStream_t stream) {
  T* o = static_cast<T*>(out);
  if (D <= 32) launch_merge<Tag, T, 1>(part_ml, part_acc, o, rows, D, nparts, stream);
  else if (D <= 64) launch_merge<Tag, T, 2>(part_ml, part_acc, o, rows, D, nparts, stream);
  else if (D <= 128) launch_merge<Tag, T, 4>(part_ml, part_acc, o, rows, D, nparts, stream);
  else if (D <= 256) launch_merge<Tag, T, 8>(part_ml, part_acc, o, rows, D, nparts, stream);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

}  // namespace repro
