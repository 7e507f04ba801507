// K2: causal chunk-prefill attention over the paged KV pool.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:71, body `_kernel` :25) in the form
// the serving engine needs: the C query rows of one sequence sit at
// positions start .. start+C-1 and attend, causally (kv_pos <= q_pos), the
// keys that the page-table row `ctx` maps, the chunk's own K/V included
// (written to the pool before the call). With start = 0 and an identity
// table over a contiguous cache it is flash_attention_pallas(causal=True)
// with Sq = Skv.
//
// Launch: one block per (query head, query tile of BQ rows), one warp per
// query row; the block visits only the pages that some row of its tile can
// see (the TPU kernel's diagonal skip, flash_attention.py:57) and stages
// each page's K/V in shared memory once for all of its rows.
#include "common.cuh"

namespace repro {

constexpr int kRowsPerBlock = 16;

template <typename T, int DPL>
__global__ void chunk_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                                     const T* __restrict__ v_pool,
                                     const int* __restrict__ ctx, T* __restrict__ out, int C,
                                     int H, int Hkv, int D, int ps, int n_ctx, int start,
                                     float scale) {
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = smem + ps * D;
  const int h = blockIdx.x;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int row = row0 + warp;
  const bool active = row < C;
  const int last_row = min(C, row0 + kRowsPerBlock) - 1;
  const int max_vis = start + last_row + 1;  // keys the tile's last row sees
  const int n_pages = min(n_ctx, (max_vis + ps - 1) / ps);

  WarpQuery<T, DPL> st;
  const size_t qoff = (static_cast<size_t>(active ? row : 0) * H + h) * D;
  load_query(st, q + qoff, D, scale, lane);
  attend_pages(st, active, start + row + 1, k_pool, v_pool, ctx, n_pages, ps, Hkv, kvh, D,
               sk, sv);
  if (active) store_output(st, out + qoff, D, lane);
}

template <typename T, int DPL>
static cudaError_t launch(const void* q, const void* kp, const void* vp, const int* ctx,
                          void* out, int C, int H, int Hkv, int D, int ps, int n_ctx,
                          int start, cudaStream_t stream) {
  const size_t smem = 2u * ps * D * sizeof(float);
  auto kernel = chunk_prefill_kernel<T, DPL>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, (C + kRowsPerBlock - 1) / kRowsPerBlock);
  kernel<<<grid, kRowsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), ctx,
      static_cast<T*>(out), C, H, Hkv, D, ps, n_ctx, start,
      1.f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch(const void* q, const void* kp, const void* vp, const int* ctx,
                            void* out, int C, int H, int Hkv, int D, int ps, int n_ctx,
                            int start, cudaStream_t s) {
  if (D <= 32) return launch<T, 1>(q, kp, vp, ctx, out, C, H, Hkv, D, ps, n_ctx, start, s);
  if (D <= 64) return launch<T, 2>(q, kp, vp, ctx, out, C, H, Hkv, D, ps, n_ctx, start, s);
  if (D <= 128) return launch<T, 4>(q, kp, vp, ctx, out, C, H, Hkv, D, ps, n_ctx, start, s);
  if (D <= 256) return launch<T, 8>(q, kp, vp, ctx, out, C, H, Hkv, D, ps, n_ctx, start, s);
  return cudaErrorInvalidValue;
}

}  // namespace repro

extern "C" int repro_chunk_prefill_attention(const void* q, const void* k_pool,
                                             const void* v_pool, const void* ctx, void* out,
                                             int C, int H, int Hkv, int D, int ps, int n_ctx,
                                             int start, int dtype, void* stream) {
  if (C <= 0 || Hkv <= 0 || H % Hkv != 0 || n_ctx <= 0 || ps <= 0 || start < 0)
    return cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(ctx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(q, k_pool, v_pool, tab, out, C, H, Hkv, D, ps, n_ctx, start,
                                  s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(q, k_pool, v_pool, tab, out, C, H, Hkv, D, ps,
                                          n_ctx, start, s);
  return cudaErrorInvalidValue;
}
