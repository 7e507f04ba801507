// K1: paged decode attention on the shared KV page pool.
//
// Replaces the TPU kernel `paged_decode_attention_pallas`
// (src/repro/kernels/decode_attention.py:101, body `_paged_kernel` :67).
// One query token per (row, head) attends the pool through the row's page
// table; GQA maps query head h to KV head h / G; positions >= lengths[b]
// are masked; fp32 online softmax, output in q's dtype.
//
// Launch: one block per (row, KV head), one warp per query head of the
// group, so each page's K/V tile is read from device memory once for all G
// heads that share it. The page loop is bounded by the table width nb (and
// by the row's length): a dead slot's length keeps growing while its table
// row is all sink pages.
#include "common.cuh"

namespace repro {

template <typename T, int DPL>
__global__ void paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                                    const T* __restrict__ v_pool,
                                    const int* __restrict__ table,
                                    const int* __restrict__ lengths, T* __restrict__ out,
                                    int H, int Hkv, int D, int ps, int nb, float scale) {
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = smem + ps * D;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int G = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = kvh * G + warp;
  const int len = max(lengths[b], 0);
  const int n_pages = min(nb, (len + ps - 1) / ps);

  WarpQuery<T, DPL> st;
  load_query(st, q + (static_cast<size_t>(b) * H + h) * D, D, scale, lane);
  attend_pages(st, true, len, k_pool, v_pool, table + static_cast<size_t>(b) * nb, n_pages,
               ps, Hkv, kvh, D, sk, sv);
  store_output(st, out + (static_cast<size_t>(b) * H + h) * D, D, lane);
}

template <typename T, int DPL>
static cudaError_t launch(const void* q, const void* kp, const void* vp, const int* table,
                          const int* lengths, void* out, int B, int H, int Hkv, int D,
                          int ps, int nb, cudaStream_t stream) {
  const size_t smem = 2u * ps * D * sizeof(float);
  auto kernel = paged_decode_kernel<T, DPL>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, Hkv);
  kernel<<<grid, (H / Hkv) * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table,
      lengths, static_cast<T*>(out), H, Hkv, D, ps, nb, 1.f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch(const void* q, const void* kp, const void* vp, const int* table,
                            const int* lengths, void* out, int B, int H, int Hkv, int D,
                            int ps, int nb, cudaStream_t s) {
  if (D <= 32) return launch<T, 1>(q, kp, vp, table, lengths, out, B, H, Hkv, D, ps, nb, s);
  if (D <= 64) return launch<T, 2>(q, kp, vp, table, lengths, out, B, H, Hkv, D, ps, nb, s);
  if (D <= 128) return launch<T, 4>(q, kp, vp, table, lengths, out, B, H, Hkv, D, ps, nb, s);
  if (D <= 256) return launch<T, 8>(q, kp, vp, table, lengths, out, B, H, Hkv, D, ps, nb, s);
  return cudaErrorInvalidValue;
}

}  // namespace repro

extern "C" int repro_paged_decode_attention(const void* q, const void* k_pool,
                                            const void* v_pool, const void* table,
                                            const void* lengths, void* out, int B, int H,
                                            int Hkv, int D, int ps, int nb, int dtype,
                                            void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || (H / Hkv) > 32 || nb <= 0 || ps <= 0)
    return cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(q, k_pool, v_pool, tab, lens, out, B, H, Hkv, D, ps, nb, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(q, k_pool, v_pool, tab, lens, out, B, H, Hkv, D, ps,
                                          nb, s);
  return cudaErrorInvalidValue;
}
