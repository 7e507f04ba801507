// K5: one-token flash-decoding over a dense per-row KV cache (the slab layout).
//
// Replaces the TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention.py:274, body `_kernel` :24). Row b's
// query heads attend the cache positions kv_pos < lengths[b] of their KV
// head (GQA: query head h reads KV head h / G); positions at or past the
// length are masked, and a length past S sees the whole cache (a slot that
// is not live keeps advancing its position). fp32 scores and online
// softmax; output in q's dtype. Layouts: q, out (B, H, D); caches
// (B, S, Hkv, D); lengths (B,).
//
// Bound on the H100: device-memory bytes. A (row, KV head) reads
// min(length, S) positions of K and V once for its G query heads (8 at
// qwen2.5-3b width): ~8 flop per byte read, far under the ~295 flop/byte
// bf16 ridge, so the least time is the visible KV bytes over 3.35 TB/s.
//
// Design: the flash-decoding split that paged verify attention (K4) uses,
// on a dense cache. A block serves one (row, KV head) -- all G query heads
// of the group -- over one span of key positions, so each K/V tile crosses
// from device memory into shared memory once for the G heads that share
// it, and the spans of one row run on separate SMs (B x Hkv alone is 8
// blocks at qwen2.5-3b width on 132 SMs). Per 64-position tile: scores
// (query head x key) in shared memory, one warp per query head for the
// online softmax, then each thread folds the tile's P V into its fp32
// accumulators in registers. A span writes its unnormalised (max,
// denominator, acc) to a float32 workspace; the shared merge kernel
// (common.cuh) merges the spans of each query head. A span at or past min(length, S) reports an
// empty state, so a zero length gives zeros (the Pallas kernel's finite
// -1e30 mask would average V instead). Products run on the CUDA cores:
// simple first, fast later.
#include <algorithm>

#include "common.cuh"

namespace repro {

constexpr int kDecThreads = 256;
constexpr int kDecTile = 64;      // key positions per shared-memory tile
constexpr int kDecAcc = 16;       // output accumulators per thread: G * D <= 4096

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
    dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                        const T* __restrict__ v_cache, const int* __restrict__ lengths,
                        float* __restrict__ part_ml, float* __restrict__ part_acc, int S,
                        int H, int Hkv, int D, int span, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int G = H / Hkv;
  const int Dp = D + 1;                     // padded K rows: conflict-free score reads
  float* sq = smem;                         // G x D queries
  float* sk = sq + G * D;                   // tile x (D + 1)
  float* sv = sk + kDecTile * Dp;           // tile x D
  float* ss = sv + kDecTile * D;            // G x tile scores, then probabilities
  float* sm = ss + G * kDecTile;            // running max per query head
  float* sl = sm + G;                       // running denominator
  float* sa = sl + G;                       // this tile's rescale factor

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int n_vis = min(max(lengths[b], 0), S);
  const int k_begin = split * span, k_end = min(n_vis, k_begin + span);
  // the G query heads of one KV head are rows b * H + kvh * G + g of
  // (B, H, D); workspace row r holds nsplit partial states
  const size_t row0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G;
  const int n_out = G * D;

  if (k_begin >= k_end) {                   // this span lies past the row's keys
    for (int i = tid; i < G; i += blockDim.x) {
      part_ml[2 * ((row0 + i) * nsplit + split)] = -INFINITY;
      part_ml[2 * ((row0 + i) * nsplit + split) + 1] = 0.f;
    }
    return;
  }
  const T* qb = q + row0 * D;
  for (int e = tid; e < n_out; e += blockDim.x) sq[e] = to_float(qb[e]);
  for (int i = tid; i < G; i += blockDim.x) {
    sm[i] = -INFINITY;
    sl[i] = 0.f;
  }
  float acc[kDecAcc];
#pragma unroll
  for (int k = 0; k < kDecAcc; ++k) acc[k] = 0.f;

  const size_t row_stride = static_cast<size_t>(Hkv) * D;   // one cache position
  const T* kb = k_cache + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(kvh) * D;
  const T* vb = v_cache + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(kvh) * D;

  for (int t0 = k_begin; t0 < k_end; t0 += kDecTile) {
    const int tn = min(kDecTile, k_end - t0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < tn * D; e += blockDim.x) {
      const int t = e / D, d = e - t * D;
      const size_t off = static_cast<size_t>(t0 + t) * row_stride + d;
      sk[t * Dp + d] = to_float(kb[off]);
      sv[t * D + d] = to_float(vb[off]);
    }
    __syncthreads();

    for (int e = tid; e < G * kDecTile; e += blockDim.x) {
      const int i = e / kDecTile, t = e - i * kDecTile;
      float s = -INFINITY;
      if (t < tn) {
        const float* qi = sq + i * D;
        const float* kt = sk + t * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qi[d] * kt[d];
        s = dot * scale;
      }
      ss[e] = s;
    }
    __syncthreads();

    for (int i = warp; i < G; i += nwarps) {
      float* row = ss + i * kDecTile;
      float mx = -INFINITY;
      for (int t = lane; t < kDecTile; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_allreduce_max(mx);
      const float m_old = sm[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < kDecTile; t += 32) {
        const float p = row[t] == -INFINITY ? 0.f : expf(row[t] - m_new);
        row[t] = p;
        sum += p;
      }
      sum = warp_allreduce_sum(sum);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 1.f : expf(m_old - m_new);
        sa[i] = alpha;
        sl[i] = sl[i] * alpha + sum;
        sm[i] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kDecAcc; ++k) {
      const int e = tid + k * kDecThreads;
      if (e < n_out) {
        const int i = e / D, d = e - i * D;
        const float* pi = ss + i * kDecTile;
        float a = acc[k] * sa[i];
        for (int t = 0; t < tn; ++t) a += pi[t] * sv[t * D + d];
        acc[k] = a;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kDecAcc; ++k) {
    const int e = tid + k * kDecThreads;
    if (e < n_out) {
      const int i = e / D, d = e - i * D;
      part_acc[((row0 + i) * nsplit + split) * D + d] = acc[k];
    }
  }
  for (int i = tid; i < G; i += blockDim.x) {
    part_ml[2 * ((row0 + i) * nsplit + split)] = sm[i];
    part_ml[2 * ((row0 + i) * nsplit + split) + 1] = sl[i];
  }
}

static size_t dec_smem_bytes(int G, int D) {
  const size_t floats = static_cast<size_t>(G) * D +
                        static_cast<size_t>(kDecTile) * (2 * D + 1) +
                        static_cast<size_t>(G) * kDecTile + 3u * G;
  return floats * sizeof(float);
}

template <typename T>
static cudaError_t dec_launch(const void* q, const void* kc, const void* vc,
                              const int* lengths, void* out, float* ws, int B, int S, int H,
                              int Hkv, int D, int nsplit, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = dec_smem_bytes(G, D);
  auto kernel = dense_decode_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kDecTile - 1) / kDecTile;
  const int span = (tiles + nsplit - 1) / nsplit * kDecTile;
  const size_t rows = static_cast<size_t>(B) * H;
  float* part_ml = ws;
  float* part_acc = ws + 2 * rows * nsplit;
  dim3 grid(B, Hkv, nsplit);
  kernel<<<grid, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), lengths,
      part_ml, part_acc, S, H, Hkv, D, span, 1.f / sqrtf(static_cast<float>(D)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // merge the spans of each query head: the workspace rows are those of (B, H, D)
  return merge_spans<DenseDecode, T>(part_ml, part_acc, out, rows, D, nsplit, stream);
}

}  // namespace repro

// ws: float32 workspace of B * H * nsplit * (D + 2) values.
extern "C" int repro_dense_decode_attention(const void* q, const void* k_cache,
                                            const void* v_cache, const void* lengths,
                                            void* out, void* ws, int B, int S, int H, int Hkv,
                                            int D, int nsplit, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256 ||
      (H / Hkv) * D > repro::kDecThreads * repro::kDecAcc || nsplit <= 0 ||
      nsplit > (S + repro::kDecTile - 1) / repro::kDecTile)
    return cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::dec_launch<float>(q, k_cache, v_cache, lens, out, w, B, S, H, Hkv, D, nsplit,
                                    s);
  if (dtype == repro::kBFloat16)
    return repro::dec_launch<__nv_bfloat16>(q, k_cache, v_cache, lens, out, w, B, S, H, Hkv,
                                            D, nsplit, s);
  return cudaErrorInvalidValue;
}
