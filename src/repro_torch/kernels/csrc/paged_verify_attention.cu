// K4: paged verify attention (speculative decoding) on the shared KV page pool.
//
// Replaces the TPU kernel `paged_verify_attention_pallas`
// (src/repro/kernels/decode_attention.py:185, body `_paged_verify_kernel` :144).
// Every row b scores C candidate tokens (the pending token plus its drafts,
// whose K/V the caller has already written to the row's pages); candidate
// c sits at position starts[b] + c and attends, causally, every key at
// kv_pos <= starts[b] + c that the page-table row maps. GQA maps query head
// h to KV head h / G; fp32 online softmax; output in q's dtype. Layouts:
// q, out (B, H, C, D); pools (P, ps, Hkv, D); table (B, nb); starts (B,).
//
// Bound on the H100: device-memory bytes. A (row, KV head) reads at most
// starts[b] + C positions of K and V once for its G x C query rows (40 at
// qwen2.5-3b width): ~40 flop per byte read, far under the ~295 flop/byte
// bf16 ridge, so the least time is the visible KV bytes over 3.35 TB/s.
//
// Design: the flash-decoding split. A block serves one (row, KV head) --
// all of its G x C query rows, split into groups of at most QB only where
// G x C x D outgrows the block's accumulators -- over one span of the key
// positions, so each K/V tile crosses from device memory into shared
// memory once for every query row that shares it, and the spans of one
// row run on separate SMs (B x Hkv alone is 8 blocks at qwen2.5-3b width).
// Keys are walked in tiles of 64 positions, each position looked up
// through the page table on its own, so pages of any size (ps = 256 at
// D = 128 included) and starts that are not page-aligned, with candidates
// crossing a page, need no special case. Per tile: scores (query row x
// key) in shared memory, one warp per query row for the online softmax,
// then each thread folds the tile's P V into its fp32 accumulators in
// registers. A span writes its unnormalised (max, denominator, acc) to a
// float32 workspace; the shared merge kernel (common.cuh) merges the
// spans of each query row. The walk stops at min(nb * ps, starts[b] + C),
// so a dead row (all-sink table, stale start) stays inside its table, and
// a span past a row's end reports an empty state; key 0 is visible to
// every candidate, so no row sees zero keys. Products run on the CUDA cores: simple first, fast later.
#include <algorithm>

#include "common.cuh"

namespace repro {

constexpr int kVerifyThreads = 256;
constexpr int kVerifyTile = 64;     // key positions per shared-memory tile
constexpr int kVerifyAcc = 32;      // output accumulators per thread
constexpr int kVerifyMaxRows = 128;

template <typename T>
__global__ void __launch_bounds__(kVerifyThreads)
    paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool, const int* __restrict__ table,
                        const int* __restrict__ starts, float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int H, int Hkv, int C, int D, int ps,
                        int nb, int QB, int span, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int G = H / Hkv, NQ = G * C;
  const int groups = (NQ + QB - 1) / QB;
  const int kvh = blockIdx.y / groups;
  const int r0 = (blockIdx.y - kvh * groups) * QB;  // first query row (g * C + c)
  const int nq = min(QB, NQ - r0);
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int Dp = D + 1;                     // padded K rows: conflict-free score reads
  float* sq = smem;                         // nq x D queries
  float* sk = sq + QB * D;                  // tile x (D + 1)
  float* sv = sk + kVerifyTile * Dp;        // tile x D
  float* ss = sv + kVerifyTile * D;         // nq x tile scores, then probabilities
  float* sm = ss + QB * kVerifyTile;        // running max per query row
  float* sl = sm + QB;                      // running denominator
  float* sa = sl + QB;                      // this tile's rescale factor
  int* spage = reinterpret_cast<int*>(sa + QB);  // page id of each tile position

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int start = max(starts[b], 0);
  const int n_vis = min(nb * ps, start + C);
  const int k_begin = split * span, k_end = min(n_vis, k_begin + span);
  // workspace row of query row i: ((b * Hkv + kvh) * NQ + r0 + i) * nsplit + split
  const size_t row0 = (static_cast<size_t>(b) * Hkv + kvh) * NQ + r0;
  const int n_out = nq * D;

  if (k_begin >= k_end) {                   // this span lies past the row's keys
    for (int i = tid; i < nq; i += blockDim.x) {
      part_ml[2 * ((row0 + i) * nsplit + split)] = -INFINITY;
      part_ml[2 * ((row0 + i) * nsplit + split) + 1] = 0.f;
    }
    return;
  }
  // the G x C query rows of one KV head are contiguous in (B, H, C, D)
  const T* qb = q + row0 * D;
  for (int e = tid; e < n_out; e += blockDim.x) sq[e] = to_float(qb[e]);
  for (int i = tid; i < nq; i += blockDim.x) {
    sm[i] = -INFINITY;
    sl[i] = 0.f;
  }
  float acc[kVerifyAcc];
#pragma unroll
  for (int k = 0; k < kVerifyAcc; ++k) acc[k] = 0.f;

  for (int t0 = k_begin; t0 < k_end; t0 += kVerifyTile) {
    const int tn = min(kVerifyTile, k_end - t0);
    __syncthreads();  // the previous tile is consumed
    if (tid < tn) spage[tid] = table[static_cast<size_t>(b) * nb + (t0 + tid) / ps];
    __syncthreads();
    for (int e = tid; e < tn * D; e += blockDim.x) {
      const int t = e / D, d = e - t * D;
      const size_t off =
          ((static_cast<size_t>(spage[t]) * ps + (t0 + t) % ps) * Hkv + kvh) *
              static_cast<size_t>(D) + d;
      sk[t * Dp + d] = to_float(k_pool[off]);
      sv[t * D + d] = to_float(v_pool[off]);
    }
    __syncthreads();

    for (int e = tid; e < nq * kVerifyTile; e += blockDim.x) {
      const int i = e / kVerifyTile, t = e - i * kVerifyTile;
      const int c = (r0 + i) % C;
      float s = -INFINITY;
      if (t < tn && t0 + t <= start + c) {
        const float* qi = sq + i * D;
        const float* kt = sk + t * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qi[d] * kt[d];
        s = dot * scale;
      }
      ss[e] = s;
    }
    __syncthreads();

    for (int i = warp; i < nq; i += nwarps) {
      float* row = ss + i * kVerifyTile;
      float mx = -INFINITY;
      for (int t = lane; t < kVerifyTile; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_allreduce_max(mx);
      const float m_old = sm[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < kVerifyTile; t += 32) {
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
    for (int k = 0; k < kVerifyAcc; ++k) {
      const int e = tid + k * kVerifyThreads;
      if (e < n_out) {
        const int i = e / D, d = e - i * D;
        const float* pi = ss + i * kVerifyTile;
        float a = acc[k] * sa[i];
        for (int t = 0; t < tn; ++t) a += pi[t] * sv[t * D + d];
        acc[k] = a;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kVerifyAcc; ++k) {
    const int e = tid + k * kVerifyThreads;
    if (e < n_out) {
      const int i = e / D, d = e - i * D;
      part_acc[((row0 + i) * nsplit + split) * D + d] = acc[k];
    }
  }
  for (int i = tid; i < nq; i += blockDim.x) {
    part_ml[2 * ((row0 + i) * nsplit + split)] = sm[i];
    part_ml[2 * ((row0 + i) * nsplit + split) + 1] = sl[i];
  }
}

// Query rows per block: all G x C of a KV head where the accumulators allow.
static int rows_per_block(int G, int C, int D) {
  return std::min(G * C, std::min(kVerifyMaxRows, kVerifyThreads * kVerifyAcc / D));
}

static size_t smem_bytes(int QB, int D) {
  const size_t floats = static_cast<size_t>(QB) * D + static_cast<size_t>(kVerifyTile) * (2 * D + 1) +
                        static_cast<size_t>(QB) * kVerifyTile + 3u * QB;
  return floats * sizeof(float) + kVerifyTile * sizeof(int);
}

template <typename T>
static cudaError_t launch(const void* q, const void* kp, const void* vp, const int* table,
                          const int* starts, void* out, float* ws, int B, int H, int Hkv,
                          int C, int D, int ps, int nb, int nsplit, cudaStream_t stream) {
  const int G = H / Hkv;
  const int QB = rows_per_block(G, C, D);
  const size_t smem = smem_bytes(QB, D);
  auto kernel = paged_verify_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (nb * ps + kVerifyTile - 1) / kVerifyTile;
  const int span = (tiles + nsplit - 1) / nsplit * kVerifyTile;
  const size_t rows = static_cast<size_t>(B) * H * C;
  float* part_ml = ws;
  float* part_acc = ws + 2 * rows * nsplit;
  dim3 grid(B, Hkv * ((G * C + QB - 1) / QB), nsplit);
  kernel<<<grid, kVerifyThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table,
      starts, part_ml, part_acc, H, Hkv, C, D, ps, nb, QB, span,
      1.f / sqrtf(static_cast<float>(D)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // merge the spans of each query row: the workspace rows are those of (B, H, C, D)
  return merge_spans<PagedVerify, T>(part_ml, part_acc, out, rows, D, nsplit, stream);
}

}  // namespace repro

// ws: float32 workspace of B * H * C * nsplit * (D + 2) values.
extern "C" int repro_paged_verify_attention(const void* q, const void* k_pool,
                                            const void* v_pool, const void* table,
                                            const void* starts, void* out, void* ws, int B,
                                            int H, int Hkv, int C, int D, int ps, int nb,
                                            int nsplit, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256 || nb <= 0 ||
      ps <= 0 || nsplit <= 0 || nsplit > (nb * ps + repro::kVerifyTile - 1) / repro::kVerifyTile)
    return cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(table);
  const int* st = static_cast<const int*>(starts);
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(q, k_pool, v_pool, tab, st, out, w, B, H, Hkv, C, D, ps, nb,
                                nsplit, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(q, k_pool, v_pool, tab, st, out, w, B, H, Hkv, C, D,
                                        ps, nb, nsplit, s);
  return cudaErrorInvalidValue;
}
