// Paged attention core shared by paged decode (K1), paged chunk prefill
// (K2), paged verify (K4), dense-cache decode (K5) and K2's non-causal form
// over a dense K/V (bidirectional_attention.cu).
//
// What one launch computes. B sequences, each with C query positions and H
// query heads over Hkv KV heads (G = H / Hkv). Query row (b, c, h) sits at
// position base_b + c, base_b = max(row_base[b], 0) + base_offset -- K1 and
// K5: lengths with -1 (C = 1); K4: the candidates' starts with 0; K2: no
// array, its scalar start (B = 1) -- and attends the keys at logical
// positions < min(base_b + c + 1, nb * ps) that row b's page table maps,
// with KV head h / G; with key_limit > 0 (the non-causal form) every row
// attends the keys < min(key_limit, nb * ps) instead. Without a table the
// layout is the identity: position pos of row b is pool row b * nb * ps +
// pos (K5's slab (B, S, Hkv, D) as one page of S a row). Layouts: q, out (B, C, H, D); pools (P, ps, Hkv,
// D); table (B, nb). fp32 online softmax; output in q's dtype.
//
// Bound on the H100: device-memory bytes at the paths' shapes. The K/V of a
// (sequence, KV head) are read once for its G x C query rows: K1 and K5 do
// ~8 flops a byte, K4's 5 candidates ~40, a 32-token chunk ~256; the bf16
// ridge is ~295.
//
// Design. A block of four warps serves one (sequence, KV head, query tile,
// key span):
// - GQA packing: the block's query rows are the G heads x C positions that
//   share one KV head, ordered position-major (row = c * G + g), so rows
//   next to each other share a causal limit. Either each warp owns 16 rows
//   (a 64-row tile, KW = 1), or, when one 16-row tile holds all G x C rows
//   (decode: 8 heads padded to the MMA's 16), the four warps share those
//   rows and each takes a quarter of every key tile (KW = 4). Each K/V tile
//   crosses into shared memory once for every query head that reads it.
// - Split over key spans (flash-decoding): the wrapper plans the spans
//   (`plan_spans`, kernels/decode_attention.py) so that enough blocks fill
//   the 132 SMs. A block writes its rows' unnormalised (max, denominator,
//   acc) for its span to a float32 workspace (with KW = 4 the four warps'
//   states are first combined in shared memory), and the shared merge
//   kernel (common.cuh) merges the spans; a one-span launch writes its
//   output itself. A span wholly past a block's last visible key, and a
//   warp's key share past its rows' limits (the causal diagonal), do no
//   work; the query tiles with the most keys are launched first.
// - Staging: K/V stay in the input dtype in shared memory, copied by
//   cp.async 16 bytes a thread, each of the tile's 64 positions looked up
//   through the page table on its own (any ps, any start; without a table
//   the identity), the lookups one tile ahead in a small index ring; a
//   ring of two tiles keeps the next tile's copy in flight while this
//   tile's math runs.
//   Rows are padded by 16 bytes, so the ldmatrix reads are free of bank
//   conflicts. Positions past the span and columns past D are zero-filled.
// - bf16: both products on the tensor cores, mma.sync m16n8k16 with fp32
//   accumulators. Scores are scaled by 1/sqrt(D) in fp32 after Q K^T
//   (times log2(e): the softmax takes exp2 on the SFU); the online softmax
//   runs on the accumulator fragments (row max by quad shuffles); P is kept
//   to ~16 bits as P_hi + P_lo (two bf16 MMAs into the same accumulator),
//   as the JAX kernels keep P in fp32.
// - float32: the same blocks, ring and fragment ownership, with the
//   products in fp32 FMA on the CUDA cores (TF32 would not hold 2e-5); a
//   thread gathers its rows' P from its quad by shuffles. At D > 128 the
//   ring has one stage (two do not fit the 227 KB).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kPaThreads = 128;  // four warps
constexpr int kPaKeyTile = 64;   // key positions per staged tile
constexpr int kPaRows = 64;      // query rows per block when each warp owns 16

struct PagedArgs {
  const void* q;        // (B, C, H, D)
  const void* k_pool;   // (P, ps, Hkv, D)
  const void* v_pool;
  const int* table;     // (B, nb) page ids, or null: the identity layout
  const int* row_base;  // (B,), or null: every sequence's base is base_offset
  int base_offset;      // added to max(row_base[b], 0)
  void* out;            // (B, C, H, D), written here when nsplit == 1
  float* part_ml;       // (B * C * H, nsplit, 2)
  float* part_acc;      // (B * C * H, nsplit, D)
  int B, C, H, Hkv, D, ps, nb, span;
  float scale;
  int key_limit = 0;    // > 0: every row sees the keys < key_limit, not the causal limit
  // K5s: every span writes its state to the workspace, one span's too, and
  // the merge writes the row's merged statistics -- max (base e) and
  // denominator to stats_ml (B * C * H, 2), the unnormalised accumulator
  // to `out` as float32 -- in place of the output
  bool stats = false;
  float* stats_ml = nullptr;
};

namespace {  // one copy per translation unit: no kernel symbol is shared

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) -> hi = bf16(x, y) and lo = bf16(x - hi, y - hi): hi + lo holds
// ~16 bits of each value.
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Fragment ownership (the m16n8 accumulator layout of mma.sync): lane
// (g = lane / 4, t = lane % 4) holds, of a 16 x 8 tile, rows g and g + 8
// at columns 2t and 2t + 1: element e of s[nt] is row g + 8 * (e / 2),
// column nt * 8 + 2t + e % 2.

// S (16 x 8 NT) = Q (16 x DP) K^T. sq: the warp's 16 query rows; sk: its
// 8 NT keys; rows RS elements apart.
template <int DP, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const __nv_bfloat16* sq,
                                       const __nv_bfloat16* sk, int lane) {
  constexpr int RS = DP + 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ks += 2) {
    unsigned qa[4], qb[4];
    const __nv_bfloat16* qrow = sq + (lane & 15) * RS + (lane >> 4) * 8;
    ldmatrix_x4(qa, qrow + ks * 16);
    ldmatrix_x4(qb, qrow + (ks + 1) * 16);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      unsigned kf[4];  // b fragments of k-steps ks and ks + 1
      ldmatrix_x4(kf, sk + (nt * 8 + (lane & 7)) * RS + ks * 16 + (lane >> 3) * 8);
      mma_bf16(s[nt], qa, kf[0], kf[1]);
      mma_bf16(s[nt], qb, kf[2], kf[3]);
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

template <int DP, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* sq, const float* sk,
                                       int lane) {
  constexpr int RS = DP + 4;
  const float* q0 = sq + (lane >> 2) * RS;
  const float* q1 = q0 + 8 * RS;
  const float* k0 = sk + 2 * (lane & 3) * RS;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(q0 + d);
    const float4 a1 = *reinterpret_cast<const float4*>(q1 + d);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 b0 = *reinterpret_cast<const float4*>(k0 + nt * 8 * RS + d);
      const float4 b1 = *reinterpret_cast<const float4*>(k0 + (nt * 8 + 1) * RS + d);
      s[nt][0] += dot4(a0, b0);
      s[nt][1] += dot4(a0, b1);
      s[nt][2] += dot4(a1, b0);
      s[nt][3] += dot4(a1, b1);
    }
  }
}

// acc (16 x DP) += P (16 x 8 NT, in the score fragments) V (8 NT x DP).
template <int DP, int NT>
__device__ __forceinline__ void accumulate(float (&acc)[DP / 8][4], const float (&p)[NT][4],
                                           const __nv_bfloat16* sv, int lane) {
  constexpr int RS = DP + 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    // the score fragments of keys 16 kk .. 16 kk + 15 are the A fragment
    unsigned hi[4], lo[4];
    split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
    split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
    const __nv_bfloat16* vrow =
        sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
#pragma unroll
    for (int dt = 0; dt < DP / 16; ++dt) {
      unsigned vf[4];  // b fragments of columns 16 dt .. +7 and 16 dt + 8 .. +15
      ldmatrix_x4_trans(vf, vrow + dt * 16);
      mma_bf16(acc[2 * dt], hi, vf[0], vf[1]);
      mma_bf16(acc[2 * dt], lo, vf[0], vf[1]);
      mma_bf16(acc[2 * dt + 1], hi, vf[2], vf[3]);
      mma_bf16(acc[2 * dt + 1], lo, vf[2], vf[3]);
    }
  }
}

template <int DP, int NT>
__device__ __forceinline__ void accumulate(float (&acc)[DP / 8][4], const float (&p)[NT][4],
                                           const float* sv, int lane) {
  constexpr int RS = DP + 4;
  const int quad = lane & ~3;
  const float* v0 = sv + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      // P of key nt * 8 + kk for rows g and g + 8, held by quad lane kk / 2
      const float pg = __shfl_sync(0xffffffffu, p[nt][kk & 1], quad | (kk >> 1));
      const float pg8 = __shfl_sync(0xffffffffu, p[nt][2 + (kk & 1)], quad | (kk >> 1));
      const float* v = v0 + (nt * 8 + kk) * RS;
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        const float2 w = *reinterpret_cast<const float2*>(v + dn * 8);
        acc[dn][0] = fmaf(pg, w.x, acc[dn][0]);
        acc[dn][1] = fmaf(pg, w.y, acc[dn][1]);
        acc[dn][2] = fmaf(pg8, w.x, acc[dn][2]);
        acc[dn][3] = fmaf(pg8, w.y, acc[dn][3]);
      }
    }
  }
}

// The online softmax's exponential: base 2 on bf16 inputs (log2(e) folded
// into the score scale, one SFU instruction), e on float32 (expf, to hold
// 2e-5); a state's max is stored in base e either way.
template <typename T>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (std::is_same<T, float>::value) return expf(x);
  else return exp2f(x);
}

template <typename T>
__device__ __forceinline__ float max_in_base_e(float m) {
  if constexpr (std::is_same<T, float>::value) return m;
  else return m * 0.6931471805599453f;  // -inf stays -inf
}

template <typename T, int DP>
__host__ __device__ constexpr int ring_stages() {
  return (sizeof(T) == 4 && DP > 128) ? 1 : 2;
}

template <typename T, int DP, int KW>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kPaRows / KW) + 2u * ring_stages<T, DP>() * kPaKeyTile) *
         (DP + 16 / sizeof(T)) * sizeof(T);
}

// grid (query tiles, spans, B * Hkv); kPaThreads threads.
template <class Tag, typename T, int DP, int KW>
__global__ void __launch_bounds__(kPaThreads) paged_attention_kernel(const PagedArgs a) {
  constexpr int EPC = 16 / sizeof(T);      // elements per 16-byte chunk
  constexpr int RS = DP + EPC;             // padded shared-memory row (elements)
  constexpr int CPR = DP / EPC;            // chunks per row
  constexpr int QB = kPaRows / KW;         // query rows per block
  constexpr int KPW = kPaKeyTile / KW;     // keys of a tile per warp
  constexpr int NT = KPW / 8;              // 8-key score tiles per warp
  constexpr int NS = ring_stages<T, DP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int sidx[NS][kPaKeyTile];     // pool row (page * ps + offset) of each staged
                                           // position; -1 past the span's visible keys
  T* sq = reinterpret_cast<T*>(smem_raw);  // QB query rows
  T* ring = sq + QB * RS;                  // stage s: 64 K rows, then 64 V rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.H / a.Hkv, NQ = G * a.C;
  const int b = blockIdx.z / a.Hkv, kvh = blockIdx.z - b * a.Hkv;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * QB;  // the longest causal rows first
  const int nq = min(QB, NQ - r0);
  const int split = blockIdx.y, nparts = gridDim.y;
  const bool direct = nparts == 1 && !a.stats;  // the block writes the output itself
  const int cap = a.nb * a.ps;
  const int k_begin = split * a.span;
  const int span_end = min(k_begin + a.span, cap);
  const T* qg = static_cast<const T*>(a.q);
  const T* kg = static_cast<const T*>(a.k_pool);
  const T* vg = static_cast<const T*>(a.v_pool);
  const int* trow = a.table ? a.table + static_cast<size_t>(b) * a.nb : nullptr;
  const int row0 = trow ? 0 : b * cap;  // the identity layout's first pool row of b
  const int dch = a.D / EPC;  // chunks of a row that hold data
  // flat (B, C, H) index of block row i: the output and workspace row
  auto out_row = [&](int i) -> size_t {
    const int r = r0 + i, c = r / G;
    return (static_cast<size_t>(b) * a.C + c) * a.H + kvh * G + (r - c * G);
  };
  auto lookup = [&](int pos, int end) {  // the pool row of a logical position
    if (pos >= end) return -1;
    return trow ? trow[pos / a.ps] * a.ps + pos % a.ps : row0 + pos;
  };

  // What does not wait for the rows' bases goes first: the queries' copies
  // and the page-table entries of the span's first NS tiles.
  for (int e = tid; e < QB * CPR; e += kPaThreads) {
    const int i = e / CPR, ch = e - i * CPR;
    const bool ok = i < nq && ch < dch;
    cp_async16(sq + i * RS + ch * EPC, ok ? qg + out_row(i) * a.D + ch * EPC : qg, ok);
  }
  int pre[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s)
    pre[s] = tid < kPaKeyTile ? lookup(k_begin + s * kPaKeyTile + tid, span_end) : -1;
  // 64 bits: a dead row's base (a stale start or length, far past its
  // table) plus c + 1 must not wrap
  const long long base =
      (a.row_base ? max(a.row_base[b], 0) : 0) + static_cast<long long>(a.base_offset);
  // the block's rows see keys < min(base + c + 1, cap), its last row most;
  // non-causal (key_limit > 0): every row sees keys < min(key_limit, cap)
  auto row_limit = [&](int r) -> long long {
    return a.key_limit > 0 ? a.key_limit : base + r / G + 1;
  };
  const int k_end =
      static_cast<int>(min(static_cast<long long>(span_end), row_limit(r0 + nq - 1)));

  if (k_begin >= k_end) {  // no row of the block sees a key of this span
    if (direct) {           // ... nor any key at all: zeros
      for (int e = tid; e < nq * a.D; e += kPaThreads)
        static_cast<T*>(a.out)[out_row(e / a.D) * a.D + e % a.D] = from_float<T>(0.f);
    } else {
      for (int i = tid; i < nq; i += kPaThreads) {
        const size_t p = out_row(i) * nparts + split;
        a.part_ml[2 * p] = -INFINITY;
        a.part_ml[2 * p + 1] = 0.f;
      }
    }
    cp_async_commit();  // the queries' copies: drained before the block exits
    cp_async_wait<0>();
    return;
  }

  auto stage_tile = [&](int j) {  // start the K/V copies of tile j into stage j % NS
    T* sk = ring + (j % NS) * 2 * kPaKeyTile * RS;
    T* sv = sk + kPaKeyTile * RS;
    for (int e = tid; e < kPaKeyTile * CPR; e += kPaThreads) {
      const int t = e / CPR, ch = e - t * CPR;
      const int row = sidx[j % NS][t];
      const bool ok = row >= 0 && ch < dch;
      const size_t off = ok ? (static_cast<size_t>(row) * a.Hkv + kvh) * a.D + ch * EPC : 0;
      cp_async16(sk + t * RS + ch * EPC, kg + off, ok);
      cp_async16(sv + t * RS + ch * EPC, vg + off, ok);
    }
  };

  // this warp's rows and key share; the limits of its two fragment rows
  const int wrow = KW == 1 ? warp * 16 : 0;
  const int kw = KW == 1 ? 0 : warp;
  const int t4 = lane & 3;
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = wrow + (lane >> 2) + 8 * h;
    lim[h] = i < nq ? static_cast<int>(min(row_limit(r0 + i), static_cast<long long>(k_end))) : 0;
  }
  const int warp_lim = __reduce_max_sync(0xffffffffu, max(lim[0], lim[1]));
  const float scale =
      std::is_same<T, float>::value ? a.scale : a.scale * 1.4426950408889634f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int ntiles = (k_end - k_begin + kPaKeyTile - 1) / kPaKeyTile;
  if (tid < kPaKeyTile) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
      sidx[s][tid] = k_begin + s * kPaKeyTile + tid < k_end ? pre[s] : -1;
  }
  __syncthreads();
  stage_tile(0);  // with the queries: group 0
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < NS; ++s) {
    if (s < ntiles) stage_tile(s);
    cp_async_commit();
  }
  for (int j = 0; j < ntiles; ++j) {
    // tile j + NS's page-table entries, in flight while tile j is multiplied
    const int next = tid < kPaKeyTile ? lookup(k_begin + (j + NS) * kPaKeyTile + tid, k_end) : -1;
    cp_async_wait<NS - 1>();  // tile j has landed (this thread's copies)
    __syncthreads();          // ... and every thread's
    const int kb = k_begin + j * kPaKeyTile + kw * KPW;  // the warp's first key
    if (kb < warp_lim) {
      const T* sk = ring + (j % NS) * 2 * kPaKeyTile * RS + kw * KPW * RS;
      const T* sv = sk + kPaKeyTile * RS;
      float s[NT][4];
      scores<DP, NT>(s, sq + wrow * RS, sk, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            const int pos = kb + nt * 8 + 2 * t4 + (e & 1);
            s[nt][e] = pos < lim[h] ? s[nt][e] * scale : -INFINITY;
            mx = fmaxf(mx, s[nt][e]);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float ref = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = softmax_exp<T>(m[h] - ref);  // 0 while the row has seen no key
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            s[nt][e] = softmax_exp<T>(s[nt][e] - ref);
            sum += s[nt][e];
          }
        }
        l[h] = l[h] * alpha + sum;  // this thread's columns; the quad sums at the end
        m[h] = m_new;
#pragma unroll
        for (int dn = 0; dn < DP / 8; ++dn) {
          acc[dn][2 * h] *= alpha;
          acc[dn][2 * h + 1] *= alpha;
        }
      }
      accumulate<DP, NT>(acc, s, sv, lane);
    }
    if (tid < kPaKeyTile) sidx[j % NS][tid] = next;  // stage j % NS takes tile j + NS
    __syncthreads();  // every warp is done with stage j % NS
    if (j + NS < ntiles) stage_tile(j + NS);
    cp_async_commit();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  T* out = static_cast<T*>(a.out);
  if constexpr (KW == 1) {  // each warp's rows are its own: write their states
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = wrow + (lane >> 2) + 8 * h;
      if (i >= nq) continue;
      if (direct) {         // the span is the whole row: its output, as the merge writes it
        const float inv = 1.f / fmaxf(l[h], 1e-30f);
        T* dst = out + out_row(i) * a.D;
#pragma unroll
        for (int dn = 0; dn < DP / 8; ++dn) {
          const int d = dn * 8 + 2 * t4;
          if (d < a.D) {
            dst[d] = from_float<T>(acc[dn][2 * h] * inv);
            dst[d + 1] = from_float<T>(acc[dn][2 * h + 1] * inv);
          }
        }
        continue;
      }
      const size_t p = out_row(i) * nparts + split;
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        const int d = dn * 8 + 2 * t4;
        if (d < a.D)
          *reinterpret_cast<float2*>(a.part_acc + p * a.D + d) =
              make_float2(acc[dn][2 * h], acc[dn][2 * h + 1]);
      }
      if (t4 == 0) {
        a.part_ml[2 * p] = max_in_base_e<T>(m[h]);
        a.part_ml[2 * p + 1] = l[h];
      }
    }
  } else {  // the KW warps share the block's 16 rows: combine their states first
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the combine
    float* sml = reinterpret_cast<float*>(ring);  // [KW][16] (max, denominator)
    float* sden = sml + KW * 16 * 2;               // [16] the combined denominator
    float* sacc = sden + 16;                       // [KW][16][DP], rescaled
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = (lane >> 2) + 8 * h;
      if (t4 == 0) {
        sml[2 * (warp * 16 + i)] = m[h];
        sml[2 * (warp * 16 + i) + 1] = l[h];
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = (lane >> 2) + 8 * h;
      float mb = -INFINITY, lb = 0.f;
#pragma unroll
      for (int w = 0; w < KW; ++w) mb = fmaxf(mb, sml[2 * (w * 16 + i)]);
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const float mw = sml[2 * (w * 16 + i)];
        if (mw != -INFINITY) lb += sml[2 * (w * 16 + i) + 1] * softmax_exp<T>(mw - mb);
      }
      const float wgt = m[h] == -INFINITY ? 0.f : softmax_exp<T>(m[h] - mb);
      float* dst = sacc + (warp * 16 + i) * DP + 2 * t4;
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn)
        *reinterpret_cast<float2*>(dst + dn * 8) =
            make_float2(acc[dn][2 * h] * wgt, acc[dn][2 * h + 1] * wgt);
      m[h] = mb;
      l[h] = lb;
      if (warp == 0 && t4 == 0) sden[i] = lb;
    }
    __syncthreads();
    for (int e = tid; e < nq * DP; e += kPaThreads) {
      const int i = e / DP, d = e - i * DP;
      if (d >= a.D) continue;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < KW; ++w) v += sacc[(w * 16 + i) * DP + d];
      if (direct)
        out[out_row(i) * a.D + d] = from_float<T>(v * (1.f / fmaxf(sden[i], 1e-30f)));
      else
        a.part_acc[(out_row(i) * nparts + split) * a.D + d] = v;
    }
    if (!direct && warp == 0 && t4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = (lane >> 2) + 8 * h;
        if (i < nq) {
          const size_t p = out_row(i) * nparts + split;
          a.part_ml[2 * p] = max_in_base_e<T>(m[h]);
          a.part_ml[2 * p + 1] = l[h];
        }
      }
    }
  }
}

template <class Tag, typename T, int DP, int KW>
cudaError_t launch_core(const PagedArgs& a, int nsplit, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DP, KW>();
  auto kernel = paged_attention_kernel<Tag, T, DP, KW>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = (a.H / a.Hkv) * a.C;
  dim3 grid((rows + kPaRows / KW - 1) / (kPaRows / KW), nsplit, a.B * a.Hkv);
  kernel<<<grid, kPaThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || (nsplit == 1 && !a.stats)) return err;  // the core wrote `out`
  const size_t out_rows = static_cast<size_t>(a.B) * a.C * a.H;
  if (a.stats)
    return merge_spans<Tag, float>(a.part_ml, a.part_acc, a.out, out_rows, a.D, nsplit, stream,
                                   a.stats_ml);
  return merge_spans<Tag, T>(a.part_ml, a.part_acc, a.out, out_rows, a.D, nsplit, stream);
}

template <class Tag, typename T, int DP>
cudaError_t launch_kw(const PagedArgs& a, int key_groups, int nsplit, cudaStream_t s) {
  return key_groups == 4 ? launch_core<Tag, T, DP, 4>(a, nsplit, s)
                         : launch_core<Tag, T, DP, 1>(a, nsplit, s);
}

template <class Tag, typename T>
cudaError_t launch_dp(const PagedArgs& a, int key_groups, int nsplit, cudaStream_t s) {
  if (a.D <= 32) return launch_kw<Tag, T, 32>(a, key_groups, nsplit, s);
  if (a.D <= 64) return launch_kw<Tag, T, 64>(a, key_groups, nsplit, s);
  if (a.D <= 128) return launch_kw<Tag, T, 128>(a, key_groups, nsplit, s);
  return launch_kw<Tag, T, 256>(a, key_groups, nsplit, s);
}

// Check a launch plan and run the core, then (nsplit > 1) the merge, on
// `stream`.
// n_keys: the positions the walk may visit (K1, K4 and K5 nb * ps, K2
// start + C); the plan must cover them with nsplit spans of `a.span`
// positions (a multiple of the key tile), and no span may start past them.
template <class Tag>
cudaError_t paged_attention(const PagedArgs& a, int n_keys, int key_groups, int nsplit,
                            int dtype, cudaStream_t s) {
  const int epc = dtype == kBFloat16 ? 8 : 4;
  const bool aligned = (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k_pool) |
                        reinterpret_cast<uintptr_t>(a.v_pool)) % 16 == 0;
  if (a.B <= 0 || a.C <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.D <= 0 || a.D > 256 ||
      a.D % epc != 0 || a.ps <= 0 || a.nb <= 0 || n_keys <= 0 || !aligned ||
      (key_groups != 1 && key_groups != 4) || nsplit <= 0 || nsplit > 65535 ||
      a.B * a.Hkv > 65535 || a.span <= 0 || a.span % kPaKeyTile != 0 ||
      static_cast<long long>(nsplit) * a.span < n_keys ||
      static_cast<long long>(nsplit - 1) * a.span >= n_keys)
    return cudaErrorInvalidValue;
  if (dtype == kFloat32) return launch_dp<Tag, float>(a, key_groups, nsplit, s);
  if (dtype == kBFloat16) return launch_dp<Tag, __nv_bfloat16>(a, key_groups, nsplit, s);
  return cudaErrorInvalidValue;
}

}  // namespace

}  // namespace repro
