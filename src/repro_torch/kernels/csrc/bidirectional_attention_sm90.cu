// K2's non-causal form at the encoder's shape, on Hopper's wgmma and TMA.
//
// Replaces the TPU kernel `flash_attention_pallas` with causal=False
// (src/repro/kernels/flash_attention.py:86, the pallas_call; body `_kernel`
// :25, whose causal mask and diagonal skip are off) for bf16 at head width
// 64 with many query rows a query head: whisper-medium's encoder, 1,500
// frames over 1,500, and a slab prompt's whole-prompt cross-attention. The
// wrapper (`flash_attention.bidirectional_route`) sends every other launch
// to the paged-attention core (bidirectional_attention.cu). Layouts: q, out
// (B, Sq, H, D); k, v (B, Skv, Hkv, D), all bf16, D = 64; query head h reads
// KV head h / G, G = H / Hkv; every query sees the keys < n_keys. fp32 online
// softmax, output in bf16.
//
// Bound on the H100: the tensor cores. The encoder does 4 x 1,500^2 x 16 x 64
// = 9.2 GFLOP on 12.3 MB (q, k, v read and out written once: ~750 flops a
// byte, 2.5 times the bf16 ridge): 0.0093 ms at 989 TFLOP/s. Its 36 M
// exponentials need 0.0086 ms of the SFUs (16 lanes an SM), nearly as long.
// The core it replaces ran 7.6x the bound, on Ampere's mma.sync with P as
// two bf16 halves.
//
// Design: one CTA per (batch, query head, 192-row query tile), no key
// split, no merge and no workspace. Three consumer warpgroups of 64 rows
// each sit beside one producer warpgroup whose first thread starts every
// TMA load; `setmaxnreg` moves registers from it to the consumers. The
// encoder is 8 tiles x 16 heads = 128 CTAs, one wave on 132 SMs (128-row
// tiles would be 192 CTAs, 1.45 waves). A CTA reads its KV head's K/V
// whatever G is: query heads that share a KV head are not packed together.
// - TMA: 4-D tensor maps over (D, heads, seq, B) with the 128-byte swizzle
//   (a 64-wide bf16 row is 128 bytes, the swizzle atom's width, which is
//   the layout a wgmma shared-memory descriptor reads). Q is loaded once,
//   64 rows a consumer warpgroup; 128-key K and V tiles go into a ring of
//   kSmStages = 3 stages, each with its own full barrier (K and V apart, so Q K^T
//   starts before V lands) and one empty barrier that every consumer thread
//   arrives on when its products have read the stage. TMA zero-fills rows
//   past Sq and past Skv; keys in [n_keys, Skv) are masked to -inf in the
//   last tile. The output goes back the same way: each warpgroup writes its
//   bf16 rows into its Q buffer and stores them as one box, which drops the
//   rows past Sq.
// - S = Q K^T: four wgmma.m64n128k16 a tile, both operands in shared
//   memory (K-major, the descriptor advanced 32 bytes a k-step within the
//   swizzled row). O += P V: eight wgmma.m64n64k16 with P as the register A
//   operand; the S accumulator's fragment is the A fragment's, so P is
//   packed to bf16 in place, no shuffle. V is read MN-major through the
//   descriptor's transpose bit: no transposed copy of V.
// - Overlap: a warpgroup starts tile i's S with tile i - 1's P V and runs
//   tile i's softmax while that P V is on the tensor cores. At D 64 the
//   exponentials take as long as the products (one exp2 a score on 16 SFU
//   lanes an SM, against 256 flops a score on the tensor cores), so two
//   tokens pass round the warpgroups on named barriers: one orders the
//   start of products, one the softmaxes, and a warpgroup hands the first
//   on as soon as its S has landed, so the next one's products run during
//   its softmax.
// - Softmax: scores scaled by log2(e) / sqrt(D) into exp2 (ex2.approx);
//   each thread holds two rows' 32 columns, the row max by two quad
//   shuffles; the denominator is summed from the fp32 probabilities, per
//   thread, and reduced over the quad once at the end.
// - P is rounded to bf16 once, unnormalised. The plain version rounds the
//   normalised P to bf16 as well (`p.to(v.dtype)`); each rounding moves an
//   output by at most 2^-9 x max|v|, so the two differ by at most 2^-8 x
//   max|v| (`tests/test_torch_bidirectional_sm90.py` holds a walk of this
//   kernel to the plain version).
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace {  // one copy per translation unit: no kernel symbol is shared

constexpr int kSmD = 64;                            // head width: one 128-byte row
constexpr int kSmKeyTile = 128;                     // keys a stage
constexpr int kSmStages = 3;                        // K/V ring
constexpr int kSmWgRows = 64;                       // query rows a consumer warpgroup
constexpr int kSmNwg = 3;                           // consumer warpgroups: 192 query rows
constexpr int kSmTileBytes = kSmKeyTile * kSmD * 2;  // 16 KB: one K or V stage
constexpr int kSmQBytes = kSmWgRows * kSmD * 2;      // 8 KB: one warpgroup's Q

// ---- mbarriers, TMA, wgmma (PTX) ---------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 4-D box from shared memory to the tensor map's tensor (rows past its
// edges are not written), as one bulk group of this thread; then wait until
// the shared memory has been read.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group.read 0;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile whose rows
// are 128 bytes: start address, leading and stride byte offsets (16-byte
// units), layout type 1 (128B swizzle). The tiles start on 1,024 bytes, so
// the base offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Two tokens pass round the consumer warpgroups in order 0, 1, 2 on named
// barriers of 256 threads (the warpgroup that waits and the one before it,
// which arrives): token 0 (barriers 1 .. 3) is the right to start products,
// token 1 (barriers 4 .. 6) the right to run a softmax.
__device__ __forceinline__ void token_wait(int token, int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + token * kSmNwg + wg) : "memory");
}

__device__ __forceinline__ void token_pass(int token, int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + token * kSmNwg + (wg + 1) % kSmNwg)
               : "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, fp32) (+)= A (64 x 16, bf16, shared, K-major) B (16 x 128,
// bf16, shared, K-major); scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16, bf16, registers) B (16 x 64, bf16,
// shared, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) -> bf16x2 bits, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// One tile's softmax, in place: the scores sc of key columns kv0 .. kv0 +
// 127 (the ownership below) become exp2(s * scale_log2 - m), m the rows'
// new running max (m0, m1 updated; keys >= n_keys see -inf, and every tile
// holds a key < n_keys, so m is finite); c0, c1 rescale what was summed
// under the old max (0 on the first tile: ex2(-inf)); r0, r1 gain this
// thread's share of the rows' sums (fp32, before any rounding).
__device__ __forceinline__ void tile_softmax(float (&sc)[64], int kv0, int n_keys, int col,
                                             float scale_log2, float& m0, float& m1, float& c0,
                                             float& c1, float& r0, float& r1) {
  if (kv0 + kSmKeyTile > n_keys) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kv0 + 8 * j + col + (e & 1) >= n_keys) sc[4 * j + e] = -INFINITY;
  }
  float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    t0 = fmaxf(t0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    t1 = fmaxf(t1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));  // the quad holds the row
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
  const float n0 = fmaxf(m0, t0 * scale_log2), n1 = fmaxf(m1, t1 * scale_log2);
  c0 = ex2(m0 - n0);
  c1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -n0));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -n0));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -n1));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -n1));
    r0 += sc[4 * j] + sc[4 * j + 1];
    r1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
}

// P (fp32, the accumulator's ownership) -> the m64k16 A registers of P V's
// eight k-steps: k-step kk is pa[4 kk .. 4 kk + 3].
__device__ __forceinline__ void pack_p(const float (&p)[64], uint32_t (&pa)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pa[2 * j] = pack_bf16(p[4 * j], p[4 * j + 1]);
    pa[2 * j + 1] = pack_bf16(p[4 * j + 2], p[4 * j + 3]);
  }
}

// Registers a thread keeps after `setmaxnreg`: FlashAttention-3's split for
// three consumer warpgroups beside one producer warpgroup (within the SM's
// 65,536).
constexpr int kSmProducerRegs = 32, kSmConsumerRegs = 160;

// Fragment ownership (the wgmma accumulator layout): thread t of a
// consumer warpgroup, warp w = t / 32, lane l, holds rows 16 w + l / 4 and
// that + 8 of the warpgroup's 64, at columns 8 j + 2 (l % 4) + {0, 1} of
// every 8-column block j: element 4 j + e is row + 8 (e / 2), column
// 8 j + 2 (l % 4) + e % 2. The m64k16 A operand in registers has the same
// ownership, so the bf16 pairs of S's columns 16 kk .. 16 kk + 15 are the A
// registers of P's k-step kk.
__global__ void __launch_bounds__((kSmNwg + 1) * 128, 1)
    bidirectional_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                        const __grid_constant__ CUtensorMap tm_k,
                                        const __grid_constant__ CUtensorMap tm_v,
                                        const __grid_constant__ CUtensorMap tm_o, int Sq, int H,
                                        int G, int n_keys, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles start on 1,024 bytes (the 128-byte swizzle's period)
  const uint32_t s_q = (smem_addr(smem_raw) + 1023u) & ~1023u;  // 3 x 8 KB
  const uint32_t s_k = s_q + kSmNwg * kSmQBytes;                   // kSmStages x 16 KB
  const uint32_t s_v = s_k + kSmStages * kSmTileBytes;             // kSmStages x 16 KB
  const uint32_t bars = s_v + kSmStages * kSmTileBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kSmStages + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * kSmStages + s); };

  const int q0 = blockIdx.x * kSmNwg * kSmWgRows, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (n_keys + kSmKeyTile - 1) / kSmKeyTile;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kSmStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kSmNwg * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kSmNwg) {
    // ---- producer warpgroup: one thread starts every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kSmProducerRegs));
    if (t == 0) {
      const int boxes = min(kSmNwg, (Sq - q0 + kSmWgRows - 1) / kSmWgRows);  // q0 < Sq
      mbar_expect_tx(q_full, boxes * kSmQBytes);
      for (int w = 0; w < boxes; ++w)
        tma_load_4d(s_q + w * kSmQBytes, &tm_q, q_full, 0, h, q0 + w * kSmWgRows, b);
      const int hk = h / G;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kSmStages;
        mbar_wait(empty(s), ((i / kSmStages) & 1) ^ 1);
        mbar_expect_tx(k_full(s), kSmTileBytes);
        tma_load_4d(s_k + s * kSmTileBytes, &tm_k, k_full(s), 0, hk, i * kSmKeyTile, b);
        mbar_expect_tx(v_full(s), kSmTileBytes);
        tma_load_4d(s_v + s * kSmTileBytes, &tm_v, v_full(s), 0, hk, i * kSmKeyTile, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kSmConsumerRegs));
    const int lane = t % 32;
    const int row0 = q0 + wg * kSmWgRows + 16 * (t / 32) + lane / 4;  // and row0 + 8
    const int col = 2 * (lane % 4);
    const uint64_t q_desc = sw128_desc(s_q + wg * kSmQBytes, 16, 1024);
    auto k_desc = [&](int s) { return sw128_desc(s_k + s * kSmTileBytes, 16, 1024); };
    auto v_desc = [&](int s) { return sw128_desc(s_v + s * kSmTileBytes, 1024, 1024); };
    // A warpgroup whose 64 rows all lie past Sq (a partial last query tile)
    // computes on whatever its Q buffer holds and stores nothing: every
    // warpgroup keeps the same barrier and turn sequence.
    float o[32], sc[64];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    uint32_t pa[32];  // P of the tile whose P V is next, bf16 pairs
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    // Tile i's softmax runs while tile i - 1's P V is on the tensor cores:
    // with token 0 an iteration starts S_i = Q K_i and O += P_{i-1} V_{i-1}
    // and waits for S_i alone; it passes token 0 on (the next warpgroup's
    // products now queue behind its own) and, with token 1, computes P_i;
    // then it waits for the P V, rescales O and packs P_i. Tile 0's S and
    // the last tile's P V stand outside the loop.
    if (wg == 0) {  // both tokens start at warpgroup 0
      token_pass(0, kSmNwg - 1);
      token_pass(1, kSmNwg - 1);
    }
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    token_wait(0, wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSmD / 16; ++kk)  // S_0: the rows in four k-steps of 32 bytes
      wgmma_m64n128k16_ss(sc, q_desc + 2 * kk, k_desc(0) + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    token_pass(0, wg);
    token_wait(1, wg);
    {
      float c0, c1;
      tile_softmax(sc, 0, n_keys, col, scale_log2, m0, m1, c0, c1, l0, l1);
    }
    token_pass(1, wg);
    pack_p(sc, pa);
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % kSmStages, sp = (i - 1) % kSmStages;
      mbar_wait(k_full(s), (i / kSmStages) & 1);
      mbar_wait(v_full(sp), ((i - 1) / kSmStages) & 1);
      fence_regs(o);
      fence_regs(pa);
      token_wait(0, wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSmD / 16; ++kk)  // S_i
        wgmma_m64n128k16_ss(sc, q_desc + 2 * kk, k_desc(s) + 2 * kk, kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kSmKeyTile / 16; ++kk)  // P V: V's rows 2,048 bytes a k-step
        wgmma_m64n64k16_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                           v_desc(sp) + kk * (16 * 128 >> 4));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      token_pass(0, wg);
      token_wait(1, wg);
      float c0, c1, r0 = 0.f, r1 = 0.f;
      tile_softmax(sc, i * kSmKeyTile, n_keys, col, scale_log2, m0, m1, c0, c1, r0, r1);
      token_pass(1, wg);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty(sp));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
      l0 = l0 * c0 + r0;
      l1 = l1 * c1 + r1;
      pack_p(sc, pa);
    }
    const int sl = (n_tiles - 1) % kSmStages;
    mbar_wait(v_full(sl), ((n_tiles - 1) / kSmStages) & 1);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSmKeyTile / 16; ++kk)
      wgmma_m64n64k16_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                         v_desc(sl) + kk * (16 * 128 >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty(sl));
    {
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float i0 = 1.f / l0, i1 = 1.f / l1;
      // O in bf16 into this warpgroup's Q buffer (its last S has been
      // read), in the 128-byte swizzle the map stores from: 16-byte
      // chunk j of row r sits at chunk j ^ (r % 8); then one box store.
      const uint32_t buf = s_q + wg * kSmQBytes;
      const int r = 16 * (t / 32) + lane / 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t at = buf + r * 128 + ((j ^ (r & 7)) << 4) + 2 * col;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                     "r"(pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0)));
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * 128),
                     "r"(pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1)));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + 2 * kSmNwg + wg) : "memory");
      if (t == 0 && q0 + wg * kSmWgRows < Sq)
        tma_store_4d(&tm_o, buf, 0, h, q0 + wg * kSmWgRows, b);
    }
  }
}

// ---- host: tensor maps and the launch ----------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query so
// that the library links no libcuda; null where the installed CUDA lacks it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (B, seq, heads, 64) tensor as a 4-D map over (64, heads, seq, B),
// boxes of one head's `rows` rows, 128-byte swizzle, zeros past every edge.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* base, int heads, int seq,
                int B, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kSmD), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = kSmD * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};  // bytes, dims 1..3
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kSmD), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_sm90(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                        const CUtensorMap& mo, int B, int Sq, int H, int G, int n_keys,
                        cudaStream_t stream) {
  const size_t smem = 1024 + kSmNwg * kSmQBytes + 2 * kSmStages * kSmTileBytes +
                      8 * (1 + 3 * kSmStages);
  const auto kernel = bidirectional_attention_sm90_kernel;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(kSmD));
  const dim3 grid((Sq + kSmNwg * kSmWgRows - 1) / (kSmNwg * kSmWgRows), H, B);
  kernel<<<grid, (kSmNwg + 1) * 128, smem, stream>>>(mq, mk, mv, mo, Sq, H, G, n_keys, scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q (B, Sq, H, 64), k and v (B, Skv, Hkv, 64), out (B, Sq, H, 64): bf16,
// contiguous, 16-byte aligned.
extern "C" int repro_bidirectional_attention_sm90(const void* q, const void* k, const void* v,
                                                  void* out, int B, int Sq, int Skv, int H,
                                                  int Hkv, int D, int n_keys, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 || D != repro::kSmD ||
      n_keys <= 0 || n_keys > Skv || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const repro::EncodeTiled encode = repro::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mo;
  if (!repro::tensor_map(encode, &mq, q, H, Sq, B, repro::kSmWgRows) ||
      !repro::tensor_map(encode, &mo, out, H, Sq, B, repro::kSmWgRows) ||
      !repro::tensor_map(encode, &mk, k, Hkv, Skv, B, repro::kSmKeyTile) ||
      !repro::tensor_map(encode, &mv, v, Hkv, Skv, B, repro::kSmKeyTile))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return repro::launch_sm90(mq, mk, mv, mo, B, Sq, H, H / Hkv, n_keys, s);
}
