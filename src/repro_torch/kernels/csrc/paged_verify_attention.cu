// K4: paged verify attention (speculative decoding) on the shared KV page pool.
//
// Replaces the TPU kernel `paged_verify_attention_pallas`
// (src/repro/kernels/decode_attention.py:185, body `_paged_verify_kernel` :144).
// Every row b scores C candidate tokens (the pending token plus its drafts,
// whose K/V the caller has already written to the row's pages); candidate
// c sits at position starts[b] + c and attends, causally, every key at
// kv_pos <= starts[b] + c that the page-table row maps. GQA maps query head
// h to KV head h / G; fp32 online softmax; output in q's dtype. Layouts:
// q, out (B, C, H, D) -- the order the engine's projection gives, so it
// needs no transposed copy; pools (P, ps, Hkv, D); table (B, nb); starts (B,).
//
// Bound on the H100: device-memory bytes. A (row, KV head) reads at most
// starts[b] + C positions of K and V once for its G x C query rows (40 at
// qwen2.5-3b width): ~40 flops per byte read, far under the ~295 flop/byte
// bf16 ridge, so the least time is the visible KV bytes over 3.35 TB/s.
//
// Design: the paged-attention core (paged_attention.cuh) with C candidate
// positions a row and each row's base at its start: the G heads x C
// candidates of a (row, KV head) are packed position-major into 64-row
// tensor-core tiles (40 rows at full width: the fourth warp idles), so
// each K/V tile is staged once for all of them, through the page table
// position by position (any page size, starts that are not page-aligned
// with candidates crossing a page); the keys are split into spans over
// blocks and merged by the shared merge kernel. The walk stops at
// min(nb * ps, starts[b] + C), so a dead row (all-sink table, stale start)
// stays inside its table; key 0 is visible to every candidate, so no row
// sees zero keys.
#include "paged_attention.cuh"

// ws: float32 workspace of B * C * H * nsplit * (D + 2) values;
// the plan (key_groups, nsplit, span) comes from `plan_spans` with
// n_keys = nb * ps.
extern "C" int repro_paged_verify_attention(const void* q, const void* k_pool,
                                            const void* v_pool, const void* table,
                                            const void* starts, void* out, void* ws, int B,
                                            int C, int H, int Hkv, int D, int ps, int nb,
                                            int key_groups, int nsplit, int span, int dtype,
                                            void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || H % Hkv != 0 || nb <= 0 || ps <= 0 ||
      nb > (1 << 30) / ps)
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  repro::PagedArgs a{q, k_pool, v_pool, static_cast<const int*>(table),
                     static_cast<const int*>(starts), 0, out, w,
                     w + 2 * static_cast<size_t>(B) * C * H * nsplit, B, C, H, Hkv, D, ps, nb,
                     span, 1.f / sqrtf(static_cast<float>(D))};
  return repro::paged_attention<repro::PagedVerify>(a, nb * ps, key_groups, nsplit, dtype,
                                                    static_cast<cudaStream_t>(stream));
}
