// K1: paged decode attention on the shared KV page pool.
//
// Replaces the TPU kernel `paged_decode_attention_pallas`
// (src/repro/kernels/decode_attention.py:101, body `_paged_kernel` :67).
// One query token per (row, head) attends the pool through the row's page
// table; GQA maps query head h to KV head h / G; positions >= lengths[b]
// are masked; fp32 online softmax, output in q's dtype.
//
// Bound on the H100: device-memory bytes. A (row, KV head) reads its
// visible positions of K and V once for its G query heads: ~8 flops a byte
// at qwen2.5-3b width (G = 8, D = 128), far under the ~295 flop/byte bf16
// ridge, so the least time is the visible KV bytes over 3.35 TB/s.
//
// Design: the paged-attention core (paged_attention.cuh) with C = 1, over
// the B rows in one launch. A row's G query heads are one 16-row MMA tile
// (8 heads padded to 16 at full width), and the block's four warps each
// take a quarter of every 64-position K/V tile, then combine their states
// in shared memory; the row's keys are split into spans over blocks (4
// rows x 2 KV heads is 8 blocks at full width on 132 SMs without the
// split), and the shared merge kernel combines the spans.
// The walk is bounded by the table width nb (a dead slot's length keeps
// growing while its table row is all sink pages); a zero length sees no
// key, every span reports an empty state, and the merge writes zeros.
#include "paged_attention.cuh"

// ws: float32 workspace of B * H * nsplit * (D + 2) values;
// the plan (key_groups, nsplit, span) comes from `plan_spans` with
// n_keys = nb * ps.
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pool,
                                            const void* v_pool, const void* table,
                                            const void* lengths, void* out, void* ws, int B,
                                            int H, int Hkv, int D, int ps, int nb,
                                            int key_groups, int nsplit, int span, int dtype,
                                            void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || nb <= 0 || ps <= 0 || nb > (1 << 30) / ps)
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  repro::PagedArgs a{q, k_pool, v_pool, static_cast<const int*>(table),
                     static_cast<const int*>(lengths), -1, out, w,
                     w + 2 * static_cast<size_t>(B) * H * nsplit, B, 1, H, Hkv, D, ps, nb,
                     span, 1.f / sqrtf(static_cast<float>(D))};
  return repro::paged_attention<repro::PagedDecode>(a, nb * ps, key_groups, nsplit, dtype,
                                                    static_cast<cudaStream_t>(stream));
}
