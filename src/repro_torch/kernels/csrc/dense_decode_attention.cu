// K5: one-token flash-decoding over a dense per-row KV cache (the slab layout).
//
// Replaces the TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention.py:274, body `_kernel` :24). Row b's
// query heads attend the cache positions kv_pos < lengths[b] of their KV
// head (GQA: query head h reads KV head h / G); positions at or past the
// length are masked, and a length past S sees the whole cache (a slot that
// is not live keeps advancing its position). fp32 online softmax; output in
// q's dtype. Layouts: q, out (B, H, D); caches (B, S, Hkv, D); lengths (B,).
//
// Bound on the H100: device-memory bytes. A (row, KV head) reads
// min(length, S) positions of K and V once for its G query heads (8 at
// qwen2.5-3b width): ~8 flops per byte read, far under the ~295 flop/byte
// bf16 ridge, so the least time is the visible KV bytes over 3.35 TB/s.
//
// Design: the paged-attention core (paged_attention.cuh) as K1 runs it,
// over the slab without a page table: the caches are a pool of B pages of
// S positions, row b's page is b (the core's identity layout, so no table
// is built a call). A row's G query heads are one 16-row MMA tile (8 heads
// padded to 16 at full width; more heads take 64-row tiles), the block's
// warps share each 64-position K/V tile, and the row's keys are split into
// spans over blocks, merged by the shared merge kernel. A zero length sees
// no key and gives zeros (the Pallas kernel's finite -1e30 mask would
// average V instead).
#include <limits.h>

#include "paged_attention.cuh"

// ws: float32 workspace of B * H * nsplit * (D + 2) values;
// the plan (key_groups, nsplit, span) comes from `plan_spans` with n_keys = S.
extern "C" int repro_dense_decode_attention(const void* q, const void* k_cache,
                                            const void* v_cache, const void* lengths,
                                            void* out, void* ws, int B, int S, int H, int Hkv,
                                            int D, int key_groups, int nsplit, int span,
                                            int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      static_cast<long long>(B) * S > INT_MAX)
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  repro::PagedArgs a{q, k_cache, v_cache, nullptr, static_cast<const int*>(lengths), -1, out,
                     w, w + 2 * static_cast<size_t>(B) * H * nsplit, B, 1, H, Hkv, D, S, 1,
                     span, 1.f / sqrtf(static_cast<float>(D))};
  return repro::paged_attention<repro::DenseDecode>(a, S, key_groups, nsplit, dtype,
                                                    static_cast<cudaStream_t>(stream));
}
