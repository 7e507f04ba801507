// K2's non-causal form: every query attends every key < n_keys, over a
// dense per-batch K/V.
//
// Replaces the TPU kernel `flash_attention_pallas` with causal=False
// (src/repro/kernels/flash_attention.py:71, body `_kernel` :25, whose
// causal mask and diagonal skip are off). Layouts: q, out (B, Sq, H, D);
// k, v (B, Skv, Hkv, D); query head h reads KV head h / G, G = H / Hkv.
// fp32 online softmax; output in q's dtype. The encoder-decoder family runs
// it for the encoder's self-attention (Sq = Skv = encoder_seq) and for the
// decoder's cross-attention over the encoder's K/V (a chunk's C queries, a
// verify round's B rows x C candidates, a whole prompt's).
//
// Bound on the H100: the tensor cores for the encoder (1,500 queries over
// 1,500 keys at D 64: ~750 flops a byte, over the ~295 flop/byte bf16
// ridge); the K/V bytes for cross-attention (128 or 5 query rows a key).
//
// Design: the paged-attention core (paged_attention.cuh) without a page
// table: the K/V is B pages of Skv positions, row b's page is b (the core's
// identity layout, as K5's slab), and every row's key limit is n_keys in
// place of the causal limit (`key_limit`). A (batch, KV head)'s G x Sq query
// rows are packed position-major into 64-row tiles (4 warps x 16 rows), or
// one 16-row tile that the four warps share by key quarters when G x Sq <=
// 16; each 64-key K/V tile is staged once for every row of the block; the
// keys are split into spans over blocks as `plan_spans` plans them and the
// spans merged by the shared merge kernel. A partial last query tile and a
// partial last key tile are masked as the core masks them.
#include <limits.h>

#include "paged_attention.cuh"

// ws: float32 workspace of B * Sq * H * nsplit * (D + 2) values;
// the plan (key_groups, nsplit, span) comes from `plan_spans` with
// n_keys.
extern "C" int repro_bidirectional_attention(const void* q, const void* k, const void* v,
                                             void* out, void* ws, int B, int Sq, int Skv,
                                             int H, int Hkv, int D, int n_keys, int key_groups,
                                             int nsplit, int span, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 || n_keys <= 0 ||
      n_keys > Skv || static_cast<long long>(B) * Skv > INT_MAX)
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  repro::PagedArgs a{q, k, v, nullptr, nullptr, 0, out, w,
                     w + 2 * static_cast<size_t>(B) * Sq * H * nsplit, B, Sq, H, Hkv, D, Skv,
                     1, span, 1.f / sqrtf(static_cast<float>(D)), n_keys};
  return repro::paged_attention<repro::Bidirectional>(a, n_keys, key_groups, nsplit, dtype,
                                                      static_cast<cudaStream_t>(stream));
}
