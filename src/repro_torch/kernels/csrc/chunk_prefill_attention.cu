// K2: causal chunk-prefill attention over the paged KV pool.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:71, body `_kernel` :25) in the form
// the serving engine needs: the C query rows of one sequence sit at
// positions start .. start+C-1 and attend, causally (kv_pos <= q_pos), the
// keys that the page-table row `ctx` maps, the chunk's own K/V included
// (written to the pool before the call). With start = 0 and an identity
// table over a contiguous cache it is flash_attention_pallas(causal=True)
// with Sq = Skv; the slab layout's whole-prompt prefill is that case.
//
// Bound on the H100: close to the ridge, on bytes at the paths' shapes. A
// 32-token chunk of qwen2.5-3b (16 query heads, 2 KV heads, head_dim 128)
// does 4 x 16 x 128 flops per (query, visible key) pair and reads 2 x 2 x
// 128 x 2 bytes per visible position, so at most ~256 flops a byte, under
// the ~295 flop/byte bf16 ridge; a whole prompt from position 0 (the slab
// launch, C in the hundreds) does ~C/8 times that per byte and is bound by
// the tensor cores.
//
// Design: the paged-attention core (paged_attention.cuh) with B = 1, the
// scalar `start` and the single table row: the 8 query heads x C positions
// of a KV head are packed into 64-row tiles (4 warps x 16 rows), so each
// K/V tile is staged once for all 8 heads that read it; the key positions
// are split into spans over blocks and merged by the shared merge kernel;
// a tile's span past the tile's last row, and a warp's key share past its
// rows (the TPU kernel's diagonal skip, flash_attention.py:57), do no work.
#include "paged_attention.cuh"

// ws: float32 workspace of C * H * nsplit * (D + 2) values;
// the plan (key_groups, nsplit, span) comes from `plan_spans` with
// n_keys = start + C.
extern "C" int repro_chunk_prefill_attention(const void* q, const void* k_pool,
                                             const void* v_pool, const void* ctx, void* out,
                                             void* ws, int C, int H, int Hkv, int D, int ps,
                                             int n_ctx, int start, int key_groups, int nsplit,
                                             int span, int dtype, void* stream) {
  if (C <= 0 || Hkv <= 0 || H % Hkv != 0 || n_ctx <= 0 || ps <= 0 || start < 0 ||
      n_ctx > (1 << 30) / ps || start > n_ctx * ps - C)
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  repro::PagedArgs a{q, k_pool, v_pool, static_cast<const int*>(ctx), nullptr, start, out, w,
                     w + 2 * static_cast<size_t>(C) * H * nsplit, 1, C, H, Hkv, D, ps, n_ctx,
                     span, 1.f / sqrtf(static_cast<float>(D))};
  return repro::paged_attention<repro::ChunkPrefill>(a, start + C, key_groups, nsplit, dtype,
                                                     static_cast<cudaStream_t>(stream));
}
