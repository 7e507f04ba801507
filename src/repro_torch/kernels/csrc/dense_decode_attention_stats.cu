// K5s: K5's statistics on one shard of a sequence-sharded slab, the
// per-shard leaf of the sequence-sharded decode (distributed/decode.py;
// the jnp body of src/repro/distributed/decode.py:33 `_partial_attn`, no
// Pallas kernel).
//
// Bound on the H100: device-memory bytes, as K5: the shard's visible K/V
// read once for the G query heads that share it; the outputs are
// (B, H, D + 2) float32.
//
// Design: K5's launch on the paged-attention core (paged_attention.cuh)
// over the shard, with the row limit moved by the shard's start, and the
// shared merge kernel (common.cuh) in its statistics mode. It is its own
// translation unit only so that nvcc compiles its instantiations of the
// core beside K5's, in parallel: in one file the build took ~94 s instead
// of ~50 s on the card's machine.
#include <limits.h>

#include "paged_attention.cuh"

// K5s: K5 on one shard of a sequence-sharded cache (distributed/decode.py's
// per-shard leaf), returning the softmax statistics of its keys instead of
// the output. The shard (B, S, Hkv, D) holds global positions [start,
// start + S); row b sees the local keys < lengths[b] - start (the core's
// row base lengths[b] - 1 - start), none where its length ends before the
// shard. Writes, float32: ml (B, H, 2) -- the max of the scaled scores, in
// base e, and the denominator relative to it -- and acc (B, H, D), the
// probability-weighted sum of V before the division; a row that sees no
// key gets -inf, 0 and zeros. The core's spans all go to the workspace and
// the shared merge kernel, in its statistics mode, merges them.
extern "C" int repro_dense_decode_attention_stats(const void* q, const void* k_shard,
                                                  const void* v_shard, const void* lengths,
                                                  void* ml, void* acc, void* ws, int B, int S,
                                                  int H, int Hkv, int D, int start,
                                                  int key_groups, int nsplit, int span,
                                                  int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || start < 0 ||
      static_cast<long long>(B) * S > INT_MAX)
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  repro::PagedArgs a{q, k_shard, v_shard, nullptr, static_cast<const int*>(lengths),
                     -1 - start, acc, w, w + 2 * static_cast<size_t>(B) * H * nsplit, B, 1, H,
                     Hkv, D, S, 1, span, 1.f / sqrtf(static_cast<float>(D))};
  a.stats = true;
  a.stats_ml = static_cast<float*>(ml);
  return repro::paged_attention<repro::DenseDecodeStats>(a, S, key_groups, nsplit, dtype,
                                                         static_cast<cudaStream_t>(stream));
}
