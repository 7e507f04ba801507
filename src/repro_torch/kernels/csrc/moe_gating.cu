// K6: MoE router gating -- softmax over the experts, k rounds of arg-max
// (the lowest index first on equal probabilities), renormalisation of the
// k weights by max(sum, 1e-9).
//
// Replaces the TPU kernel `moe_gating_pallas` (src/repro/kernels/
// moe_gating.py:47, body `_kernel` :22), the function the JAX model computes
// inline in `moe_apply` (softmax -> lax.top_k -> w / max(sum w, 1e-9)).
//
// Bound on the H100: bytes, and tiny. A launch reads T x E float32 logits
// and writes T x k weights and indices: at T = 128, E = 64, k = 6 about
// 39 KB, ~0.012 us at 3.35 TB/s, and the T x E exponentials take less, so
// the launch itself is what costs. Design: one warp per token row, 8 rows
// a block, the ragged T edge masked by whole warps. Lane l holds the
// logits of experts l + 32 j (j < EPL, E <= 32 EPL <= 256), coalesced; an
// expert past E holds -inf. Max and sum are warp shuffles; the k rounds
// each reduce (probability, index) pairs across the warp, ties to the
// lower index, exactly the order of `lax.top_k` and of the Pallas kernel's
// `jnp.argmax`: the dispatch numbers assignments in (token, rank) order, so
// the rank decides which assignment a full expert drops. Round r's pick is
// kept by lane r % 32 in slot r / 32 (registers, no shared memory), and
// every lane sums the clamped picks in round order, as the plain version.
#include <climits>

#include "common.cuh"

namespace repro {

constexpr int kGatingRowsPerBlock = 8;

template <int EPL>
__global__ void moe_gating_kernel(const float* __restrict__ logits, float* __restrict__ w_out,
                                  int* __restrict__ i_out, int T, int E, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kGatingRowsPerBlock + warp;
  if (row >= T) return;  // warp-uniform: the whole warp leaves together
  const float* x = logits + static_cast<size_t>(row) * E;

  float p[EPL];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? x[e] : -INFINITY;
    m = fmaxf(m, p[j]);
  }
  m = warp_allreduce_max(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? expf(p[j] - m) : 0.f;
    s += p[j];
  }
  s = warp_allreduce_sum(s);
#pragma unroll
  for (int j = 0; j < EPL; ++j) p[j] = lane + 32 * j < E ? p[j] / s : -INFINITY;

  float wk[EPL];
  int ik[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    wk[j] = 0.f;
    ik[j] = 0;
  }
  float total = 0.f;
  for (int r = 0; r < k; ++r) {
    // this lane's best; its experts ascend with j, so a strict > keeps the
    // lowest index among equal probabilities
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      if (p[j] > bv) {
        bv = p[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      if (lane + 32 * j == bi) p[j] = -INFINITY;  // picked: never again
      if (lane + 32 * j == r) {
        wk[j] = bv;
        ik[j] = bi;
      }
    }
    total += fmaxf(bv, 0.f);
  }
  const float denom = fmaxf(total, 1e-9f);
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int r = lane + 32 * j;
    if (r < k) {
      w_out[static_cast<size_t>(row) * k + r] = fmaxf(wk[j], 0.f) / denom;
      i_out[static_cast<size_t>(row) * k + r] = ik[j];
    }
  }
}

template <int EPL>
static void launch_gating(const float* x, float* w, int* idx, int T, int E, int k,
                          cudaStream_t stream) {
  const int blocks = (T + kGatingRowsPerBlock - 1) / kGatingRowsPerBlock;
  moe_gating_kernel<EPL><<<blocks, 32 * kGatingRowsPerBlock, 0, stream>>>(x, w, idx, T, E, k);
}

}  // namespace repro

extern "C" int repro_moe_gating(const void* logits, void* w, void* idx, int T, int E, int k,
                                void* stream) {
  if (T <= 0 || E <= 0 || E > 256 || k <= 0 || k > E) return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(logits);
  float* wo = static_cast<float*>(w);
  int* io = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((E + 31) / 32) {
    case 1: repro::launch_gating<1>(x, wo, io, T, E, k, s); break;
    case 2: repro::launch_gating<2>(x, wo, io, T, E, k, s); break;
    case 3: repro::launch_gating<3>(x, wo, io, T, E, k, s); break;
    case 4: repro::launch_gating<4>(x, wo, io, T, E, k, s); break;
    case 5: repro::launch_gating<5>(x, wo, io, T, E, k, s); break;
    case 6: repro::launch_gating<6>(x, wo, io, T, E, k, s); break;
    case 7: repro::launch_gating<7>(x, wo, io, T, E, k, s); break;
    default: repro::launch_gating<8>(x, wo, io, T, E, k, s); break;
  }
  return cudaGetLastError();
}
