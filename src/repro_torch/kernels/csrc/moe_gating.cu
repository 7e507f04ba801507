// K6: MoE router gating -- softmax over the experts, k rounds of arg-max
// (the lowest index first on equal probabilities), renormalisation of the
// k weights by max(sum, 1e-9) -- fused with the GShard capacity numbering
// of the dispatch that follows it.
//
// Replaces the TPU kernel `moe_gating_pallas` (src/repro/kernels/
// moe_gating.py:47, body `_kernel` :22), the function the JAX model computes
// inline in `moe_apply` (softmax -> lax.top_k -> w / max(sum w, 1e-9)), and
// the numbering that `moe_apply` computes after it
// (src/repro/models/layers.py:649-654): assignments in (token, rank) order,
// pos = the number of earlier assignments to the same expert, keep = pos <
// C, slot = keep ? e C + pos : E C (the drop slot), and the kept weight
// w keep. Every token of the call counts, pad positions and dead rows too.
//
// Bound on the H100: bytes, and tiny (T x E logits in; T x k weights,
// indices, kept weights and int64 slots out: ~30 KB at T = 128, E = 64,
// k = 6, bf16), so latency is what costs -- and, before this kernel took
// the numbering, the ~10 launches of cast, one_hot, cumsum, gather and
// where around it. Design:
//  - Gating: one warp per token row, exactly as before (so the weights and
//    indices keep their bits): lane l holds the logits of experts l + 32 j
//    (j < EPL, E <= 32 EPL <= 256), converted from the model dtype in
//    registers (bf16 -> fp32 is exact); max and sum are warp shuffles in a
//    fixed tree; the k rounds each reduce (probability, index) pairs across
//    the warp, ties to the lower index -- the order of `lax.top_k` and of
//    the Pallas kernel's `jnp.argmax`, which matters: the numbering runs in
//    (token, rank) order, so the rank decides which assignment a full expert
//    drops. Round r's pick is kept by lane r % 32 in slot r / 32.
//  - Numbering: the T rows are spread over a thread-block cluster of cs <=
//    8 blocks, `per` rows a block, a warp a row. A block's assignments are
//    split into contiguous shares, one a warp; a warp counts its share's
//    experts 32 assignments at a time (__match_any_sync: one leader a
//    distinct expert adds the group's size), the block scans those counts
//    over its warps per expert, and after a cluster barrier each block
//    adds the totals of the blocks before it, read from their shared
//    memory (distributed shared memory), a (block, expert) a thread. A
//    second walk gives each assignment base + its rank among equal experts
//    in its 32, and its kept weight from the weights the block kept in
//    shared memory; the barrier that keeps a block's totals alive for its
//    peers is split, its wait at the end. No host
//    synchronisation, no global atomics, nothing left to reset between
//    launches (a CUDA graph replays it as it is), no allocation. The
//    wrapper caps T x k (MAX_ASSIGNMENTS) so a block's expert bytes fit in
//    shared memory; `gating_plan` (kernels/moe_gating.py) is the plan.
//  - Groups (the grouped dispatch of `moe_apply`, the JAX
//    `jax.vmap(_moe_dispatch_group)`): the T rows are G contiguous groups
//    of T / G, each numbered against its own capacity C with group-local
//    slots e C + pos or E C. The grid is (cs, G): grid row g is one
//    cluster, which reads rows [g T/G, (g+1) T/G) and writes their
//    weights, indices, slots and kept weights at the same rows. G is a
//    runtime grid dimension, so no instance is added; G = 1 is the
//    ungrouped launch.
#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace repro {

constexpr int kGatingMaxCluster = 8;

// Gating of one token row by one warp: weights and indices to w[r], i[r]
// (r < k); with `sidx`, also the indices as bytes to sidx[r] and the
// weights to sw[r] (shared memory, for the numbering).
template <typename T, int EPL>
__device__ __forceinline__ void gate_row(const T* __restrict__ x, int E, int k, int lane,
                                         float* __restrict__ w_out, int* __restrict__ i_out,
                                         unsigned char* sidx, float* sw) {
  float p[EPL];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? to_float<T>(x[e]) : -INFINITY;
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
      const float w = fmaxf(wk[j], 0.f) / denom;
      w_out[r] = w;
      i_out[r] = ik[j];
      if (sidx != nullptr) {
        sidx[r] = static_cast<unsigned char>(ik[j]);
        sw[r] = w;
      }
    }
  }
}

// Blocks of one cluster share the n_tok rows of its group (blockIdx.y),
// `per` a block. With slot == null
// only the gating runs. Shared memory (numbering only): wcnt[nwarps][E]
// (per-warp expert counts, then their exclusive scan), btot[E] (the block's
// totals, read by later blocks), cbase[E] (the totals of earlier blocks),
// the block's weights (per x k floats), its expert indices (per x k bytes).
template <typename T, int EPL>
__global__ void __launch_bounds__(1024)
    moe_gating_kernel(const T* __restrict__ logits, float* __restrict__ w_out,
                      int* __restrict__ i_out, long long* __restrict__ slot_out,
                      float* __restrict__ kept_out, int n_tok, int E, int k, int C, int per) {
  extern __shared__ int smem_i[];
  const bool numbering = slot_out != nullptr;
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  // rows are the call's: the group's first row is blockIdx.y * n_tok
  const int first = static_cast<int>(blockIdx.y) * n_tok;
  const int row_lo = first + min(n_tok, b * per), row_hi = first + min(n_tok, b * per + per);
  int* wcnt = smem_i;
  int* btot = wcnt + nwarps * E;
  int* cbase = btot + E;
  float* sw = reinterpret_cast<float*>(cbase + E);
  unsigned char* sidx = reinterpret_cast<unsigned char*>(sw + per * k);

  if (numbering)
    for (int i = threadIdx.x; i < (nwarps + 2) * E; i += blockDim.x) wcnt[i] = 0;  // wcnt, btot, cbase
  for (int row = row_lo + warp; row < row_hi; row += nwarps) {
    const size_t o = static_cast<size_t>(row) * k;
    const int lo = (row - row_lo) * k;
    gate_row<T, EPL>(logits + static_cast<size_t>(row) * E, E, k, lane, w_out + o, i_out + o,
                     numbering ? sidx + lo : nullptr, sw + lo);
  }
  if (!numbering) return;  // the same for every block of the cluster
  __syncthreads();

  // each warp's contiguous share of the block's assignments
  const int A = (row_hi - row_lo) * k;
  const int share = (A + nwarps - 1) / nwarps;
  const int a_lo = min(A, warp * share), a_hi = min(A, a_lo + share);
  int* mine = wcnt + warp * E;
  for (int a0 = a_lo; a0 < a_hi; a0 += 32) {
    const int a = a0 + lane;
    const int e = a < a_hi ? sidx[a] : -1;
    const unsigned same = __match_any_sync(0xffffffffu, e);
    if (e >= 0 && lane == __ffs(same) - 1) mine[e] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int run = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int c = wcnt[w * E + e];
      wcnt[w * E + e] = run;
      run += c;
    }
    btot[e] = run;
  }
  cluster.sync();  // every block's totals written
  // the totals of the blocks before this one, a (block, expert) a thread
  for (int i = threadIdx.x; i < b * E; i += blockDim.x)
    atomicAdd(cbase + i % E, cluster.map_shared_rank(btot, i / E)[i % E]);
  cluster_arrive();  // done reading the peers
  __syncthreads();

  const long long drop = static_cast<long long>(E) * C;
  const size_t g0 = static_cast<size_t>(row_lo) * k;
  for (int a0 = a_lo; a0 < a_hi; a0 += 32) {
    const int a = a0 + lane;
    const int e = a < a_hi ? sidx[a] : -1;
    const unsigned same = __match_any_sync(0xffffffffu, e);
    int pos = 0;
    if (e >= 0) pos = cbase[e] + mine[e] + __popc(same & ((1u << lane) - 1u));
    __syncwarp();
    if (e >= 0 && lane == __ffs(same) - 1) mine[e] += __popc(same);
    __syncwarp();
    if (e >= 0) {
      const bool keep = pos < C;
      slot_out[g0 + a] = keep ? static_cast<long long>(e) * C + pos : drop;
      kept_out[g0 + a] = sw[a] * (keep ? 1.f : 0.f);
    }
  }
  cluster_wait();  // no peer reads this block's totals any more
}

template <typename T, int EPL>
static cudaError_t launch_gating(const void* x, float* w, int* idx, long long* slot,
                                 float* kept, int n_tok, int E, int k, int C, int cs, int per,
                                 int threads, int groups, cudaStream_t stream) {
  auto kernel = moe_gating_kernel<T, EPL>;
  const size_t smem =
      slot == nullptr ? 0
                      : (static_cast<size_t>(threads / 32 + 2) * E + static_cast<size_t>(per) * k) *
                                4u +
                            ((static_cast<size_t>(per) * k + 3) & ~static_cast<size_t>(3));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, groups);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), w, idx, slot, kept, n_tok,
                            E, k, C, per);
}

template <typename T>
static cudaError_t dispatch_gating(const void* x, float* w, int* idx, long long* slot,
                                   float* kept, int n_tok, int E, int k, int C, int cs, int per,
                                   int threads, int G, cudaStream_t s) {
  switch ((E + 31) / 32) {
    case 1: return launch_gating<T, 1>(x, w, idx, slot, kept, n_tok, E, k, C, cs, per, threads, G, s);
    case 2: return launch_gating<T, 2>(x, w, idx, slot, kept, n_tok, E, k, C, cs, per, threads, G, s);
    case 3: return launch_gating<T, 3>(x, w, idx, slot, kept, n_tok, E, k, C, cs, per, threads, G, s);
    case 4: return launch_gating<T, 4>(x, w, idx, slot, kept, n_tok, E, k, C, cs, per, threads, G, s);
    case 5: return launch_gating<T, 5>(x, w, idx, slot, kept, n_tok, E, k, C, cs, per, threads, G, s);
    case 6: return launch_gating<T, 6>(x, w, idx, slot, kept, n_tok, E, k, C, cs, per, threads, G, s);
    case 7: return launch_gating<T, 7>(x, w, idx, slot, kept, n_tok, E, k, C, cs, per, threads, G, s);
    default: return launch_gating<T, 8>(x, w, idx, slot, kept, n_tok, E, k, C, cs, per, threads, G, s);
  }
}

}  // namespace repro

// logits (T, E) in `dtype` (kFloat32 / kBFloat16) -> w, idx (T, k); with
// `slot` non-null also slot (T k,) int64 and kept (T k,) float32 for
// capacity C. The rows are G groups of T / G, each numbered on its own
// (G = 1: one group). Plan: a cluster of cs blocks of `threads` a group,
// `per` rows a block.
extern "C" int repro_moe_gating(const void* logits, int dtype, void* w, void* idx, void* slot,
                                void* kept, int T, int E, int k, int C, int cs, int per,
                                int threads, int G, void* stream) {
  if (T <= 0 || E <= 0 || E > 256 || k <= 0 || k > E || G < 1 || G > 65535 || T % G)
    return cudaErrorInvalidValue;
  const int n_tok = T / G;
  if (cs < 1 || cs > repro::kGatingMaxCluster || per < 1 ||
      static_cast<long long>(cs) * per < n_tok || threads < 32 || threads > 1024 ||
      threads % 32 || (slot != nullptr && (C <= 0 || !kept)))
    return cudaErrorInvalidValue;
  float* wo = static_cast<float*>(w);
  int* io = static_cast<int*>(idx);
  long long* so = static_cast<long long*>(slot);
  float* ko = static_cast<float*>(kept);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kFloat32)
    err = repro::dispatch_gating<float>(logits, wo, io, so, ko, n_tok, E, k, C, cs, per, threads,
                                        G, s);
  else if (dtype == repro::kBFloat16)
    err = repro::dispatch_gating<__nv_bfloat16>(logits, wo, io, so, ko, n_tok, E, k, C, cs, per,
                                                threads, G, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
