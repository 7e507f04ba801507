// K3: fused squared-L2 distance + ascending top-k per query row.
//
// Replaces the TPU kernel `topk_l2_pallas` (src/repro/kernels/topk_l2.py:55,
// body `_kernel` :24). The retriever asks for k = N (a full ranking).
//
// d^2 = sum_d (q_d - db_d)^2 directly in fp32 -- the form of the reference
// `topk_l2_ref`, not the TPU kernel's |q|^2 + |db|^2 - 2 q.db, which cancels
// for L2-normalised near neighbours and reorders near-ties. Lane l of a warp
// sums d = l + 32 j in j order (one fma a term), then the xor butterfly:
// identical rows give bit-identical d^2, and every body of this kernel has
// given the same bits. The ranking is lexicographic in (d^2, index), so
// ties go lowest index first, as lax.top_k.
//
// Bound on the H100: bytes, and tiny: the retriever's launch (db 309 x 256
// float32, 4 query rows, k = N) reads 316 KB, ~0.1 us at 3.35 TB/s. What
// costs is latency: a load's round trip, a barrier, a launch. Design:
//  - Spread a query row over a thread-block cluster (Hopper's distributed
//    shared memory): `cs` blocks, up to 8, each computes d^2 of its slice of
//    `per` database rows, a warp 4 rows at a time with all their loads in
//    flight (8 a row a lane, the query's with them), up to a warp a row.
//    After a cluster barrier every block copies its peers' slices from
//    their shared memory, an element a thread, so each holds the whole d^2
//    row and the database is read once a query row; the barrier that keeps
//    a block's slice alive for its peers is split, its wait at the end.
//  - Rank by counting instead of sorting: element e's rank is the number
//    of j with key_j < key_e, key = d^2's bits above the index in 64 bits
//    (d^2 >= 0, so its bits order as its value; NaN after +inf, as
//    torch.sort puts it). A block ranks its own slice: warps split into
//    groups of 32 elements times slices of the j range, read d^2 by
//    broadcast from shared memory, add their counts with shared atomics
//    (integer sums: any order gives the same count), and each element is
//    written at its rank if that is below k. No compare-exchange stages, no
//    barrier ladder; exact and deterministic. O(N^2) compares, spread over
//    the cluster, four keys a 16-byte shared load.
//  - Above kClusterMaxN rows the d^2 row would be ranked by too few warps:
//    a distance kernel writes d^2 of many row tiles into the caller's
//    (M, N) scratch, and a rank kernel ranks spans of kRankSpan elements, a
//    block each, from the whole row staged in shared memory.
// The launch plan (cs, per, threads) comes from the wrapper
// (`kernels/topk_l2.py: topk_plan`), which the CPU tests emulate.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace repro {

constexpr int kClusterMaxN = 2048;  // topk_l2.py: CLUSTER_MAX_N
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kRowsInFlight = 4;    // database rows a warp reads at once
constexpr int kLoadsInFlight = 8;   // loads a row a lane has in flight
constexpr int kDistRows = 64;       // rows a block of the distance kernel
constexpr int kDistThreads = 256;
constexpr int kRankSpan = 128;      // elements a block of the rank kernel (RANK_SPAN)
constexpr int kRankThreads = 1024;

// d^2 of database rows [r_lo, r_hi) against the query row `qr`, stored as
// bits at out[r - r_lo]. Warp `warp` of `nwarps` takes rows r_lo + warp +
// nwarps t, kRowsInFlight at a time; the query's loads go out with the
// rows' (the first group's) and hit L1 after.
__device__ __forceinline__ void l2_rows(const float* __restrict__ db,
                                        const float* __restrict__ qr, int D,
                                        int r_lo, int r_hi, int warp, int nwarps, int lane,
                                        unsigned* out) {
  for (int r0 = r_lo + warp; r0 < r_hi; r0 += kRowsInFlight * nwarps) {
    float part[kRowsInFlight];
#pragma unroll
    for (int i = 0; i < kRowsInFlight; ++i) part[i] = 0.f;
    for (int d0 = 0; d0 < D; d0 += 32 * kLoadsInFlight) {
      float v[kRowsInFlight][kLoadsInFlight], qv[kLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int d = d0 + lane + 32 * u;
        qv[u] = d < D ? __ldg(qr + d) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) {
        const int r = r0 + i * nwarps;
        const float* row = db + static_cast<size_t>(r) * D;
#pragma unroll
        for (int u = 0; u < kLoadsInFlight; ++u) {
          const int d = d0 + lane + 32 * u;
          v[i][u] = (r < r_hi && d < D) ? __ldg(row + d) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i)
#pragma unroll
        for (int u = 0; u < kLoadsInFlight; ++u) {
          const int d = d0 + lane + 32 * u;
          if (d < D) {
            const float diff = qv[u] - v[i][u];
            part[i] = __fmaf_rn(diff, diff, part[i]);
          }
        }
    }
#pragma unroll
    for (int i = 0; i < kRowsInFlight; ++i) {
      const float s = warp_allreduce_sum(part[i]);
      const int r = r0 + i * nwarps;
      if (lane == 0 && r < r_hi) out[r - r_lo] = __float_as_uint(s);
    }
  }
}

// Ranks of elements [e_lo, e_hi) of the d^2 row `bits` (N entries padded
// to a multiple of 4 with 0xffffffff, above every d^2; shared memory,
// 16-byte aligned), added into cnt[e - e_lo] (shared, zeroed). Warp w
// counts for the 32 elements of group w % groups over slice w / groups of
// j, four keys a shared load.
__device__ __forceinline__ void rank_span(const unsigned* bits, int N, int e_lo, int e_hi,
                                          int* cnt, int warp, int nwarps, int lane) {
  const int groups = (e_hi - e_lo + 31) >> 5;
  if (groups == 0) return;
  const int slices = nwarps / groups;  // >= 1: the plan gives every group a warp
  if (warp >= groups * slices) return;
  const int e = e_lo + 32 * (warp % groups) + lane;
  const int s = warp / groups;
  const bool own = e < e_hi;
  const unsigned long long key =
      own ? (static_cast<unsigned long long>(bits[e]) << 32) | static_cast<unsigned>(e) : 0ull;
  const int n4 = (N + 3) >> 2;
  const int j_lo = static_cast<int>(static_cast<long long>(n4) * s / slices);
  const int j_hi = static_cast<int>(static_cast<long long>(n4) * (s + 1) / slices);
  const uint4* b4 = reinterpret_cast<const uint4*>(bits);
  int c = 0;
#pragma unroll 2
  for (int j4 = j_lo; j4 < j_hi; ++j4) {
    const uint4 v = b4[j4];
    const unsigned j = 4u * j4;
    c += ((static_cast<unsigned long long>(v.x) << 32) | j) < key;
    c += ((static_cast<unsigned long long>(v.y) << 32) | (j + 1)) < key;
    c += ((static_cast<unsigned long long>(v.z) << 32) | (j + 2)) < key;
    c += ((static_cast<unsigned long long>(v.w) << 32) | (j + 3)) < key;
  }
  if (own) atomicAdd(cnt + (e - e_lo), c);
}

// Element e of [e_lo, e_hi) to its rank, if below k: distance and index of
// query row `row` in the packed output (distances (M, k), then the indices).
__device__ __forceinline__ void write_ranked(const unsigned* bits, const int* cnt, int e_lo,
                                             int e_hi, int k, float* out, int M, int row) {
  float* od = out + static_cast<size_t>(row) * k;
  int* oi = reinterpret_cast<int*>(out + static_cast<size_t>(M) * k) + static_cast<size_t>(row) * k;
  for (int e = e_lo + threadIdx.x; e < e_hi; e += blockDim.x) {
    const int r = cnt[e - e_lo];
    if (r < k) {
      od[r] = sqrtf(fmaxf(__uint_as_float(bits[e]), 0.f));
      oi[r] = e;
    }
  }
}

__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// One query row a cluster of gridDim.x blocks (blockIdx.y = the row).
// Shared memory: the d^2 row (N, padded to 4), the counts (per).
__global__ void __launch_bounds__(1024)
    topk_l2_cluster_kernel(const float* __restrict__ db, const float* __restrict__ q,
                           float* __restrict__ out, int M, int N, int D, int k, int per) {
  extern __shared__ __align__(16) unsigned bits[];
  int* cnt = reinterpret_cast<int*>(bits + round4(N));
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const int nb = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int e_lo = min(N, b * per), e_hi = min(N, e_lo + per);

  for (int i = threadIdx.x; i < per; i += blockDim.x) cnt[i] = 0;
  if (threadIdx.x < round4(N) - N) bits[N + threadIdx.x] = 0xffffffffu;
  l2_rows(db, q + static_cast<size_t>(row) * D, D, e_lo, e_hi, warp, nwarps, lane,
          bits + e_lo);
  cluster.sync();  // every slice written
  // the peers' slices, one (peer, element) a thread, all loads in flight
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    const int p = e / per;
    if (p != b) bits[e] = cluster.map_shared_rank(bits, p)[e];
  }
  cluster_arrive();  // done reading the peers
  __syncthreads();
  rank_span(bits, N, e_lo, e_hi, cnt, warp, nwarps, lane);
  __syncthreads();
  write_ranked(bits, cnt, e_lo, e_hi, k, out, M, row);
  cluster_wait();  // no peer reads this block's slice any more
}

// Large N, pass 1: d^2 of kDistRows database rows (blockIdx.x) against query
// row blockIdx.y, into d2[row * N + r].
__global__ void __launch_bounds__(kDistThreads)
    topk_l2_dist_kernel(const float* __restrict__ db, const float* __restrict__ q,
                        unsigned* __restrict__ d2, int N, int D) {
  const int row = blockIdx.y;
  const int r_lo = blockIdx.x * kDistRows, r_hi = min(N, r_lo + kDistRows);
  l2_rows(db, q + static_cast<size_t>(row) * D, D, r_lo, r_hi, threadIdx.x >> 5, blockDim.x >> 5, threadIdx.x & 31,
          d2 + static_cast<size_t>(row) * N + r_lo);
}

// Large N, pass 2: ranks of kRankSpan elements (blockIdx.x) of query row
// blockIdx.y against its whole d^2 row, staged in shared memory.
__global__ void __launch_bounds__(kRankThreads)
    topk_l2_rank_kernel(const unsigned* __restrict__ d2, float* __restrict__ out, int M, int N,
                        int k) {
  extern __shared__ __align__(16) unsigned sbits[];
  int* cnt = reinterpret_cast<int*>(sbits + round4(N));
  const int row = blockIdx.y;
  const unsigned* src = d2 + static_cast<size_t>(row) * N;
  for (int j = threadIdx.x; j < round4(N); j += blockDim.x)
    sbits[j] = j < N ? src[j] : 0xffffffffu;
  for (int i = threadIdx.x; i < kRankSpan; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int e_lo = blockIdx.x * kRankSpan, e_hi = min(N, e_lo + kRankSpan);
  rank_span(sbits, N, e_lo, e_hi, cnt, threadIdx.x >> 5, blockDim.x >> 5, threadIdx.x & 31);
  __syncthreads();
  write_ranked(sbits, cnt, e_lo, e_hi, k, out, M, row);
}

}  // namespace repro

// out: (2, M, k) float32, the distances then the indices' int32 bits.
// N <= kClusterMaxN: one cluster of cs blocks of `threads` a query row, `per`
// rows a block (scratch unused). Larger N: scratch is (M, N) float32.
extern "C" int repro_topk_l2(const void* db, const void* q, void* out, void* scratch, int M,
                             int N, int D, int k, int cs, int per, int threads, void* stream) {
  if (M <= 0 || N <= 0 || D <= 0 || k <= 0 || k > N) return cudaErrorInvalidValue;
  const float* dbf = static_cast<const float*>(db);
  const float* qf = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N <= repro::kClusterMaxN) {
    if (cs < 1 || cs > repro::kMaxCluster || per < 1 || static_cast<long long>(cs) * per < N ||
        threads < 32 || threads > 1024 || threads % 32 || (per + 31) / 32 > threads / 32)
      return cudaErrorInvalidValue;
    const size_t smem = (static_cast<size_t>((N + 3) & ~3) + per) * 4u;
    err = repro::allow_smem(repro::topk_l2_cluster_kernel, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs, M);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, repro::topk_l2_cluster_kernel, dbf, qf, o, M, N, D, k, per);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  unsigned* d2 = static_cast<unsigned*>(scratch);
  repro::topk_l2_dist_kernel<<<dim3((N + repro::kDistRows - 1) / repro::kDistRows, M),
                               repro::kDistThreads, 0, s>>>(dbf, qf, d2, N, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t rsmem = (static_cast<size_t>((N + 3) & ~3) + repro::kRankSpan) * 4u;
  err = repro::allow_smem(repro::topk_l2_rank_kernel, rsmem);
  if (err != cudaSuccess) return err;
  repro::topk_l2_rank_kernel<<<dim3((N + repro::kRankSpan - 1) / repro::kRankSpan, M),
                               repro::kRankThreads, rsmem, s>>>(d2, o, M, N, k);
  return cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
