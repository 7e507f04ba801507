// K7: the Mamba1 selective scan, from an optional carried state, with the
// state after every position written on request.
//
// Replaces the TPU kernel `ssm_scan_pallas` (src/repro/kernels/ssm_scan.py:55,
// body `_kernel` :24), which asserts h0 is None; this one takes h0, since
// every chunk after a prompt's first, and every chunk after a prefix hit,
// starts from a carried state. Per (batch row b, channel d, state n):
//
//   h  = exp(dt_t * A[d, n]) * h + (dt_t * x_t) * B_t[n]        fp32
//   y_t = sum_n h * C_t[n] + D[d] * x_t                          -> x's dtype
//
// Bound on the H100. A 128-token chunk of falcon-mamba-7b (B = 1, di =
// 8192, N = 16) moves ~7 MB (x, dt, y in bf16, the fp32 h0 and final
// state) and evaluates 16.8M exponentials: ~4 us on the SFU's 16 a clock
// an SM, the larger bound. A verify round's launch (B = 4, S = 5) writes
// 10.5 MB of per-position states: ~4.8 us of bytes. Above both sits the
// issue rate: by a count of the source an update is ~20 instructions
// (expf alone is 9: its range reduction around one MUFU.EX2), ~10 us of
// the SMs' four issue slots a clock at the chunk, and a B = 1 chunk has
// only ~8 warps an SM (131k recurrences, 4 a thread) to keep them busy.
//
// Mapping. The Pallas kernel walks a sequential chunk axis of its grid
// with the state resident in VMEM. Here blocks run in parallel, each
// thread owns its recurrences for the whole sequence, and a block of 128
// threads walks tiles of time steps staged in shared memory. A thread
// holds one channel and R of its N states, strided: lane l of the
// channel's L = N / R lanes holds n = l + L j for j < R (R = 4 at N = 16:
// 4 lanes a channel, 8 channels a warp, 128 updates a warp step, where
// one state a thread gave 32). A channel step then costs a warp two
// broadcast shared loads (x, dt), two 16-byte loads of B_t and C_t (staged
// permuted, so a thread's R values are contiguous), log2(L) shuffles and
// one predicated store of y, where the one-state body spent four shared
// loads, four shuffles and a store on every 32 updates. A thread walks G
// steps at a time (`steps`): the G steps' exponentials first (they do not
// depend on h), then the recurrence, then the G sums with their shuffles
// interleaved, so a warp, which issues in order, has independent work
// while one step's chain waits. G = 8 for full tiles (the few warps of a
// B = 1 chunk), 1 for short sequences (fewer registers, so more of a
// verify round's blocks are resident); the wrapper's `scan_plan` chooses.
//
// The sum over n is the one-state body's butterfly, bit for bit. That
// butterfly first added states n and n + N/2, then n + N/4, ... down to
// n + 1. With the strided mapping, the levels N/2 .. L pair slots j and
// j + R/2, j + R/4, ... of one thread, and the levels L/2 .. 1 pair lanes:
// the same operands meet in the same tree (a + b == b + a in IEEE), then
// x * D is added as before. The state update keeps its unfused
// __fmul_rn / __fadd_rn and expf (not __expf), so nvcc contracts nothing
// into an FMA and the state rounds as the plain decode step's tensor ops
// do (`models/ssm.mamba1_decode`); the per-position states and the final
// state are one loop's values. The outputs equal the one-state body's.
//
// Staging. x and dt tiles go to shared memory by cp.async, double
// buffered: tile k + 1 is in flight while tile k is walked, behind one
// barrier a tile (rows whose start is not 16-byte aligned are copied by
// plain loads). B and C, tile x N each, are loaded to registers while a
// tile is walked and written permuted and in fp32 into the other buffer
// after it. y leaves through shared memory in coalesced rows, one tile
// behind the walk.
//
// No chunked parallel scan: its h_t = P_t H + h_loc rounds differently
// from the sequential update, and the plain decode step, the verify
// checkpoints a rejected draft rolls back to and the card-against-CPU
// state check all rely on the sequential rounding. Nor is the walk bound
// by its chain of steps at these widths: B = 1 has 131k independent
// recurrences, and the time goes to issue slots.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kScanThreads = 128;  // wrapper: ssm_scan.THREADS
constexpr int kScanTile = 32;      // time steps a staged tile; wrapper: ssm_scan.TILE

template <typename T>
struct ScanArgs {
  const T* x;
  const T* dt;
  const float* A;
  const T* Bm;
  const T* Cm;
  const T* Dp;
  const float* h0;
  T* y;
  float* h_out;
  float* states;
  int S, di, tile;
  bool vec;  // x and dt rows start 16-byte aligned: staged by cp.async
};

// Shared memory of one block: two buffers each of B_t and C_t (fp32,
// permuted), y (fp32), x and dt (T); every array 16-byte aligned.
__host__ __device__ inline size_t up16(size_t v) { return (v + 15) & ~size_t(15); }

struct ScanSmem {
  size_t b, c, y, x, dt, bytes;
  __host__ __device__ ScanSmem(int tile, int N, int CH, int tsize) {
    b = 0;
    c = b + up16(2 * size_t(tile) * N * 4);
    y = c + up16(2 * size_t(tile) * N * 4);
    x = y + up16(2 * size_t(tile) * CH * 4);
    dt = x + up16(2 * size_t(tile) * CH * tsize);
    bytes = dt + up16(2 * size_t(tile) * CH * tsize);
  }
};

template <int R>
__device__ __forceinline__ void load_slots(const float* p, float (&v)[R]) {
  if constexpr (R == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (R == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// R states a thread, L lanes a channel (N = R L), kScanThreads / L
// channels a block, G time steps walked together; grid (channel blocks,
// batch rows).
template <typename T, int R, int L, int G>
__global__ void __launch_bounds__(kScanThreads) ssm_scan_kernel(const ScanArgs<T> a) {
  constexpr int N = R * L;
  constexpr int CH = kScanThreads / L;                     // channels a block
  constexpr int BC = (kScanTile * N + kScanThreads - 1) / kScanThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, di = a.di, tile = a.tile;
  const ScanSmem lay(tile, N, CH, sizeof(T));
  float* s_b = reinterpret_cast<float*>(smem + lay.b);
  float* s_c = reinterpret_cast<float*>(smem + lay.c);
  float* s_y = reinterpret_cast<float*>(smem + lay.y);
  T* s_x = reinterpret_cast<T*>(smem + lay.x);
  T* s_dt = reinterpret_cast<T*>(smem + lay.dt);

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int nch = min(CH, di - d0);     // channels of this block inside di
  const int c = threadIdx.x / L, l = threadIdx.x % L;
  const int d = d0 + c;
  const bool active = c < nch;
  const size_t hrow = (static_cast<size_t>(b) * di + d) * N + l;

  float av[R], h[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    av[j] = active ? a.A[static_cast<size_t>(d) * N + l + L * j] : 0.f;
    h[j] = (active && a.h0 != nullptr) ? a.h0[hrow + L * j] : 0.f;
  }
  const float dskip = active ? to_float(a.Dp[d]) : 0.f;

  // x and dt of tile k into buffer buf (rows of CH channels)
  auto stage_xdt = [&](int k, int buf) {
    const int tn = min(tile, S - k * tile);
    const size_t row0 = static_cast<size_t>(b) * S + k * tile;
    T* sx = s_x + buf * tile * CH;
    T* sd = s_dt + buf * tile * CH;
    if (a.vec) {
      constexpr int EPC = 16 / sizeof(T);   // elements a 16-byte chunk
      constexpr int CPR = CH / EPC;         // chunks a row
      for (int q = threadIdx.x; q < tn * CPR; q += kScanThreads) {
        const int t = q / CPR, cc = (q - t * CPR) * EPC;
        const bool ok = cc < nch;           // nch is a multiple of EPC here
        const size_t off = (row0 + t) * di + d0 + cc;
        cp_async16(sx + t * CH + cc, ok ? a.x + off : a.x, ok);
        cp_async16(sd + t * CH + cc, ok ? a.dt + off : a.dt, ok);
      }
    } else {
      for (int e = threadIdx.x; e < tn * CH; e += kScanThreads) {
        const int t = e / CH, cc = e - t * CH;
        const size_t off = (row0 + t) * di + d0 + cc;
        sx[e] = cc < nch ? a.x[off] : from_float<T>(0.f);
        sd[e] = cc < nch ? a.dt[off] : from_float<T>(0.f);
      }
    }
    cp_async_commit();
  };
  // B_t and C_t of tile k: loaded into registers, then written permuted
  // (state n = l + L j at l R + j) and in fp32 into buffer buf
  float rb[BC], rc[BC];
  auto load_bc = [&](int k) {
    const int tn = min(tile, S - k * tile);
    const size_t base = (static_cast<size_t>(b) * S + k * tile) * N;
#pragma unroll
    for (int i = 0; i < BC; ++i) {
      const int e = threadIdx.x + i * kScanThreads;
      const bool ok = e < tn * N;
      rb[i] = ok ? to_float(a.Bm[base + e]) : 0.f;
      rc[i] = ok ? to_float(a.Cm[base + e]) : 0.f;
    }
  };
  auto store_bc = [&](int buf) {
#pragma unroll
    for (int i = 0; i < BC; ++i) {
      const int e = threadIdx.x + i * kScanThreads;
      if (e < tile * N) {
        const int t = e / N, n = e - t * N;
        const int at = buf * tile * N + t * N + (n % L) * R + n / L;
        s_b[at] = rb[i];
        s_c[at] = rc[i];
      }
    }
  };
  auto store_y = [&](int k, int buf) {
    const int tn = min(tile, S - k * tile);
    const size_t row0 = static_cast<size_t>(b) * S + k * tile;
    const float* sy = s_y + buf * tile * CH;
    for (int e = threadIdx.x; e < tn * CH; e += kScanThreads) {
      const int t = e / CH, cc = e - t * CH;
      if (cc < nch) a.y[(row0 + t) * di + d0 + cc] = from_float<T>(sy[e]);
    }
  };
  // GS steps of the tile from step t (see Mapping above)
  auto steps = [&](auto group, int buf, int t, size_t row0) {
    constexpr int GS = decltype(group)::value;
    const T* sx = s_x + buf * tile * CH + c;
    const T* sd = s_dt + buf * tile * CH + c;
    const float* sb = s_b + buf * tile * N + l * R;
    const float* sc = s_c + buf * tile * N + l * R;
    float xv[GS], da[GS][R], dxb[GS][R], cv[GS][R];
#pragma unroll
    for (int g = 0; g < GS; ++g) {
      xv[g] = to_float(sx[(t + g) * CH]);
      const float dv = to_float(sd[(t + g) * CH]);
      float bv[R];
      load_slots<R>(sb + (t + g) * N, bv);
      load_slots<R>(sc + (t + g) * N, cv[g]);
      const float dx = __fmul_rn(dv, xv[g]);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        da[g][j] = expf(__fmul_rn(dv, av[j]));
        dxb[g][j] = __fmul_rn(dx, bv[j]);
      }
    }
#pragma unroll
    for (int g = 0; g < GS; ++g) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        h[j] = __fadd_rn(__fmul_rn(da[g][j], h[j]), dxb[g][j]);
        da[g][j] = __fmul_rn(h[j], cv[g][j]);   // the term h C of y's sum
      }
      if (a.states != nullptr && active) {
        float* st = a.states + ((row0 + t + g) * di + d) * N + l;
#pragma unroll
        for (int j = 0; j < R; ++j) st[L * j] = h[j];
      }
    }
    // the butterfly's levels N/2 .. L inside the thread, L/2 .. 1 across lanes
    float p[GS];
#pragma unroll
    for (int g = 0; g < GS; ++g) {
#pragma unroll
      for (int half = R / 2; half > 0; half >>= 1)
#pragma unroll
        for (int j = 0; j < half; ++j) da[g][j] = __fadd_rn(da[g][j], da[g][j + half]);
      p[g] = da[g][0];
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < GS; ++g) p[g] = __fadd_rn(p[g], __shfl_xor_sync(0xffffffffu, p[g], off));
    if (l == 0) {
      float* sy = s_y + buf * tile * CH + c;
#pragma unroll
      for (int g = 0; g < GS; ++g) sy[(t + g) * CH] = __fadd_rn(p[g], __fmul_rn(xv[g], dskip));
    }
  };
  auto walk = [&](int k, int buf) {
    const int tn = min(tile, S - k * tile);
    const size_t row0 = static_cast<size_t>(b) * S + k * tile;
    int t = 0;
    for (; t + G <= tn; t += G) steps(std::integral_constant<int, G>(), buf, t, row0);
    for (; t < tn; ++t) steps(std::integral_constant<int, 1>(), buf, t, row0);
  };

  const int ntiles = (S + tile - 1) / tile;
  if (ntiles > 0) {
    stage_xdt(0, 0);
    load_bc(0);
    store_bc(0);
  }
  for (int k = 0; k < ntiles; ++k) {
    const int buf = k & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile k staged; tile k - 1 walked, its y in s_y[buf ^ 1]
    if (k > 0) store_y(k - 1, buf ^ 1);
    const bool next = k + 1 < ntiles;
    if (next) {
      stage_xdt(k + 1, buf ^ 1);
      load_bc(k + 1);
    }
    walk(k, buf);
    if (next) store_bc(buf ^ 1);
  }
  if (ntiles > 0) {
    __syncthreads();
    store_y(ntiles - 1, (ntiles - 1) & 1);
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < R; ++j) a.h_out[hrow + L * j] = h[j];
  }
}

template <typename T, int R, int L, int G>
cudaError_t scan_launch(const ScanArgs<T>& a, int batch, cudaStream_t stream) {
  constexpr int CH = kScanThreads / L;
  const ScanSmem lay(a.tile, R * L, CH, sizeof(T));
  auto kernel = ssm_scan_kernel<T, R, L, G>;
  cudaError_t err = allow_smem(kernel, lay.bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.di + CH - 1) / CH, batch);
  kernel<<<grid, kScanThreads, lay.bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int R, int G>
cudaError_t scan_lanes(const ScanArgs<T>& a, int batch, int L, cudaStream_t s) {
  switch (L) {
    case 1: return scan_launch<T, R, 1, G>(a, batch, s);
    case 2: return scan_launch<T, R, 2, G>(a, batch, s);
    case 4: return scan_launch<T, R, 4, G>(a, batch, s);
    case 8: return scan_launch<T, R, 8, G>(a, batch, s);
    case 16:
      if constexpr (R == 2) return scan_launch<T, R, 16, G>(a, batch, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int G>
cudaError_t scan_states(const ScanArgs<T>& a, int batch, int N, int R, cudaStream_t s) {
  if (R == 4 && N >= 4) return scan_lanes<T, 4, G>(a, batch, N / 4, s);
  if (R == 2 && N >= 2) return scan_lanes<T, 2, G>(a, batch, N / 2, s);
  if (R == 1 && N == 1) return scan_launch<T, 1, 1, G>(a, batch, s);
  return cudaErrorInvalidValue;
}

// R in {2, 4} (at most N), or 1 at N = 1; G in {1, 8}
template <typename T>
cudaError_t scan_dispatch(const ScanArgs<T>& a, int batch, int N, int R, int G,
                          cudaStream_t s) {
  if (G == 8) return scan_states<T, 8>(a, batch, N, R, s);
  if (G == 1) return scan_states<T, 1>(a, batch, N, R, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t scan_entry(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* D, const void* h0, void* y, void* h_out,
                       void* states, int batch, int S, int di, int N, int R, int G,
                       cudaStream_t stream) {
  ScanArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.dt = static_cast<const T*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = static_cast<const T*>(Bm);
  a.Cm = static_cast<const T*>(Cm);
  a.Dp = static_cast<const T*>(D);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<T*>(y);
  a.h_out = static_cast<float*>(h_out);
  a.states = static_cast<float*>(states);
  a.S = S;
  a.di = di;
  a.tile = S < kScanTile ? (S > 0 ? S : 1) : kScanTile;
  constexpr int EPC = 16 / sizeof(T);
  a.vec = di % EPC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(dt) % 16 == 0;
  return scan_dispatch<T>(a, batch, N, R, G, stream);
}

}  // namespace repro

// x, dt (B, S, di), B_mat, C_mat (B, S, N), D (di) and y (B, S, di) in the
// dtype `dtype`; A (di, N), h0 (B, di, N) or null, h_out (B, di, N) and
// states (B, S, di, N) or null in float32. N is a power of two <= 32; R,
// the states a thread holds, is 2 or 4 (at most N), or 1 at N = 1
// (ssm_scan.scan_plan).
extern "C" int repro_ssm_scan(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* D, const void* h0, void* y,
                              void* h_out, void* states, int batch, int S, int di, int N,
                              int R, int G, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || S < 0 || di <= 0 || N <= 0 || N > 32 || (N & (N - 1)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::scan_entry<float>(x, dt, A, Bm, Cm, D, h0, y, h_out, states, batch, S, di,
                                    N, R, G, s);
  if (dtype == repro::kBFloat16)
    return repro::scan_entry<__nv_bfloat16>(x, dt, A, Bm, Cm, D, h0, y, h_out, states, batch,
                                            S, di, N, R, G, s);
  return cudaErrorInvalidValue;
}
