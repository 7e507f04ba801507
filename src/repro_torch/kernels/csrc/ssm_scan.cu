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
// The Pallas kernel walks a sequential chunk axis of its grid with the
// state resident in VMEM. Here blocks run in parallel, so each thread owns
// one recurrence for the whole sequence: one thread per (b, d, n), N
// neighbouring lanes per channel, 256 / N channels per block (16 at N = 16;
// 131k independent recurrences at B = 1, di = 8192, where one thread per
// channel would give 2 warps an SM). The block stages a tile of time steps
// of x and dt for its channels, and of B_t and C_t, in shared memory, and
// walks the tile in registers; the N lanes of a channel reduce y with
// __shfl_xor_sync, and the tile's y goes out through shared memory. States
// are written as (B, S, di, N) fp32: a block's 256 threads store one
// contiguous 1 KB row per step.
//
// The state update is written with __fmul_rn / __fadd_rn, so nvcc does not
// contract it into an FMA: it rounds as the unfused tensor ops of the plain
// decode step do (`models/ssm.mamba1_decode`), and the per-position states
// are the same arithmetic as the final state (one loop computes both).
// expf, not __expf.
//
// Bound on the H100: at a 128-token chunk of falcon-mamba-7b (di = 8192,
// N = 16, B = 1) the kernel moves ~7 MB (x, dt, y in bf16, the fp32 h0 and
// h_final) and evaluates 16.8M exponentials, ~4 us on the SFU's 16 per
// clock per SM; a verify round's launch (B = 4, S = 5) writes 10.5 MB of
// states. Each time step depends on the one before, so the walk is latency
// bound at these widths; a chunked parallel scan is later work.
#include "common.cuh"

namespace repro {

constexpr int kScanThreads = 256;
constexpr int kScanTile = 64;  // time steps staged in shared memory at once

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
    ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const T* __restrict__ Dp,
                    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_out,
                    float* __restrict__ states, int S, int di, int N) {
  extern __shared__ float smem[];
  const int ch = kScanThreads / N;      // channels per block
  float* s_x = smem;                    // kScanTile * ch
  float* s_dt = s_x + kScanTile * ch;   // kScanTile * ch
  float* s_y = s_dt + kScanTile * ch;   // kScanTile * ch
  float* s_b = s_y + kScanTile * ch;    // kScanTile * N
  float* s_c = s_b + kScanTile * N;     // kScanTile * N

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * ch;
  const int nch = min(ch, di - d0);     // channels of this block inside di
  const int c = threadIdx.x / N, n = threadIdx.x - (threadIdx.x / N) * N;
  const int d = d0 + c;
  const bool active = c < nch;

  const float a = active ? A[static_cast<size_t>(d) * N + n] : 0.f;
  const float dskip = active ? to_float(Dp[d]) : 0.f;
  const size_t hrow = (static_cast<size_t>(b) * di + d) * N + n;
  float h = (active && h0 != nullptr) ? h0[hrow] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kScanTile) {
    const int tn = min(kScanTile, S - t0);
    const size_t row0 = static_cast<size_t>(b) * S + t0;
    __syncthreads();  // the previous tile's y has been written out
    for (int e = threadIdx.x; e < tn * ch; e += blockDim.x) {
      const int t = e / ch, cc = e - t * ch;
      float xv = 0.f, dv = 0.f;
      if (cc < nch) {
        const size_t off = (row0 + t) * di + d0 + cc;
        xv = to_float(x[off]);
        dv = to_float(dt[off]);
      }
      s_x[e] = xv;
      s_dt[e] = dv;
    }
    for (int e = threadIdx.x; e < tn * N; e += blockDim.x) {
      s_b[e] = to_float(Bm[row0 * N + e]);
      s_c[e] = to_float(Cm[row0 * N + e]);
    }
    __syncthreads();
    for (int t = 0; t < tn; ++t) {
      const float xv = s_x[t * ch + c], dv = s_dt[t * ch + c];
      const float da = expf(__fmul_rn(dv, a));
      h = __fadd_rn(__fmul_rn(da, h), __fmul_rn(__fmul_rn(dv, xv), s_b[t * N + n]));
      float part = __fmul_rn(h, s_c[t * N + n]);
      for (int off = N >> 1; off > 0; off >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
      if (n == 0) s_y[t * ch + c] = __fadd_rn(part, __fmul_rn(xv, dskip));
      if (states != nullptr && active) states[((row0 + t) * di + d) * N + n] = h;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < tn * ch; e += blockDim.x) {
      const int t = e / ch, cc = e - t * ch;
      if (cc < nch) y[(row0 + t) * di + d0 + cc] = from_float<T>(s_y[e]);
    }
  }
  if (active) h_out[hrow] = h;
}

template <typename T>
cudaError_t scan_launch(const void* x, const void* dt, const float* A, const void* Bm,
                        const void* Cm, const void* D, const float* h0, void* y, float* h_out,
                        float* states, int batch, int S, int di, int N, cudaStream_t stream) {
  const int ch = kScanThreads / N;
  const size_t smem = static_cast<size_t>(kScanTile) * (3 * ch + 2 * N) * sizeof(float);
  auto kernel = ssm_scan_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((di + ch - 1) / ch, batch);
  kernel<<<grid, kScanThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(D), h0, static_cast<T*>(y), h_out,
      states, S, di, N);
  return cudaGetLastError();
}

}  // namespace repro

// x, dt (B, S, di), B_mat, C_mat (B, S, N), D (di) and y (B, S, di) in the
// dtype `dtype`; A (di, N), h0 (B, di, N) or null, h_out (B, di, N) and
// states (B, S, di, N) or null in float32. N is a power of two <= 32.
extern "C" int repro_ssm_scan(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* D, const void* h0, void* y,
                              void* h_out, void* states, int batch, int S, int di, int N,
                              int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || S < 0 || di <= 0 || N <= 0 || N > 32 || (N & (N - 1)))
    return cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(A);
  const float* h = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(h_out);
  float* st = static_cast<float*>(states);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::scan_launch<float>(x, dt, a, Bm, Cm, D, h, y, ho, st, batch, S, di, N, s);
  if (dtype == repro::kBFloat16)
    return repro::scan_launch<__nv_bfloat16>(x, dt, a, Bm, Cm, D, h, y, ho, st, batch, S, di,
                                             N, s);
  return cudaErrorInvalidValue;
}
