// Selective scan of the mamba1 layer (diagonal SSM), hand-written for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes; see
// kernels/build.py and kernels/mamba_scan.py).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   mamba_scan <- src/repro/kernels/mamba_scan.py:49 (_kernel :20)
//
// Contract (kernels/ref.py::mamba_scan_ref, all arithmetic in f32):
//   h[t] = exp(dt[t] * a) * h[t-1] + (dt[t] * x[t]) * B[t]
//   y[t] = sum_n h[t, :, n] * C[t, n]
// x, dt (B, S, D) and B, C (B, S, N) dense in the activation type (bf16 or
// f32, one type for all four), widened to f32 as they are read: bf16 widens
// exactly, so no f32 copy is written to device memory.  a (D, N) f32; h0
// (B, D, N) f32, or null for zeros (the TPU kernel always starts from
// zeros; the serving path carries the state from chunk to chunk and from
// step to step).  Writes y (B, S, D) f32 and h_final (B, D, N) f32.  Any
// S >= 1 and D >= 1, N <= 64 (the TPU kernel asserted D % block_d == 0 and
// S % chunk == 0).
//
// dt == 0 is an exact identity on the state: the decay is then exactly 1
// and the input term exactly 0, so a ragged chunk's masked pad tail, or an
// idle serving row, leaves h bit for bit as it was.  No fast math: expf
// rounds as the plain version's exp does, up to its last ulp.
//
// Design (simple first):
//   A block of 256 threads takes 16 channels d of one batch row b; each
//   channel has 16 lanes, and lane l carries the state elements
//   n = l, l + 16, l + 32, l + 48 (those below N) in registers for the
//   whole sweep over t.  The block stages 32 time steps of its x and dt
//   columns and of B and C in shared memory, each element read once,
//   then steps through them: one expf and two FMAs per state element, the
//   lanes' partial dot products with C summed by warp shuffles inside
//   each 16-lane group.  y goes through shared memory and out as whole
//   rows of 16 channels per step.  At the chunk shape (B 1, D 8192) that is
//   512 blocks, 131,072 threads; at decode (B 4, S 1) 2,048 blocks.
//
// Bound on the H100: bytes.  The scan moves x, dt, B and C once, A once,
// h0 and h_final once, y once, against 7 f32 operations per (t, d, n):
//   a prefill chunk (B 1, S 64, D 8192, N 16, bf16 in): 5.77 MB, 1.72 us
//     at 3.35 TB/s (0.75 us of f32 operations at 67 TFLOP/s);
//   a decode step (B 4, S 1): 4.98 MB, mostly h0 and h_final, 1.49 us.
// A launch and its first loads take several microseconds by themselves,
// so at these shapes the overhead of the launch, not the bound, sets the
// time (PERF.md gives the readings).
//
// Left for later PRs: the sequence split across blocks (a chunked scan
// with a carry pass) for long one-shot prompts at small batch, where the
// sweep over t runs on few threads, and the scan fused with the layer's
// elementwise prologue (softplus, the D skip, the gate).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 16;                   // lanes per channel
constexpr int kThreads = 256;
constexpr int kChannels = kThreads / kLanes; // channels a block
constexpr int kPer = 4;                      // state elements per lane
constexpr int kMaxN = kLanes * kPer;         // 64
constexpr int kChunk = 32;                   // time steps staged at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  const float* __restrict__ a, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ hout, int S,
                  int D, int N) {
  __shared__ float xs[kChunk][kChannels];
  __shared__ float dts[kChunk][kChannels];
  __shared__ float ys[kChunk][kChannels];
  __shared__ float bs[kChunk][kMaxN];
  __shared__ float cs[kChunk][kMaxN];

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int ch = tid / kLanes;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + ch;
  const bool live = d < D;
  const long long row0 = static_cast<long long>(b) * S;   // row (b, 0)
  const long long hbase = (static_cast<long long>(b) * D + d) * N;

  float h[kPer], av[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = lane + j * kLanes;
    const bool on = live && n < N;
    av[j] = on ? a[static_cast<long long>(d) * N + n] : 0.f;
    h[j] = (on && h0 != nullptr) ? h0[hbase + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int tc = min(kChunk, S - t0);
    __syncthreads();           // the last chunk's tiles are consumed
    for (int i = tid; i < kChunk * kChannels; i += kThreads) {
      const int tt = i / kChannels;
      const int c = i - tt * kChannels;
      float xv = 0.f, dv = 0.f;
      if (tt < tc && d0 + c < D) {
        const long long off = (row0 + t0 + tt) * D + d0 + c;
        xv = to_f32(x[off]);
        dv = to_f32(dt[off]);
      }
      xs[tt][c] = xv;
      dts[tt][c] = dv;
    }
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int tt = i / N;
      const int n = i - tt * N;
      if (tt < tc) {
        const long long off = (row0 + t0 + tt) * N + n;
        bs[tt][n] = to_f32(bm[off]);
        cs[tt][n] = to_f32(cm[off]);
      }
    }
    __syncthreads();

    for (int tt = 0; tt < tc; ++tt) {
      const float dtt = dts[tt][ch];
      const float dx = dtt * xs[tt][ch];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int n = lane + j * kLanes;
        if (n < N) {
          // dt == 0: a decay of exactly 1, whatever expf does at 0
          const float decay = dtt == 0.f ? 1.f : expf(dtt * av[j]);
          h[j] = decay * h[j] + dx * bs[tt][n];
          acc = fmaf(h[j], cs[tt][n], acc);
        }
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off, kLanes);
      if (lane == 0) ys[tt][ch] = acc;
    }
    __syncthreads();
    for (int i = tid; i < tc * kChannels; i += kThreads) {
      const int tt = i / kChannels;
      const int c = i - tt * kChannels;
      if (d0 + c < D) y[(row0 + t0 + tt) * D + d0 + c] = ys[tt][c];
    }
  }

#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = lane + j * kLanes;
    if (live && n < N) hout[hbase + n] = h[j];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* a, const void* h0, void* y, void* hout, int B, int S,
           int D, int N, cudaStream_t stream) {
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  mamba_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hout), S, D, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype of x, dt, B and C: 0 = float32, 1 = bfloat16.  h0 may be null
// (zeros); it must not alias hout.  Returns a cudaError_t: sizes the kernel
// does not take (cudaErrorInvalidValue), or the launch's own error.
int mamba_scan(int dtype, const void* x, const void* dt, const void* bm,
               const void* cm, const void* a, const void* h0, void* y,
               void* hout, int B, int S, int D, int N, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, bm, cm, a, h0, y, hout, B, S, D, N,
                                 st);
  if (dtype == 0)
    return launch<float>(x, dt, bm, cm, a, h0, y, hout, B, S, D, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
