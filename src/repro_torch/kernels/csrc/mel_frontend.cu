// Mel frontend (window -> DFT as two products -> power -> mel -> log),
// hand-written for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes; see kernels/build.py and kernels/mel_frontend.py).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   mel_frontend <- src/repro/kernels/mel_frontend.py:34 (_kernel :19)
//
// Contract (kernels/ref.py::mel_frontend_ref, all in f32):
//   xw[r, t]    = frames[r, t] * window[t]
//   power[r, k] = (sum_t xw[r, t] * cos[t, k])^2
//               + (sum_t xw[r, t] * sin[t, k])^2
//   out[r, m]   = log(max(sum_k power[r, k] * mel[k, m], 1e-6))
// frames are rows r = b * NF + j of a (B, NF, L) view with strides
// (sb, sf, 1): an unfold view of the signal (sf = hop < L, so neighbouring
// frames overlap) is read in place, with no copy.  window (L,), cos and sin
// (L, nbins), mel (nbins, n_mels) dense; out (B * NF, n_mels) dense.  The
// tables are used as given, so frame_len > n_fft (wrapped angles) works.
//
// Design (simple first):
//   A block of 256 threads takes TF = 32 frames.  The last block is
//   masked, so any frame count works (the TPU kernel asserted
//   F % block_f == 0).  Its tiles take 4 * 32 * (L + nbins) bytes of shared
//   memory: at most 196,736 for L 1024 and 513 bins (n_fft 1024); larger
//   tables are refused.
//   1. It stages the windowed frames in shared memory, rows padded to a
//      multiple of 4 floats with zeros.
//   2. Each thread owns one DFT bin for 16 frames: it walks t, reads
//      cos[t, k] and sin[t, k] (neighbouring threads, neighbouring bins:
//      coalesced; the two 329 KB tables at the defaults stay in L2) and
//      the frames as float4 warp broadcasts, and keeps 16 re and 16 im
//      sums in registers.  The power tile goes to shared memory.
//   3. Each thread then computes 4 frames of one mel band as a dense
//      product over the bins and writes log(max(mel, 1e-6)).
//   No fast math: logf and the products round as the plain version's do,
//   up to summation order; silence gives log(1e-6) exactly.
//
// Bound on the H100: operations.  At the defaults (L 320, 257 bins, 40
// mels) a frame costs 4 * L * nbins + 2 * nbins * n_mels = 349,520 flops
// in f32 (no tensor cores: 67 TFLOP/s) against about 1.3 KB of signal and
// 160 bytes of output, so the batch of 512 one-second clips (50,688
// frames) is bound at 17.7 GFLOP / 67 TFLOP/s = 0.26 ms.
//
// Measured on the H100 (PERF.md): 0.94 ms at full width, 3.6 times the
// bound and slower than the plain version's cuBLAS products.
//
// Left for later PRs: the DFT on tensor cores (TF32 or split-precision
// bf16 products) or as an FFT inside the kernel (a 512-point rfft does an
// order of magnitude fewer operations than the dense DFT), more blocks for
// small batches (99 frames run on 4 blocks), and the mel product over the
// filterbank's nonzero band only.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int FPT = 16;                 // frames per thread in the DFT
constexpr int MF = 4;                   // frames per thread in the mel product
constexpr int NG = 2;                   // groups of FPT frames a block
constexpr int TF = NG * FPT;            // frames a block
constexpr float kLogFloor = 1e-6f;      // ref.py's LOG_FLOOR
constexpr size_t kMaxSmem = 232448;     // 227 KB: the opt-in limit of sm_90

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

size_t smem_bytes(int L, int nbins) {
  return sizeof(float) * static_cast<size_t>(TF) * (round4(L) + nbins);
}

__global__ void __launch_bounds__(kThreads)
mel_frontend_kernel(const float* __restrict__ frames, long long sb,
                    long long sf, int nf, int F, int L,
                    const float* __restrict__ window,
                    const float* __restrict__ dcos,
                    const float* __restrict__ dsin,
                    const float* __restrict__ mel, float* __restrict__ out,
                    int nbins, int n_mels) {
  extern __shared__ float4 smem4[];
  const int LDX = round4(L);
  float* xw_s = reinterpret_cast<float*>(smem4);        // [TF][LDX]
  float* pw_s = xw_s + TF * LDX;                         // [TF][nbins]
  const int f0 = blockIdx.x * TF;

  // 1. windowed frames; rows past F and columns past L are zeros
  for (int i = threadIdx.x; i < TF * LDX; i += kThreads) {
    const int f = i / LDX;
    const int t = i - f * LDX;
    const int r = f0 + f;
    float v = 0.f;
    if (r < F && t < L) {
      const int b = r / nf;
      const int j = r - b * nf;
      v = __fmul_rn(__ldg(frames + b * sb + j * sf + t), __ldg(window + t));
    }
    xw_s[i] = v;
  }
  __syncthreads();

  // 2. DFT: item (g, k) is bin k of frames [g * FPT, g * FPT + FPT)
  for (int item = threadIdx.x; item < nbins * NG; item += kThreads) {
    const int g = item / nbins;
    const int k = item - g * nbins;
    float re[FPT], im[FPT];
#pragma unroll
    for (int f = 0; f < FPT; ++f) re[f] = im[f] = 0.f;
    const float* xg = xw_s + g * FPT * LDX;
    for (int t0 = 0; t0 < LDX; t0 += 4) {
      float c[4], s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u;
        c[u] = t < L ? __ldg(dcos + t * nbins + k) : 0.f;
        s[u] = t < L ? __ldg(dsin + t * nbins + k) : 0.f;
      }
#pragma unroll
      for (int f = 0; f < FPT; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(xg + f * LDX + t0);
        re[f] = fmaf(x.x, c[0], re[f]);
        im[f] = fmaf(x.x, s[0], im[f]);
        re[f] = fmaf(x.y, c[1], re[f]);
        im[f] = fmaf(x.y, s[1], im[f]);
        re[f] = fmaf(x.z, c[2], re[f]);
        im[f] = fmaf(x.z, s[2], im[f]);
        re[f] = fmaf(x.w, c[3], re[f]);
        im[f] = fmaf(x.w, s[3], im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FPT; ++f)
      pw_s[(g * FPT + f) * nbins + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  // 3. mel product and log: item (fg, m) is band m of frames
  //    [fg * MF, fg * MF + MF)
  for (int item = threadIdx.x; item < n_mels * (TF / MF); item += kThreads) {
    const int fg = item / n_mels;
    const int m = item - fg * n_mels;
    const float* pr = pw_s + fg * MF * nbins;
    float acc[MF];
#pragma unroll
    for (int j = 0; j < MF; ++j) acc[j] = 0.f;
    for (int k = 0; k < nbins; ++k) {
      const float w = __ldg(mel + k * n_mels + m);
#pragma unroll
      for (int j = 0; j < MF; ++j) acc[j] = fmaf(pr[j * nbins + k], w, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < MF; ++j) {
      const int r = f0 + fg * MF + j;
      // max(NaN, floor) stays NaN, as the plain version's clamp
      float v = acc[j];
      if (v < kLogFloor) v = kLogFloor;
      if (r < F) out[static_cast<long long>(r) * n_mels + m] = logf(v);
    }
  }
}

}  // namespace

extern "C" {

// frames: (nb, nf, L) f32 view with strides (sb, sf, 1) in elements.
// Returns a cudaError_t: invalid sizes, shared-memory tiles that do not
// fit (cudaErrorInvalidValue), or the launch's own error.
int mel_frontend(const void* frames, long long sb, long long sf, int nb,
                 int nf, int L, const void* window, const void* dcos,
                 const void* dsin, const void* mel, void* out, int nbins,
                 int n_mels, void* stream) {
  const long long F = static_cast<long long>(nb) * nf;
  if (nb <= 0 || nf <= 0 || L <= 0 || nbins <= 0 || n_mels <= 0 ||
      F > INT_MAX || static_cast<long long>(L) * nbins > INT_MAX ||
      static_cast<long long>(nbins) * n_mels > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(L, nbins);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mel_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((F + TF - 1) / TF);
  mel_frontend_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), sb, sf, nf, static_cast<int>(F), L,
      static_cast<const float*>(window), static_cast<const float*>(dcos),
      static_cast<const float*>(dsin), static_cast<const float*>(mel),
      static_cast<float*>(out), nbins, n_mels);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
