// int8 x int8 matmul with the per-row x per-channel dequant fused into the
// epilogue, hand-written for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; see kernels/build.py and
// kernels/int8_matmul.py).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   int8_matmul <- src/repro/kernels/int8_matmul.py:45 (_kernel :22)
//
// Contract (identical to kernels/ref.py::int8_matmul_ref):
//   out[m, n] = float(acc[m, n]) * (x_scale[m] * w_scale[n]),
//   acc[m, n] = sum_k x_q[m, k] * w_q[n, k]      (exact, int32)
// x_q (M, K) int8 with row stride ldx; w_q (N, K) int8 with row stride ldw
// (output channel first: the port's QTensor layout, K contiguous for both
// operands); x_scale (M,), w_scale (N,) f32; out (M, N) f32, dense.  The
// epilogue multiplies in exactly the plain version's order with
// round-to-nearest intrinsics (no contraction), so the result is bitwise
// equal to the plain version's.
//
// Design (simple first):
//   grid (N / 32 output channels, M / BM rows), 128 threads.  A loop inside
//   the block walks K in tiles of 512 bytes: the next tile of W (32 rows)
//   and X (BM rows) is fetched into registers, 16 bytes a load, while the
//   current one is computed, then staged in shared memory as int32 words
//   (rows padded to an odd word stride: conflict-free reads).  Each thread
//   owns one output channel (its lane) and BM / 4 rows, and accumulates
//   with __dp4a (four s8*s8 products into s32 per instruction); X words
//   are warp broadcasts.  BM is 4 at decode (M = slots) and 16 otherwise,
//   so a decode step computes no padded rows.  Ragged M, N and K are
//   handled by predicated loads that leave zeros in the tile: zero int8
//   entries add nothing to the sum, and nothing is padded or copied in
//   device memory.  When K is a multiple of 16 and the rows are 16-byte
//   aligned the loads are 16-byte vectors, else byte loads (the wrapper
//   chooses).
//
// Bound on the H100: bytes.  A call must read the weight once, N * K
// bytes, plus X, the scales and the f32 output; at decode (M = 4) the
// 2 * M * N * K operations are three orders of magnitude below the byte
// time at 1,979 TOP/s int8.  A decode step of internlm2-1.8b streams
// 24 x 62.9 MB of int8 weights: about 0.45 ms at 3.35 TB/s.
//
// Left for later PRs: the grid is only N / 32 blocks (32 for the 1024-wide
// K/V projections on 132 SMs): split K across blocks (int32 partial sums
// add exactly, in any order) or narrow the tile; cp.async/TMA pipelining;
// an mma.sync / wgmma s8 path for the chunk's M = 64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // 4 warps
constexpr int BN = 32;                  // output channels per block (lanes)
constexpr int BK = 512;                 // bytes of K per staged tile
constexpr int WK = BK / 4;              // int32 words per tile row
constexpr int LDS = WK + 1;             // padded smem row stride in words
constexpr int CPR = BK / 16;            // 16-byte chunks per tile row

// One 16-byte chunk of a row, bytes [kb, kb + 16) of K; zeros past K.
template <bool VEC>
__device__ __forceinline__ uint4 fetch_chunk(const int8_t* row, int kb,
                                             int K) {
  if (VEC) {
    if (kb < K) return *reinterpret_cast<const uint4*>(row + kb);
    return make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (kb + i < K)
      wd[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(row[kb + i]))
                    << (8 * (i & 3));
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// Fetch tile [k0, k0 + BK) of rows [r0, r0 + ROWS) (rows >= R are zeros)
// into registers: chunk i = tid + u * kThreads is row i / CPR, chunk
// i % CPR, so neighbouring threads read neighbouring addresses.
template <int ROWS, bool VEC, int LOADS>
__device__ __forceinline__ void fetch_tile(uint4 (&reg)[LOADS],
                                           const int8_t* base, long long ld,
                                           int r0, int R, int k0, int K,
                                           int tid) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int i = tid + u * kThreads;
    const int r = i / CPR, c = i % CPR;
    reg[u] = make_uint4(0u, 0u, 0u, 0u);
    if (i < ROWS * CPR && r0 + r < R)
      reg[u] = fetch_chunk<VEC>(base + (long long)(r0 + r) * ld,
                                k0 + c * 16, K);
  }
}

template <int ROWS, int LOADS>
__device__ __forceinline__ void stage_tile(int* dst, const uint4 (&reg)[LOADS],
                                           int tid) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int i = tid + u * kThreads;
    if (i < ROWS * CPR) {
      int* d = dst + (i / CPR) * LDS + (i % CPR) * 4;
      d[0] = static_cast<int>(reg[u].x);
      d[1] = static_cast<int>(reg[u].y);
      d[2] = static_cast<int>(reg[u].z);
      d[3] = static_cast<int>(reg[u].w);
    }
  }
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ xs, const float* __restrict__ ws,
               float* __restrict__ out, int M, int N, int K, long long ldx,
               long long ldw) {
  constexpr int GROUPS = kThreads / BN;           // row groups
  constexpr int RPT = BM / GROUPS;                // rows per thread
  constexpr int WLOADS = BN * CPR / kThreads;     // W chunks per thread
  constexpr int XLOADS = (BM * CPR + kThreads - 1) / kThreads;
  static_assert(BM % GROUPS == 0 && BN * CPR % kThreads == 0, "tile shape");

  __shared__ int x_s[BM * LDS];
  __shared__ int w_s[BN * LDS];

  const int tid = threadIdx.x;
  const int tn = tid % BN, tm = tid / BN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  int acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0;

  uint4 wreg[WLOADS], xreg[XLOADS];
  fetch_tile<BN, VEC>(wreg, w, ldw, n0, N, 0, K, tid);
  fetch_tile<BM, VEC>(xreg, x, ldx, m0, M, 0, K, tid);

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();   // the previous tile is consumed
    stage_tile<BN>(w_s, wreg, tid);
    stage_tile<BM>(x_s, xreg, tid);
    __syncthreads();
    if (k0 + BK < K) {
      fetch_tile<BN, VEC>(wreg, w, ldw, n0, N, k0 + BK, K, tid);
      fetch_tile<BM, VEC>(xreg, x, ldx, m0, M, k0 + BK, K, tid);
    }
    const int* wr = w_s + tn * LDS;
#pragma unroll 16
    for (int j = 0; j < WK; ++j) {
      const int wv = wr[j];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        acc[r] = __dp4a(x_s[(tm + r * GROUPS) * LDS + j], wv, acc[r]);
    }
  }

  const int n = n0 + tn;
  if (n >= N) return;
  const float wsn = ws[n];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int m = m0 + tm + r * GROUPS;
    if (m < M)
      out[(long long)m * N + n] =
          __fmul_rn(__int2float_rn(acc[r]), __fmul_rn(xs[m], wsn));
  }
}

template <int BM, bool VEC>
int launch(const void* x, const void* w, const void* xs, const void* ws,
           void* out, int M, int N, int K, long long ldx, long long ldw,
           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_mm_kernel<BM, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<float*>(out), M, N, K, ldx, ldw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vec: 1 when K, ldx, ldw are multiples of 16 and x, w 16-byte aligned.
int int8_matmul(const void* x, const void* w, const void* xs, const void* ws,
                void* out, int M, int N, int K, long long ldx, long long ldw,
                int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 4)
    return vec ? launch<4, true>(x, w, xs, ws, out, M, N, K, ldx, ldw, st)
               : launch<4, false>(x, w, xs, ws, out, M, N, K, ldx, ldw, st);
  return vec ? launch<16, true>(x, w, xs, ws, out, M, N, K, ldx, ldw, st)
             : launch<16, false>(x, w, xs, ws, out, M, N, K, ldx, ldw, st);
}

}  // extern "C"
