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
// dt == 0 is an exact identity on the state: the decay expf(0 * a) is then
// exactly 1 (a finite; expf(+-0) is 1, as the plain version's exp(0)) and
// the input term exactly 0, so a ragged chunk's masked pad tail, or an
// idle serving row, leaves h bit for bit as it was.  No fast math: expf
// rounds as the plain version's exp does, up to its last ulp.  The step
// has no branch (a select around expf compiles to one, which serializes
// the step's independent exponentials).
//
// Bound on the H100: bytes.  The scan moves x, dt, B and C once, A once,
// h0 and h_final once, y once, against 7 f32 operations per (t, d, n):
//   a prefill chunk (B 1, S 64, D 8192, N 16, bf16 in): 5.77 MB, 1.72 us
//     at 3.35 TB/s (0.75 us of f32 operations at 67 TFLOP/s);
//   a decode step (B 4, S 1): 4.98 MB, mostly h0 and h_final, 1.49 us.
// In practice the sweep is bound by instruction issue: expf (about ten
// instructions of its accurate sequence) is over half of a step's
// instructions, and the one-shot S 2048 at B 1 runs two warps a
// scheduler (PERF.md gives the readings).
//
// Design: a quarter of a channel a thread.
//   Lane q of a channel's four holds the states n = q * KPER .. q * KPER +
//   KPER - 1 (KPER 4 for N <= 16, 16 for N <= 64) in registers for the
//   whole sweep over t, and moves h0, h_final and a as float4s (a warp
//   moves 512 contiguous bytes of state at a time).  y[t] is the lanes'
//   partial dot products with C[t], each summed in state order, then
//   summed across the 4 lanes in a fixed order: at S > 1 four steps at a
//   time, their decays and inputs first (16 independent expf) and the
//   lanes' 4 x 4 partials reduced by a transposing butterfly (3 shuffles
//   for 4 steps; lane q writes step q's y).  A block is 256 threads, 64
//   channels of
//   one batch row: at the decode step (B 4, D 8192) 131,072 threads, one
//   wave; at the prefill chunk (B 1) 32,768, eight warps an SM.
//   S = 1 (decode) reads x, dt, B and C straight from global memory, with
//   no staging and no block sync.  S > 1 stages TC steps of the block's x
//   and dt columns and of B and C (which every channel of the row shares)
//   in shared memory through a two-chunk cp.async ring (16-byte copies
//   when every row is 16-byte aligned, else plain loads), one block sync a
//   chunk; each thread then steps through the chunk on its own.  The
//   sequence is not split across blocks: a split scan redoes each
//   segment's sweep (and its expf) once the incoming state is known, and
//   the long one-shot sweep is issue-bound, not latency-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                    // lanes a channel
constexpr int kThreads = 256;
constexpr int kChannels = kThreads / kLanes; // channels a block
constexpr int kMaxN = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// K consecutive values from p (K * sizeof(T) bytes aligned), widened
template <int K>
__device__ __forceinline__ void widen(const float* p, float (&v)[K]) {
#pragma unroll
  for (int i = 0; i < K / 4; ++i) {
    const float4 u = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = u.x;
    v[4 * i + 1] = u.y;
    v[4 * i + 2] = u.z;
    v[4 * i + 3] = u.w;
  }
}
template <int K>
__device__ __forceinline__ void widen(const __nv_bfloat16* p,
                                      float (&v)[K]) {
#pragma unroll
  for (int i = 0; i < K / 4; ++i) {
    const uint2 u = reinterpret_cast<const uint2*>(p)[i];
    v[4 * i] = __uint_as_float(u.x << 16);
    v[4 * i + 1] = __uint_as_float(u.x & 0xffff0000u);
    v[4 * i + 2] = __uint_as_float(u.y << 16);
    v[4 * i + 3] = __uint_as_float(u.y & 0xffff0000u);
  }
}

// The thread's K values at p: the first `live`, zeros after (under VEC
// `live` is K or 0, and K values are read as vectors)
template <int K, bool VEC, typename T>
__device__ __forceinline__ void read_k(const T* p, int live, float (&v)[K]) {
  if (VEC) {
    if (live > 0) {
      widen<K>(p, v);
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = j < live ? to_f32(p[j]) : 0.f;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// U consecutive steps (x and dt rows kChannels apart, B and C rows N
// apart: a staged chunk, or at S = 1 global memory).  The decays and inputs of all U steps come first, so
// that their U * KPER expf are independent; then the state walks the U
// steps.  The lanes' partial y of the U steps are summed by a transposing
// reduction: for U = 4 the channel's lane q returns step q's y, summed as
// (y0 + y2) + (y1 + y3) over the lanes' partials (3 shuffles for 4 steps);
// for U = 1 every lane returns the one step's.
template <int KPER, int U, bool VEC, typename T>
__device__ __forceinline__ float steps(float (&h)[KPER],
                                       const float (&av)[KPER],
                                       const T* xr, const T* dtr,
                                       const T* br, const T* cr, int N,
                                       int n0, int live, int q) {
  float dec[U][KPER], inp[U][KPER], cv[U][KPER];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float dtv = to_f32(dtr[u * kChannels]);
    const float dx = dtv * to_f32(xr[u * kChannels]);
    float bv[KPER];
    // every lane may read its K values (VEC: rows of 4 * KPER)
    read_k<KPER, VEC>(br + u * N + n0, VEC ? KPER : live, bv);
    read_k<KPER, VEC>(cr + u * N + n0, VEC ? KPER : live, cv[u]);
#pragma unroll
    for (int j = 0; j < KPER; ++j) {
      dec[u][j] = expf(dtv * av[j]);   // exactly 1 at dt = 0
      inp[u][j] = dx * bv[j];
    }
  }
  float yp[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < KPER; ++j) {
      if (VEC || j < live) {
        h[j] = dec[u][j] * h[j] + inp[u][j];
        acc = fmaf(h[j], cv[u][j], acc);
      }
    }
    yp[u] = acc;
  }
  if constexpr (U == 1) {
    float acc = yp[0];
    acc += __shfl_xor_sync(0xffffffffu, acc, 1, kLanes);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2, kLanes);
    return acc;
  } else {
    static_assert(U == kLanes, "one step a lane");
    // lanes q and q ^ 2 swap halves: q keeps steps (q & 2) + {0, 1}
    const bool up = q & 2;
    float r1[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float send = up ? yp[u] : yp[u + 2];
      const float keep = up ? yp[u + 2] : yp[u];
      r1[u] = keep + __shfl_xor_sync(0xffffffffu, send, 2, kLanes);
    }
    // lanes q and q ^ 1: q keeps step (q & 2) + (q & 1) = q
    const bool odd = q & 1;
    const float send = odd ? r1[0] : r1[1];
    const float keep = odd ? r1[1] : r1[0];
    return keep + __shfl_xor_sync(0xffffffffu, send, 1, kLanes);
  }
}

// VEC: N == 4 * KPER, every pointer 16-byte aligned and the rows of x, dt
// (D * sizeof(T) bytes) and of B, C (N * sizeof(T)) multiples of 16 bytes
template <typename T, int KPER, bool VEC>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  const float* __restrict__ a, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ hout, int S,
                  int D, int N) {
  constexpr int TC = 64 / sizeof(T);         // steps a chunk
  constexpr int NS = kLanes * KPER;          // states a channel at most
  constexpr int EPC = 16 / sizeof(T);        // elements a 16-byte copy
  constexpr int U = KPER == 4 ? 4 : 1;       // steps at once
  static_assert(TC % U == 0, "chunk");
  // two chunks of x and dt columns, then of B and C rows (raw storage:
  // __nv_bfloat16 has constructors)
  __shared__ __align__(16) unsigned char
      raw[sizeof(T) * 2 * TC * (2 * kChannels + 2 * NS)];
  T(*xs)[TC][kChannels] = reinterpret_cast<T(*)[TC][kChannels]>(raw);
  T(*dts)[TC][kChannels] = xs + 2;
  T(*bs)[TC * NS] = reinterpret_cast<T(*)[TC * NS]>(dts + 2);
  T(*cs)[TC * NS] = bs + 2;

  const int tid = threadIdx.x;
  const int ch = tid / kLanes, q = tid % kLanes;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + ch;
  const bool on = d < D;
  const int n0 = q * KPER;
  const int live = !on ? 0 : VEC ? KPER : max(0, min(KPER, N - n0));
  const long long hoff = (static_cast<long long>(b) * D + d) * N + n0;

  float h[KPER], av[KPER];
  read_k<KPER, VEC>(a + static_cast<long long>(d) * N + n0, live, av);
  if (h0 != nullptr) {
    read_k<KPER, VEC>(h0 + hoff, live, h);
  } else {
#pragma unroll
    for (int j = 0; j < KPER; ++j) h[j] = 0.f;
  }

  if (S == 1) {
    // decode: one step straight from global memory (a channel past D
    // reads channel 0's x and dt, and its result is dropped)
    const long long xo = static_cast<long long>(b) * D + (on ? d : 0);
    const long long bo = static_cast<long long>(b) * N;
    const float yv = steps<KPER, 1, VEC>(h, av, x + xo, dt + xo, bm + bo,
                                         cm + bo, N, n0, live, q);
    if (q == 0 && on) y[xo] = yv;
  } else {
    const long long row0 = static_cast<long long>(b) * S;   // row (b, 0)
    // chunk c's x, dt, B and C into buffer s; rows past S and channels
    // past D are zeros
    auto stage = [&](int c, int s) {
      const int t0 = c * TC;
      if (VEC) {
        constexpr int CPR = kChannels / EPC;   // 16-byte copies a row
        for (int i = tid; i < TC * CPR; i += kThreads) {
          const int tt = i / CPR, dc = d0 + (i % CPR) * EPC;
          const bool ok = t0 + tt < S && dc < D;
          const long long off = ok ? (row0 + t0 + tt) * D + dc : 0;
          cp_async16(&xs[s][tt][(i % CPR) * EPC], x + off, ok);
          cp_async16(&dts[s][tt][(i % CPR) * EPC], dt + off, ok);
        }
        const long long base = (row0 + t0) * N;
        for (int i = tid; i < TC * N / EPC; i += kThreads) {
          const bool ok = t0 + (i * EPC) / N < S;
          const long long off = ok ? base + i * EPC : 0;
          cp_async16(&bs[s][i * EPC], bm + off, ok);
          cp_async16(&cs[s][i * EPC], cm + off, ok);
        }
        cp_async_commit();
      } else {
        const T zero = T(0.f);
        for (int i = tid; i < TC * kChannels; i += kThreads) {
          const int tt = i / kChannels, c2 = i % kChannels;
          const bool ok = t0 + tt < S && d0 + c2 < D;
          const long long off = (row0 + t0 + tt) * D + d0 + c2;
          xs[s][tt][c2] = ok ? x[off] : zero;
          dts[s][tt][c2] = ok ? dt[off] : zero;
        }
        for (int i = tid; i < TC * N; i += kThreads) {
          const bool ok = t0 + i / N < S;
          const long long off = (row0 + t0) * N + i;
          bs[s][i] = ok ? bm[off] : zero;
          cs[s][i] = ok ? cm[off] : zero;
        }
      }
    };
    const int nchunks = (S + TC - 1) / TC;
    stage(0, 0);
    for (int c = 0; c < nchunks; ++c) {
      const int s = c & 1;
      if (VEC) cp_async_wait_all();
      // chunk c has landed, and every thread is done with chunk c - 1,
      // whose buffer chunk c + 1 takes
      __syncthreads();
      if (c + 1 < nchunks) stage(c + 1, s ^ 1);
      const int tc = min(TC, S - c * TC);
      const long long yrow = (row0 + c * TC) * D + d;
      for (int tt = 0; tt < tc; tt += U) {
        // rows past S are zeros: dt = 0 steps, which leave h as it was
        const float yv = steps<KPER, U, VEC>(h, av, &xs[s][tt][ch],
                                             &dts[s][tt][ch], &bs[s][tt * N],
                                             &cs[s][tt * N], N, n0, live, q);
        // lane q holds step tt + q's y (U = 4), lane 0 step tt's (U = 1)
        if (on && q < U && tt + q < tc)
          y[yrow + static_cast<long long>(tt + q) * D] = yv;
      }
    }
  }

  if (VEC) {
    if (on) {
#pragma unroll
      for (int i = 0; i < KPER / 4; ++i)
        reinterpret_cast<float4*>(hout + hoff)[i] =
            make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < KPER; ++j)
      if (j < live) hout[hoff + j] = h[j];
  }
}

template <typename T, int KPER, bool VEC>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* a, const void* h0, void* y, void* hout, int B, int S,
           int D, int N, cudaStream_t stream) {
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  mamba_scan_kernel<T, KPER, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hout), S, D, N);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* bm, const void* cm,
             const void* a, const void* h0, void* y, void* hout, int B,
             int S, int D, int N, int kper, cudaStream_t st) {
  const bool vec = N == kLanes * kper &&
                   (static_cast<long long>(D) * sizeof(T)) % 16 == 0 &&
                   (static_cast<long long>(N) * sizeof(T)) % 16 == 0 &&
                   aligned16(x) && aligned16(dt) && aligned16(bm) &&
                   aligned16(cm) && aligned16(a) && aligned16(h0) &&
                   aligned16(hout);
  if (kper == 4)
    return vec ? launch<T, 4, true>(x, dt, bm, cm, a, h0, y, hout, B, S, D,
                                    N, st)
               : launch<T, 4, false>(x, dt, bm, cm, a, h0, y, hout, B, S, D,
                                     N, st);
  return vec ? launch<T, 16, true>(x, dt, bm, cm, a, h0, y, hout, B, S, D, N,
                                   st)
             : launch<T, 16, false>(x, dt, bm, cm, a, h0, y, hout, B, S, D,
                                    N, st);
}

// ---------------------------------------------------------------------------
// Backward (the TPU kernel has none: XLA differentiates the reference's
// associative scan).  Contract: kernels/ref.py::mamba_scan_bwd_ref.  With
// decay[t] = exp(dt[t] a) and g the gradient of h[t], carried from
// dh_final (zeros when null) down to t = 0:
//   g[t] = decay[t+1] g[t+1] + dy[t] C[t]
//   dx[t] = dt[t] sum_n g[t] B[t];  ddt[t] = x[t] sum_n g[t] B[t] +
//   sum_n g[t] h[t-1] decay[t] a;  dB[t] = sum_d g[t] dt[t] x[t];
//   dC[t] = sum_d dy[t] h[t];  dA = sum_{b,t} g[t] h[t-1] decay[t] dt[t];
//   dh0 = decay[0] g[0].
// The sweep needs h[t-1] in reverse order, and the decay is never
// inverted (exp(dt a) underflows to 0).  The same lanes as the forward (a
// quarter of a channel a thread, KPER states in registers) first run the
// forward recurrence from h0 and store the state entering each chunk of
// TB steps (`hs`); then, from the last chunk down, each recomputes its
// chunk's states from that boundary into a scratch trajectory (`traj`, its
// own KPER floats a step, neighbouring threads on neighbouring addresses)
// and walks them in reverse.  Both scratches are thread-private, so they
// need no sync.  Every exponential is computed three times (boundaries,
// recompute, reverse).
// The sums over channels (dB, dC) are reduced in fixed orders: across the
// 8 channels of a warp by shuffles, across the 8 warps of the block in
// shared memory at the end of each chunk, into per-block partials
// (B, blocks, S, N) f32; dA's per-row partials (B, D, N) are in registers
// until the end.  A second kernel sums the partials over the blocks (and
// dA over B) in block order, so two runs give the same bits (no atomics).
// dx, ddt, dB and dC are written in the input type, dA and dh0 in f32.
// Inputs are read straight from global memory (no staging): a first,
// simple design.
// Bound on the H100: operations.  20 f32 operations a (t, d, n) (the
// state and its decay, the carried gradient, the sums of dx, ddt, dA, dB
// and dC): at falcon-mamba's training shape (B 1, S 2048, D 8192, N 16,
// bf16) 5.37 GFLOP, 0.080 ms at 67 TFLOP/s; the bytes (x, dt, B, C, dy
// read once, dx, ddt, dB, dC, dA, dh0 written once) 201 MB, 0.060 ms.
// This first design reads 3.90 ms there (PERF.md): one block an SM at B 1,
// each thread's sweep serial, the exponentials computed three times.
// ---------------------------------------------------------------------------
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// steps a backward chunk: the trajectory a thread keeps is TB x KPER
// floats, and the block's per-step partials of dB and dC 2 x TB x 8 warps
// x 4 KPER floats (32 KB) of shared memory
template <int KPER>
__host__ __device__ constexpr int bwd_steps() {
  return 128 / KPER;
}

// the thread's KPER values of row `row` (N apart) at n0: zeros past N or
// off the channels
template <int KPER, typename T>
__device__ __forceinline__ void read_row(const T* p, int live,
                                         float (&v)[KPER]) {
#pragma unroll
  for (int j = 0; j < KPER; ++j) v[j] = j < live ? load_f(p + j) : 0.f;
}

template <typename T, int KPER>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ a,
                      const float* __restrict__ h0,
                      const float* __restrict__ dy,
                      const float* __restrict__ dhf, float* __restrict__ hs,
                      float* __restrict__ traj, T* __restrict__ dx,
                      T* __restrict__ ddt, float* __restrict__ pdb,
                      float* __restrict__ pdc, float* __restrict__ pda,
                      float* __restrict__ dh0, int S, int D, int N) {
  constexpr int TB = bwd_steps<KPER>();
  constexpr int NS = kLanes * KPER;
  __shared__ float red[2][TB][kWarps][NS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = tid / kLanes, q = tid % kLanes;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d = blk * kChannels + ch;
  const bool on = d < D;
  const int n0 = q * KPER;
  const int live = on ? max(0, min(KPER, N - n0)) : 0;
  const long long hoff = (static_cast<long long>(b) * D + d) * N + n0;
  const int nchunks = (S + TB - 1) / TB;
  // this thread's KPER floats in the scratches: (b, block, step or
  // chunk, thread)
  const long long lane_base = static_cast<long long>(b) * nblk + blk;
  float* hs_t = hs + (lane_base * nchunks * kThreads + tid) * KPER;
  float* tr_t = traj + (lane_base * TB * kThreads + tid) * KPER;
  constexpr long long kStride = static_cast<long long>(kThreads) * KPER;

  float av[KPER], h[KPER];
  read_row<KPER>(a + static_cast<long long>(on ? d : 0) * N + n0, live, av);
  if (h0 != nullptr) {
    read_row<KPER>(h0 + hoff, live, h);
  } else {
#pragma unroll
    for (int j = 0; j < KPER; ++j) h[j] = 0.f;
  }

  const long long row0 = static_cast<long long>(b) * S;
  // one forward step at t: h = decay h + dt x B
  auto forward = [&](int t, float (&hh)[KPER]) {
    const long long xo = (row0 + t) * D + d;
    const float dtv = on ? load_f(dt + xo) : 0.f;
    const float dxv = on ? dtv * load_f(x + xo) : 0.f;
    float bv[KPER];
    read_row<KPER>(bm + (row0 + t) * N + n0, live, bv);
#pragma unroll
    for (int j = 0; j < KPER; ++j)
      hh[j] = expf(dtv * av[j]) * hh[j] + dxv * bv[j];
  };

  // 1. the forward recurrence, storing the state entering each chunk
  for (int c = 0; c < nchunks; ++c) {
#pragma unroll
    for (int j = 0; j < KPER; ++j) hs_t[c * kStride + j] = h[j];
    const int t1 = min(S, (c + 1) * TB);
    for (int t = c * TB; t < t1; ++t) forward(t, h);
  }

  // 2. chunks from the last: recompute, then walk the chunk in reverse
  float g[KPER], dav[KPER];
  if (dhf != nullptr) {
    read_row<KPER>(dhf + hoff, live, g);
  } else {
#pragma unroll
    for (int j = 0; j < KPER; ++j) g[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < KPER; ++j) dav[j] = 0.f;

  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * TB, tc = min(TB, S - t0);
    float hstart[KPER], cur[KPER];
#pragma unroll
    for (int j = 0; j < KPER; ++j) {
      hstart[j] = hs_t[c * kStride + j];
      cur[j] = hstart[j];
    }
    for (int tt = 0; tt < tc; ++tt) {
      forward(t0 + tt, cur);
#pragma unroll
      for (int j = 0; j < KPER; ++j) tr_t[tt * kStride + j] = cur[j];
    }
    // cur is h[t0 + tc - 1]
    for (int tt = tc - 1; tt >= 0; --tt) {
      const int t = t0 + tt;
      const long long xo = (row0 + t) * D + d;
      const float dtv = on ? load_f(dt + xo) : 0.f;
      const float xv = on ? load_f(x + xo) : 0.f;
      const float dyv = on ? dy[xo] : 0.f;
      float bv[KPER], cv[KPER], prev[KPER];
      read_row<KPER>(bm + (row0 + t) * N + n0, live, bv);
      read_row<KPER>(cm + (row0 + t) * N + n0, live, cv);
#pragma unroll
      for (int j = 0; j < KPER; ++j)
        prev[j] = tt > 0 ? tr_t[(tt - 1) * kStride + j] : hstart[j];
      float gb = 0.f, gha = 0.f, pb[KPER], pc[KPER];
#pragma unroll
      for (int j = 0; j < KPER; ++j) {
        const float dec = expf(dtv * av[j]);
        const float gj = fmaf(dyv, cv[j], g[j]);
        gb = fmaf(gj, bv[j], gb);
        const float gh = gj * prev[j] * dec;
        gha = fmaf(gh, av[j], gha);
        dav[j] = fmaf(gh, dtv, dav[j]);
        pb[j] = gj * (dtv * xv);
        pc[j] = dyv * cur[j];
        g[j] = dec * gj;
        cur[j] = prev[j];
      }
      // the channel's four lanes, in a fixed order
      gb += __shfl_xor_sync(0xffffffffu, gb, 1, kLanes);
      gb += __shfl_xor_sync(0xffffffffu, gb, 2, kLanes);
      gha += __shfl_xor_sync(0xffffffffu, gha, 1, kLanes);
      gha += __shfl_xor_sync(0xffffffffu, gha, 2, kLanes);
      if (on && q == 0) {
        store_f(dx + xo, dtv * gb);
        store_f(ddt + xo, fmaf(xv, gb, gha));
      }
      // the warp's 8 channels (lanes of one q, 4 apart), in a fixed order
#pragma unroll
      for (int j = 0; j < KPER; ++j) {
#pragma unroll
        for (int o = kLanes; o < 32; o <<= 1) {
          pb[j] += __shfl_xor_sync(0xffffffffu, pb[j], o);
          pc[j] += __shfl_xor_sync(0xffffffffu, pc[j], o);
        }
      }
      if (lane < kLanes) {
#pragma unroll
        for (int j = 0; j < KPER; ++j) {
          red[0][tt][warp][n0 + j] = pb[j];
          red[1][tt][warp][n0 + j] = pc[j];
        }
      }
    }
    __syncthreads();
    // the block's partials of this chunk, the warps summed in order
    for (int i = tid; i < tc * N; i += kThreads) {
      const int tt = i / N, n = i % N;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sb += red[0][tt][w][n];
        sc += red[1][tt][w][n];
      }
      const long long po = ((lane_base * S) + t0 + tt) * N + n;
      pdb[po] = sb;
      pdc[po] = sc;
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < KPER; ++j) {
    if (j < live) {
      dh0[hoff + j] = g[j];
      pda[hoff + j] = dav[j];
    }
  }
}

// dB, dC (B, S, N) = the per-block partials summed over the blocks in
// block order; dA (D, N) = the per-row partials summed over B in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_sum_kernel(const float* __restrict__ pdb,
                          const float* __restrict__ pdc,
                          const float* __restrict__ pda, T* __restrict__ db,
                          T* __restrict__ dc, float* __restrict__ da, int B,
                          int S, int D, int N, int nblk) {
  const long long sn = static_cast<long long>(S) * N;
  const long long n_bc = B * sn, n_a = static_cast<long long>(D) * N;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n_bc + n_a; i += static_cast<long long>(gridDim.x) * kThreads) {
    if (i < n_bc) {
      const long long b = i / sn, r = i % sn;
      float sb = 0.f, sc = 0.f;
      for (int k = 0; k < nblk; ++k) {
        const long long po = (b * nblk + k) * sn + r;
        sb += pdb[po];
        sc += pdc[po];
      }
      store_f(db + i, sb);
      store_f(dc + i, sc);
    } else {
      const long long r = i - n_bc;
      float s = 0.f;
      for (int b = 0; b < B; ++b) s += pda[b * n_a + r];
      da[r] = s;
    }
  }
}

template <typename T, int KPER>
int launch_bwd(const void* x, const void* dt, const void* bm, const void* cm,
               const void* a, const void* h0, const void* dy,
               const void* dhf, void* hs, void* traj, void* dx, void* ddt,
               void* pdb, void* pdc, void* pda, void* db, void* dc, void* da,
               void* dh0, int B, int S, int D, int N, cudaStream_t stream) {
  const int nblk = (D + kChannels - 1) / kChannels;
  mamba_scan_bwd_kernel<T, KPER><<<dim3(nblk, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<const float*>(dhf),
      static_cast<float*>(hs), static_cast<float*>(traj),
      static_cast<T*>(dx), static_cast<T*>(ddt), static_cast<float*>(pdb),
      static_cast<float*>(pdc), static_cast<float*>(pda),
      static_cast<float*>(dh0), S, D, N);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const long long total = static_cast<long long>(B) * S * N +
                          static_cast<long long>(D) * N;
  const long long want = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  mamba_scan_bwd_sum_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(pdb), static_cast<const float*>(pdc),
      static_cast<const float*>(pda), static_cast<T*>(db),
      static_cast<T*>(dc), static_cast<float*>(da), B, S, D, N, nblk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const void* x, const void* dt, const void* bm,
                 const void* cm, const void* a, const void* h0,
                 const void* dy, const void* dhf, void* hs, void* traj,
                 void* dx, void* ddt, void* pdb, void* pdc, void* pda,
                 void* db, void* dc, void* da, void* dh0, int B, int S,
                 int D, int N, int kper, cudaStream_t st) {
  if (kper == 4)
    return launch_bwd<T, 4>(x, dt, bm, cm, a, h0, dy, dhf, hs, traj, dx, ddt,
                            pdb, pdc, pda, db, dc, da, dh0, B, S, D, N, st);
  return launch_bwd<T, 16>(x, dt, bm, cm, a, h0, dy, dhf, hs, traj, dx, ddt,
                           pdb, pdc, pda, db, dc, da, dh0, B, S, D, N, st);
}

}  // namespace

extern "C" {

// dtype of x, dt, B and C: 0 = float32, 1 = bfloat16.  h0 may be null
// (zeros); it must not alias hout.  kper: the wrapper's plan, states a
// lane, 4 (N <= 16) or 16 (N <= 64).  Returns a cudaError_t: sizes or a
// plan the kernel does not take (cudaErrorInvalidValue), or the launch's
// own error.
int mamba_scan(int dtype, const void* x, const void* dt, const void* bm,
               const void* cm, const void* a, const void* h0, void* y,
               void* hout, int B, int S, int D, int N, int kper,
               void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || N < 1 || N > kMaxN ||
      (kper != 4 && kper != 16) || N > kLanes * kper)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, bm, cm, a, h0, y, hout, B, S, D,
                                   N, kper, st);
  if (dtype == 0)
    return dispatch<float>(x, dt, bm, cm, a, h0, y, hout, B, S, D, N, kper,
                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of mamba_scan (two kernels, one call).  x, dt, B, C, a and
// h0 as the forward's (h0 may be null: zeros); dy (B, S, D) f32; dhf (B,
// D, N) f32 or null (zeros).  Scratch, f32, from the wrapper's plan: hs
// (B, blocks, chunks, 256 x kper), traj (B, blocks, 128 / kper, 256 x
// kper), pdb/pdc (B, blocks, S, N), pda (B, D, N).  Writes dx, ddt (B, S,
// D) and db, dc (B, S, N) in the input type, da (D, N) and dh0 (B, D, N)
// f32.  Returns a cudaError_t, as mamba_scan.
int mamba_scan_bwd(int dtype, const void* x, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* h0,
                   const void* dy, const void* dhf, void* hs, void* traj,
                   void* dx, void* ddt, void* pdb, void* pdc, void* pda,
                   void* db, void* dc, void* da, void* dh0, int B, int S,
                   int D, int N, int kper, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || N < 1 || N > kMaxN ||
      (kper != 4 && kper != 16) || N > kLanes * kper)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(x, dt, bm, cm, a, h0, dy, dhf, hs,
                                       traj, dx, ddt, pdb, pdc, pda, db, dc,
                                       da, dh0, B, S, D, N, kper, st);
  if (dtype == 0)
    return dispatch_bwd<float>(x, dt, bm, cm, a, h0, dy, dhf, hs, traj, dx,
                               ddt, pdb, pdc, pda, db, dc, da, dh0, B, S, D,
                               N, kper, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
