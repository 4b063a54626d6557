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
// dx, ddt, dB and dC are written in the input type, dA and dh0 in f32.
//
// Bound on the H100: operations.  20 f32 operations a (t, d, n) (the
// state and its decay, the carried gradient, the sums of dx, ddt, dA, dB
// and dC): at falcon-mamba's training shape (B 1, S 2048, D 8192, N 16,
// bf16) 5.37 GFLOP, 0.080 ms at 67 TFLOP/s; the bytes (x, dt, B, C, dy
// read once, dx, ddt, dB, dC, dA, dh0 written once) 201 MB, 0.060 ms.
//
// The first design read 3.821 ms there, 0.021 of the bound: a block of
// 256 threads for 64 channels of a batch row (128 blocks at B 1, two
// warps a scheduler), each thread walking all of S in series; every input
// read from device memory step by step, three times; the states at chunk
// boundaries and each chunk's recomputed trajectory in a global scratch;
// 28 shuffles a step for dx, ddt and the warp's dB and dC.
//
// This design splits the sequence into segments of kSeg steps, at fixed
// multiples of kSeg from t = 0, and scans in two levels, four kernels:
//   1. summary, a block for (64 channels, a segment, a batch row): the
//      segment walked forward from zeros gives its local end state hl,
//      the product P of its decays, and the gradient its steps send out
//      of its start from a zero carry, gl = sum_t Q[t] dy[t] C[t] with Q
//      the running product of the same decays (a forward walk too).
//   2. combine, a thread a (b, d, n) and direction: over the segments in
//      order, the state entering each (h0 into the first, then P h + hl);
//      from the last, the gradient entering each from the right
//      (dh_final into the last, then P g + gl).  Written over hl and gl.
//   3. main, the grid of 1: the segment walked forward from its entering
//      state, the state entering each later sub-chunk of kSub steps kept
//      in shared memory; then the sub-chunks from the last, each recomputed
//      from its state into registers (a thread's kSub x 4 decays and
//      decayed states h[t-1] decay[t]) and walked in reverse from the
//      carried gradient.
//   4. sum: dB and dC over the channel blocks, dA over the batch rows and
//      segments, each in a fixed order.
// At B 1, S 2048, D 8192: 128 x 16 = 2,048 blocks of 256 threads, two
// resident an SM (128 registers a thread, 110.5 KB of shared memory a
// block).  Nothing divides by a decay (exp(dt a) underflows to 0).
//
// Each sub-chunk's x, dt, dy and the B and C rows every channel of the
// row shares are staged in shared memory: 16-byte cp.async copies into a
// landing buffer, widened to f32 tiles (two, one block sync a sub-chunk)
// by the thread that copied them; dy lands in the tile.  The forward
// walk stages x, dt and B only.  dB and dC: each thread stores its states'
// products of a step in its warp's buffer; every two steps the warp sums
// its channels in order (float2 a lane, no shuffle), and after the next
// block sync the block sums its warps in order into per-block partials
// (B, blocks, S, N).  dx and ddt sum a channel's lanes by shuffles (two
// levels at 4 lanes).  dA: per-segment partials (B, segments, D, N), in
// the scratch of P.  dh0: segment 0's carried gradient.  No atomics: two
// runs give the same bits.
//
// Exponentials per (t, d, n): three, each an ex2.approx (`decay`).  The
// summary needs the decays before any entering state is known; the main
// pass's forward walk needs them to reach each sub-chunk's state (a
// segment's decays and states, 4 KB a thread, do not fit on chip), and
// the recompute keeps its sub-chunk's decays for the reverse walk, which
// computes none.  The last sub-chunk of a segment skips the forward walk.
// The staging's copy counts and the flush's trip counts are constants:
// with loops and divisions by the shape, integer work outnumbered the
// float work two to one (PERF.md).
//
// dt == 0 with dy == 0 is an exact identity: the decay is 1 and the
// inputs 0, so the state, the gradient, the summaries (P x 1, hl + 0,
// gl + 0) and the combine (1 x h + 0) pass on bit for bit, and dA gains
// exact zeros.  Segments and sub-chunks start at fixed multiples from
// t = 0, so a padded run's real prefix sees the cut run's operations.
// Rows past S stage as zeros: such steps are the same identity.
// N <= 16: 4 lanes a channel, 64 channels a block; N <= 64: 16 lanes, 16
// channels; 4 states a lane either way.
// ---------------------------------------------------------------------------
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 128;               // steps a segment
constexpr int kSub = 8;                 // steps a sub-chunk
constexpr int kSubs = kSeg / kSub;      // sub-chunks a segment
constexpr int kSt = 4;                  // states a lane

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// decay = exp(dt a) as 2^(dt al), al = a log2(e) formed once a state,
// on the SFU (ex2.approx, subnormals flushed to zero): two instructions
// with the product, against some ten of the accurate expf (its argument
// reduction) and 4 to 5 of exp2f.  2^(+-0) is exactly 1, so dt = 0 stays
// an identity.  The readings stay within chip_smoke.py's MAMBA_BWD_TOL
// with it (PERF.md gives them for expf, exp2f and this).
__device__ __forceinline__ float decay(float dtv, float al) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(dtv * al));
  return r;
}

// a's states n0 .. n0 + 3 of channel d, times log2(e)
template <bool VEC>
__device__ __forceinline__ void read_al(const float* a, int live,
                                        float (&al)[kSt]) {
  read_k<kSt, VEC>(a, live, al);
#pragma unroll
  for (int j = 0; j < kSt; ++j) al[j] *= kLog2e;
}

// The shapes of a backward block, LANES lanes a channel.  Shared memory
// in floats: two staged tiles (x, dt, dy columns [kSub][CH], then B, C
// rows [kSub][NP]), the landing buffer (x, dt, B, C in the input type),
// and in the main kernel the states entering sub-chunks 1 .. kSubs - 1
// [kSubs - 1][threads][4] (sub-chunk 0's is the combine's),
// each warp's products of two steps [step][pb, pc][CW x NP, padded], and
// two buffers of a sub-chunk's warp sums [kSub][warps][pb, pc][NP].
template <typename T, int LANES>
struct Bwd {
  static constexpr int CH = kThreads / LANES;   // channels a block
  static constexpr int CW = 32 / LANES;         // channels a warp
  static constexpr int NP = kSt * LANES;        // states a channel, padded
  static constexpr int EPC = 16 / sizeof(T);    // elements a 16-byte copy
  static constexpr int TILE = 3 * kSub * CH + 2 * kSub * NP;
  static constexpr int RAW = 2 * kSub * CH + 2 * kSub * NP;
  static constexpr int RAW_F = (RAW * static_cast<int>(sizeof(T)) + 15) /
                               16 * 4;
  // 16 floats of padding: the two halves of a warp read other banks
  static constexpr int WROW = CW * NP + 16;
  static constexpr int WB = 4 * WROW;
  static constexpr int RB = kSub * kWarps * 2 * NP;
  static constexpr int CKPT = (kSubs - 1) * kThreads * kSt;
  static constexpr size_t kStageBytes = (2 * TILE + RAW_F) * 4;
  // blocks an SM of the main kernel: two (128 registers a thread) on the
  // training path (bf16, N <= 16); one elsewhere, with registers to spare
  static constexpr int kMinBlocks = sizeof(T) == 2 && LANES == 4 ? 2 : 1;
  static constexpr size_t kMainBytes =
      kStageBytes + static_cast<size_t>(CKPT + kWarps * WB + 2 * RB) * 4;
};

// One staged sub-chunk: rows [t0, t0 + kSub) of batch row b, the block's
// channels [d0, d0 + CH).  `full`: dy and C too (the forward walk needs
// x, dt and B only).  VEC: 16-byte cp.async copies, at most one of each
// kind a thread (x, dt, B and C into the landing buffer, widened by
// `land`; dy straight into the tile), rows past S and channels past D
// zeros.  Otherwise plain loads, states N .. NP - 1 zeros.  Every count
// is a constant: no loop or division depends on the shape.
template <typename T, int LANES, bool VEC>
struct Stager {
  using Sh = Bwd<T, LANES>;
  static constexpr int CH = Sh::CH, NP = Sh::NP, EPC = Sh::EPC;
  static constexpr int NX = kSub * CH / EPC;     // copies of x, of dt
  static constexpr int NY = kSub * CH / 4;       // copies of dy
  static constexpr int NB = kSub * NP / EPC;     // copies of B, of C
  static_assert(NX <= kThreads && NY <= kThreads && NB <= kThreads,
                "one copy of a kind a thread");
  const T* x;
  const T* dt;
  const T* bm;
  const T* cm;
  const float* dy;
  T* raw;
  long long row0;      // row (b, 0)
  int S, D, N, d0, tid;

  __device__ void issue(int t0, bool full, float* tile) const {
    if (VEC) {
      if (tid < NX) {
        const int e = tid * EPC, tt = e / CH, cc = e % CH;
        const bool ok = t0 + tt < S && d0 + cc < D;
        const long long off = ok ? (row0 + t0 + tt) * D + d0 + cc : 0;
        cp_async16(raw + e, x + off, ok);
        cp_async16(raw + kSub * CH + e, dt + off, ok);
      }
      const int j = tid - (kThreads - NY);
      if (full && j >= 0) {
        const int e = j * 4, tt = e / CH, cc = e % CH;
        const bool ok = t0 + tt < S && d0 + cc < D;
        const long long off = ok ? (row0 + t0 + tt) * D + d0 + cc : 0;
        cp_async16(tile + 2 * kSub * CH + e, dy + off, ok);
      }
      if (tid < NB) {
        // N == NP here: the rows are contiguous, kSub x N elements
        const int e = tid * EPC;
        const bool ok = t0 + e / NP < S;
        const long long off = ok ? (row0 + t0) * NP + e : 0;
        T* rb = raw + 2 * kSub * CH;
        cp_async16(rb + e, bm + off, ok);
        if (full) cp_async16(rb + kSub * NP + e, cm + off, ok);
      }
      cp_async_commit();
    } else {
#pragma unroll
      for (int k = 0; k < (kSub * CH + kThreads - 1) / kThreads; ++k) {
        const int i = tid + k * kThreads, tt = i / CH, cc = i % CH;
        if (i >= kSub * CH) continue;
        const bool ok = t0 + tt < S && d0 + cc < D;
        const long long off = ok ? (row0 + t0 + tt) * D + d0 + cc : 0;
        tile[i] = ok ? to_f32(x[off]) : 0.f;
        tile[kSub * CH + i] = ok ? to_f32(dt[off]) : 0.f;
        if (full) tile[2 * kSub * CH + i] = ok ? dy[off] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < (kSub * NP + kThreads - 1) / kThreads; ++k) {
        const int i = tid + k * kThreads, tt = i / NP, n = i % NP;
        if (i >= kSub * NP) continue;
        const bool ok = n < N && t0 + tt < S;
        const long long off = ok ? (row0 + t0 + tt) * N + n : 0;
        float* tb = tile + 3 * kSub * CH;
        tb[i] = ok ? to_f32(bm[off]) : 0.f;
        if (full) tb[kSub * NP + i] = ok ? to_f32(cm[off]) : 0.f;
      }
    }
  }

  // VEC: wait for this thread's copies and widen them into the tile (each
  // thread widens only what it copied, so the landing buffer needs no sync)
  __device__ void land(bool full, float* tile) const {
    if (!VEC) return;
    cp_async_wait_all();
    if (tid < NX) {
      const int e = tid * EPC;
      widen16(raw + e, tile + e);
      widen16(raw + kSub * CH + e, tile + kSub * CH + e);
    }
    if (tid < NB) {
      const int e = tid * EPC;
      const T* rb = raw + 2 * kSub * CH;
      float* tb = tile + 3 * kSub * CH;
      widen16(rb + e, tb + e);
      if (full) widen16(rb + kSub * NP + e, tb + kSub * NP + e);
    }
  }

  // the EPC values of one 16-byte copy, widened to f32
  __device__ static void widen16(const T* src, float* dst) {
    float v[EPC];
    widen<EPC>(src, v);
#pragma unroll
    for (int i = 0; i < EPC / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
};

template <bool VEC>
__device__ __forceinline__ void write4(float* p, int live,
                                       const float (&v)[kSt]) {
  if (VEC) {
    if (live > 0)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kSt; ++j)
      if (j < live) p[j] = v[j];
  }
}

// B and C states n0 .. n0 + 3 of step u of a tile
__device__ __forceinline__ void row4(const float* p, float (&v)[kSt]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

// 1. A segment's summaries from zeros: hl, P and gl (B, segments, D, N)
template <typename T, int LANES, bool VEC>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_summary_kernel(const T* __restrict__ x,
                              const T* __restrict__ dt,
                              const T* __restrict__ bm,
                              const T* __restrict__ cm,
                              const float* __restrict__ a,
                              const float* __restrict__ dy,
                              float* __restrict__ hl, float* __restrict__ gl,
                              float* __restrict__ pp, int S, int D, int N) {
  using Sh = Bwd<T, LANES>;
  constexpr int CH = Sh::CH, NP = Sh::NP;
  extern __shared__ float4 smem4[];
  float* tiles = reinterpret_cast<float*>(smem4);
  T* raw = reinterpret_cast<T*>(tiles + 2 * Sh::TILE);

  const int tid = threadIdx.x, ch = tid / LANES, q = tid % LANES;
  const int seg = blockIdx.y, b = blockIdx.z;
  const int d0 = blockIdx.x * CH, d = d0 + ch, n0 = q * kSt;
  const int live = d < D ? max(0, min(kSt, N - n0)) : 0;
  const int t0 = seg * kSeg;
  const int nsub = (min(kSeg, S - t0) + kSub - 1) / kSub;
  const Stager<T, LANES, VEC> st{x, dt, bm, cm, dy, raw,
                                 static_cast<long long>(b) * S, S, D, N, d0,
                                 tid};

  float al[kSt], h[kSt], qd[kSt], g[kSt];
  read_al<VEC>(a + static_cast<long long>(d < D ? d : 0) * N + n0, live, al);
#pragma unroll
  for (int j = 0; j < kSt; ++j) {
    h[j] = 0.f;
    qd[j] = 1.f;
    g[j] = 0.f;
  }
  st.issue(t0, true, tiles);
  for (int c = 0; c < nsub; ++c) {
    float* tile = tiles + (c & 1) * Sh::TILE;
    st.land(true, tile);
    // sub-chunk c has landed, and every thread is done with c - 1, whose
    // tile c + 1 takes
    __syncthreads();
    if (c + 1 < nsub)
      st.issue(t0 + (c + 1) * kSub, true, tiles + ((c + 1) & 1) * Sh::TILE);
    const float* tx = tile;
    const float* tdt = tile + kSub * CH;
    const float* tdy = tile + 2 * kSub * CH;
    const float* tb = tile + 3 * kSub * CH;
    const float* tc = tb + kSub * NP;
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const float dtv = tdt[u * CH + ch], dyv = tdy[u * CH + ch];
      const float dtx = dtv * tx[u * CH + ch];
      float bv[kSt], cv[kSt];
      row4(tb + u * NP + n0, bv);
      row4(tc + u * NP + n0, cv);
#pragma unroll
      for (int j = 0; j < kSt; ++j) {
        const float dec = decay(dtv, al[j]);   // exactly 1 at dt = 0
        h[j] = fmaf(dtx, bv[j], dec * h[j]);
        qd[j] *= dec;
        g[j] = fmaf(qd[j], dyv * cv[j], g[j]);
      }
    }
  }
  const long long so =
      ((static_cast<long long>(b) * gridDim.y + seg) * D + d) * N + n0;
  write4<VEC>(hl + so, live, h);
  write4<VEC>(gl + so, live, g);
  write4<VEC>(pp + so, live, qd);
}

// 2. The states and gradients entering each segment, over hl and gl: a
// thread a (b, d, n), the first B D N forward and the rest backward.
// Sixteen segments' summaries (S 2048) are loaded at a time.
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_combine_kernel(const float* __restrict__ h0,
                              const float* __restrict__ dhf,
                              float* __restrict__ hl, float* __restrict__ gl,
                              const float* __restrict__ pp, int B, int nseg,
                              long long dn) {
  constexpr int G = 16;
  const long long bdn = B * dn;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < 2 * bdn; i += static_cast<long long>(gridDim.x) * kThreads) {
    const bool back = i >= bdn;
    const long long e = back ? i - bdn : i;   // (b, d, n)
    const long long base = (e / dn) * nseg * dn + e % dn;
    const float* init = back ? dhf : h0;
    float* sum = back ? gl : hl;
    float v = init != nullptr ? init[e] : 0.f;
    for (int k0 = 0; k0 < nseg; k0 += G) {
      float s[G], p[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int k = back ? nseg - 1 - (k0 + j) : k0 + j;
        if (k0 + j < nseg) {
          s[j] = sum[base + k * dn];
          p[j] = pp[base + k * dn];
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int k = back ? nseg - 1 - (k0 + j) : k0 + j;
        if (k0 + j < nseg) {
          sum[base + k * dn] = v;
          v = fmaf(p[j], v, s[j]);
        }
      }
    }
  }
}

// 3. The gradients of a segment from its entering state hin and gradient
// gin; dA's partial over pp, dB and dC's per-block partials, dh0 from
// segment 0
template <typename T, int LANES, bool VEC>
__global__ void __launch_bounds__(kThreads, Bwd<T, LANES>::kMinBlocks)
mamba_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ a,
                      const float* __restrict__ dy,
                      const float* __restrict__ hin,
                      const float* __restrict__ gin, float* __restrict__ pda,
                      T* __restrict__ dx, T* __restrict__ ddt,
                      float* __restrict__ pdb, float* __restrict__ pdc,
                      float* __restrict__ dh0, int S, int D, int N) {
  using Sh = Bwd<T, LANES>;
  constexpr int CH = Sh::CH, NP = Sh::NP, CW = Sh::CW;
  extern __shared__ float4 smem4[];
  float* ckpt = reinterpret_cast<float*>(smem4);
  float* wbuf = ckpt + Sh::CKPT;
  float* rbuf = wbuf + kWarps * Sh::WB;
  float* tiles = rbuf + 2 * Sh::RB;
  T* raw = reinterpret_cast<T*>(tiles + 2 * Sh::TILE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = tid / LANES, q = tid % LANES, chw = lane / LANES;
  const int blk = blockIdx.x, seg = blockIdx.y, b = blockIdx.z;
  const int d0 = blk * CH, d = d0 + ch, n0 = q * kSt;
  const bool on = d < D;
  const int live = on ? max(0, min(kSt, N - n0)) : 0;
  const int t0 = seg * kSeg;
  const int nsub = (min(kSeg, S - t0) + kSub - 1) / kSub;
  const long long row0 = static_cast<long long>(b) * S;
  const long long so =
      ((static_cast<long long>(b) * gridDim.y + seg) * D + d) * N + n0;
  const Stager<T, LANES, VEC> st{x, dt, bm, cm, dy, raw, row0, S, D, N, d0,
                                 tid};

  float al[kSt], h[kSt], g[kSt], dav[kSt];
  read_al<VEC>(a + static_cast<long long>(on ? d : 0) * N + n0, live, al);
  read_k<kSt, VEC>(hin + so, live, h);
  read_k<kSt, VEC>(gin + so, live, g);
#pragma unroll
  for (int j = 0; j < kSt; ++j) dav[j] = 0.f;

  // a sub-chunk's warp sums (starting at step tc) into per-block
  // partials, the warps in order
  auto flush = [&](const float* rb, int tc) {
    constexpr int NO = kSub * 2 * NP;
#pragma unroll
    for (int k = 0; k < (NO + kThreads - 1) / kThreads; ++k) {
      const int o = tid + k * kThreads;
      const int n = o % NP, v = (o / NP) & 1, u = o / (2 * NP);
      if (o >= NO || n >= N || tc + u >= S) continue;
      const float* r = rb + (u * kWarps * 2 + v) * NP + n;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += r[w * 2 * NP];
      (v ? pdc : pdb)[((static_cast<long long>(b) * gridDim.x + blk) * S +
                       tc + u) * N + n] = s;
    }
  };

  // sub-chunk c stages into tile c & 1, in either walk, the next one
  // while c is computed (the reverse starts at nsub - 1, after the
  // forward walk's nsub - 2)
  st.issue(t0, nsub == 1, tiles);
  // 1. the forward walk over sub-chunks 0 .. nsub - 2, the state entering
  // each later one kept
  for (int c = 0; c < nsub - 1; ++c) {
    float* tile = tiles + (c & 1) * Sh::TILE;
    st.land(false, tile);
    // sub-chunk c has landed, and every thread is done with the one
    // before, whose tile the next one takes
    __syncthreads();
    st.issue(t0 + (c + 1) * kSub, c + 1 == nsub - 1,
             tiles + ((c + 1) & 1) * Sh::TILE);
    const float* tx = tile;
    const float* tdt = tile + kSub * CH;
    const float* tb = tile + 3 * kSub * CH;
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const float dtv = tdt[u * CH + ch];
      const float dtx = dtv * tx[u * CH + ch];
      float bv[kSt];
      row4(tb + u * NP + n0, bv);
#pragma unroll
      for (int j = 0; j < kSt; ++j)
        h[j] = fmaf(dtx, bv[j], decay(dtv, al[j]) * h[j]);
    }
    reinterpret_cast<float4*>(ckpt)[c * kThreads + tid] =
        make_float4(h[0], h[1], h[2], h[3]);
  }
  // 2. the sub-chunks from the last: recomputed, walked in reverse
  float* wb = wbuf + warp * Sh::WB;
  for (int c = nsub - 1; c >= 0; --c) {
    const int tc = t0 + c * kSub;
    float* tile = tiles + (c & 1) * Sh::TILE;
    st.land(true, tile);
    __syncthreads();
    if (c > 0) st.issue(tc - kSub, true, tiles + ((c - 1) & 1) * Sh::TILE);
    if (c < nsub - 1) flush(rbuf + ((c + 1) & 1) * Sh::RB, tc + kSub);
    const float* tx = tile;
    const float* tdt = tile + kSub * CH;
    const float* tdy = tile + 2 * kSub * CH;
    const float* tb = tile + 3 * kSub * CH;
    const float* tcm = tb + kSub * NP;
    // the state entering sub-chunk c (sub-chunk 0's is hin's)
    float hp[kSt];
    if (c == 0) {
      read_k<kSt, VEC>(hin + so, live, hp);
    } else {
      const float4 v =
          reinterpret_cast<const float4*>(ckpt)[(c - 1) * kThreads + tid];
      hp[0] = v.x;
      hp[1] = v.y;
      hp[2] = v.z;
      hp[3] = v.w;
    }
    // recompute: the sub-chunk's decays and decayed states h[t-1]
    // decay[t] in registers (the reverse walk redoes h[t]'s one fma)
    float dec[kSub][kSt], hd[kSub][kSt];
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const float dtv = tdt[u * CH + ch];
      const float dtx = dtv * tx[u * CH + ch];
      float bv[kSt];
      row4(tb + u * NP + n0, bv);
#pragma unroll
      for (int j = 0; j < kSt; ++j) {
        dec[u][j] = decay(dtv, al[j]);
        hd[u][j] = dec[u][j] * hp[j];
        hp[j] = fmaf(dtx, bv[j], hd[u][j]);
      }
    }
    // walk it in reverse
    float* rb = rbuf + (c & 1) * Sh::RB;
#pragma unroll
    for (int u = kSub - 1; u >= 0; --u) {
      const float dtv = tdt[u * CH + ch], xv = tx[u * CH + ch];
      const float dyv = tdy[u * CH + ch];
      const float dtx = dtv * xv;
      float bv[kSt], cv[kSt], pb[kSt], pc[kSt];
      row4(tb + u * NP + n0, bv);
      row4(tcm + u * NP + n0, cv);
      float gb = 0.f, gha = 0.f;
#pragma unroll
      for (int j = 0; j < kSt; ++j) {
        const float gj = fmaf(dyv, cv[j], g[j]);
        gb = fmaf(gj, bv[j], gb);
        const float gh = gj * hd[u][j];
        gha = fmaf(gh, al[j], gha);
        dav[j] = fmaf(gh, dtv, dav[j]);
        pb[j] = gj * dtx;
        pc[j] = dyv * fmaf(dtx, bv[j], hd[u][j]);      // dy[t] h[t]
        g[j] = dec[u][j] * gj;
      }
      // the channel's lanes, in a fixed order
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1) {
        gb += __shfl_xor_sync(0xffffffffu, gb, o, LANES);
        gha += __shfl_xor_sync(0xffffffffu, gha, o, LANES);
      }
      if (q == 0 && on && tc + u < S) {
        const long long xo = (row0 + tc + u) * D + d;
        store_f(dx + xo, dtv * gb);
        store_f(ddt + xo, fmaf(xv, gb, gha * kLn2));   // sum g h a
      }
      float* w = wb + (u & 1) * 2 * Sh::WROW + chw * NP + n0;
      *reinterpret_cast<float4*>(w) = make_float4(pb[0], pb[1], pb[2], pb[3]);
      *reinterpret_cast<float4*>(w + Sh::WROW) =
          make_float4(pc[0], pc[1], pc[2], pc[3]);
      if ((u & 1) == 0) {
        // steps u and u + 1: the warp's channels summed in order, two
        // states a lane
        __syncwarp();
#pragma unroll
        for (int k = lane; k < 2 * NP; k += 32) {
          const int np2 = k % (NP / 2), v = (k / (NP / 2)) & 1, uu = k / NP;
          const float* src = wb + (uu * 2 + v) * Sh::WROW + 2 * np2;
          float2 s = *reinterpret_cast<const float2*>(src);
#pragma unroll
          for (int cw = 1; cw < CW; ++cw) {
            const float2 e = *reinterpret_cast<const float2*>(src + cw * NP);
            s.x += e.x;
            s.y += e.y;
          }
          *reinterpret_cast<float2*>(
              rb + (((u + uu) * kWarps + warp) * 2 + v) * NP + 2 * np2) = s;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  flush(rbuf, t0);
  write4<VEC>(pda + so, live, dav);
  if (seg == 0)
    write4<VEC>(dh0 + (static_cast<long long>(b) * D + d) * N + n0, live, g);
}

// 4. dB, dC (B, S, N) = the per-block partials summed over the blocks in
// block order; dA (D, N) = the per-segment partials summed over the
// batch rows and segments in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_sum_kernel(const float* __restrict__ pdb,
                          const float* __restrict__ pdc,
                          const float* __restrict__ pda, T* __restrict__ db,
                          T* __restrict__ dc, float* __restrict__ da, int B,
                          int S, int D, int N, int nblk, int nseg) {
  const long long sn = static_cast<long long>(S) * N;
  const long long n_bc = B * sn, n_a = static_cast<long long>(D) * N;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n_bc + n_a; i += static_cast<long long>(gridDim.x) * kThreads) {
    if (i < n_bc) {
      const long long b = i / sn, r = i % sn;
      float sb = 0.f, sc = 0.f;
#pragma unroll 8
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
      for (long long k = 0; k < static_cast<long long>(B) * nseg; ++k)
        s += pda[k * n_a + r];
      da[r] = s;
    }
  }
}

int grid_of(long long threads) {
  const long long want = (threads + kThreads - 1) / kThreads;
  return static_cast<int>(want < 132 * 8 ? want : 132 * 8);
}

template <typename T, int LANES, bool VEC>
int launch_bwd(const void* x, const void* dt, const void* bm, const void* cm,
               const void* a, const void* h0, const void* dy,
               const void* dhf, void* seg, void* pdb, void* pdc, void* dx,
               void* ddt, void* db, void* dc, void* da, void* dh0, int B,
               int S, int D, int N, cudaStream_t stream) {
  using Sh = Bwd<T, LANES>;
  const int nblk = (D + Sh::CH - 1) / Sh::CH, nseg = (S + kSeg - 1) / kSeg;
  const long long dn = static_cast<long long>(D) * N;
  float* hl = static_cast<float*>(seg);
  float* gl = hl + B * nseg * dn;
  float* pp = gl + B * nseg * dn;
  const dim3 grid(nblk, nseg, B);
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  const float* af = static_cast<const float*>(a);
  const float* dyf = static_cast<const float*>(dy);
  mamba_scan_bwd_summary_kernel<T, LANES, VEC>
      <<<grid, kThreads, Sh::kStageBytes, stream>>>(xt, dtt, bt, ct, af, dyf,
                                                    hl, gl, pp, S, D, N);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  mamba_scan_bwd_combine_kernel<<<grid_of(2 * B * dn), kThreads, 0,
                                  stream>>>(
      static_cast<const float*>(h0), static_cast<const float*>(dhf), hl, gl,
      pp, B, nseg, dn);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  // above 48 KB of shared memory a block only when asked for (once)
  static const cudaError_t attr = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<T, LANES, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sh::kMainBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  mamba_scan_bwd_kernel<T, LANES, VEC>
      <<<grid, kThreads, Sh::kMainBytes, stream>>>(
          xt, dtt, bt, ct, af, dyf, hl, gl, pp, static_cast<T*>(dx),
          static_cast<T*>(ddt), static_cast<float*>(pdb),
          static_cast<float*>(pdc), static_cast<float*>(dh0), S, D, N);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  mamba_scan_bwd_sum_kernel<T>
      <<<grid_of(static_cast<long long>(B) * S * N + dn), kThreads, 0,
         stream>>>(static_cast<const float*>(pdb),
                   static_cast<const float*>(pdc), pp, static_cast<T*>(db),
                   static_cast<T*>(dc), static_cast<float*>(da), B, S, D, N,
                   nblk, nseg);
  return static_cast<int>(cudaGetLastError());
}

// kper, the forward's plan, picks the lanes: 4 (N <= 16) or 16 (N <= 64)
template <typename T>
int dispatch_bwd(const void* x, const void* dt, const void* bm,
                 const void* cm, const void* a, const void* h0,
                 const void* dy, const void* dhf, void* seg, void* pdb,
                 void* pdc, void* dx, void* ddt, void* db, void* dc,
                 void* da, void* dh0, int B, int S, int D, int N, int kper,
                 cudaStream_t st) {
  const bool vec = N == kSt * kper &&
                   (static_cast<long long>(D) * sizeof(T)) % 16 == 0 &&
                   (static_cast<long long>(N) * sizeof(T)) % 16 == 0 &&
                   aligned16(x) && aligned16(dt) && aligned16(bm) &&
                   aligned16(cm) && aligned16(a) && aligned16(h0) &&
                   aligned16(dy) && aligned16(dhf) && aligned16(seg) &&
                   aligned16(dh0);
#define MAMBA_BWD_LAUNCH(L, V)                                             \
  launch_bwd<T, L, V>(x, dt, bm, cm, a, h0, dy, dhf, seg, pdb, pdc, dx, ddt, \
                      db, dc, da, dh0, B, S, D, N, st)
  if (kper == 4) return vec ? MAMBA_BWD_LAUNCH(4, true)
                            : MAMBA_BWD_LAUNCH(4, false);
  return vec ? MAMBA_BWD_LAUNCH(16, true) : MAMBA_BWD_LAUNCH(16, false);
#undef MAMBA_BWD_LAUNCH
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


// The backward of mamba_scan (four kernels, one call).  x, dt, B, C, a
// and h0 as the forward's (h0 may be null: zeros); dy (B, S, D) f32; dhf
// (B, D, N) f32 or null (zeros).  Scratch, f32, from the wrapper's plan:
// seg (3, B, segments, D, N) (each segment's local end state, then the
// state entering it; its gradient from a zero carry, then the gradient
// entering it; the product of its decays, then its dA partial), pdb/pdc
// (B, channel blocks, S, N).  Writes dx, ddt (B, S, D) and db, dc (B, S,
// N) in the input type, da (D, N) and dh0 (B, D, N) f32.  Returns a
// cudaError_t, as mamba_scan.
int mamba_scan_bwd(int dtype, const void* x, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* h0,
                   const void* dy, const void* dhf, void* seg, void* pdb,
                   void* pdc, void* dx, void* ddt, void* db, void* dc,
                   void* da, void* dh0, int B, int S, int D, int N, int kper,
                   void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || N < 1 || N > kMaxN ||
      (kper != 4 && kper != 16) || N > kLanes * kper)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(x, dt, bm, cm, a, h0, dy, dhf, seg,
                                       pdb, pdc, dx, ddt, db, dc, da, dh0, B,
                                       S, D, N, kper, st);
  if (dtype == 0)
    return dispatch_bwd<float>(x, dt, bm, cm, a, h0, dy, dhf, seg, pdb, pdc,
                               dx, ddt, db, dc, da, dh0, B, S, D, N, kper,
                               st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
