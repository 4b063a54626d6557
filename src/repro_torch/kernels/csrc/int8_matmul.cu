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
// equal to the plain version's: int32 sums are exact in any order.
//
// Bound on the H100: bytes, in both regimes the serving path runs.  A call
// reads the weight once, N * K bytes, at 3.35 TB/s; its 2 * M * N * K
// operations at 1,979 TOP/s int8 weigh 2 * M operations a weight byte
// against the card's 591, so the weight's bytes bound every M below about
// 295.  At decode (M = 4 slots) the 16.8 MB up/gate/down projections take
// 5.0 us at the bound, the 2 MB K/V projections 0.63 us; in a 64-token
// chunk the operations are a fifth of the byte time.
//
// Design: the wrapper's _plan(m, n, k) picks a regime from the shape
// alone (nothing else selects), with its tile and its split of K:
//   decode, M <= 16 (int8_mm_kernel): tiles of 8 or 16 tokens x 32
//     channels, two warps, mma.sync.m16n8k32 s8 with the operands
//     swapped: W's channels are the 16-row A operand and the tokens the
//     n = 8 side, so 4 decode tokens fill half an n8 tile instead of a
//     quarter of a 16-row one.  Both operands are K-contiguous, as A
//     row-major and B column-major want them: ldmatrix reads both,
//     nothing is transposed.  The accumulator is (channel, token).
//   chunk, M > 16 (int8_mm_kernel_wgmma): tiles of 64 tokens x 32
//     channels, one warpgroup, wgmma.m64n32k32.s32.s8.s8 with both
//     operands K-major in shared memory (the only layout wgmma takes for
//     8-bit types, and the one both tensors have): X is the 64-row A, W
//     the N side; four asynchronous products a stage, one stage's
//     products in flight while the next stage is waited for.
// Both:
//   1. Split K across a thread-block cluster: grid (split, N / 32,
//      M / MT) with the split blocks of one tile in one cluster of <= 8
//      (the portable size), each over its own range of K, in whole
//      128-byte K tiles; the plan never makes an empty range.  Every
//      serving shape gets 192 or 256 blocks (the old kernel: 32 to 256),
//      in one wave: the card holds 7 decode or 3 chunk blocks an SM.
//   2. Streaming: a ring of 6 stages of cp.async (16-byte loads, eight
//      neighbouring threads on one 128-byte row segment): 5 K tiles in
//      flight at decode, 20 KB of weight a block; 4 in a chunk, 16 KB of
//      weight and 32 KB of X.  The weight's loads carry an L2 evict-first
//      policy: read once a call, its lines are the first the L2 gives up,
//      before the (dirty) lines of the other kernels' data.  Tiles are
//      128-byte rows with the 16-byte chunk c of row r at c ^ (r % 8):
//      ldmatrix reads them conflict-free, and it is wgmma's 128-byte
//      swizzle (1024-byte atoms of 8 rows).
//   3. The split's int32 partial sums meet in distributed shared memory:
//      each block writes its (token, channel) partials into its own ring,
//      the cluster syncs, then each block sums the split's partials of
//      every split-th token row through map_shared_rank (four channels a
//      load, all ranks' loads of a batch of rows issued before its
//      stores), applies the epilogue and writes its rows; a second
//      cluster sync keeps every block's shared memory alive until all
//      have read it.  One launch, no workspace, no memset.  Without a
//      split (the plan's choice for the 8192-wide projections) a block
//      writes its outputs straight from the accumulator fragments, which
//      saves the shared-memory round trip and both cluster syncs.  The
//      scales are read at the start, under the stream.
// Ragged M, N and K: predicated loads leave zeros in the tile (zero int8
// entries add nothing); nothing is padded or copied in device memory.
// When K, ldx and ldw are multiples of 16 and x, w 16-byte aligned the
// loads are cp.async (vec), else byte loads stored by the threads.
//
// Dynamic shared memory, 6 x (32 + MT) x 128 bytes + 1,024 of alignment
// slack: decode 31,744 (MT 8) or 37,888 (MT 16); chunk 74,752, above
// 48 KB through cudaFuncSetAttribute.  Registers (ptxas, chip_smoke.py
// phase 1), vec / byte loads: decode MT 8 54 / 56, MT 16 62 / 64, chunk
// 71 / 78; no spills; static shared memory 32, 64, 256 bytes (x_scale).
//
// On the card (chip_smoke.py phase 2, PERF.md): every serving shape
// beats the old kernel.  The 16.8 MB shapes stay near 0.014 ms: the
// 0.005 ms that time_ms reads for a kernel writing one float, and a read
// whose every new L2 line first evicts one of the dirty lines time_ms's
// flush leaves there (after a flush that leaves them clean, about 0.001
// ms less).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 128;          // bytes of K a stage holds of each row
constexpr int kMaxSplit = 8;     // the portable cluster size
constexpr uint32_t kAtom = 1024;   // 8 swizzled rows of 128 bytes
constexpr int kBN = 32;          // channels a block tile holds
constexpr int kStages = 6;       // depth of the cp.async ring
constexpr int kDecodeThreads = 64;    // two warps
constexpr int kChunkThreads = 128;    // one warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk c of row r in a tile of 128-byte rows:
// the chunk sits at c ^ (r % 8), so the eight rows ldmatrix reads at one
// chunk fall in eight different bank groups (wgmma's 128-byte swizzle).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * BK + ((c ^ (r & 7)) << 4);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (no read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// The same, with an L2 eviction policy for the line it brings in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::
          "r"(dst),
      "l"(src), "r"(valid ? 16 : 0), "l"(policy)
      : "memory");
}
// The weight is read once a call: its lines are the first the L2 gives up
// when it needs room, before the (dirty) lines of the other kernels' data
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's cp.async writes, visible to the async proxy wgmma reads by
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bytes [kb, kb + 16) of a row by byte loads (any alignment); zeros past K.
__device__ __forceinline__ uint4 bytes16(const int8_t* row, int kb, int K) {
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (kb + i < K)
      wd[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(row[kb + i]))
                    << (8 * (i & 3));
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// Rows [r0, r0 + ROWS) of a row-major int8 matrix (rows >= R zeros), K
// bytes [k0, k0 + BK) (bytes >= K zeros), into the swizzled tile at dst.
// Chunk i = tid + u * THREADS is row i / 8, chunk i % 8: eight
// neighbouring threads read one 128-byte row segment.  STREAM: the rows
// are read once (the weight), evict-first in the L2.
template <int ROWS, int THREADS, bool VEC, bool STREAM>
__device__ __forceinline__ void load_tile(uint32_t dst, const int8_t* base,
                                          long long ld, int r0, int R,
                                          int k0, int K, int tid,
                                          uint64_t policy) {
  constexpr int CHUNKS = ROWS * (BK / 16);
  static_assert(CHUNKS % THREADS == 0, "tile / threads");
#pragma unroll
  for (int u = 0; u < CHUNKS / THREADS; ++u) {
    const int i = tid + u * THREADS;
    const int r = i >> 3, c = i & 7;
    const int kb = k0 + c * 16;
    const bool ok = r0 + r < R && kb < K;
    const int8_t* row = base + (long long)(ok ? r0 + r : 0) * ld;
    if (VEC && STREAM) {
      cp_async16(dst + swz(r, c), row + (ok ? kb : 0), ok, policy);
    } else if (VEC) {
      cp_async16(dst + swz(r, c), row + (ok ? kb : 0), ok);
    } else {
      const uint4 v = ok ? bytes16(row, kb, K) : make_uint4(0u, 0u, 0u, 0u);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       dst + swz(r, c)),
                   "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
}

// The block's view of the problem: its tile and its range of K
struct Tile {
  int n0, m0, kbeg, nkt;
};

__device__ __forceinline__ Tile block_tile(int MT, int K, int kchunk) {
  Tile t;
  t.n0 = blockIdx.y * kBN;
  t.m0 = blockIdx.z * MT;
  t.kbeg = blockIdx.x * kchunk;
  t.nkt = (min(K, t.kbeg + kchunk) - t.kbeg + BK - 1) / BK;   // >= 1
  return t;
}

// Stage kt of the block's K range into ring slot `slot`: the W tile (32
// rows), then the X tile (MT rows).  K tiles never cross kbeg + kchunk (a
// multiple of BK), so K alone bounds them.
template <int MT, int THREADS, bool VEC>
__device__ __forceinline__ void load_stage(uint32_t ring, int slot, int kt,
                                           const Tile& t, const int8_t* x,
                                           const int8_t* w, int M, int N,
                                           int K, long long ldx,
                                           long long ldw, int tid,
                                           uint64_t policy) {
  const uint32_t st = ring + slot * (kBN + MT) * BK;
  const int k0 = t.kbeg + kt * BK;
  load_tile<kBN, THREADS, VEC, true>(st, w, ldw, t.n0, N, k0, K, tid, policy);
  load_tile<MT, THREADS, VEC, false>(st + kBN * BK, x, ldx, t.m0, M, k0, K,
                                     tid, policy);
}

// The epilogue's scales, read at the start so that their latency hides
// under the stream: the four w_scale of this thread's channels (fixed:
// THREADS is a multiple of 32 / 4) and x_scale of the tile's token `tid`.
template <int MT>
struct Scales {
  float ws[4];
  float xs;
  __device__ __forceinline__ void load(const float* xsp, const float* wsp,
                                       int M, int N, const Tile& t,
                                       int tid) {
    const int c = t.n0 + 4 * (tid % (kBN / 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) ws[e] = c + e < N ? wsp[c + e] : 0.f;
    xs = tid < MT && t.m0 + tid < M ? xsp[t.m0 + tid] : 0.f;
  }
};

// A scale, or 0 past the end (the output element is not written)
__device__ __forceinline__ float scale_at(const float* p, int i, int n) {
  return i < n ? p[i] : 0.f;
}
// out[m, n] = float(acc) * (xs[m] * ws[n]), inside the output only
__device__ __forceinline__ void store_out(float* out, int M, int N, int m,
                                          int n, int acc, float xm,
                                          float wn) {
  if (m < M && n < N)
    out[(long long)m * N + n] =
        __fmul_rn(__int2float_rn(acc), __fmul_rn(xm, wn));
}

// Sum the cluster's partials (int32 [MT][LDP] in each block's shared
// memory) over the split, for the token rows rank, rank + split, ... of
// the tile, four channels a thread, and write out[m, n] =
// float(acc) * (xs[m] * ws[n]).  Rows go in batches of RB: every remote
// load of a batch is issued before its stores, which the compiler cannot
// move the next batch's loads above.
template <int MT, int LDP, int THREADS>
__device__ __forceinline__ void reduce_store(int* part, float* xs_s,
                                             const Scales<MT>& sc,
                                             float* out, int M, int N,
                                             const Tile& t, int tid) {
  constexpr int G = kBN / 4;                 // 4-channel groups a row
  constexpr int RSTEP = THREADS / G;         // rows the block takes at once
  constexpr int RB = MT / RSTEP < 4 ? (MT + RSTEP - 1) / RSTEP : 4;
  static_assert(THREADS % G == 0 && LDP % 4 == 0, "epilogue shape");
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (tid < MT) xs_s[tid] = sc.xs;
  cluster.sync();   // every block's partials are written and visible
  const int rows = min(MT, M - t.m0);
  const int mine = rank < rows ? (rows - rank + split - 1) / split : 0;
  const int cgi = tid % G, n = t.n0 + 4 * cgi;
  for (int r0 = tid / G; r0 < mine; r0 += RB * RSTEP) {
    int s[RB][4];
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      s[b][0] = s[b][1] = s[b][2] = s[b][3] = 0;
      const int tok = rank + (r0 + b * RSTEP) * split;
      if (r0 + b * RSTEP < mine) {
#pragma unroll
        for (int p = 0; p < kMaxSplit; ++p)
          if (p < split) {
            const int4 v = *reinterpret_cast<const int4*>(
                cluster.map_shared_rank(part, p) + tok * LDP + 4 * cgi);
            s[b][0] += v.x;
            s[b][1] += v.y;
            s[b][2] += v.z;
            s[b][3] += v.w;
          }
      }
    }
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      if (r0 + b * RSTEP >= mine) break;
      const int tok = rank + (r0 + b * RSTEP) * split;
      const float xm = xs_s[tok];
      float* o = out + (long long)(t.m0 + tok) * N + n;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N)
          o[e] = __fmul_rn(__int2float_rn(s[b][e]), __fmul_rn(xm, sc.ws[e]));
    }
  }
  cluster.sync();   // no block leaves while another reads its partials
}

// ---------------------------------------------------------------------------
// decode: mma.sync, W's channels as the 16-row A operand
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// d += a * b: 16 channels x 8 tokens x 32 bytes of K, exact s32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One block: MT tokens x 32 channels over its range of K.  Warp w owns
// channels 16 w .. 16 w + 15 and all NT tiles of 8 tokens.
template <int MT, bool VEC>
__global__ void __launch_bounds__(kDecodeThreads)
int8_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ xs, const float* __restrict__ ws,
               float* __restrict__ out, int M, int N, int K, long long ldx,
               long long ldw, int kchunk) {
  constexpr int BN = kBN, THREADS = kDecodeThreads, STAGES = kStages;
  constexpr int NT = MT / 8;
  constexpr int STAGE = (BN + MT) * BK;
  constexpr int LDP = BN + 4;                 // partials' row stride, words
  static_assert(NT == 1 || NT == 2, "decode tile");
  static_assert(MT * LDP * 4 <= STAGES * STAGE, "partials fit the ring");

  extern __shared__ uint8_t smem[];
  __shared__ float xs_s[MT];
  const uint32_t ring = (smem_u32(smem) + kAtom - 1) & ~(kAtom - 1);
  int* part = reinterpret_cast<int*>(smem + (ring - smem_u32(smem)));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile t = block_tile(MT, K, kchunk);
  // No split: the block's sums are whole and go out from the fragments,
  // whose scales are read now (lane: channels g and g + 8, tokens 2t and
  // 2t + 1 of each n8 tile); else the cluster's epilogue's scales.
  const bool direct = gridDim.x == 1;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int ch = t.n0 + warp * 16 + g;
  float dws[2], dxs[NT][2];
  Scales<MT> sc;
  if (direct) {
    dws[0] = scale_at(ws, ch, N);
    dws[1] = scale_at(ws, ch + 8, N);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dxs[j][e] = scale_at(xs, t.m0 + 8 * j + t2 + e, M);
  } else {
    sc.load(xs, ws, M, N, t, tid);
  }
  const uint64_t policy = evict_first_policy();

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  // ldmatrix lane roles: matrix q = lane / 8, its row lane % 8.  A (W):
  // (rows 0-7, bytes 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31) of
  // the k32 step are a0..a3.  B (X): (tokens 0-7, bytes 0-15), (0-7,
  // 16-31) are b0, b1 of tile 0, and of tile 1 the next two (x4).
  const int q = lane >> 3, r8 = lane & 7;
  const int a_row = warp * 16 + r8 + 8 * (q & 1), a_hi = q >> 1;
  const int b_row = r8 + 8 * (q >> 1), b_hi = q & 1;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < t.nkt)
      load_stage<MT, THREADS, VEC>(ring, s, s, t, x, w, M, N, K, ldx, ldw,
                                   tid, policy);
    cp_async_commit();
  }
  for (int kt = 0; kt < t.nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile kt has landed; slot (kt - 1) % STAGES is free
    const int nk = kt + STAGES - 1;
    if (nk < t.nkt)
      load_stage<MT, THREADS, VEC>(ring, nk % STAGES, nk, t, x, w, M, N, K,
                                   ldx, ldw, tid, policy);
    cp_async_commit();
    const uint32_t wt = ring + (kt % STAGES) * STAGE, xt = wt + BN * BK;
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
      uint32_t b[NT][2];
      if constexpr (NT == 1) {
        ldmatrix_x2(b[0], xt + swz(r8, 2 * s + b_hi));
      } else {
        uint32_t t4[4];
        ldmatrix_x4(t4, xt + swz(b_row, 2 * s + b_hi));
        b[0][0] = t4[0];
        b[0][1] = t4[1];
        b[1][0] = t4[2];
        b[1][1] = t4[3];
      }
      uint32_t a[4];
      ldmatrix_x4(a, wt + swz(a_row, 2 * s + a_hi));
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[j], a, b[j]);
    }
  }
  cp_async_wait<0>();
  // c0/c1 are channel g, tokens 2t and 2t + 1; c2/c3 the same for g + 8
  if (direct) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int tok = t.m0 + 8 * j + t2;
      store_out(out, M, N, tok, ch, acc[j][0], dxs[j][0], dws[0]);
      store_out(out, M, N, tok + 1, ch, acc[j][1], dxs[j][1], dws[0]);
      store_out(out, M, N, tok, ch + 8, acc[j][2], dxs[j][0], dws[1]);
      store_out(out, M, N, tok + 1, ch + 8, acc[j][3], dxs[j][1], dws[1]);
    }
    return;
  }
  __syncthreads();   // every warp is done with the ring
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = ch - t.n0, tok = 8 * j + t2;
    part[tok * LDP + c] = acc[j][0];
    part[(tok + 1) * LDP + c] = acc[j][1];
    part[tok * LDP + c + 8] = acc[j][2];
    part[(tok + 1) * LDP + c + 8] = acc[j][3];
  }
  reduce_store<MT, LDP, THREADS>(part, xs_s, sc, out, M, N, t, tid);
}

// ---------------------------------------------------------------------------
// chunk: wgmma, X's 64 tokens as the A operand
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle, K-major: the start
// address of a tile of 128-byte rows at k-step s (32 bytes of K), leading
// offset 16 (unused when swizzled), stride offset 1024 (8-row atoms)
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int s) {
  const uint32_t addr = tile + 32 * s;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(kAtom >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// D[64 x 32] += A[64 x 32] . B[32 x 32]^T, s8 x s8 -> s32, both K-major
__device__ __forceinline__ void wgmma_s8(int (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// One block: 64 tokens x 32 channels over its range of K, one warpgroup.
// Thread (warp w, lane l) holds acc[i] at token 16 w + l / 4 + 8 ((i / 2)
// % 2), channel 8 (i / 4) + 2 (l % 4) + i % 2.
template <bool VEC>
__global__ void __launch_bounds__(kChunkThreads)
int8_mm_kernel_wgmma(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ xs,
                     const float* __restrict__ ws, float* __restrict__ out,
                     int M, int N, int K, long long ldx, long long ldw,
                     int kchunk) {
  constexpr int MT = 64, BN = kBN, THREADS = kChunkThreads;
  constexpr int STAGES = kStages;
  constexpr int STAGE = (BN + MT) * BK;
  constexpr int LDP = BN + 8;                 // partials' row stride, words
  static_assert(MT * LDP * 4 <= STAGES * STAGE, "partials fit the ring");

  extern __shared__ uint8_t smem[];
  __shared__ float xs_s[MT];
  const uint32_t ring = (smem_u32(smem) + kAtom - 1) & ~(kAtom - 1);
  int* part = reinterpret_cast<int*>(smem + (ring - smem_u32(smem)));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile t = block_tile(MT, K, kchunk);
  // No split: the sums go out from the fragments (lane: tokens g and
  // g + 8 of the warp's 16, channels 8 j + 2t and + 1), as in the decode
  // kernel
  const bool direct = gridDim.x == 1;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int tok = t.m0 + 16 * warp + g;
  float dws[BN / 8][2], dxs[2];
  Scales<MT> sc;
  if (direct) {
    dxs[0] = scale_at(xs, tok, M);
    dxs[1] = scale_at(xs, tok + 8, M);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dws[j][e] = scale_at(ws, t.n0 + 8 * j + t2 + e, N);
  } else {
    sc.load(xs, ws, M, N, t, tid);
  }
  const uint64_t policy = evict_first_policy();

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  // One stage's products stay in flight while the next stage is waited
  // for: the load issued at stage kt refills the slot of stage kt - 2,
  // whose products every warp has waited for (wait_group 1 at kt - 1)
  // before this stage's barrier.  STAGES - 2 tiles are in flight.
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < t.nkt)
      load_stage<MT, THREADS, VEC>(ring, s, s, t, x, w, M, N, K, ldx, ldw,
                                   tid, policy);
    cp_async_commit();
  }
  fence_regs(acc);
  for (int kt = 0; kt < t.nkt; ++kt) {
    cp_async_wait<STAGES - 3>();
    fence_async_smem();
    __syncthreads();   // tile kt has landed; slot (kt - 2) % STAGES is free
    const int nk = kt + STAGES - 2;
    if (nk < t.nkt)
      load_stage<MT, THREADS, VEC>(ring, nk % STAGES, nk, t, x, w, M, N, K,
                                   ldx, ldw, tid, policy);
    cp_async_commit();
    const uint32_t wt = ring + (kt % STAGES) * STAGE, xt = wt + BN * BK;
    wg_fence();
#pragma unroll
    for (int s = 0; s < BK / 32; ++s)
      wgmma_s8(acc, desc_kmajor(xt, s), desc_kmajor(wt, s));
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();
  if (direct) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int h = (i >> 1) & 1;
      store_out(out, M, N, tok + 8 * h, t.n0 + 8 * (i >> 2) + t2 + (i & 1),
                acc[i], dxs[h], dws[i >> 2][i & 1]);
    }
    return;
  }
  __syncthreads();   // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int r = tok - t.m0 + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + t2;
    *reinterpret_cast<int2*>(part + r * LDP + c) =
        make_int2(acc[i], acc[i + 1]);
  }
  reduce_store<MT, LDP, THREADS>(part, xs_s, sc, out, M, N, t, tid);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <typename Kern>
int launch(Kern kernel, int threads, int mt, const void* x, const void* w,
           const void* xs, const void* ws, void* out, int M, int N, int K,
           long long ldx, long long ldw, int split, int kchunk, bool* raised,
           cudaStream_t stream) {
  const int smem = kStages * (kBN + mt) * BK + static_cast<int>(kAtom);
  if (smem > 48 * 1024 && !*raised) {   // once a process (one card)
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    *raised = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + kBN - 1) / kBN, (M + mt - 1) / mt);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int8_t*>(x),
      static_cast<const int8_t*>(w), static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<float*>(out), M, N, K, ldx,
      ldw, kchunk);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

// vec: 1 when K, ldx, ldw are multiples of 16 and x, w 16-byte aligned.
// (mt, split, kchunk): the wrapper's plan.  mt 8 or 16 tokens a tile
// (decode, mma.sync) or 64 (chunk, wgmma); 1 <= split <= 8; kchunk a
// positive multiple of 128 with (split - 1) * kchunk < K <= split *
// kchunk, so that no block of the split has an empty range of K.
int int8_matmul(const void* x, const void* w, const void* xs, const void* ws,
                void* out, int M, int N, int K, long long ldx, long long ldw,
                int vec, int mt, int split, int kchunk, void* stream) {
  static bool raised[6] = {false, false, false, false, false, false};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || split < 1 || split > kMaxSplit ||
      kchunk <= 0 || kchunk % BK != 0 ||
      static_cast<long long>(split - 1) * kchunk >= K ||
      static_cast<long long>(split) * kchunk < K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int v = vec != 0;
  if (mt == 8)
    return launch(v ? int8_mm_kernel<8, true> : int8_mm_kernel<8, false>,
                  kDecodeThreads, 8, x, w, xs, ws, out, M, N, K, ldx, ldw,
                  split, kchunk, &raised[v], st);
  if (mt == 16)
    return launch(v ? int8_mm_kernel<16, true> : int8_mm_kernel<16, false>,
                  kDecodeThreads, 16, x, w, xs, ws, out, M, N, K, ldx, ldw,
                  split, kchunk, &raised[2 + v], st);
  if (mt == 64)
    return launch(v ? int8_mm_kernel_wgmma<true> : int8_mm_kernel_wgmma<false>,
                  kChunkThreads, 64, x, w, xs, ws, out, M, N, K, ldx, ldw,
                  split, kchunk, &raised[4 + v], st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
