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
// tables are used as given (any tables, not only a DFT's), so frame_len >
// n_fft (wrapped angles) works.
//
// Bound on the H100: operations.  A frame costs 4 * L * nbins + 2 * nbins *
// n_mels flops; at the defaults (L 320, 257 bins, 40 mels) the batch of 512
// one-second clips (50,688 frames) is 17.7 GFLOP: 0.036 ms at the 495
// TFLOP/s of the TF32 tensor cores, against 0.012 ms for its bytes.
//
// Design: a GEMM whose two products run on the tensor cores in TF32.
//   M = frames, N = one group of bins (its cos and its sin columns side by
//   side), K = L.  The grid is (bin groups) x (frame tiles): the G <= 8
//   groups of one frame tile form a cluster.  The wrapper's plan
//   (kernels/mel_frontend.py::_plan) picks one of three block shapes (128,
//   64 or 16 frames; 8 warps each, two blocks an SM) and G from the shape
//   alone, so that a single clip (99 frames) still runs on 56 blocks.
//   1. K streams in stages of 16 samples through a cp.async ring, copied
//      DEPTH - 1 stages ahead.  Each thread then splits in place the
//      values it copied itself, so no block sync sits between a copy and
//      its split, and one block sync a stage serves both the split and
//      the ring's reuse: a = a_hi + a_lo with
//      a_hi and a_lo = a - a_hi rounded to TF32 (to nearest, ties away, as
//      cvt.rna), for the windowed frames (xw rounded once in f32, as the
//      plain version) and for the table tiles.  mma.sync reads only the
//      top 19 bits of a .tf32 register (it truncates), hence the explicit
//      rounding.  One TF32 product keeps 11 bits of each operand and puts
//      the log-mel about 1e-2 off, a hundred times the limit; the three
//      products a_hi b_hi + a_hi b_lo + a_lo b_hi drop only a_lo b_lo.
//      The tensor cores' f32 sums truncate, which over all of K left the
//      log-mel 1e-5 from the plain version, past what phase 6's
//      card-against-CPU logits allow: each stage's 6 products a column
//      start from zero and join the running sums with a rounded f32 add
//      (tests/test_torch_mel_plan.py emulates all three in numpy).
//   2. mma.sync.m16n8k8 TF32: A (frames) by ldmatrix (an 8 x 8 b16 matrix
//      is 8 rows of 4 f32; 16-byte chunks swizzled against bank
//      conflicts), B (tables) kept as pairs of rows (t, t + 4), hi and lo
//      apart, so that one 64-bit load is an operand (pair rows of 4 mod
//      16 pairs: conflict-free).  A warp owns 16
//      frames and up to NT bin tiles of 8, with the cos and sin
//      accumulators of a bin in the same thread, so power = re^2 + im^2 is
//      formed in registers.  The loop is instantiated for each tile count
//      a warp can own: no branch inside it.
//   3. The block's power tile goes to shared memory (bins x frames), its
//      group's rows of mel are applied on the CUDA cores in f32, and the
//      partial mel sums stay in shared memory.  After a cluster sync,
//      block rank q of the cluster sums its share of the tile's (frame,
//      mel) outputs over the G blocks in rank order (distributed shared
//      memory; a fixed order, no atomics) and writes log(max(sum, 1e-6)).
//   4. Any bin count.  A group holds ceil(nbins / 8) / G bin tiles, and a
//      block shape takes at most MAXT of them at once (8 groups of the
//      widest: 1,024 bins).  A group with more loops: it runs steps 1 to 3
//      in passes of at most MAXT tiles (its tiles split as evenly as whole
//      tiles allow), each pass's mel partials added to the block's running
//      partials in pass order, and the cluster merges once, after the last
//      pass.  Of the three ways to cover more bins this is the one that
//      keeps the kernel's one launch and its fixed summation order (bins
//      in order within a pass, passes in order, groups in rank order: two
//      runs are bitwise equal) and needs nothing else: a non-portable
//      cluster of 16 would reach only 2,048 bins, and a second pass over
//      the partials of several clusters would need a workspace and a second
//      kernel.  The running partials then lie past the ring (which the
//      next pass's copies overwrite), not aliased on it: a block of a
//      multi-pass launch takes TM * n_mels * 4 bytes more shared memory
//      (the plan's `multi`), so that at L 1,536 (48 kHz, n_fft 2048) a
//      128-frame block takes 126 KB and runs one block an SM.  The tables
//      (L, nbins) are read from global memory in place whatever their size
//      (25 MB each at n_fft 4096 and L 3,072).
//   No fast math: logf rounds as the plain version's log; silence gives
//   log(1e-6) exactly and NaN stays NaN.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): about 1.5
// times faster than the first design at full width and 2.4 times at the
// quickstart's shape, but still slower there than the rfft chain.  Most of a block's time is the K
// loop, whose split (each frame sample split once for every bin group,
// each table value once for every frame tile) and copies outweigh its
// MMAs; then the mel product and the cluster merge (which waits for the
// group with one more tile).  Past one pass the same holds a pass: 512
// one-second 48 kHz clips at 1,025 bins (one group, 17 passes) take 6.2
// ms, 5.8 times the rfft chain and 1.3 times the plain version's f32
// GEMM, at 2,049 bins (33 passes) 23.8 ms (NVIDIA H100 80GB HBM3, 700.00
// W; chip_smoke.py phase 2, PERF.md).  Left for later PRs:
// producer and consumer warps (the split overlapping the MMAs), larger
// warp tiles, a frame tile split once for all of a block's passes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 8;           // the portable cluster size
constexpr float kLogFloor = 1e-6f;      // ref.py's LOG_FLOOR
constexpr size_t kMaxSmem = 232448;     // 227 KB: the opt-in limit of sm_90

// One block shape: WARPS_M warps along the frames (16 each), the others
// along the bins, NT bin tiles of 8 a warp at most, a ring of DEPTH stages
// of 16 samples, MINB blocks an SM.
template <int WARPS_M_, int NT_, int DEPTH_, int MINB_>
struct Cfg {
  static constexpr int WARPS_M = WARPS_M_, NT = NT_;
  static constexpr int DEPTH = DEPTH_, MINB = MINB_;
  static constexpr int BK = 16;                  // samples a stage
  static constexpr int WARPS_N = kWarps / WARPS_M;
  static constexpr int TM = 16 * WARPS_M;        // frames a block
  static constexpr int MAXT = WARPS_N * NT;      // bin tiles a block
  static constexpr int HALF = 8 * MAXT;          // cos columns, then sin
  static constexpr int LDB = 2 * HALF + 4;       // pairs a pair row: 4
                                                 // mod 16, conflict-free
  static constexpr int A_FLOATS = TM * BK;       // rows of 4 16-byte chunks
  static constexpr int B_FLOATS = BK * LDB;      // BK / 2 pair rows
  static constexpr int SLOT = 2 * A_FLOATS + 2 * B_FLOATS;  // hi and lo
  static constexpr int RING = DEPTH * SLOT;
  static constexpr int LDP = TM + 4;             // power tile rows (bins)
  static constexpr int A_CHUNKS = TM * BK / 4;   // 4 samples of a frame
  static constexpr int A_PER = (A_CHUNKS + kThreads - 1) / kThreads;
  static constexpr int B_PER = BK * 2 * HALF / kThreads;   // table values
  static_assert(kThreads % (2 * HALF) == 0 && B_PER % 8 == 0 &&
                    (A_CHUNKS % kThreads == 0 || A_CHUNKS % 32 == 0),
                "block shape");
};

// The plan's three shapes (kernels/mel_frontend.py::CONFIGS), each small
// enough in shared memory and registers for two blocks an SM
using CfgBig = Cfg<8, 8, 3, 2>;     // 128 frames x 8 bin tiles
using CfgMid = Cfg<4, 8, 2, 2>;     // 64 frames x 16 bin tiles
using CfgSmall = Cfg<1, 1, 4, 2>;   // 16 frames x 8 bin tiles

// The window, zero-padded to whole stages
template <typename C>
__host__ __device__ int window_floats(int L) {
  return (L + C::BK - 1) / C::BK * C::BK;
}

// Float offset of the partial mel tile from the ring's start: after the
// epilogue's tiles that alias the ring (the group's mel rows, the power
// tile), and past the ring itself when the group runs in several passes
// (`multi`), whose copies would overwrite the running partials
template <typename C>
__host__ __device__ long long part_offset(int n_mels, bool multi) {
  const long long epi =
      static_cast<long long>(C::HALF) * n_mels + C::HALF * C::LDP;
  return multi && C::RING > epi ? C::RING : epi;
}

// Bytes of shared memory: the row offsets, the window, then the ring, the
// epilogue's tiles and the partial mel tile
template <typename C>
size_t smem_bytes(int L, int n_mels, bool multi) {
  const long long end =
      part_offset<C>(n_mels, multi) + static_cast<long long>(C::TM) * n_mels;
  const long long body = end > C::RING ? end : C::RING;
  return sizeof(long long) * C::TM +
         sizeof(float) * (static_cast<size_t>(window_floats<C>(L)) + body);
}

// more bin tiles in the fullest group than the block shape takes at once
template <typename C>
__host__ __device__ bool multi_pass(int nbins, int groups) {
  const int ntiles = (nbins + 7) / 8;
  return (ntiles + groups - 1) / groups > C::MAXT;
}

// Float offset of chunk c (4 samples) of row r of an A tile: the chunk
// sits at c ^ ((r / 2) % 4), so the 8 rows one ldmatrix phase reads at a
// chunk fall in 8 different bank groups
__device__ __forceinline__ int a_at(int r, int c) {
  return 16 * r + 4 * (c ^ ((r >> 1) & 3));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to TF32 (10 bits of mantissa), to nearest, ties away from
// zero: cvt.rna.tf32.f32's rounding, which ptxas expands into more
// compares and selects.  Inf stays inf; NaN is passed as it is (the
// card's NaN, 0x7fffffff, would carry into the sign bit and round to -0).
__device__ __forceinline__ float tf32_rna(float x) {
  const float r =
      __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  return isnan(x) ? x : r;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a * b: 16 frames x 8 columns x 8 samples, TF32 in, f32 sums; b
// holds the column's rows t and t + 4
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         float2 b) {
  const uint32_t b0 = __float_as_uint(b.x), b1 = __float_as_uint(b.y);
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Params {
  const float* frames;
  long long sb, sf;
  int nf, F, L;
  const float* window;
  const float* dcos;
  const float* dsin;
  const float* mel;
  float* out;
  int nbins, n_mels;
};

// cp.async of 4 or 16 bytes (src_bytes of them read, zeros after)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What a block works on in one pass: TM frames from m0, and the bin tiles
// [t_lo, t_lo + nbt) of the pass, bins [bin0, bin0 + nbg) of them live;
// the warp's own tiles [w_lo, w_lo + w_nt) of those.
struct Block {
  int m0, nbt, bin0, nbg, w_lo, w_nt;
};

// The K loop and the power tile, for a warp that owns NTW bin tiles.
// Every thread copies and splits its share of each stage, whatever its
// warp's NTW, so the switch on NTW in the kernel only picks how many MMAs
// the warp issues (no branch inside the loop).
//   Stage st is copied raw (cp.async) into slot st % DEPTH of the ring,
//   DEPTH - 1 stages ahead of the MMAs (a cold L2 needs the lead).  Each
//   thread then splits in place the values it copied itself
//   (cp.async.wait_group makes them visible to it): its chunks of 4 frame
//   samples (windowed first; hi over the raw values, lo beside) and its
//   table values, one column of the tile each (columns past the group's
//   bins and rows past L copy zeros: no branch).  The table tile is kept
//   as pairs of rows (t, t + 4) of each 8, hi and lo apart, so that one
//   64-bit load is an mma B operand.  One
//   block sync a stage: after it every split of the stage is visible and
//   every warp is done with the slot the next copy takes.
template <typename C, int NTW>
__device__ __forceinline__ void dft_power(const Params& p, const Block& bk,
                                          bool vec, const long long* rowoff,
                                          const float* win_s, float* ring,
                                          float* pw_s) {
  constexpr int COLS = 2 * C::HALF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % C::WARPS_M;
  const int L = p.L;

  // the thread's frame chunks: row i / 4, samples 4 (i % 4) of the stage;
  // a row past F reads nothing (a_len 0)
  const float* a_src[C::A_PER];
  int a_c[C::A_PER], a_len[C::A_PER], a_dst[C::A_PER];
#pragma unroll
  for (int u = 0; u < C::A_PER; ++u) {
    const int i = min(tid + u * kThreads, C::A_CHUNKS - 1);
    const long long off = tid + u * kThreads < C::A_CHUNKS ? rowoff[i / 4]
                                                           : -1;
    a_c[u] = 4 * (i % 4);
    a_src[u] = p.frames + (off < 0 ? 0 : off + a_c[u]);
    a_len[u] = off < 0 ? 0 : L - a_c[u];   // samples left from stage 0
    a_dst[u] = a_at(i / 4, i % 4);
  }
  // the thread's table column: rows kr = B_PER * col_k + u of each stage,
  // at half kr / 4 % 2 of pair row 4 (kr / 8) + kr % 4 (32-bit offsets:
  // L * nbins < 2^31)
  const int col = tid % COLS, col_k = tid / COLS;
  const int n = col % C::HALF, bin = bk.bin0 + n;
  const bool b_live = n < 8 * bk.nbt && bin < p.nbins;
  const float* b_src = (col < C::HALF ? p.dcos : p.dsin) + (b_live ? bin : 0);
  const int b_off0 = C::B_PER * col_k * p.nbins;
  const int b_dst = 2 * ((C::B_PER / 2) * col_k * C::LDB + col);
  auto b_at = [](int u) {   // float offset of row u of the thread's rows
    return 2 * ((4 * (u >> 3) + (u & 3)) * C::LDB) + ((u >> 2) & 1);
  };

  auto slot_a = [&](int st) { return ring + (st % C::DEPTH) * C::SLOT; };
  auto slot_b = [&](int st) { return slot_a(st) + 2 * C::A_FLOATS; };
  auto issue = [&](int st) {
    const int k0 = st * C::BK;
    float* ra = slot_a(st);
#pragma unroll
    for (int u = 0; u < C::A_PER; ++u) {
      if (C::A_CHUNKS % kThreads == 0 || tid + u * kThreads < C::A_CHUNKS) {
        const int nk = min(4, max(0, a_len[u] - k0));
        const float* src = nk > 0 ? a_src[u] + k0 : p.frames;
        if (vec) {
          cp_async16(ra + a_dst[u], src, 4 * nk);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cp_async4(ra + a_dst[u] + e, e < nk ? src + e : p.frames,
                      e < nk ? 4 : 0);
        }
      }
    }
    const float* bk0 = b_src + k0 * p.nbins + b_off0;
    float* rb = slot_b(st) + b_dst;
#pragma unroll
    for (int u = 0; u < C::B_PER; ++u) {
      const bool ok = b_live && k0 + C::B_PER * col_k + u < L;
      cp_async4(rb + b_at(u), ok ? bk0 + u * p.nbins : b_src, ok ? 4 : 0);
    }
  };
  auto split = [&](int st) {
    const int k0 = st * C::BK;
    float* a_hi = slot_a(st);
    float* a_lo = a_hi + C::A_FLOATS;
#pragma unroll
    for (int u = 0; u < C::A_PER; ++u) {
      if (C::A_CHUNKS % kThreads == 0 || tid + u * kThreads < C::A_CHUNKS) {
        const float4 x = *reinterpret_cast<const float4*>(a_hi + a_dst[u]);
        const float4 w =
            *reinterpret_cast<const float4*>(win_s + k0 + a_c[u]);
        // xw rounded once in f32, as the plain version's product
        const float xw[4] = {__fmul_rn(x.x, w.x), __fmul_rn(x.y, w.y),
                             __fmul_rn(x.z, w.z), __fmul_rn(x.w, w.w)};
        float hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[e] = tf32_rna(xw[e]);
          lo[e] = tf32_rna(xw[e] - hi[e]);
        }
        *reinterpret_cast<float4*>(a_hi + a_dst[u]) =
            make_float4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<float4*>(a_lo + a_dst[u]) =
            make_float4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    float* rb = slot_b(st) + b_dst;
#pragma unroll
    for (int u = 0; u < C::B_PER; ++u) {
      const float v = rb[b_at(u)];
      const float hi = tf32_rna(v);
      rb[b_at(u)] = hi;
      rb[b_at(u) + C::B_FLOATS] = tf32_rna(v - hi);
    }
  };

  float acc_c[NTW > 0 ? NTW : 1][4], acc_s[NTW > 0 ? NTW : 1][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_c[j][e] = acc_s[j][e] = 0.f;

  const int nstage = (L + C::BK - 1) / C::BK;
#pragma unroll
  for (int i = 0; i < C::DEPTH - 1; ++i) {
    if (i < nstage) issue(i);
    cp_async_commit();
  }
  // ldmatrix rows: matrix lane / 8 is (rows + 8 * bit 0, chunk + bit 1)
  const int arow = 16 * wm + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int achunk = lane >> 4;
  const int bfrag = t4 * C::LDB + 8 * bk.w_lo + g;   // pair index
  for (int st = 0; st < nstage; ++st) {
    cp_async_wait<C::DEPTH - 2>();   // this thread's copies of stage st
    split(st);
    __syncthreads();
    // the slot of stage st - 1, whose MMAs every warp has now finished
    if (st + C::DEPTH - 1 < nstage) issue(st + C::DEPTH - 1);
    cp_async_commit();
    const float* a_hi = slot_a(st);
    const float* a_lo = a_hi + C::A_FLOATS;
    const float2* bh = reinterpret_cast<const float2*>(slot_b(st)) + bfrag;
    const float2* bl = bh + C::B_FLOATS / 2;
    uint32_t ah[C::BK / 8][4], al[C::BK / 8][4];
#pragma unroll
    for (int ks = 0; ks < C::BK / 8; ++ks) {
      const int at = a_at(arow, 2 * ks + achunk);
      ldmatrix_x4(ah[ks], smem_u32(a_hi + at));
      ldmatrix_x4(al[ks], smem_u32(a_lo + at));
    }
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      // the stage's sums start from zero (the tensor cores truncate as
      // they accumulate) and join the running sums with a rounded add
      float tc[4] = {0.f, 0.f, 0.f, 0.f}, ts[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < C::BK / 8; ++ks) {
        // rows t4 and t4 + 4 of column g of tile j: cos and sin, hi and lo
        const int at = 4 * ks * C::LDB + 8 * j;   // pair row 4 ks + t4
        const float2 ch = bh[at], cl = bl[at];
        const float2 sh = bh[at + C::HALF], sl = bl[at + C::HALF];
        mma_tf32(tc, al[ks], ch);
        mma_tf32(ts, al[ks], sh);
        mma_tf32(tc, ah[ks], cl);
        mma_tf32(ts, ah[ks], sl);
        mma_tf32(tc, ah[ks], ch);
        mma_tf32(ts, ah[ks], sh);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_c[j][e] += tc[e];
        acc_s[j][e] += ts[e];
      }
    }
  }
  __syncthreads();   // every warp is done with the ring the power tile takes

  // the power tile, bins x frames
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int frame = 16 * wm + g + 8 * (e >> 1);
      const int bl = 8 * (bk.w_lo + j) + 2 * t4 + (e & 1);
      pw_s[bl * C::LDP + frame] =
          __fadd_rn(__fmul_rn(acc_c[j][e], acc_c[j][e]),
                    __fmul_rn(acc_s[j][e], acc_s[j][e]));
    }
  }
}

// One block: TM frames x the bin tiles [t_lo, t_hi) of its group (rank
// q of a cluster of G), in passes of at most MAXT tiles.  In a pass of
// nbt tiles warp w owns frames 16 (w % WARPS_M) .. + 15 and bin tiles
// [wn * nbt / WARPS_N, (wn + 1) * nbt / WARPS_N), wn = w / WARPS_M: at
// most NT.
template <typename C>
__global__ void __launch_bounds__(kThreads, C::MINB)
mel_frontend_kernel(const Params p, int vec) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wn = warp / C::WARPS_M;
  const int ntiles = (p.nbins + 7) >> 3;
  const int t_lo = q * ntiles / G, t_hi = (q + 1) * ntiles / G;
  const int gt = t_hi - t_lo;                            // the group's tiles
  const int npass = (gt + C::MAXT - 1) / C::MAXT;
  const int m0 = (blockIdx.x / G) * C::TM;

  long long* rowoff = reinterpret_cast<long long*>(smem4);   // [TM]
  float* win_s = reinterpret_cast<float*>(rowoff + C::TM);
  float* ring = win_s + window_floats<C>(p.L);
  // the epilogue's tiles alias the ring; the partials too in one pass
  float* mel_s = ring;                                  // [HALF][n_mels]
  float* pw_s = mel_s + C::HALF * p.n_mels;             // [HALF][LDP]
  float* part =                                         // [TM][n_mels]
      ring + part_offset<C>(p.n_mels, multi_pass<C>(p.nbins, G));

  for (int i = tid; i < C::TM; i += kThreads) {
    const int r = m0 + i;
    const int b = r / p.nf;
    rowoff[i] = r < p.F ? b * p.sb + static_cast<long long>(r - b * p.nf) *
                                         p.sf
                        : -1;
  }
  for (int i = tid; i < window_floats<C>(p.L); i += kThreads)
    win_s[i] = i < p.L ? p.window[i] : 0.f;
  __syncthreads();

  static_assert(C::NT <= 8, "bodies");
  const bool v = vec != 0;
  for (int pass = 0; pass < npass; ++pass) {
    Block bk;
    const int p_lo = t_lo + pass * gt / npass;
    const int p_hi = t_lo + (pass + 1) * gt / npass;
    bk.m0 = m0;
    bk.nbt = p_hi - p_lo;                                 // <= MAXT
    bk.bin0 = 8 * p_lo;
    bk.nbg = min(p.nbins, 8 * p_hi) - bk.bin0;            // live bins
    bk.w_lo = wn * bk.nbt / C::WARPS_N;
    bk.w_nt = (wn + 1) * bk.nbt / C::WARPS_N - bk.w_lo;   // <= NT
    // every warp is done with the last pass's mel rows and power tile,
    // which the ring's first copies overwrite
    if (pass > 0) __syncthreads();
    // NT + 1 bodies, one for each tile count a warp can own
    switch (bk.w_nt) {
#define MEL_BODY(n)                                                       \
  case n:                                                                 \
    dft_power<C, (n <= C::NT ? n : 0)>(p, bk, v, rowoff, win_s, ring,   \
                                       pw_s);                             \
    break;
      MEL_BODY(0) MEL_BODY(1) MEL_BODY(2) MEL_BODY(3) MEL_BODY(4)
      MEL_BODY(5) MEL_BODY(6) MEL_BODY(7) MEL_BODY(8)
#undef MEL_BODY
    }
    // the pass's rows of mel (the ring is free: the loop ended in a sync)
    for (int i = tid; i < bk.nbg * p.n_mels; i += kThreads)
      mel_s[i] = p.mel[static_cast<long long>(bk.bin0) * p.n_mels + i];
    __syncthreads();
    // item (fq, m): mel band m of frames 4 fq .. 4 fq + 3, the same
    // thread's in every pass; the pass's sums over its bins in order,
    // added to the running partials in pass order
    for (int item = tid; item < (C::TM / 4) * p.n_mels; item += kThreads) {
      const int fq = item / p.n_mels, m = item - fq * p.n_mels;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 8
      for (int k = 0; k < bk.nbg; ++k) {
        const float4 pv =
            *reinterpret_cast<const float4*>(pw_s + k * C::LDP + 4 * fq);
        const float w = mel_s[k * p.n_mels + m];
        s0 = fmaf(pv.x, w, s0);
        s1 = fmaf(pv.y, w, s1);
        s2 = fmaf(pv.z, w, s2);
        s3 = fmaf(pv.w, w, s3);
      }
      float* pr = part + 4 * fq * p.n_mels + m;
      if (pass > 0) {
        s0 += pr[0];
        s1 += pr[p.n_mels];
        s2 += pr[2 * p.n_mels];
        s3 += pr[3 * p.n_mels];
      }
      pr[0] = s0;
      pr[p.n_mels] = s1;
      pr[2 * p.n_mels] = s2;
      pr[3 * p.n_mels] = s3;
    }
  }

  // ---- the cluster's partial sums, in rank order, then the log ----
  cluster.sync();
  const int total = C::TM * p.n_mels;
  const int per = (total + G - 1) / G;
  const int hi = min(total, (q + 1) * per);
  const int rows = min(C::TM, p.F - m0);
  for (int i = q * per + tid; i < hi; i += kThreads) {
    if (i / p.n_mels >= rows) break;
    float v[kMaxGroups];
#pragma unroll
    for (int r = 0; r < kMaxGroups; ++r)
      v[r] = r < G ? cluster.map_shared_rank(part, r)[i] : 0.f;
    float sum = v[0];
#pragma unroll
    for (int r = 1; r < kMaxGroups; ++r)
      if (r < G) sum += v[r];
    // max(NaN, floor) stays NaN, as the plain version's clamp
    if (sum < kLogFloor) sum = kLogFloor;
    p.out[static_cast<long long>(m0) * p.n_mels + i] = logf(sum);
  }
  cluster.sync();   // no block leaves while another reads its partials
}

template <typename C>
int launch(const Params& p, int groups, bool vec, cudaStream_t stream) {
  const int ntiles = (p.nbins + 7) / 8;
  if (groups < 1 || groups > kMaxGroups || groups > ntiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long mtiles = (static_cast<long long>(p.F) + C::TM - 1) / C::TM;
  if (mtiles * groups > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      smem_bytes<C>(p.L, p.n_mels, multi_pass<C>(p.nbins, groups));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static int raised = 0;   // bytes the attribute allows (one card)
  if (smem > 48 * 1024 && static_cast<int>(smem) > raised) {
    cudaError_t e = cudaFuncSetAttribute(
        mel_frontend_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = static_cast<int>(smem);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(mtiles * groups));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = groups;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, mel_frontend_kernel<C>, p, vec ? 1 : 0);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

// frames: (nb, nf, L) f32 view with strides (sb, sf, 1) in elements.
// (config, groups): the wrapper's plan, config 0 (128 frames a block), 1
// (64) or 2 (16); the bins split into `groups` (<= 8, at most the bin
// tiles) groups of whole tiles of 8, each run in passes of at most the
// config's tiles.  Returns a cudaError_t:
// invalid sizes or plan, shared memory past 227 KB
// (cudaErrorInvalidValue), or the launch's own error.
int mel_frontend(const void* frames, long long sb, long long sf, int nb,
                 int nf, int L, const void* window, const void* dcos,
                 const void* dsin, const void* mel, void* out, int nbins,
                 int n_mels, int config, int groups, void* stream) {
  const long long F = static_cast<long long>(nb) * nf;
  if (nb <= 0 || nf <= 0 || L <= 0 || nbins <= 0 || n_mels <= 0 ||
      F > INT_MAX || static_cast<long long>(L) * nbins > INT_MAX ||
      static_cast<long long>(nbins) * n_mels > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(frames), sb, sf, nf,
                 static_cast<int>(F), L, static_cast<const float*>(window),
                 static_cast<const float*>(dcos),
                 static_cast<const float*>(dsin),
                 static_cast<const float*>(mel), static_cast<float*>(out),
                 nbins, n_mels};
  // 16-byte copies of the frames when every row starts 16-byte aligned
  const bool vec = reinterpret_cast<uintptr_t>(frames) % 16 == 0 &&
                   sb % 4 == 0 && sf % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (config == 0) return launch<CfgBig>(p, groups, vec, st);
  if (config == 1) return launch<CfgMid>(p, groups, vec, st);
  if (config == 2) return launch<CfgSmall>(p, groups, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
