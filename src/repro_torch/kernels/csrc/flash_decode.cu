// Flash-decode and chunk-prefill attention over the slot-addressed or paged
// KV cache, float or int8, hand-written for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes; see kernels/build.py and
// kernels/flash_decode.py).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   flash_decode        <- src/repro/kernels/flash_decode.py:147 (_kernel :76)
//   flash_chunk_prefill <- src/repro/kernels/flash_decode.py:334 (_chunk_kernel :274)
// It computes what they compute, not block for block.  Decode is the chunk
// with R = G query rows sharing one q_pos per slot, so both C entry points
// launch the same two kernels, in all four layouts: float or int8 K/V, each
// contiguous or paged.
//
// Contract (identical to kernels/ref.py::chunk_attention_ref and its paged
// twin): query row r of slot b attends cache entry i (KV head h) when
//     pos(b, i) >= 0, pos(b, i) <= q_pos[b, r], i < kv_len[b],
//     and, with a window, pos(b, i) > q_pos[b, r] - window.
// Scores, online softmax and the accumulator are f32; the output is in q's
// type.  A masked score is -inf, m starts at -1e30 and l is floored at
// 1e-30, so an empty slot (kv_len == 0, the normal state of an idle slot in
// the decode batch) and a pad query row (q_pos == -1) give exact zeros,
// never NaN.
//
// Layouts.  Entry i of slot b lives at (block, offset) of an outer axis:
//   contiguous  (b, i):                         k/v (B, S, Hkv, D)
//   paged       (table[b, i / BS], i % BS):     k/v pool (NB, BS, Hkv, D)
// and its position at pos[block * pos_sb + offset], so one address
// resolution serves both.  Every 16-byte chunk of a row resolves its own
// block, so a tile may span pages of any size >= 8.  Table entries past
// kv_len are never read, nor are the rows: a row at index >= kv_len is
// zero-filled by cp.async (source size 0) and masked by its index.
// Int8 K/V (Int8KV) come with one f32 scale per (entry, head): the int8
// rows and their scales go into shared memory raw, and each value is
// dequantized as value * scale in f32, rounded once to q's type, the plain
// version's dequant exactly; no float copy of the cache exists.
//
// Design.  The wrapper's _plan(b, hkv, r, s, dtype, int8, d) fixes the
// launch from the host-known shape (kv_len lives on the card):
//   1. Split the KV sweep over a thread-block cluster (flash-decoding).
//      The grid is (slot, kv-head, row tile x split) with a cluster of
//      (1, 1, split), split 1, 2, 4 or 8 (the portable cluster size),
//      chosen so the grid holds at least one block an SM (decode at 4 slots
//      x 8 KV heads: 256 blocks, not 32).  Block `rank` of a cluster reads
//      kv_len[b] and sweeps the whole KV tiles [rank * n / split,
//      (rank + 1) * n / split) of the n = ceil(kv_len / BK) live ones;
//      a range may be empty, and such a block still takes part in the
//      merge with m = -1e30, l = 0, acc = 0.
//   2. Loads go through a cp.async ring (16-byte chunks for K/V, 4 bytes
//      for positions and the Hkv-strided scales), one __syncthreads a
//      tile.  No TMA: it does not fit the per-row page gather.
//   3. Two kernels, both named *_attn_kernel (chip_smoke.py's profiles
//      file attention by that name):
//      simt_attn_kernel, CUDA cores, f32: decode, every f32 call, and bf16
//        calls of <= 16 rows.  16-entry tiles through a 4-stage ring; 2
//        or 4 rows a block (decode at G <= 2, and at G 3 or 4) with eight
//        warps, else 16 rows (8 at D 256) with four.
//        Warp w takes the keys [w * 16/NW, ...) of each tile, lane l the
//        D/32 columns [l * D/32, ...): a score is a warp sum (all of a
//        warp's scores summed one butterfly step at a time, so the
//        shuffles overlap), and (m, l, acc) of the block's rows live in
//        each warp's registers; the warps meet once in shared memory after
//        the sweep.  Nothing inside the sweep branches on the row count:
//        rows past R carry q = 0 and q_pos = -1, so they are masked.
//      mma_attn_kernel, tensor cores, bf16 chunks of more than 16 rows:
//        16, 32 or 64 query rows a block, one warp for every 16 (two at
//        D 256, each holding the outputs of half of D: both compute the
//        group's S, and the registers stay those of D 128), 64-entry
//        tiles through a 2-stage ring (a deeper one takes so much shared
//        memory that the clusters of the serving chunk need two waves),
//        mma.sync.m16n8k16 bf16 with f32 accumulators as in
//        FlashAttention-2: S = Q K^T with Q and K through ldmatrix (tiles
//        swizzled, chunk c of row r at c ^ (r % 8): conflict-free), the
//        scale (softmax scale x log2 e) and the mask applied to the f32
//        accumulator fragments, the online softmax in base 2 with quad
//        shuffles, P V with V through ldmatrix.trans and P split into
//        bf16 hi + mid + lo, three products, the S fragments reused as
//        the A operand of P V.  One rounding of P fails the output's
//        limit; hi + lo (16 bits) passes it but flips about four times
//        as many bf16 outputs as f32 P does, which the int8 path's
//        activation quantizer amplifies past chip_smoke.py's greedy gate
//        (phase 5); hi + mid + lo carries P to 24 bits.  Int8
//        K/V are dequantized into a swizzled bf16 tile before the
//        fragments are loaded.
//   4. The split meets in distributed shared memory: each block leaves its
//      rows' (m, l, acc) in its own shared memory, the cluster syncs, and
//      block `rank` merges a 1/split share of the (rows, D) outputs over
//      the split's blocks (map_shared_rank, every remote load of a group
//      issued before the first is used): m = max m_i, l = sum l_i *
//      2^(m_i - m), acc likewise, out = acc / max(l, 1e-30); a second
//      cluster sync keeps every block's shared memory alive until all have
//      read it.  One launch a call, no workspace, no second kernel.  With
//      a split of 1 a block writes its outputs straight away.
//
// Bound on the H100: bytes.  Per layer the kernel must read the live K/V
//   sum_b kv_len_b * Hkv * (D * 2 * sizeof(KV) + 2 * sizeof(scale))
// at 3.35 TB/s, plus q, positions, the table and the output; the operations
// (4 * R * kv_len * D per slot and head) are far below it.  At the serving
// shapes a call moves a few MB or less, so what is left is latency: a
// launch, the kv_len and table reads, one DRAM round trip for the tiles,
// the sweep's dependent arithmetic, the merge's two cluster syncs.
//
// Head dim 80 (zamba2's shared block).  80 is 2.5 columns a lane and 10
// (bf16) or 5 (int8) 16-byte chunks a row, which neither the lane layout
// nor the 8-chunk swizzle takes.  So the kernels separate the width they
// compute on (D, the template's tile width: 128) from the cache's (DG,
// 80): each K/V/q row's 80 real columns are loaded with cp.async and the
// 48 past them zero-filled with a source size of 0 (no global read), the
// lanes and output columns past DG are never written, the softmax scale is
// the real D's (1/sqrt(80), from the D the call passes), and the split's
// merge walks the DG real columns.  Bytes moved stay D 80's; only the
// arithmetic pays the padding, 128 / 80 = 1.6 times.  A kernel that
// computes exactly 80 columns (m16n8k16 on 10 column blocks, 5 lanes' worth
// of K-major chunks) is left for a later redesign.
//
// ptxas (-Xptxas -v, sm_90a) at D 256, no spills: mma_attn_kernel
// 199 registers (int8 K/V 185 to 188), simt_attn_kernel 98 to 118 at 2 rows
// a block and 228 to 244 at 8.
//
// Left for later PRs: computing D 80 without the padding;
// the decode sweep still spends about a microsecond a tile in dependent
// arithmetic (a layout with a few lanes a key would cut its shuffles);
// pushing the partials to their owner (one cluster sync, not two); skipping
// the tiles that lie wholly after every row of a causal chunk; wgmma for
// chunks of 64 rows.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;   // m's start: finite, so m - m is 0
constexpr int kMaxSplit = 8;        // the portable cluster size
constexpr int kSlack = 128;         // dynamic shared memory aligned to 128
// simt_attn_kernel: 16-entry tiles, a ring of 4 stages; eight warps for
// 2 rows a block (decode), four for 16
constexpr int kSimtBK = 16;
constexpr int kSimtStages = 4;
// mma_attn_kernel: a warp for every 16 rows, 64-entry tiles, 2 stages
constexpr int kMmaBK = 64;
constexpr int kMmaStages = 2;

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (no read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronously; zeros when !valid (no read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// an int8 value dequantized as the plain version does: value * scale in
// f32, rounded once to T
template <typename T>
__device__ __forceinline__ float dequant(int8_t x, float scale) {
  return to_f32(from_f32<T>(static_cast<float>(x) * scale));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of the 16-byte chunk c of row r in a tile of rows of `rb`
// bytes, swizzled (chunk c at c ^ (r % 8)) or plain
template <bool SWZ>
__device__ __forceinline__ uint32_t chunk_off(int r, int c, int rb) {
  return r * rb + ((SWZ ? (c ^ (r & 7)) : c) << 4);
}

// Where slot b's entries live: the outer index (slot or pool block) and
// offset of entry idx, contiguous (table == nullptr) or paged.
struct KVAddr {
  const int* table;   // this slot's block-table row, or nullptr
  int bs;             // entries per block (paged)
  int b;              // slot (contiguous)
  __device__ __forceinline__ void resolve(int idx, int& outer,
                                          int& off) const {
    if (table != nullptr) {
      outer = __ldg(table + idx / bs);
      off = idx % bs;
    } else {
      outer = b;
      off = idx;
    }
  }
};

// Everything a launch reads, by value in the kernel's parameters.
// q:   (B, Hkv, R, D) dense T             out: (B, Hkv, R, D) dense T
// k/v: outer axis (slot or pool block) of stride k_ob / v_ob elements, then
//      (S or BS, Hkv, D) dense, of type KV; int8 scales (outer, S or BS,
//      Hkv) of outer stride s_ob (null for float K/V)
// q_pos[b * qp_sb + r * qp_sr]; positions pos[outer * pos_ob + offset];
// kv_len[b]; table (B, n_tbl) dense int32 or null (contiguous).
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* q_pos;
  long long qp_sb, qp_sr;
  const int* cache_pos;
  long long pos_ob;
  const int* kv_len;
  const int* table;
  int n_tbl, bs;
  void* out;
  int S, Hkv, R;
  long long k_ob, v_ob, s_ob;
  int window;
  float scale_log2;   // softmax scale * log2(e)
};

// One slot's view of the cache, and this block's tile range in the split.
template <typename KV>
struct Sweep {
  KVAddr at;
  const KV* kh;
  const KV* vh;
  const float* ksh;
  const float* vsh;
  int kvl;      // live entries, clamped to [0, S]
  int tb, te;   // this block's whole tiles [tb, te)

  __device__ __forceinline__ Sweep(const Params& p, int b, int rank, int split,
                                   int bk) {
    at = KVAddr{p.table != nullptr ? p.table + (long long)b * p.n_tbl
                                   : nullptr,
                p.bs, b};
    kh = static_cast<const KV*>(p.k);
    vh = static_cast<const KV*>(p.v);
    ksh = p.k_scale;
    vsh = p.v_scale;
    kvl = min(max(p.kv_len[b], 0), p.S);
    const int n = (kvl + bk - 1) / bk;
    tb = static_cast<int>((long long)rank * n / split);
    te = static_cast<int>((long long)(rank + 1) * n / split);
  }
};

// Issue the cp.async loads of tile [t0, t0 + BK) of head h into one ring
// stage: K and V rows (chunk c of row j at chunk_off<SWZ>(j, c)), then the
// positions and, for int8, the scales (4 bytes each).  Rows at index >=
// kvl are zero-filled without a read.  The tile's rows are D wide, the
// cache's DG (DG < D: head dim 80 computed on tiles of 128); the chunks
// past DG are zero-filled without a read.
template <typename KV, int D, int BK, int THREADS, bool SWZ, int DG = D>
__device__ __forceinline__ void load_tile(uint32_t stage, const Params& p,
                                          const Sweep<KV>& sw, int h, int t0,
                                          int tid) {
  constexpr int VEC = 16 / sizeof(KV);   // elements a 16-byte chunk
  constexpr int CPR = D / VEC;           // chunks a tile row
  constexpr int CPG = DG / VEC;          // chunks of a cache row
  constexpr int RB = D * sizeof(KV);     // bytes a tile row
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  static_assert(DG <= D && DG % VEC == 0, "cache rows of whole chunks");
  const uint32_t k_dst = stage, v_dst = stage + BK * RB;
  const uint32_t pos_dst = stage + 2 * BK * RB;
  const long long row_stride = (long long)p.Hkv * DG;
#pragma unroll 4
  for (int i = tid; i < BK * CPR; i += THREADS) {
    const int j = i / CPR, c = i % CPR, idx = t0 + j;
    const bool live = idx < sw.kvl;
    const bool ok = live && (DG == D || c < CPG);
    int outer = 0, off = 0;
    if (live) sw.at.resolve(idx, outer, off);
    const long long e = off * row_stride + (long long)h * DG + c * VEC;
    const uint32_t so = chunk_off<SWZ>(j, c, RB);
    cp_async16(k_dst + so, ok ? sw.kh + outer * p.k_ob + e : sw.kh, ok);
    cp_async16(v_dst + so, ok ? sw.vh + outer * p.v_ob + e : sw.vh, ok);
  }
  for (int j = tid; j < BK; j += THREADS) {
    const int idx = t0 + j;
    const bool ok = idx < sw.kvl;
    int outer = 0, off = 0;
    if (ok) sw.at.resolve(idx, outer, off);
    cp_async4(pos_dst + 4 * j,
              ok ? p.cache_pos + outer * p.pos_ob + off : p.cache_pos, ok);
    if constexpr (INT8) {
      const long long s = outer * p.s_ob + (long long)off * p.Hkv + h;
      cp_async4(pos_dst + 4 * (BK + j), ok ? sw.ksh + s : sw.ksh, ok);
      cp_async4(pos_dst + 4 * (2 * BK + j), ok ? sw.vsh + s : sw.vsh, ok);
    }
  }
}

// bytes of one ring stage: K and V tiles, positions, int8 scales
template <typename KV, int D, int BK>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * BK * D * static_cast<int>(sizeof(KV)) +
         BK * 4 * (std::is_same<KV, int8_t>::value ? 3 : 1);
}

__device__ __forceinline__ bool visible(int idx, int kvl, int pos, int qp,
                                        int window) {
  return idx < kvl && pos >= 0 && pos <= qp &&
         (window <= 0 || pos > qp - window);
}

// Merge the cluster's partials and write this block's share of the
// outputs.  Each block's `part` holds acc [cap][D], then m [cap], then l
// [cap] (f32, base 2) for its rows; block `rank` takes the float4 groups
// [rank * per, (rank + 1) * per) of the nrows x DG outputs (rows of DG <=
// D columns).  Every remote load of a group is issued before any is used.
template <typename T, int D, int SPLIT, int DG>
__device__ __forceinline__ void merge_split(float* part, int cap, int nrows,
                                            int rank, T* out, int tid,
                                            int threads) {
  static_assert(DG % 4 == 0, "float4 groups");
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every block's partials are written and visible
  const int total = nrows * DG / 4;
  const int per = (total + SPLIT - 1) / SPLIT;
  const int end = min(total, (rank + 1) * per);
  for (int i = rank * per + tid; i < end; i += threads) {
    const int r = (4 * i) / DG, c = (4 * i) % DG;
    float mi[SPLIT], li[SPLIT];
    float4 ai[SPLIT];
#pragma unroll
    for (int s = 0; s < SPLIT; ++s) {
      const float* pp = cluster.map_shared_rank(part, s);
      mi[s] = pp[cap * D + r];
      li[s] = pp[cap * D + cap + r];
      ai[s] = *reinterpret_cast<const float4*>(pp + r * D + c);
    }
    float mx = mi[0];
#pragma unroll
    for (int s = 1; s < SPLIT; ++s) mx = fmaxf(mx, mi[s]);
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < SPLIT; ++s) {
      const float w = exp2f(mi[s] - mx);
      l = fmaf(li[s], w, l);
      a.x = fmaf(ai[s].x, w, a.x);
      a.y = fmaf(ai[s].y, w, a.y);
      a.z = fmaf(ai[s].z, w, a.z);
      a.w = fmaf(ai[s].w, w, a.w);
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + (long long)r * DG + c;
    o[0] = from_f32<T>(a.x * inv);
    o[1] = from_f32<T>(a.y * inv);
    o[2] = from_f32<T>(a.z * inv);
    o[3] = from_f32<T>(a.w * inv);
  }
  cluster.sync();   // no block leaves while another reads its partials
}

template <typename T, int D, int DG>
__device__ __forceinline__ void cluster_merge(float* part, int cap,
                                              int nrows, int split, int rank,
                                              T* out, int tid, int threads) {
  if (split == 2)
    merge_split<T, D, 2, DG>(part, cap, nrows, rank, out, tid, threads);
  else if (split == 4)
    merge_split<T, D, 4, DG>(part, cap, nrows, rank, out, tid, threads);
  else
    merge_split<T, D, kMaxSplit, DG>(part, cap, nrows, rank, out, tid,
                                     threads);
}

// ---------------------------------------------------------------------------
// simt_attn_kernel: CUDA cores, f32 arithmetic
// ---------------------------------------------------------------------------
// Lane l's D/32 columns of a K/V row in shared memory, as f32 (int8:
// dequantized and rounded to T)
template <typename T, typename KV, int VPL>
__device__ __forceinline__ void row_cols(float (&x)[VPL], const KV* row,
                                         float scale) {
  if constexpr (VPL == 8) {
    // D 256: two 4-column halves, each read as at D 128
    float lo[4], hi[4];
    row_cols<T, KV, 4>(lo, row, scale);
    row_cols<T, KV, 4>(hi, row + 4, scale);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = lo[e];
      x[4 + e] = hi[e];
    }
  } else if constexpr (std::is_same<KV, int8_t>::value) {
    const int8_t* r8 = row;
    if constexpr (VPL == 4) {
      const char4 c = *reinterpret_cast<const char4*>(r8);
      x[0] = dequant<T>(c.x, scale);
      x[1] = dequant<T>(c.y, scale);
      x[2] = dequant<T>(c.z, scale);
      x[3] = dequant<T>(c.w, scale);
    } else {
      const char2 c = *reinterpret_cast<const char2*>(r8);
      x[0] = dequant<T>(c.x, scale);
      x[1] = dequant<T>(c.y, scale);
    }
  } else if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
    if constexpr (VPL == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(row);
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      x[0] = a.x;
      x[1] = a.y;
      x[2] = b.x;
      x[3] = b.y;
    } else {
      const float2 a =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row));
      x[0] = a.x;
      x[1] = a.y;
    }
  } else {
    if constexpr (VPL == 4) {
      const float4 a = *reinterpret_cast<const float4*>(row);
      x[0] = a.x;
      x[1] = a.y;
      x[2] = a.z;
      x[3] = a.w;
    } else {
      const float2 a = *reinterpret_cast<const float2*>(row);
      x[0] = a.x;
      x[1] = a.y;
    }
  }
}

template <int MR>
__host__ __device__ constexpr int simt_warps() {
  return MR <= 4 ? 8 : 4;
}
// the simt kernel's most rows a block at head dim D: 16, or 8 at D 256
// (16 rows of 8 columns a lane would hold 256 f32 of q and acc)
template <int D>
__host__ __device__ constexpr int simt_max_rows() {
  return D > 128 ? 8 : 16;
}

template <typename KV, int D, int MR>
__host__ __device__ constexpr int simt_smem() {
  constexpr int ring = kSimtStages * stage_bytes<KV, D, kSimtBK>();
  constexpr int merge = (simt_warps<MR>() + 1) * MR * (D + 2) * 4;
  return (ring > merge ? ring : merge) + kSlack;
}

// MR: the block's query rows (2, 4, or simt_max_rows<D>()), row tile
// blockIdx.z / split.  D is the width the block computes on, DG the
// cache's and the query's (DG < D: the lanes past DG hold zeros)
template <typename T, typename KV, int D, int MR, int DG = D>
__global__ void __launch_bounds__(simt_warps<MR>() * 32)
simt_attn_kernel(const Params p, int split) {
  constexpr int BK = kSimtBK, STAGES = kSimtStages;
  constexpr int NW = simt_warps<MR>(), THREADS = NW * 32;
  constexpr int VPL = D / 32;            // columns a lane holds
  constexpr int KPW = BK / NW;           // keys a warp takes of a tile
  constexpr int KB = MR <= 4 ? KPW : 1;  // keys scored at once
  constexpr int SB = stage_bytes<KV, D, BK>();
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  static_assert(KPW % KB == 0 && D % 32 == 0 && DG % VPL == 0,
                "tile shape");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSlack - 1) &
      ~static_cast<uintptr_t>(kSlack - 1));
  const uint32_t ring = smem_u32(smem);

  const int b = blockIdx.x, h = blockIdx.y;
  const int rank = blockIdx.z % split, r0 = (blockIdx.z / split) * MR;
  const int nrows = min(MR, p.R - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this lane's columns of the block's query rows, and their positions
  float qv[MR][VPL];
  int qp[MR];
  const long long row0 = ((long long)b * p.Hkv + h) * p.R + r0;
  const T* qb = static_cast<const T*>(p.q) + row0 * DG + lane * VPL;
  const bool lane_live = DG == D || lane * VPL < DG;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    qp[r] = -1;
#pragma unroll
    for (int e = 0; e < VPL; ++e) qv[r][e] = 0.f;
    if (r < nrows) {
      qp[r] = p.q_pos[b * p.qp_sb + (long long)(r0 + r) * p.qp_sr];
      if (lane_live) row_cols<T, T, VPL>(qv[r], qb + r * DG, 1.f);
    }
  }

  const Sweep<KV> sw(p, b, rank, split, BK);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (sw.tb + s < sw.te)
      load_tile<KV, D, BK, THREADS, false, DG>(ring + s * SB, p, sw, h,
                                               (sw.tb + s) * BK, tid);
    cp_async_commit();
  }

  float m[MR], l[MR], acc[MR][VPL];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VPL; ++e) acc[r][e] = 0.f;
  }

  for (int t = sw.tb; t < sw.te; ++t) {
    const int i = t - sw.tb;
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile t is in; every warp is done with tile t - 1
    if (t + STAGES - 1 < sw.te)
      load_tile<KV, D, BK, THREADS, false, DG>(
          ring + ((i + STAGES - 1) % STAGES) * SB, p, sw, h,
          (t + STAGES - 1) * BK, tid);
    cp_async_commit();

    const unsigned char* st = smem + (i % STAGES) * SB;
    const KV* ks = reinterpret_cast<const KV*>(st);
    const KV* vs = reinterpret_cast<const KV*>(st + BK * D * sizeof(KV));
    const int* pos_s =
        reinterpret_cast<const int*>(st + 2 * BK * D * sizeof(KV));
    const float* ksc = reinterpret_cast<const float*>(pos_s + BK);
    const float* vsc = ksc + BK;
    const int t0 = t * BK;
#pragma unroll 1
    for (int kb = 0; kb < KPW; kb += KB) {
      // rows past nrows have q = 0 and q_pos = -1: masked, never written
      const int j0 = warp * KPW + kb;
      float s[KB][MR];
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        float kf[VPL];
        row_cols<T, KV, VPL>(kf, ks + (j0 + u) * D + lane * VPL,
                             INT8 ? ksc[j0 + u] : 1.f);
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VPL; ++e) d = fmaf(qv[r][e], kf[e], d);
          s[u][r] = d;
        }
      }
      // the warp sums of all KB x MR scores, one butterfly step at a time
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < KB; ++u)
#pragma unroll
          for (int r = 0; r < MR; ++r)
            s[u][r] += __shfl_xor_sync(0xffffffffu, s[u][r], o);
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const int j = j0 + u, pos = pos_s[j];
#pragma unroll
        for (int r = 0; r < MR; ++r)
          s[u][r] = visible(t0 + j, sw.kvl, pos, qp[r], p.window)
                        ? s[u][r] * p.scale_log2 : -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < KB; ++u) mx = fmaxf(mx, s[u][r]);
        const float alpha = exp2f(m[r] - mx);
        m[r] = mx;
        l[r] *= alpha;
#pragma unroll
        for (int e = 0; e < VPL; ++e) acc[r][e] *= alpha;
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          s[u][r] = exp2f(s[u][r] - mx);   // 0 for a masked key
          l[r] += s[u][r];
        }
      }
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        float vf[VPL];
        row_cols<T, KV, VPL>(vf, vs + (j0 + u) * D + lane * VPL,
                             INT8 ? vsc[j0 + u] : 1.f);
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
          for (int e = 0; e < VPL; ++e)
            acc[r][e] = fmaf(s[u][r], vf[e], acc[r][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for the warps' partials

  // the warps' partials: acc [NW][MR][D], m [NW][MR], l [NW][MR]
  float* wa = reinterpret_cast<float*>(smem);
  float* wm = wa + NW * MR * D;
  float* wl = wm + NW * MR;
#pragma unroll
  for (int r = 0; r < MR; ++r)
    if (r < nrows) {
#pragma unroll
      for (int e = 0; e < VPL; ++e)
        wa[(warp * MR + r) * D + lane * VPL + e] = acc[r][e];
      if (lane == 0) {
        wm[warp * MR + r] = m[r];
        wl[warp * MR + r] = l[r];
      }
    }
  __syncthreads();

  // the block's partial (or, without a split, its output)
  T* out = static_cast<T*>(p.out) + row0 * DG;
  float* part = wl + NW * MR;   // acc [MR][D], m [MR], l [MR]
  for (int i = tid; i < nrows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w * MR + r]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = exp2f(wm[w * MR + r] - mx);
      a = fmaf(wa[(w * MR + r) * D + c], f, a);
      ls = fmaf(wl[w * MR + r], f, ls);
    }
    if (split == 1) {
      if (DG == D || c < DG)
        out[r * DG + c] = from_f32<T>(a / fmaxf(ls, 1e-30f));
    } else {
      part[i] = a;
      if (c == 0) {
        part[MR * D + r] = mx;
        part[MR * D + MR + r] = ls;
      }
    }
  }
  if (split > 1)
    cluster_merge<T, D, DG>(part, MR, nrows, split, rank, out, tid, THREADS);
}

// ---------------------------------------------------------------------------
// mma_attn_kernel: tensor cores, bf16 operands, f32 sums
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3},"
      " [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x0, x1) as three bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid): together x to 24 bits, an f32's precision
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// warps that share a 16-row group of mma_attn_kernel: one, or at D 256
// two, each holding the output of half of D (64 f32 a lane, as at D 128;
// all of D would take 128, beside 64 of Q fragments, past 255 registers).
// Both compute the group's whole S, so their softmax states agree bit for
// bit.
template <int D>
__host__ __device__ constexpr int mma_dw() {
  return D > 128 ? 2 : 1;
}

template <typename KV, int D, int NW>
__host__ __device__ constexpr int mma_smem() {
  constexpr bool int8 = std::is_same<KV, int8_t>::value;
  constexpr int ring = kMmaStages * stage_bytes<KV, D, kMmaBK>();
  constexpr int qt = NW * 16 * D * 2;
  constexpr int deq = int8 ? 2 * kMmaBK * D * 2 : 0;
  constexpr int part = NW * 16 * (D + 2) * 4;
  return (ring + qt + deq > part ? ring + qt + deq : part) + kSlack;
}

// Dequantize one stage's int8 K and V tiles into swizzled bf16 tiles:
// value * scale in f32, rounded once
template <int D, int BK, int THREADS>
__device__ __forceinline__ void dequant_tile(const unsigned char* st,
                                             unsigned char* kd,
                                             unsigned char* vd, int tid) {
  constexpr int CPR = D / 16;   // 16-value int8 chunks a row
  const float* ksc = reinterpret_cast<const float*>(st + 2 * BK * D + 4 * BK);
  const float* vsc = ksc + BK;
  for (int i = tid; i < 2 * BK * CPR; i += THREADS) {
    const int which = i / (BK * CPR), jc = i % (BK * CPR);
    const int j = jc / CPR, c = jc % CPR;
    const float sc = (which ? vsc : ksc)[j];
    const uint4 raw = *reinterpret_cast<const uint4*>(
        st + which * BK * D + j * D + c * 16);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t word = w[e >> 1] >> (16 * (e & 1));
      const float f0 =
          static_cast<float>(static_cast<int8_t>(word & 0xffu)) * sc;
      const float f1 =
          static_cast<float>(static_cast<int8_t>((word >> 8) & 0xffu)) * sc;
      o[e] = bf16x2_bits(__floats2bfloat162_rn(f0, f1));
    }
    unsigned char* dst = which ? vd : kd;
    *reinterpret_cast<uint4*>(dst + chunk_off<true>(j, 2 * c, D * 2)) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + chunk_off<true>(j, 2 * c + 1, D * 2)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// NW groups of 16 query rows, mma_dw<D>() warps each (a group's warps
// split D between them); row tile blockIdx.z / split.  D is the tile
// width, DG the cache's and the query's (DG < D: zero columns past DG)
template <typename KV, int D, int NW, int DG = D>
__global__ void __launch_bounds__(NW * mma_dw<D>() * 32)
mma_attn_kernel(const Params p, int split) {
  using T = __nv_bfloat16;
  constexpr int DW = mma_dw<D>(), DC = D / DW;   // output columns a warp
  constexpr int THREADS = NW * DW * 32, ROWS = NW * 16;
  constexpr int BK = kMmaBK, STAGES = kMmaStages;
  constexpr int SB = stage_bytes<KV, D, BK>();
  constexpr int RB = D * 2;   // bytes of a bf16 row
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  static_assert(D % 64 == 0, "the swizzle takes rows of 8 or 16 chunks");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSlack - 1) &
      ~static_cast<uintptr_t>(kSlack - 1));
  const uint32_t ring = smem_u32(smem);
  unsigned char* q_s = smem + STAGES * SB;
  unsigned char* kd = q_s + ROWS * RB;   // int8: dequantized K, then V
  unsigned char* vd = kd + BK * RB;

  const int b = blockIdx.x, h = blockIdx.y;
  const int rank = blockIdx.z % split, r0 = (blockIdx.z / split) * ROWS;
  const int nrows = min(ROWS, p.R - r0);
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) / DW, dh = (tid >> 5) % DW;   // group, half
  const int g = lane >> 2, t4 = lane & 3;

  // the query tile, swizzled; rows past R and columns past DG are zeros
  const long long row0 = ((long long)b * p.Hkv + h) * p.R + r0;
  const T* qg = static_cast<const T*>(p.q) + row0 * DG;
  for (int i = tid; i < ROWS * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r < nrows && (DG == D || c < DG / 8);
    cp_async16(smem_u32(q_s) + chunk_off<true>(r, c, RB),
               ok ? qg + (long long)r * DG + c * 8 : qg, ok);
  }
  cp_async_commit();
  // this lane's two rows of its warp's 16, and their positions
  const int wr0 = warp * 16 + g, wr1 = wr0 + 8;
  const int qp0 = wr0 < nrows
                      ? p.q_pos[b * p.qp_sb + (long long)(r0 + wr0) * p.qp_sr]
                      : -1;
  const int qp1 = wr1 < nrows
                      ? p.q_pos[b * p.qp_sb + (long long)(r0 + wr1) * p.qp_sr]
                      : -1;

  const Sweep<KV> sw(p, b, rank, split, BK);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (sw.tb + s < sw.te)
      load_tile<KV, D, BK, THREADS, !INT8, DG>(ring + s * SB, p, sw, h,
                                               (sw.tb + s) * BK, tid);
    cp_async_commit();
  }

  float o[DC / 8][4];   // columns dh * DC + [0, DC)
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const bool live = warp * 16 < nrows;   // the warp holds a row of R

  // the Q fragments stay in registers up to D 128; at D 256 (64 registers)
  // each k-step reloads its own from the query tile, or the kernel spills
  constexpr bool QREG = D <= 128;
  uint32_t qf[QREG ? D / 16 : 1][4];
  const int qr = warp * 16 + (lane & 15);
  if (sw.tb < sw.te) {
    cp_async_wait<STAGES - 1>();   // the query tile is in
    __syncthreads();
    if constexpr (QREG) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        ldmatrix_x4(qf[ks], smem_u32(q_s) + chunk_off<true>(
                                qr, 2 * ks + (lane >> 4), RB));
    }
  }

  for (int t = sw.tb; t < sw.te; ++t) {
    const int i = t - sw.tb;
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile t is in; every warp is done with tile t - 1
    if (t + STAGES - 1 < sw.te)
      load_tile<KV, D, BK, THREADS, !INT8, DG>(
          ring + ((i + STAGES - 1) % STAGES) * SB, p, sw, h,
          (t + STAGES - 1) * BK, tid);
    cp_async_commit();

    const unsigned char* st = smem + (i % STAGES) * SB;
    const int* pos_s = reinterpret_cast<const int*>(st + 2 * BK * D *
                                                    sizeof(KV));
    uint32_t k_t = ring + (i % STAGES) * SB;
    uint32_t v_t = k_t + BK * D * sizeof(KV);
    if constexpr (INT8) {
      dequant_tile<D, BK, THREADS>(st, kd, vd, tid);
      __syncthreads();
      k_t = smem_u32(kd);
      v_t = smem_u32(vd);
    }
    if (!live) continue;

    // S = Q K^T: 16 rows x 64 keys a warp, K through ldmatrix
    float sc[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      if constexpr (!QREG)
        ldmatrix_x4(qf[0], smem_u32(q_s) + chunk_off<true>(
                               qr, 2 * ks + (lane >> 4), RB));
      const uint32_t(&qk)[4] = qf[QREG ? ks : 0];
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        uint32_t kb[4];
        const int key = n * 8 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(kb, k_t + chunk_off<true>(key, 2 * ks + ((lane >> 3) & 1),
                                              RB));
        mma_bf16(sc[n], qk, kb[0], kb[1]);
        mma_bf16(sc[n + 1], qk, kb[2], kb[3]);
      }
    }

    // scale and mask in f32; online softmax in base 2 over the quad
    const int t0 = t * BK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n * 8 + 2 * t4 + e, pos = pos_s[j];
        sc[n][e] = visible(t0 + j, sw.kvl, pos, qp0, p.window)
                       ? sc[n][e] * p.scale_log2 : -INFINITY;
        sc[n][2 + e] = visible(t0 + j, sw.kvl, pos, qp1, p.window)
                           ? sc[n][2 + e] * p.scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, sc[n][e]);
        mx1 = fmaxf(mx1, sc[n][2 + e]);
      }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[n][e] = exp2f(sc[n][e] - m0);   // 0 for a masked key
        sc[n][2 + e] = exp2f(sc[n][2 + e] - m1);
        l0 += sc[n][e];
        l1 += sc[n][2 + e];
      }

    // O += P V: P from the S fragments, split into bf16 hi + mid + lo
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pm[4], pl[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pm[0], pl[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pm[1], pl[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pm[2], pl[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pm[3], pl[3]);
      const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int n = 0; n < DC / 8; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, v_t + chunk_off<true>(key, dh * (DC / 8) + n + (lane >> 4),
                                      RB));
        mma_bf16(o[n], ph, vb[0], vb[1]);
        mma_bf16(o[n], pm, vb[0], vb[1]);
        mma_bf16(o[n], pl, vb[0], vb[1]);
        mma_bf16(o[n + 1], ph, vb[2], vb[3]);
        mma_bf16(o[n + 1], pm, vb[2], vb[3]);
        mma_bf16(o[n + 1], pl, vb[2], vb[3]);
      }
    }
  }
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for the partials

  T* out = static_cast<T*>(p.out) + row0 * DG;
  if (split == 1) {
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      const int c = dh * DC + n * 8 + 2 * t4;
      if (DG != D && c >= DG) continue;   // a padded column
      if (wr0 < nrows)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)wr0 * DG + c) =
            __floats2bfloat162_rn(o[n][0] * i0, o[n][1] * i0);
      if (wr1 < nrows)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)wr1 * DG + c) =
            __floats2bfloat162_rn(o[n][2] * i1, o[n][3] * i1);
    }
    return;
  }
  float* part = reinterpret_cast<float*>(smem);   // acc, m, l of ROWS rows
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    const int c = dh * DC + n * 8 + 2 * t4;
    *reinterpret_cast<float2*>(part + wr0 * D + c) =
        make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(part + wr1 * D + c) =
        make_float2(o[n][2], o[n][3]);
  }
  if (t4 == 0 && dh == 0) {
    part[ROWS * D + wr0] = m0;
    part[ROWS * D + wr1] = m1;
    part[ROWS * D + ROWS + wr0] = l0;
    part[ROWS * D + ROWS + wr1] = l1;
  }
  cluster_merge<T, D, DG>(part, ROWS, nrows, split, rank, out, tid, THREADS);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
// One launch of `kernel` over the grid (B, Hkv, gz) in clusters of (1, 1,
// split), `smem` bytes of dynamic shared memory (raised above 48 KB once
// for each kernel and size, in `*raised`).
template <typename Kern>
int launch_kernel(Kern kernel, const Params& p, int B, int gz, int threads,
                  int split, int smem, int* raised, cudaStream_t stream) {
  if (smem > 48 * 1024 && smem > *raised) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    *raised = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, p.Hkv, gz);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p, split);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, typename KV, int D, int MR, int DG>
int launch_simt(const Params& p, int B, int split, int smem,
                cudaStream_t st) {
  static int raised = 0;
  if (smem < simt_smem<KV, D, MR>())
    return static_cast<int>(cudaErrorInvalidValue);
  const int gz = (p.R + MR - 1) / MR * split;
  return launch_kernel(simt_attn_kernel<T, KV, D, MR, DG>, p, B, gz,
                       simt_warps<MR>() * 32, split, smem, &raised, st);
}

template <typename KV, int D, int NW, int DG>
int launch_mma(const Params& p, int B, int split, int smem,
               cudaStream_t st) {
  static int raised = 0;
  if (smem < mma_smem<KV, D, NW>())
    return static_cast<int>(cudaErrorInvalidValue);
  const int gz = (p.R + NW * 16 - 1) / (NW * 16) * split;
  return launch_kernel(mma_attn_kernel<KV, D, NW, DG>, p, B, gz,
                       NW * mma_dw<D>() * 32, split, smem, &raised, st);
}

// D: the tile width the kernels compute on; DG: the head dim of q, the
// cache and the output (DG < D pads each row with zero columns)
template <typename T, typename KV, int D, int DG = D>
int dispatch_rows(bool mma, int rows, const Params& p, int B, int split,
                  int smem, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (mma && rows == 16)
      return launch_mma<KV, D, 1, DG>(p, B, split, smem, st);
    if (mma && rows == 32)
      return launch_mma<KV, D, 2, DG>(p, B, split, smem, st);
    if (mma && rows == 64)
      return launch_mma<KV, D, 4, DG>(p, B, split, smem, st);
  }
  if (!mma && rows == 2)
    return launch_simt<T, KV, D, 2, DG>(p, B, split, smem, st);
  if (!mma && rows == 4)
    return launch_simt<T, KV, D, 4, DG>(p, B, split, smem, st);
  if (!mma && rows == simt_max_rows<D>())
    return launch_simt<T, KV, D, simt_max_rows<D>(), DG>(p, B, split, smem,
                                                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_kv(bool int8, int D, bool mma, int rows, const Params& p, int B,
                int split, int smem, cudaStream_t st) {
  // head dim 80 (zamba2) on tiles of 128
  if (int8 && D == 80)
    return dispatch_rows<T, int8_t, 128, 80>(mma, rows, p, B, split, smem,
                                             st);
  if (!int8 && D == 80)
    return dispatch_rows<T, T, 128, 80>(mma, rows, p, B, split, smem, st);
  if (int8 && D == 256)
    return dispatch_rows<T, int8_t, 256>(mma, rows, p, B, split, smem, st);
  if (!int8 && D == 256)
    return dispatch_rows<T, T, 256>(mma, rows, p, B, split, smem, st);
  if (int8 && D == 128)
    return dispatch_rows<T, int8_t, 128>(mma, rows, p, B, split, smem, st);
  if (int8 && D == 64)
    return dispatch_rows<T, int8_t, 64>(mma, rows, p, B, split, smem, st);
  if (!int8 && D == 128)
    return dispatch_rows<T, T, 128>(mma, rows, p, B, split, smem, st);
  if (!int8 && D == 64)
    return dispatch_rows<T, T, 64>(mma, rows, p, B, split, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype (q, out): 0 = float32, 1 = bfloat16; K/V of that type, or int8
// when scales are given.  D: 64, 80, 128 or 256.  table null: contiguous.
// The plan (tensor_cores, rows, bk, stages, split, smem) is the wrapper's
// _plan:
// bk and stages must be the chosen kernel's, split 1, 2, 4 or 8, smem at
// least what the kernel lays out.
int dispatch(int dtype, int D, const Params& p, int B, int tensor_cores,
             int rows, int bk, int stages, int split, int smem,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool int8 = p.k_scale != nullptr;
  const bool mma = tensor_cores != 0;
  if (int8 != (p.v_scale != nullptr) || B <= 0 || p.R <= 0 ||
      (p.table != nullptr && p.bs <= 0) ||
      (split != 1 && split != 2 && split != 4 && split != 8) ||
      bk != (mma ? kMmaBK : kSimtBK) ||
      stages != (mma ? kMmaStages : kSimtStages))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return dispatch_kv<__nv_bfloat16>(int8, D, mma, rows, p, B, split, smem,
                                      st);
  if (dtype == 0 && !mma)
    return dispatch_kv<float>(int8, D, mma, rows, p, B, split, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* q_pos, long long qp_sb, long long qp_sr,
                   const void* cache_pos, const void* kv_len,
                   const void* table, void* out, int S, int Hkv, int R, int D,
                   int n_tbl, int bs, long long k_ob, long long v_ob,
                   long long s_ob, long long pos_ob, int window) {
  return Params{q, k, v, static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<const int*>(q_pos), qp_sb, qp_sr,
                static_cast<const int*>(cache_pos), pos_ob,
                static_cast<const int*>(kv_len),
                static_cast<const int*>(table), n_tbl, bs, out, S, Hkv, R,
                k_ob, v_ob, s_ob, window,
                static_cast<float>(1.4426950408889634 /
                                   sqrt(static_cast<double>(D)))};
}

}  // namespace

extern "C" {

// q (B, Hkv, G, D); q_pos (B,): one query position per slot.
// Contiguous (table null): k/v (B, S, Hkv, D), outer stride k_ob/v_ob per
// slot, cache_pos (B, S), scales (B, S, Hkv).  Paged: k/v pool (NB, BS,
// Hkv, D), outer stride per block, cache_pos (NB, BS), scales (NB, BS,
// Hkv), table (B, n_tbl) and S = n_tbl * BS.  The last six ints are the
// launch plan (see dispatch).
int flash_decode(int dtype, const void* q, const void* k, const void* v,
                 const void* k_scale, const void* v_scale, const void* q_pos,
                 const void* cache_pos, const void* kv_len, const void* table,
                 void* out, int B, int S, int Hkv, int G, int D, int n_tbl,
                 int bs, long long k_ob, long long v_ob, long long s_ob,
                 long long pos_ob, int window, int tensor_cores, int rows,
                 int bk, int stages, int split, int smem, void* stream) {
  const Params p = make_params(q, k, v, k_scale, v_scale, q_pos, 1, 0,
                               cache_pos, kv_len, table, out, S, Hkv, G, D,
                               n_tbl, bs, k_ob, v_ob, s_ob, pos_ob, window);
  return dispatch(dtype, D, p, B, tensor_cores, rows, bk, stages, split,
                  smem, stream);
}

// q (B, Hkv, R, D) with R = C * G rows ordered (c, g); q_pos (B, R); the
// rest as in flash_decode.
int flash_chunk_prefill(int dtype, const void* q, const void* k,
                        const void* v, const void* k_scale,
                        const void* v_scale, const void* q_pos,
                        const void* cache_pos, const void* kv_len,
                        const void* table, void* out, int B, int S, int Hkv,
                        int R, int D, int n_tbl, int bs, long long k_ob,
                        long long v_ob, long long s_ob, long long pos_ob,
                        int window, int tensor_cores, int rows, int bk,
                        int stages, int split, int smem, void* stream) {
  const Params p = make_params(q, k, v, k_scale, v_scale, q_pos, R, 1,
                               cache_pos, kv_len, table, out, S, Hkv, R, D,
                               n_tbl, bs, k_ob, v_ob, s_ob, pos_ob, window);
  return dispatch(dtype, D, p, B, tensor_cores, rows, bk, stages, split,
                  smem, stream);
}

}  // extern "C"
