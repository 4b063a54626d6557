// Flash-decode and chunk-prefill attention over the slot-addressed or paged
// KV cache, float or int8, hand-written for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes; see kernels/build.py and
// kernels/flash_decode.py).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   flash_decode        <- src/repro/kernels/flash_decode.py:147 (_kernel :76)
//   flash_chunk_prefill <- src/repro/kernels/flash_decode.py:334 (_chunk_kernel :274)
// It computes what they compute, not block for block.  Decode is the chunk
// kernel with R = G query rows sharing one q_pos per slot, so one templated
// body serves both C entry points, in all four layouts: float or int8 K/V,
// each contiguous or paged.
//
// Contract (identical to kernels/ref.py::chunk_attention_ref and its paged
// twin): query row r of slot b attends cache entry i (KV head h) when
//     pos(b, i) >= 0, pos(b, i) <= q_pos[b, r], i < kv_len[b],
//     and, with a window, pos(b, i) > q_pos[b, r] - window.
// Scores, online softmax and the accumulator are f32; the output is in q's
// type.  The probability of an invalid entry is zeroed explicitly and l is
// floored at 1e-30, so an empty slot (kv_len == 0, the normal state of an
// idle slot in the decode batch) and a pad query row (q_pos == -1) give
// exact zeros, never NaN.
//
// Layouts.  Entry i of slot b lives at (block, offset) of an outer axis:
//   contiguous  (b, i):                         k/v (B, S, Hkv, D)
//   paged       (table[b, i / BS], i % BS):     k/v pool (NB, BS, Hkv, D)
// and its position at pos[block * pos_sb + offset], so one address
// resolution serves both.  In the paged layout every row resolves its own
// block: a 64-entry tile spans several pages when BS < 64 (BS is any
// divisor of the capacity >= 8).  Table entries past kv_len are never read.
// Int8 K/V (Int8KV) come with one f32 scale per (entry, head): the int8
// row is loaded as bytes and each value is multiplied by its scale in f32
// and rounded once to q's type as it is staged in shared memory, the
// plain version's dequant exactly; no float copy of the cache exists.
//
// Design (simple first):
//   grid (slot, kv-head, row-tile of kRows query rows), 128 threads.  A loop
//   inside the block walks the KV sweep in tiles of BK entries (the TPU's
//   sequential KV grid axis), so nothing is carried across blocks.  Each tile
//   of K and V rows is fetched into registers one tile ahead (its load
//   latency overlaps the current tile's compute), then staged in shared
//   memory (rows padded to an odd word stride: conflict-free reads); q rows
//   live in shared memory as pre-scaled f32.  Scores are FMA dot products,
//   one K row per thread against up to kRows/2 query rows (G = 2 rows at
//   decode is far below an MMA tile); the online-softmax state (m, l) is per
//   row in shared memory, and each thread keeps its output column of every
//   row in f32 registers.  The sweep stops at kv_len and loads only the live
//   rows, so the capacity tail is never read; a capacity that is no multiple
//   of BK is masked in the last tile, and the cache is never padded or
//   copied.  K/V may be strided views (a layer slice of the stacked cache, or
//   one slot's row): the outer stride is an argument, the (S, Hkv, D) inner
//   layout must be dense.
//
// Bound on the H100: bytes.  Per layer the kernel must read the live K/V
//   sum_b kv_len_b * Hkv * (D * 2 * sizeof(KV) + 2 * sizeof(scale))
// (the TPU kernel rounds each kv_len_b up to its block, ceil(kv_len_b/bk)*bk)
// at 3.35 TB/s, plus q, positions, the table and the output.  Operations are
// 4 * R * kv_len * D per (slot, head), far below the byte bound at decode.
//
// Left for later PRs: at decode the grid is only slots * Hkv blocks (32 on
// 132 SMs at 4 slots x 8 KV heads), so the KV sweep should be split across
// blocks with a second pass merging the partial (m, l, acc); the loads
// should move to cp.async double-buffered with the compute (TMA does not fit
// the per-row page gather of small pages); the chunk kernel's 128-row tiles
// are worth a wgmma path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kRows = 16;       // query rows per block
constexpr float kNegInf = -1e30f;

template <typename T> struct TileCfg;
template <> struct TileCfg<__nv_bfloat16> {
  static constexpr int BK = 64;   // KV entries per staged tile
  static constexpr int PAD = 2;   // row stride D + 2 bf16: odd word count
};
template <> struct TileCfg<float> {
  static constexpr int BK = 32;
  static constexpr int PAD = 1;
};

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

// four consecutive elements of a (word-aligned) shared-memory row, as f32
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + 2));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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
      outer = table[idx / bs];
      off = idx % bs;
    } else {
      outer = b;
      off = idx;
    }
  }
};

// Stage one 16-byte chunk of a K/V row into shared memory as T: a float
// chunk is copied word by word (padded rows are only word-aligned); an int8
// chunk (16 values) is dequantized, value * scale in f32 rounded once to T.
template <typename T, typename KV>
__device__ __forceinline__ void stage_chunk(T* dst, const uint4& r,
                                            float scale) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  if constexpr (std::is_same<KV, T>::value) {
    d[0] = r.x; d[1] = r.y; d[2] = r.z; d[3] = r.w;
  } else {
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[e] = static_cast<float>(static_cast<int8_t>(
                   (words[wi] >> (8 * e)) & 0xffu)) * scale;
      if constexpr (std::is_same<T, float>::value) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[wi * 4 + e] = f[e];
      } else {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
        d[wi * 2] = *reinterpret_cast<const uint32_t*>(&lo);
        d[wi * 2 + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }
    }
  }
}

// Load tile [t0, t0 + BK) of one slot's K/V rows (and their scales, for
// int8) and positions into registers: 16 bytes per load, neighbouring
// threads on neighbouring addresses, each row's address resolved on its
// own.  Rows at index >= kv_len are zeros (positions -1).
template <typename KV, int BK, int VPR, int VEC, int LOADS>
__device__ __forceinline__ void fetch_tile(
    uint4 (&kreg)[LOADS], uint4 (&vreg)[LOADS], float (&ksreg)[LOADS],
    float (&vsreg)[LOADS], int& preg, const KVAddr& at, const KV* kh,
    const KV* vh, const float* ksh, const float* vsh, const int* pos,
    long long k_ob, long long v_ob, long long s_ob, long long pos_ob,
    long long row_stride, int hkv, int t0, int kvl, int tid) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int i = tid + u * kThreads;
    const int idx = t0 + i / VPR, c = (i % VPR) * VEC;
    kreg[u] = make_uint4(0u, 0u, 0u, 0u);
    vreg[u] = kreg[u];
    ksreg[u] = 0.f;
    vsreg[u] = 0.f;
    if (idx < kvl) {
      int outer, off;
      at.resolve(idx, outer, off);
      const long long row = off * row_stride + c;
      kreg[u] = *reinterpret_cast<const uint4*>(kh + outer * k_ob + row);
      vreg[u] = *reinterpret_cast<const uint4*>(vh + outer * v_ob + row);
      if (ksh != nullptr) {
        const long long srow = outer * s_ob + (long long)off * hkv;
        ksreg[u] = ksh[srow];
        vsreg[u] = vsh[srow];
      }
    }
  }
  preg = -1;
  if (tid < BK && t0 + tid < kvl) {
    int outer, off;
    at.resolve(t0 + tid, outer, off);
    preg = pos[outer * pos_ob + off];
  }
}

// q:   (B, Hkv, R, D) dense T             out: (B, Hkv, R, D) dense T
// k/v: outer axis (slot or pool block) of stride k_ob / v_ob elements, then
//      (S or BS, Hkv, D) dense, of type KV; int8 scales (outer, S or BS,
//      Hkv) of outer stride s_ob (null for float K/V)
// q_pos[b * qp_sb + r * qp_sr]; positions pos[outer * pos_ob + offset];
// kv_len[b]; table (B, n_tbl) dense int32 or null (contiguous).
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const KV* __restrict__ k,
            const KV* __restrict__ v, const float* __restrict__ k_scale,
            const float* __restrict__ v_scale,
            const int* __restrict__ q_pos, long long qp_sb, long long qp_sr,
            const int* __restrict__ cache_pos, long long pos_ob,
            const int* __restrict__ kv_len, const int* __restrict__ table,
            int n_tbl, int bs, T* __restrict__ out, int S, int Hkv, int R,
            long long k_ob, long long v_ob, long long s_ob, int window,
            float scale) {
  constexpr int BK = TileCfg<T>::BK;
  constexpr int LD = D + TileCfg<T>::PAD;
  constexpr int GROUPS = kThreads / D;    // row groups of the PV phase
  constexpr int ACC = kRows / GROUPS;     // rows per thread in the PV phase
  constexpr int VEC = 16 / sizeof(KV);    // elements per 16-byte load
  constexpr int VPR = D / VEC;            // 16-byte loads per K/V row
  constexpr int LOADS = BK * VPR / kThreads;   // per thread and tile
  constexpr int NG = kThreads / BK;       // row groups of the score phase
  constexpr int RPT = kRows / NG;         // rows per thread in the score phase
  static_assert(kThreads % D == 0 && kRows % GROUPS == 0, "tile shape");
  static_assert(BK * VPR % kThreads == 0 && kRows % NG == 0, "tile shape");
  static_assert(BK % 32 == 0 && BK <= kThreads, "softmax lanes");

  __shared__ __align__(16) T k_s[BK * LD];
  __shared__ __align__(16) T v_s[BK * LD];
  __shared__ __align__(16) float q_s[kRows * D];
  __shared__ __align__(16) float p_s[kRows * BK];
  __shared__ int pos_s[BK];
  __shared__ float m_s[kRows], l_s[kRows], alpha_s[kRows];
  __shared__ int qp_s[kRows];

  const int b = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * kRows;
  const int nrows = min(kRows, R - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvl = min(max(kv_len[b], 0), S);

  const long long q_off = (((long long)b * Hkv + h) * R + r0) * D;
  for (int i = tid; i < kRows * D; i += kThreads)
    q_s[i] = i / D < nrows ? to_f32(q[q_off + i]) * scale : 0.f;
  for (int r = tid; r < kRows; r += kThreads) {
    qp_s[r] = r < nrows ? q_pos[b * qp_sb + (long long)(r0 + r) * qp_sr] : -1;
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int col = tid % D;   // PV phase: this thread's output column
  const int rg = tid / D;    // ... of rows rg, rg + GROUPS, ... (na of them)
  const int na = (nrows - rg + GROUPS - 1) / GROUPS;
  const int kj = tid % BK;   // score phase: this thread's entry
  const int g0 = tid / BK;   // ... against rows g0, g0 + NG, ... (nr of them)
  const int nr = (nrows - g0 + NG - 1) / NG;
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;

  const long long row_stride = (long long)Hkv * D;
  const KVAddr at{table != nullptr ? table + (long long)b * n_tbl : nullptr,
                  bs, b};
  const KV* kh = k + (long long)h * D;
  const KV* vh = v + (long long)h * D;
  const float* ksh = k_scale != nullptr ? k_scale + h : nullptr;
  const float* vsh = v_scale != nullptr ? v_scale + h : nullptr;

  // The next tile is fetched into registers while this one is computed,
  // so its load latency overlaps the three compute phases.
  uint4 kreg[LOADS], vreg[LOADS];
  float ksreg[LOADS], vsreg[LOADS];
  int preg = -1;
  if (kvl > 0)
    fetch_tile<KV, BK, VPR, VEC>(kreg, vreg, ksreg, vsreg, preg, at, kh, vh,
                                 ksh, vsh, cache_pos, k_ob, v_ob, s_ob,
                                 pos_ob, row_stride, Hkv, 0, kvl, tid);

  for (int t0 = 0; t0 < kvl; t0 += BK) {
    __syncthreads();   // the previous tile is consumed; q_s/qp_s are ready
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = tid + u * kThreads;
      const int j = i / VPR, c = (i % VPR) * VEC;
      stage_chunk<T, KV>(k_s + j * LD + c, kreg[u], ksreg[u]);
      stage_chunk<T, KV>(v_s + j * LD + c, vreg[u], vsreg[u]);
    }
    if (tid < BK) pos_s[tid] = preg;
    __syncthreads();
    if (t0 + BK < kvl)
      fetch_tile<KV, BK, VPR, VEC>(kreg, vreg, ksreg, vsreg, preg, at, kh,
                                   vh, ksh, vsh, cache_pos, k_ob, v_ob, s_ob,
                                   pos_ob, row_stride, Hkv, t0 + BK, kvl,
                                   tid);

    // Scores: each thread dots its entry with up to RPT query rows, one
    // K read feeding RPT rows (q reads are warp broadcasts).
    {
      float sc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sc[i] = 0.f;
      const T* kr = k_s + kj * LD;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 kf = load4(kr + d);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          if (i < nr) {
            const float4 qf =
                *reinterpret_cast<const float4*>(q_s + (g0 + i * NG) * D + d);
            sc[i] = fmaf(qf.x, kf.x, sc[i]);
            sc[i] = fmaf(qf.y, kf.y, sc[i]);
            sc[i] = fmaf(qf.z, kf.z, sc[i]);
            sc[i] = fmaf(qf.w, kf.w, sc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (i < nr) p_s[(g0 + i * NG) * BK + kj] = sc[i];
    }
    __syncthreads();

    // Online softmax: warp w owns rows w, w + 4, ...
    for (int r = warp; r < nrows; r += kThreads / 32) {
      const int qp = qp_s[r];
      float sv[BK / 32];
      bool ok[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int j = lane + 32 * u, pos = pos_s[j];
        ok[u] = pos >= 0 && pos <= qp && (window <= 0 || pos > qp - window);
        sv[u] = ok[u] ? p_s[r * BK + j] : kNegInf;
        mx = fmaxf(mx, sv[u]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        // explicit mask: an all-invalid tile has m_new == kNegInf, where
        // exp(s - m_new) would be 1
        const float p = ok[u] ? expf(sv[u] - m_new) : 0.f;
        p_s[r * BK + lane + 32 * u] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, one output column per thread; four P
    // values per (broadcast) read.
#pragma unroll
    for (int a = 0; a < ACC; ++a)
      if (a < na) acc[a] *= alpha_s[rg + a * GROUPS];
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      const float v0 = to_f32(v_s[(j + 0) * LD + col]);
      const float v1 = to_f32(v_s[(j + 1) * LD + col]);
      const float v2 = to_f32(v_s[(j + 2) * LD + col]);
      const float v3 = to_f32(v_s[(j + 3) * LD + col]);
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        if (a < na) {
          const float4 pf = *reinterpret_cast<const float4*>(
              p_s + (rg + a * GROUPS) * BK + j);
          acc[a] = fmaf(pf.x, v0, acc[a]);
          acc[a] = fmaf(pf.y, v1, acc[a]);
          acc[a] = fmaf(pf.z, v2, acc[a]);
          acc[a] = fmaf(pf.w, v3, acc[a]);
        }
      }
    }
  }
  __syncthreads();   // l_s is final (also when the sweep was empty)

#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int r = rg + a * GROUPS;
    if (r < nrows)
      out[q_off + (long long)r * D + col] =
          from_f32<T>(acc[a] / fmaxf(l_s[r], 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *q_pos;
  long long qp_sb, qp_sr;
  const void *cache_pos;
  long long pos_ob;
  const void *kv_len, *table;
  int n_tbl, bs;
  void* out;
  int B, S, Hkv, R;
  long long k_ob, v_ob, s_ob;
  int window;
};

template <typename T, typename KV, int D>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B, a.Hkv, (a.R + kRows - 1) / kRows);
  attn_kernel<T, KV, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.q_pos),
      a.qp_sb, a.qp_sr, static_cast<const int*>(a.cache_pos), a.pos_ob,
      static_cast<const int*>(a.kv_len), static_cast<const int*>(a.table),
      a.n_tbl, a.bs, static_cast<T*>(a.out), a.S, a.Hkv, a.R, a.k_ob, a.v_ob,
      a.s_ob, a.window,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_kv(bool int8, int D, const Args& a, cudaStream_t st) {
  if (int8 && D == 128) return launch<T, int8_t, 128>(a, st);
  if (int8 && D == 64) return launch<T, int8_t, 64>(a, st);
  if (!int8 && D == 128) return launch<T, T, 128>(a, st);
  if (!int8 && D == 64) return launch<T, T, 64>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype (q, out): 0 = float32, 1 = bfloat16; K/V of that type, or int8
// when scales are given.  D: 64 or 128.  table null: contiguous.
int dispatch(int dtype, int D, const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool int8 = a.k_scale != nullptr;
  if (int8 != (a.v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.table != nullptr && a.bs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return dispatch_kv<__nv_bfloat16>(int8, D, a, st);
  if (dtype == 0) return dispatch_kv<float>(int8, D, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B, Hkv, G, D); q_pos (B,): one query position per slot.
// Contiguous (table null): k/v (B, S, Hkv, D), outer stride k_ob/v_ob per
// slot, cache_pos (B, S), scales (B, S, Hkv).  Paged: k/v pool (NB, BS,
// Hkv, D), outer stride per block, cache_pos (NB, BS), scales (NB, BS,
// Hkv), table (B, n_tbl) and S = n_tbl * BS.
int flash_decode(int dtype, const void* q, const void* k, const void* v,
                 const void* k_scale, const void* v_scale, const void* q_pos,
                 const void* cache_pos, const void* kv_len, const void* table,
                 void* out, int B, int S, int Hkv, int G, int D, int n_tbl,
                 int bs, long long k_ob, long long v_ob, long long s_ob,
                 long long pos_ob, int window, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, q_pos, 1, 0, cache_pos, pos_ob,
               kv_len, table, n_tbl, bs, out, B, S, Hkv, G, k_ob, v_ob, s_ob,
               window};
  return dispatch(dtype, D, a, stream);
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
                        int window, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, q_pos, R, 1, cache_pos, pos_ob,
               kv_len, table, n_tbl, bs, out, B, S, Hkv, R, k_ob, v_ob, s_ob,
               window};
  return dispatch(dtype, D, a, stream);
}

}  // extern "C"
