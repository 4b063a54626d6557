// Flash-decode and chunk-prefill attention over the slot-addressed KV
// cache, hand-written for Hopper (sm_90a), bound to Python through a plain
// C interface (ctypes; see kernels/build.py and kernels/flash_decode.py).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   flash_decode        <- src/repro/kernels/flash_decode.py:147 (_kernel :76)
//   flash_chunk_prefill <- src/repro/kernels/flash_decode.py:334 (_chunk_kernel :274)
// It computes what they compute, not block for block.  Decode is the chunk
// kernel with R = G query rows sharing one q_pos per slot, so one templated
// body serves both C entry points.
//
// Contract (identical to kernels/ref.py::chunk_attention_ref): query row r
// of slot b attends cache entry i (KV head h) when
//     cache_pos[b, i] >= 0, cache_pos[b, i] <= q_pos[b, r], i < kv_len[b],
//     and, with a window, cache_pos[b, i] > q_pos[b, r] - window.
// Scores, online softmax and the accumulator are f32; the output is in the
// input type.  The probability of an invalid entry is zeroed explicitly and
// l is floored at 1e-30, so an empty slot (kv_len == 0, the normal state of
// an idle slot in the decode batch) and a pad query row (q_pos == -1) give
// exact zeros, never NaN.
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
//   row in f32 registers.  The sweep stops at kv_len and loads only the live rows,
//   so the capacity tail is never read; a capacity that is no multiple of BK
//   is masked in the last tile, and the cache is never padded or copied.
//   K/V may be strided views (a layer slice of the stacked cache, or one
//   slot's row): the batch stride is an argument, the (S, Hkv, D) inner
//   layout must be dense.
//
// Bound on the H100: bytes.  Per layer the kernel must read the live K/V
//   sum_b kv_len_b * Hkv * D * 2 * sizeof(T)
// (the TPU kernel rounds each kv_len_b up to its block, ceil(kv_len_b/bk)*bk)
// at 3.35 TB/s, plus q, positions and the output.  Operations are
// 4 * R * kv_len * D per (slot, head), far below the byte bound at decode.
//
// Left for later PRs: at decode the grid is only slots * Hkv blocks (32 on
// 132 SMs at 4 slots x 8 KV heads), so the KV sweep should be split across
// blocks with a second pass merging the partial (m, l, acc); the loads
// should move to cp.async/TMA double-buffered with the compute; the chunk
// kernel's 128-row tiles are worth a wgmma path; the int8 (Int8KV) and
// paged (block-table) layouts of the TPU kernels come with the int8/paged
// slice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// Load tile [t0, t0 + BK) of one slot's K/V rows and positions into
// registers: 16 bytes per load, neighbouring threads on neighbouring
// addresses.  Rows at index >= kv_len are zeros (positions -1).
template <typename T, int BK, int VPR, int VEC, int LOADS>
__device__ __forceinline__ void fetch_tile(uint4 (&kreg)[LOADS],
                                           uint4 (&vreg)[LOADS], int& preg,
                                           const T* kb, const T* vb,
                                           const int* pb,
                                           long long row_stride, int t0,
                                           int kvl, int tid) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int i = tid + u * kThreads;
    const int idx = t0 + i / VPR, c = (i % VPR) * VEC;
    kreg[u] = make_uint4(0u, 0u, 0u, 0u);
    vreg[u] = kreg[u];
    if (idx < kvl) {
      kreg[u] = *reinterpret_cast<const uint4*>(kb + idx * row_stride + c);
      vreg[u] = *reinterpret_cast<const uint4*>(vb + idx * row_stride + c);
    }
  }
  preg = tid < BK && t0 + tid < kvl ? pb[t0 + tid] : -1;
}

// q:   (B, Hkv, R, D) dense                out: (B, Hkv, R, D) dense
// k/v: (B, S, Hkv, D), batch stride k_sb / v_sb elements, inner dense
// q_pos[b * qp_sb + r * qp_sr]; cache_pos[b * pos_sb + i]; kv_len[b]
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ q_pos,
            long long qp_sb, long long qp_sr,
            const int* __restrict__ cache_pos, long long pos_sb,
            const int* __restrict__ kv_len, T* __restrict__ out, int S,
            int Hkv, int R, long long k_sb, long long v_sb, int window,
            float scale) {
  constexpr int BK = TileCfg<T>::BK;
  constexpr int LD = D + TileCfg<T>::PAD;
  constexpr int GROUPS = kThreads / D;    // row groups of the PV phase
  constexpr int ACC = kRows / GROUPS;     // rows per thread in the PV phase
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
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
  const T* kb = k + b * k_sb + (long long)h * D;
  const T* vb = v + b * v_sb + (long long)h * D;
  const int* pb = cache_pos + b * pos_sb;

  // The next tile is fetched into registers while this one is computed,
  // so its load latency overlaps the three compute phases.
  uint4 kreg[LOADS], vreg[LOADS];
  int preg = -1;
  if (kvl > 0)
    fetch_tile<T, BK, VPR, VEC>(kreg, vreg, preg, kb, vb, pb, row_stride, 0,
                                kvl, tid);

  for (int t0 = 0; t0 < kvl; t0 += BK) {
    __syncthreads();   // the previous tile is consumed; q_s/qp_s are ready
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = tid + u * kThreads;
      const int j = i / VPR, c = (i % VPR) * VEC;
      // padded smem rows are only word-aligned: store word by word
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + j * LD + c);
      uint32_t* vd = reinterpret_cast<uint32_t*>(v_s + j * LD + c);
      kd[0] = kreg[u].x; kd[1] = kreg[u].y; kd[2] = kreg[u].z; kd[3] = kreg[u].w;
      vd[0] = vreg[u].x; vd[1] = vreg[u].y; vd[2] = vreg[u].z; vd[3] = vreg[u].w;
    }
    if (tid < BK) pos_s[tid] = preg;
    __syncthreads();
    if (t0 + BK < kvl)
      fetch_tile<T, BK, VPR, VEC>(kreg, vreg, preg, kb, vb, pb, row_stride,
                                  t0 + BK, kvl, tid);

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           long long qp_sb, long long qp_sr, const void* cache_pos,
           long long pos_sb, const void* kv_len, void* out, int B, int S,
           int Hkv, int R, long long k_sb, long long v_sb, int window,
           cudaStream_t stream) {
  const dim3 grid(B, Hkv, (R + kRows - 1) / kRows);
  attn_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos), qp_sb, qp_sr,
      static_cast<const int*>(cache_pos), pos_sb,
      static_cast<const int*>(kv_len), static_cast<T*>(out), S, Hkv, R, k_sb,
      v_sb, window, static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16.  D: 64 or 128.
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* q_pos, long long qp_sb, long long qp_sr,
             const void* cache_pos, long long pos_sb, const void* kv_len,
             void* out, int B, int S, int Hkv, int R, int D, long long k_sb,
             long long v_sb, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ATTN_ARGS q, k, v, q_pos, qp_sb, qp_sr, cache_pos, pos_sb, kv_len, \
                  out, B, S, Hkv, R, k_sb, v_sb, window, st
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(ATTN_ARGS);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(ATTN_ARGS);
  if (dtype == 0 && D == 128) return launch<float, 128>(ATTN_ARGS);
  if (dtype == 0 && D == 64) return launch<float, 64>(ATTN_ARGS);
#undef ATTN_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B, Hkv, G, D); q_pos (B,): one query position per slot.
int flash_decode(int dtype, const void* q, const void* k, const void* v,
                 const void* q_pos, const void* cache_pos, const void* kv_len,
                 void* out, int B, int S, int Hkv, int G, int D,
                 long long k_sb, long long v_sb, long long pos_sb, int window,
                 void* stream) {
  return dispatch(dtype, q, k, v, q_pos, 1, 0, cache_pos, pos_sb, kv_len, out,
                  B, S, Hkv, G, D, k_sb, v_sb, window, stream);
}

// q (B, Hkv, R, D) with R = C * G rows ordered (c, g); q_pos (B, R).
int flash_chunk_prefill(int dtype, const void* q, const void* k,
                        const void* v, const void* q_pos,
                        const void* cache_pos, const void* kv_len, void* out,
                        int B, int S, int Hkv, int R, int D, long long k_sb,
                        long long v_sb, long long pos_sb, int window,
                        void* stream) {
  return dispatch(dtype, q, k, v, q_pos, R, 1, cache_pos, pos_sb, kv_len, out,
                  B, S, Hkv, R, D, k_sb, v_sb, window, stream);
}

}  // extern "C"
