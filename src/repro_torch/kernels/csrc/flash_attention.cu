// Whole-sequence flash attention, forward and backward, hand-written for
// Hopper (sm_90a), bound to Python through a plain C interface (ctypes; see
// kernels/build.py and kernels/flash_attention.py).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   flash_attention <- src/repro/kernels/flash_attention.py:83 (_kernel :24)
// It computes what that kernel computes, not block for block.  The TPU
// kernel has no backward (XLA differentiates the jnp attention); the port's
// training path needs one, so the gradient is a second kernel here.
//
// Contract (identical to kernels/ref.py::flash_attention_ref):
//   q (B, S, Hq, D), k/v (B, S, Hkv, D), dense, of one type T (f32 or bf16);
//   query head h reads KV head h / (Hq / Hkv) in place (GQA, no repeat copy).
//   Query row i attends key j when
//       j < S, (causal ? j <= i : true), (window > 0 ? j > i - window : true)
//   (index masks: the caller's positions are 0..S-1).  Scores q * scale . k
//   in f32 (scale = D^-1/2 applied to q, as the TPU kernel does), online
//   softmax (m, l, acc) in f32, l floored at 1e-30, output in T.  The
//   forward also writes each row's log-sum-exp lse = m + log(l) in f32
//   (B, Hq, S), which the backward reads to rebuild P = exp(s - lse).
//   Any S: the last tile of rows and of keys is masked (the TPU kernel
//   asserts S % block == 0).
//
// Backward, from (q, k, v, o, lse, dO):
//   Dr = rowsum(dO * o)                 (f32, one warp per row)
//   P  = exp(q*scale . k - lse),  dP = dO . v,  dS = P * (dP - Dr)
//   dV = P^T dO,  dK = dS^T (q * scale),  dQ = scale * dS K
// in three kernels: the row sums; one pass per KV tile that loops over the
// G query heads sharing the tile and over their query tiles, so dK/dV sum
// the group in registers without atomics; one pass per query tile for dQ.
// Accumulation in f32; dQ, dK, dV written in T.
//
// Design (simple first): 128 threads a block; tiles of q/k/v/dO rows are
// staged in shared memory as f32 rows of D + 4 words (conflict-free float4
// reads of neighbouring rows); score tiles are register-blocked FMA dot
// products (8 rows x 4 keys a thread in the forward), and the P.V / P^T.dO
// products are register-blocked outer products over the tile (8 rows x D/16
// columns a thread).  The online-softmax row max is a shuffle over the 16
// lanes that share a row.  A loop inside the block walks the key tiles (the
// TPU's sequential grid axis); tiles above the diagonal or wholly outside
// the window are skipped, as the TPU kernel skips them.  Loads are
// synchronous (no overlap of a tile's load with the previous one's compute).
//
// Bound on the H100: operations.  A causal forward at the training shape
// (B 4, S 2048, Hq 16, D 128) does 4 * B * Hq * S^2 * D / 2 = 69 GFLOP
// (0.07 ms at 989 TFLOP/s bf16) against 50 MB of bytes (0.015 ms at
// 3.35 TB/s); the backward does 2.5 times the forward's operations.  This
// kernel runs on the CUDA cores in f32 (67 TFLOP/s at best), so it cannot
// come near the bf16 bound: mma.sync/wgmma tiles, TMA loads and a pipelined
// K/V ring are the work of a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps: 8 row groups (ty) x 16 lanes (tx)
constexpr int kBQ = 64;         // query rows per tile
constexpr float kNegInf = -1e30f;

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

// 16 bytes of T as f32: 4 floats, or 8 bf16 (bf16 -> f32 is exact: the
// bf16 bits are the high half of the f32)
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [row0, row0 + ROWS) of one head of a (B, S, H, D) tensor into
// shared memory as f32 times `mul`: dst[r * LD + d].  `src` points at
// (b, 0, h, 0); consecutive rows are `rs` elements apart.  Rows at index
// >= S are zeros.  16-byte loads, neighbouring threads on neighbouring
// addresses.
template <typename T, int D, int LD, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long rs, int row0, int S,
                                           float mul, int tid) {
  constexpr int N = Vec<T>::N;
  constexpr int VPR = D / N;   // 16-byte loads per row
  for (int i = tid; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * N;
    float f[N];
    if (row0 + r < S) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (row0 + r) * rs + c);
      Vec<T>::unpack(raw, f);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; e += 4)
      *reinterpret_cast<float4*>(dst + r * LD + c + e) =
          make_float4(f[e] * mul, f[e + 1] * mul, f[e + 2] * mul,
                      f[e + 3] * mul);
  }
}

__device__ __forceinline__ bool key_ok(int kp, int qp, int S, int causal,
                                       int window) {
  return kp < S && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// ---------------------------------------------------------------------------
// Forward: grid (query tiles, Hq, B).  Thread (ty, tx) owns query rows
// ty*8 .. ty*8+7 of the tile; in the score phase keys tx + 16 j of the key
// tile, in the P.V phase output columns cg*64 + tx*4 .. +3.
// ---------------------------------------------------------------------------
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           float* __restrict__ lse, int S, int Hq, int Hkv, int causal,
           int window, float scale) {
  constexpr int LD = D + 4;        // f32 row stride of the staged tiles
  constexpr int LDP = kBQ + 4;     // row stride of the transposed P tile
  constexpr int KPT = BK / 16;     // keys a thread scores
  constexpr int CG = D / 64;       // groups of 4 output columns a thread owns
  static_assert(D % 64 == 0 && BK % 16 == 0, "tile shape");
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kBQ][LD], q * scale
  float* k_s = q_s + kBQ * LD;                     // [BK][LD]
  float* v_s = k_s + BK * LD;                      // [BK][LD]
  float* pt_s = v_s + BK * LD;                     // [BK][LDP], P transposed

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long q_rs = (long long)Hq * D, k_rs = (long long)Hkv * D;
  const long long q_base = (long long)b * S * q_rs + (long long)h * D;
  const long long k_base = (long long)b * S * k_rs + (long long)hk * D;

  stage_rows<T, D, LD, kBQ>(q_s, q + q_base, q_rs, q0, S, scale, tid);

  float m[8], l[8], acc[8][4 * CG];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) acc[i][c] = 0.f;
  }

  // live key tiles: below the diagonal (causal), inside the window
  const int k_hi = causal ? min(S, q0 + kBQ) : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile is consumed; q_s is ready
    stage_rows<T, D, LD, BK>(k_s, k + k_base, k_rs, k0, S, 1.f, tid);
    stage_rows<T, D, LD, BK>(v_s, v + k_base, k_rs, k0, S, 1.f, tid);
    __syncthreads();

    float s[8][KPT];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kf[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kf[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qf =
            *reinterpret_cast<const float4*>(q_s + (ty * 8 + i) * LD + d);
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
        }
      }
    }

    // online softmax; the 16 lanes of a row group share its rows
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qp = q0 + ty * 8 + i;
      bool ok[KPT];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        ok[j] = key_ok(k0 + tx + 16 * j, qp, S, causal, window);
        mx = fmaxf(mx, ok[j] ? s[i][j] : kNegInf);
      }
      mx = group16_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        // explicit mask: a row with no valid key yet has m_new == kNegInf
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        pt_s[(tx + 16 * j) * LDP + ty * 8 + i] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + ps;   // this lane's share of the row sum
#pragma unroll
      for (int c = 0; c < 4 * CG; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V: an outer product per key of the tile
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pa =
          *reinterpret_cast<const float4*>(pt_s + kk * LDP + ty * 8);
      const float4 pb =
          *reinterpret_cast<const float4*>(pt_s + kk * LDP + ty * 8 + 4);
      const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int cg = 0; cg < CG; ++cg) {
        const float4 vf = *reinterpret_cast<const float4*>(
            v_s + kk * LD + cg * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][cg * 4 + 0] = fmaf(p[i], vf.x, acc[i][cg * 4 + 0]);
          acc[i][cg * 4 + 1] = fmaf(p[i], vf.y, acc[i][cg * 4 + 1]);
          acc[i][cg * 4 + 2] = fmaf(p[i], vf.z, acc[i][cg * 4 + 2]);
          acc[i][cg * 4 + 3] = fmaf(p[i], vf.w, acc[i][cg * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float li = group16_sum(l[i]);
    const int row = q0 + ty * 8 + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    T* o = out + q_base + row * q_rs;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[cg * 64 + tx * 4 + e] = from_f32<T>(acc[i][cg * 4 + e] * inv);
    // a row with no valid key (none exists for rows < S) gets lse = +inf,
    // so the backward's P = exp(s - lse) is 0 there
    if (tx == 0)
      lse[((long long)b * Hq + h) * S + row] =
          li > 0.f ? m[i] + logf(li) : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// Backward 1: Dr[b, h, i] = sum_d dO[b, i, h, d] * o[b, i, h, d], one warp
// per (b, i, h) row in memory order.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ dr, long long rows, int S, int Hq) {
  const long long r = (long long)blockIdx.x * (kThreads / 32) +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float sum = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32)
    sum = fmaf(to_f32(dout[r * D + c]), to_f32(o[r * D + c]), sum);
  sum = warp_sum(sum);
  if (lane == 0) {
    const int h = static_cast<int>(r % Hq);
    const long long bi = r / Hq;   // b * S + i
    const long long b = bi / S, i = bi % S;
    dr[(b * Hq + h) * S + i] = sum;
  }
}

// ---------------------------------------------------------------------------
// Backward 2: dK, dV.  Grid (key tiles of BKV, Hkv, B).  For each of the G
// query heads of the KV head and each live query tile of 64 rows: the
// transposed scores and dP^T (thread (ty, tx): keys ty*4 .. +3, rows tx + 16
// j), then dV += P^T dO and dK += dS^T (q * scale) as outer products over
// the rows (thread: keys ty*4 .. +3, columns cg*64 + tx*4 .. +3).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dr,
            T* __restrict__ dk, T* __restrict__ dv, int S, int Hq, int Hkv,
            int causal, int window, float scale) {
  constexpr int BKV = 32;          // keys per block
  constexpr int LD = D + 4;
  constexpr int LDP = BKV + 4;     // row stride of the P / dS tiles
  constexpr int CG = D / 64;
  static_assert(D % 64 == 0, "tile shape");
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // [BKV][LD]
  float* v_s = k_s + BKV * LD;                     // [BKV][LD]
  float* q_s = v_s + BKV * LD;                     // [kBQ][LD], q * scale
  float* do_s = q_s + kBQ * LD;                    // [kBQ][LD]
  float* p_s = do_s + kBQ * LD;                    // [kBQ][LDP]
  float* ds_s = p_s + kBQ * LDP;                   // [kBQ][LDP]
  float* lse_s = ds_s + kBQ * LDP;                 // [kBQ]
  float* dr_s = lse_s + kBQ;                       // [kBQ]

  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long q_rs = (long long)Hq * D, k_rs = (long long)Hkv * D;
  const long long k_base = (long long)b * S * k_rs + (long long)hk * D;

  stage_rows<T, D, LD, BKV>(k_s, k + k_base, k_rs, k0, S, 1.f, tid);
  stage_rows<T, D, LD, BKV>(v_s, v + k_base, k_rs, k0, S, 1.f, tid);

  float dka[4][4 * CG], dva[4][4 * CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) {
      dka[i][c] = 0.f;
      dva[i][c] = 0.f;
    }

  // live query tiles: rows at or below the tile's keys (causal), rows whose
  // window still reaches them
  const int q_lo = causal ? (k0 / kBQ) * kBQ : 0;
  const int q_hi = window > 0 ? min(S, k0 + BKV - 1 + window) : S;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long q_base = (long long)b * S * q_rs + (long long)h * D;
    const float* lse_h = lse + ((long long)b * Hq + h) * S;
    const float* dr_h = dr + ((long long)b * Hq + h) * S;
    for (int q0 = q_lo; q0 < q_hi; q0 += kBQ) {
      __syncthreads();   // the previous tile is consumed; k_s/v_s are ready
      stage_rows<T, D, LD, kBQ>(q_s, q + q_base, q_rs, q0, S, scale, tid);
      stage_rows<T, D, LD, kBQ>(do_s, dout + q_base, q_rs, q0, S, 1.f, tid);
      for (int r = tid; r < kBQ; r += kThreads) {
        lse_s[r] = q0 + r < S ? lse_h[q0 + r] : 0.f;
        dr_s[r] = q0 + r < S ? dr_h[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = 0.f;
          dp[i][j] = 0.f;
        }
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 qf[4], gf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qf[j] = *reinterpret_cast<const float4*>(q_s + (tx + 16 * j) * LD + d);
          gf[j] =
              *reinterpret_cast<const float4*>(do_s + (tx + 16 * j) * LD + d);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 kf =
              *reinterpret_cast<const float4*>(k_s + (ty * 4 + i) * LD + d);
          const float4 vf =
              *reinterpret_cast<const float4*>(v_s + (ty * 4 + i) * LD + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kf.x, qf[j].x, s[i][j]);
            s[i][j] = fmaf(kf.y, qf[j].y, s[i][j]);
            s[i][j] = fmaf(kf.z, qf[j].z, s[i][j]);
            s[i][j] = fmaf(kf.w, qf[j].w, s[i][j]);
            dp[i][j] = fmaf(vf.x, gf[j].x, dp[i][j]);
            dp[i][j] = fmaf(vf.y, gf[j].y, dp[i][j]);
            dp[i][j] = fmaf(vf.z, gf[j].z, dp[i][j]);
            dp[i][j] = fmaf(vf.w, gf[j].w, dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, qp = q0 + r;
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok =
              qp < S && key_ok(k0 + ty * 4 + i, qp, S, causal, window);
          p[i] = ok ? expf(s[i][j] - lse_s[r]) : 0.f;
          ds[i] = p[i] * (dp[i][j] - dr_s[r]);
        }
        *reinterpret_cast<float4*>(p_s + r * LDP + ty * 4) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(ds_s + r * LDP + ty * 4) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();

#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        const float4 pf =
            *reinterpret_cast<const float4*>(p_s + r * LDP + ty * 4);
        const float4 sf =
            *reinterpret_cast<const float4*>(ds_s + r * LDP + ty * 4);
        const float pv[4] = {pf.x, pf.y, pf.z, pf.w};
        const float sv[4] = {sf.x, sf.y, sf.z, sf.w};
#pragma unroll
        for (int cg = 0; cg < CG; ++cg) {
          const float4 gf = *reinterpret_cast<const float4*>(
              do_s + r * LD + cg * 64 + tx * 4);
          const float4 qf = *reinterpret_cast<const float4*>(
              q_s + r * LD + cg * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][cg * 4 + 0] = fmaf(pv[i], gf.x, dva[i][cg * 4 + 0]);
            dva[i][cg * 4 + 1] = fmaf(pv[i], gf.y, dva[i][cg * 4 + 1]);
            dva[i][cg * 4 + 2] = fmaf(pv[i], gf.z, dva[i][cg * 4 + 2]);
            dva[i][cg * 4 + 3] = fmaf(pv[i], gf.w, dva[i][cg * 4 + 3]);
            dka[i][cg * 4 + 0] = fmaf(sv[i], qf.x, dka[i][cg * 4 + 0]);
            dka[i][cg * 4 + 1] = fmaf(sv[i], qf.y, dka[i][cg * 4 + 1]);
            dka[i][cg * 4 + 2] = fmaf(sv[i], qf.z, dka[i][cg * 4 + 2]);
            dka[i][cg * 4 + 3] = fmaf(sv[i], qf.w, dka[i][cg * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= S) continue;
    T* dko = dk + k_base + row * k_rs;
    T* dvo = dv + k_base + row * k_rs;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dko[cg * 64 + tx * 4 + e] = from_f32<T>(dka[i][cg * 4 + e]);
        dvo[cg * 64 + tx * 4 + e] = from_f32<T>(dva[i][cg * 4 + e]);
      }
  }
}

// ---------------------------------------------------------------------------
// Backward 3: dQ.  Grid (query tiles, Hq, B).  Thread (ty, tx): rows ty*8 ..
// +7; in the score phase keys tx + 16 j of the key tile, in the dS.K phase
// columns cg*64 + tx*4 .. +3.
// ---------------------------------------------------------------------------
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
fa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dr,
          T* __restrict__ dq, int S, int Hq, int Hkv, int causal, int window,
          float scale) {
  constexpr int LD = D + 4;
  constexpr int LDP = kBQ + 4;
  constexpr int KPT = BK / 16;
  constexpr int CG = D / 64;
  static_assert(D % 64 == 0 && BK % 16 == 0, "tile shape");
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kBQ][LD], q * scale
  float* do_s = q_s + kBQ * LD;                    // [kBQ][LD]
  float* k_s = do_s + kBQ * LD;                    // [BK][LD]
  float* v_s = k_s + BK * LD;                      // [BK][LD]
  float* dst_s = v_s + BK * LD;                    // [BK][LDP], dS transposed

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long q_rs = (long long)Hq * D, k_rs = (long long)Hkv * D;
  const long long q_base = (long long)b * S * q_rs + (long long)h * D;
  const long long k_base = (long long)b * S * k_rs + (long long)hk * D;

  stage_rows<T, D, LD, kBQ>(q_s, q + q_base, q_rs, q0, S, scale, tid);
  stage_rows<T, D, LD, kBQ>(do_s, dout + q_base, q_rs, q0, S, 1.f, tid);
  float lse_r[8], dr_r[8], acc[8][4 * CG];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty * 8 + i;
    const long long at = ((long long)b * Hq + h) * S + row;
    lse_r[i] = row < S ? lse[at] : 0.f;
    dr_r[i] = row < S ? dr[at] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) acc[i][c] = 0.f;
  }

  const int k_hi = causal ? min(S, q0 + kBQ) : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();
    stage_rows<T, D, LD, BK>(k_s, k + k_base, k_rs, k0, S, 1.f, tid);
    stage_rows<T, D, LD, BK>(v_s, v + k_base, k_rs, k0, S, 1.f, tid);
    __syncthreads();

    float s[8][KPT], dp[8][KPT];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kf[KPT], vf[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        kf[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * LD + d);
        vf[j] = *reinterpret_cast<const float4*>(v_s + (tx + 16 * j) * LD + d);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qf =
            *reinterpret_cast<const float4*>(q_s + (ty * 8 + i) * LD + d);
        const float4 gf =
            *reinterpret_cast<const float4*>(do_s + (ty * 8 + i) * LD + d);
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
          dp[i][j] = fmaf(gf.x, vf[j].x, dp[i][j]);
          dp[i][j] = fmaf(gf.y, vf[j].y, dp[i][j]);
          dp[i][j] = fmaf(gf.z, vf[j].z, dp[i][j]);
          dp[i][j] = fmaf(gf.w, vf[j].w, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qp = q0 + ty * 8 + i;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const bool ok =
            qp < S && key_ok(k0 + tx + 16 * j, qp, S, causal, window);
        const float p = ok ? expf(s[i][j] - lse_r[i]) : 0.f;
        dst_s[(tx + 16 * j) * LDP + ty * 8 + i] = p * (dp[i][j] - dr_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      const float4 da =
          *reinterpret_cast<const float4*>(dst_s + kk * LDP + ty * 8);
      const float4 db =
          *reinterpret_cast<const float4*>(dst_s + kk * LDP + ty * 8 + 4);
      const float ds[8] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
#pragma unroll
      for (int cg = 0; cg < CG; ++cg) {
        const float4 kf = *reinterpret_cast<const float4*>(
            k_s + kk * LD + cg * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][cg * 4 + 0] = fmaf(ds[i], kf.x, acc[i][cg * 4 + 0]);
          acc[i][cg * 4 + 1] = fmaf(ds[i], kf.y, acc[i][cg * 4 + 1]);
          acc[i][cg * 4 + 2] = fmaf(ds[i], kf.z, acc[i][cg * 4 + 2]);
          acc[i][cg * 4 + 3] = fmaf(ds[i], kf.w, acc[i][cg * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty * 8 + i;
    if (row >= S) continue;
    T* o = dq + q_base + row * q_rs;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[cg * 64 + tx * 4 + e] = from_f32<T>(acc[i][cg * 4 + e] * scale);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
constexpr int kFwdBK = 64;   // keys per tile, forward
constexpr int kDqBK = 32;    // keys per tile, dQ pass

template <typename T, int D>
constexpr int fwd_smem() {
  return ((kBQ + 2 * kFwdBK) * (D + 4) + kFwdBK * (kBQ + 4)) * 4;
}
template <typename T, int D>
constexpr int dkdv_smem() {
  return ((2 * 32 + 2 * kBQ) * (D + 4) + 2 * kBQ * (32 + 4) + 2 * kBQ) * 4;
}
template <typename T, int D>
constexpr int dq_smem() {
  return ((2 * kBQ + 2 * kDqBK) * (D + 4) + kDqBK * (kBQ + 4)) * 4;
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

float scale_of(int D) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int S, int Hq, int Hkv, int causal,
               int window, cudaStream_t st) {
  auto kern = fa_fwd_kernel<T, D, kFwdBK>;
  constexpr int smem = fwd_smem<T, D>();
  int rc = set_smem(kern, smem);
  if (rc != 0) return rc;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), S, Hq, Hkv, causal, window, scale_of(D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* dr, void* dq,
               void* dk, void* dv, int B, int S, int Hq, int Hkv, int causal,
               int window, cudaStream_t st) {
  const long long rows = (long long)B * S * Hq;
  const int rows_per_block = kThreads / 32;
  const unsigned int n_blocks =
      static_cast<unsigned int>((rows + rows_per_block - 1) / rows_per_block);
  fa_rowdot_kernel<T, D><<<n_blocks, kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(dr), rows, S, Hq);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  auto kv_kern = fa_dkdv_kernel<T, D>;
  constexpr int kv_smem = dkdv_smem<T, D>();
  rc = set_smem(kv_kern, kv_smem);
  if (rc != 0) return rc;
  kv_kern<<<dim3((S + 31) / 32, Hkv, B), kThreads, kv_smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), S, Hq, Hkv, causal, window,
      scale_of(D));
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  auto q_kern = fa_dq_kernel<T, D, kDqBK>;
  constexpr int q_smem = dq_smem<T, D>();
  rc = set_smem(q_kern, q_smem);
  if (rc != 0) return rc;
  q_kern<<<dim3((S + kBQ - 1) / kBQ, Hq, B), kThreads, q_smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dr),
      static_cast<T*>(dq), S, Hq, Hkv, causal, window, scale_of(D));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  D: 64 or 128.  q/out (B, S, Hq, D),
// k/v (B, S, Hkv, D) dense; lse (B, Hq, S) f32.  Hq % Hkv == 0.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* out, void* lse, int B, int S,
                        int Hq, int Hkv, int D, int causal, int window,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    return launch_fwd<__nv_bfloat16, 128>(q, k, v, out, lse, B, S, Hq, Hkv,
                                          causal, window, st);
  if (dtype == 1 && D == 64)
    return launch_fwd<__nv_bfloat16, 64>(q, k, v, out, lse, B, S, Hq, Hkv,
                                         causal, window, st);
  if (dtype == 0 && D == 128)
    return launch_fwd<float, 128>(q, k, v, out, lse, B, S, Hq, Hkv, causal,
                                  window, st);
  if (dtype == 0 && D == 64)
    return launch_fwd<float, 64>(q, k, v, out, lse, B, S, Hq, Hkv, causal,
                                 window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward's tensors, dout (B, S, Hq, D) dense, dr (B, Hq, S) f32
// scratch; writes dq (B, S, Hq, D) and dk/dv (B, S, Hkv, D) in the input
// type.
int flash_attention_bwd(int dtype, const void* q, const void* k,
                        const void* v, const void* o, const void* dout,
                        const void* lse, void* dr, void* dq, void* dk,
                        void* dv, int B, int S, int Hq, int Hkv, int D,
                        int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    return launch_bwd<__nv_bfloat16, 128>(q, k, v, o, dout, lse, dr, dq, dk,
                                          dv, B, S, Hq, Hkv, causal, window,
                                          st);
  if (dtype == 1 && D == 64)
    return launch_bwd<__nv_bfloat16, 64>(q, k, v, o, dout, lse, dr, dq, dk,
                                         dv, B, S, Hq, Hkv, causal, window,
                                         st);
  if (dtype == 0 && D == 128)
    return launch_bwd<float, 128>(q, k, v, o, dout, lse, dr, dq, dk, dv, B,
                                  S, Hq, Hkv, causal, window, st);
  if (dtype == 0 && D == 64)
    return launch_bwd<float, 64>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, S,
                                 Hq, Hkv, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
