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
//   q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), dense, of one type T (f32 or
//   bf16); query head h reads KV head h / (Hq / Hkv) in place (GQA, no
//   repeat copy).  Query row i < Sq attends key j when
//       j < Skv, (causal ? j <= i : true), (window > 0 ? j > i - window : true)
//   (index masks: the caller's positions are 0..S-1).  Skv may differ from
//   Sq only with causal == 0 and window == 0 (cross-attention: every key
//   visible); the causal and window paths take Sq == Skv.  Scores q . k *
//   scale (scale = D^-1/2) in f32, online softmax (m, l, acc) in f32, l
//   floored at 1e-30, output in T.  The forward also writes each row's
//   log-sum-exp lse = m + log(l) in f32 (B, Hq, Sq), which the backward
//   reads to rebuild P = exp(s - lse).  Any Sq and Skv: the last tile of
//   rows is masked by Sq, the last tile of keys by Skv (the TPU kernel
//   asserts one S, S % block == 0).
//
// Backward, from (q, k, v, o, lse, dO):
//   Dr = rowsum(dO * o)                 (f32, one warp per row)
//   P  = exp(q . k * scale - lse),  dP = dO . v,  dS = P * (dP - Dr)
//   dV = P^T dO,  dK = scale * dS^T q,  dQ = scale * dS K
// in three kernels: the row sums; one pass per KV tile that loops over the
// G query heads sharing the tile and over their query tiles, so dK/dV sum
// the group in registers without atomics; one pass per query tile for dQ.
// Accumulation in f32; dQ, dK, dV written in T.  The launcher dispatches on
// the type: bf16 goes to the tensor-core kernels, f32 to the CUDA-core
// kernels, and nothing else is taken.  Query tiles run over Sq, key tiles
// over Skv: the dK/dV pass loops over ceil(Sq / 64) query tiles for each
// key tile, the dQ pass over ceil(Skv / 64) key tiles; lse, Dr and dQ are
// sized by Sq, dK and dV by Skv.
//
// Bound on the H100: operations.  A causal forward at the training shape
// (B 4, S 2048, Hq 16, D 128) does 4 * B * Hq * D * S (S + 1) / 2 = 68.75
// GFLOP, 0.0695 ms at 989 TFLOP/s bf16, against 50 MB of bytes (0.015 ms
// at 3.35 TB/s); the backward does 2.5 times the forward's operations,
// 0.174 ms.
//
// bf16: the tensor-core kernels (fa_*_wgmma_kernel).  One warpgroup (128
// threads) a block, tiles of 64 query rows and 64 keys.  What holds a
// CUDA-core design back, and what this one does about it:
//   1. Products on the tensor cores: every product is a wgmma (sm_90a),
//      f32 accumulation.  S = Q K^T (and S^T = K Q^T, dP = dO V^T, dP^T =
//      V dO^T) reads both operands from shared memory, K-major, m64n64k16;
//      `scale` multiplies the f32 sum afterwards (D^-1/2 is no power of
//      two, so q * scale in bf16 would round).  P V, P^T dO, dS^T q and
//      dS K take P (or dS) from registers as the A operand -- the f32
//      accumulator of the score product is laid out as wgmma's A fragment
//      -- and the other tile from shared memory, MN-major (read
//      transposed), m64n64k16 on one 64-column block of D at a time.
//      Rounding P or dS once to bf16 would compute a less exact function
//      (an error of about 2^-9 of the output's scale, beyond the 2^-8-of-
//      each-element limit the checks hold), so each is split exactly,
//      x = hi + lo with both in bf16 (x to 16 significant bits), and both
//      parts are issued into the same f32 accumulator: 1.5 times the
//      forward's tensor work, 10/6 times the backward's.
//   2. Tiles staged in bf16, as loaded: 64 rows x D in D / 64 column blocks
//      of 128-byte rows, 16-byte chunks swizzled (chunk c of row r at
//      c ^ (r % 8)), wgmma's 128-byte swizzle.  Shared memory at D 128:
//      forward 82,944 bytes (Q and two K/V stages), dK/dV pass 100,352, dQ
//      pass 99,328: two blocks (eight warps) an SM.
//   3. Asynchronous loads: cp.async with zero-fill past S, into a ring of
//      two stages: the forward and the dQ pass stream K/V tiles, the dK/dV
//      pass keeps its K/V tile and streams (Q, dO, lse, Dr); the next
//      tile's load is issued before the current tile's products.  cp.async
//      and not TMA: the swizzle is written by hand, and no tensor map or
//      driver entry point is needed.  A fence.proxy.async makes the copies
//      visible to wgmma's reads.
//   Key tiles wholly above the diagonal or outside the window are skipped;
//   only tiles that hold a masked pair (diagonal, window edge, ragged tail)
//   evaluate the mask.  The grid puts the tile index on its slowest axis
//   and starts with the longest causal rows (the forward and dQ pass with
//   the last query tile, the dK/dV pass with the first key tile).
//   Each second product is summed on the tensor cores one tile (64 rows
//   of T) at a time and added to its accumulator in f32 on the CUDA cores
//   (gemm_split_add): one wgmma accumulator carried along a whole causal
//   row drifted beyond the limit.
//   ptxas (-Xptxas -v, CUDA 12.9, sm_90a), registers at D 128 / D 64, and
//   the dynamic shared memory: fa_fwd_wgmma_kernel 220 / 170, no spills,
//   82,944 / 41,984 bytes (D 256: 225, no spills, 132,096 bytes, two
//   blocks a head, each with half of the output's columns);
//   fa_dkdv_wgmma_kernel 255 with 116 bytes of spill stores and loads (68
//   before Sq and Skv were split) / 226, no spills, 100,352 / 51,200
//   bytes; fa_dq_wgmma_kernel 199 / 143, no spills, 99,328 / 50,176
//   bytes; fa_rowdot_kernel 24.
//
// Head dim 80 (zamba2's shared block).  Every kernel, forward and
// backward, computes on tiles of D 128 and reads the tensors' rows of DG
// 80: the 10 real 16-byte chunks of a row are loaded (cp.async, or the f32
// kernels' 16-byte loads), the 6 past them are zeros read from nowhere,
// the output (dQ, dK, dV) columns past 80 are never written, and the
// softmax scale is 1/sqrt(80).  Bytes stay D 80's; the products pay 128 /
// 80 = 1.6 times (a 64 + 16 split of the K-major blocks and m64n80k16 for
// P V would not, a later redesign).
//
// Head dim 256 (gemma3), bf16: two blocks a head in every kernel, each
// with half of the output's columns (fwd_cols), the scores (S, dP)
// recomputed by both over the whole of D: the forward's output, the dK/dV
// pass's dK and dV, the dQ pass's dQ.  A thread then holds 128
// accumulators, as at D 128; the whole 256 columns of dK and dV would be
// 256 registers before S and dP.  The tiles are twice D 128's: 198,656
// bytes of shared memory in the dK/dV pass, 197,632 in the dQ pass (one
// block an SM).  The f32 kernels take D 256 whole.
//
// Position masks (every kernel, a second instantiation: POS = true).
// Given q_pos (B, Sq) and k_pos (B, Skv) int32, the masks are the JAX
// reference's full_attention masks (src/repro/models/layers.py:150) instead
// of the index ones: key j visible to row i when
//     k_pos[j] >= 0, (causal ? k_pos[j] <= q_pos[i] : true),
//     (window > 0 ? k_pos[j] > q_pos[i] - window : true)
// for any Sq and Skv (Qwen2-VL's image patches share one temporal
// position, so a key after the query by index can be visible; a packed row
// restarts its positions and pads at -1).  No tile can be skipped by its
// index: every key tile is visited and every score masked element by
// element.  A masked score is the reference's finite -1e30, not -inf, so a
// row that sees no key (a pad query at -1) gets what the reference gives
// it, uniform weights: the mean of V over all Skv keys, and an lse near
// -1e30 (the base-2 kernels start m at that value, so such a row's
// exp2(x - m) is exactly 1).  The backward reads such a row from its lse
// (below kEmptyLse): its P is 1 / Skv on every key, which dV takes, and
// its dS is 0, as the reference's where() passes no gradient to a masked
// score; every other masked pair has P = dS = 0.  The index kernels
// (POS = false, null position pointers) are unchanged.
//
// f32: the CUDA-core kernels (fa_fwd_kernel, fa_dkdv_kernel, fa_dq_kernel),
// the design of the first port, kept for f32 alone: tensor cores would
// mean TF32, which the f32 card-against-CPU training check cannot take.
// 128 threads a block; tiles of q/k/v/dO rows staged in shared memory as
// f32 rows of D + 4 words; score tiles are register-blocked FMA dot
// products, P.V and P^T.dO register-blocked outer products; synchronous
// loads.  q is multiplied by scale in f32 as it is staged.

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

// 16 bytes of T as f32 (the CUDA-core kernels take f32 alone)
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

// Stage rows [row0, row0 + ROWS) of one head of a (B, S, H, DG) tensor
// into shared memory as f32 times `mul`: dst[r * LD + d], D columns.
// `src` points at (b, 0, h, 0); consecutive rows are `rs` elements apart.
// Rows at index >= S, and the columns past DG (DG < D: head dim 80 on
// tiles of 128), are zeros.  16-byte loads, neighbouring threads on
// neighbouring addresses.
template <typename T, int D, int LD, int ROWS, int DG = D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long rs, int row0, int S,
                                           float mul, int tid) {
  constexpr int N = Vec<T>::N;
  constexpr int VPR = D / N;   // 16-byte loads per row
  static_assert(DG <= D && DG % N == 0, "rows of whole loads");
  // at D 256 the loads' offsets, invariant in the caller's loop over key
  // tiles, would be hoisted out of it and held (the f32 forward then
  // spilled at 255 registers), as in load_tile
  if constexpr (D > 128) asm volatile("" : "+r"(tid));
  for (int i = tid; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * N;
    float f[N];
    if (row0 + r < S && (DG == D || c < DG)) {
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

// key kp visible to query row qp (Skv: the keys' length)
__device__ __forceinline__ bool key_ok(int kp, int qp, int Skv, int causal,
                                       int window) {
  return kp < Skv && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// key position kp visible to query position qp (the position masks)
__device__ __forceinline__ bool pos_ok(int kp, int qp, int causal,
                                       int window) {
  return kp >= 0 && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}
// a row's lse below this saw no key (the position masks' uniform row)
constexpr float kEmptyLse = 0.5f * kNegInf;
// row r's position, -1 past the rows (never read there)
__device__ __forceinline__ int pos_at(const int* __restrict__ pos, int r,
                                      int n) {
  return r < n ? __ldg(pos + r) : -1;
}

// ---------------------------------------------------------------------------
// f32 forward: grid (query tiles, Hq, B).  Thread (ty, tx) owns query rows
// ty*8 .. ty*8+7 of the tile; in the score phase keys tx + 16 j of the key
// tile, in the P.V phase output columns cg*64 + tx*4 .. +3.
// ---------------------------------------------------------------------------
// D is the width the block computes on, DG the tensors' head dim (DG < D:
// the columns past DG are zeros and never written); POS: the position
// masks from q_pos/k_pos (else null, unread)
template <typename T, int D, int BK, int DG = D, bool POS = false>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           float* __restrict__ lse, const int* __restrict__ q_pos,
           const int* __restrict__ k_pos, int Sq, int Skv, int Hq, int Hkv,
           int causal, int window, float scale) {
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
  const long long q_rs = (long long)Hq * DG, k_rs = (long long)Hkv * DG;
  const long long q_base = (long long)b * Sq * q_rs + (long long)h * DG;
  const long long k_base = (long long)b * Skv * k_rs + (long long)hk * DG;

  stage_rows<T, D, LD, kBQ, DG>(q_s, q + q_base, q_rs, q0, Sq, scale, tid);

  float m[8], l[8], acc[8][4 * CG];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) acc[i][c] = 0.f;
  }

  // live key tiles: below the diagonal (causal), inside the window; with
  // positions every tile
  const int k_hi = causal && !POS ? min(Skv, q0 + kBQ) : Skv;
  const int k_lo = window > 0 && !POS ? max(0, q0 - window + 1) : 0;
  const int* qp_b = POS ? q_pos + (long long)b * Sq : nullptr;
  const int* kp_b = POS ? k_pos + (long long)b * Skv : nullptr;
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile is consumed; q_s is ready
    stage_rows<T, D, LD, BK, DG>(k_s, k + k_base, k_rs, k0, Skv, 1.f, tid);
    stage_rows<T, D, LD, BK, DG>(v_s, v + k_base, k_rs, k0, Skv, 1.f, tid);
    // the position masks of this thread's 8 rows x KPT keys, bit i KPT + j,
    // folded before the products: one register stays live across them (the
    // positions themselves spilled the D 80 forward)
    uint32_t vis = 0u;
    if constexpr (POS) {
      static_assert(8 * KPT <= 32, "one bit a pair");
      int kpos[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kpos[j] = pos_at(kp_b, k0 + tx + 16 * j, Skv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qpos = pos_at(qp_b, q0 + ty * 8 + i, Sq);
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          if (pos_ok(kpos[j], qpos, causal, window)) vis |= 1u << (i * KPT + j);
      }
    }
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
        if constexpr (POS) {
          // every key in range is weighed; a masked one holds the
          // reference's finite score, weight 1 in a row that sees no key
          ok[j] = k0 + tx + 16 * j < Skv;
          if (!((vis >> (i * KPT + j)) & 1u)) s[i][j] = kNegInf;
        } else {
          ok[j] = key_ok(k0 + tx + 16 * j, qp, Skv, causal, window);
        }
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
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    T* o = out + q_base + row * q_rs;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (DG == D || cg * 64 + tx * 4 + e < DG)
          o[cg * 64 + tx * 4 + e] = from_f32<T>(acc[i][cg * 4 + e] * inv);
    // a row with no valid key (none exists for rows < Sq) gets lse = +inf,
    // so the backward's P = exp(s - lse) is 0 there
    if (tx == 0)
      lse[((long long)b * Hq + h) * Sq + row] =
          li > 0.f ? m[i] + logf(li) : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// Backward 1, either type: Dr[b, h, i] = sum_d dO[b, i, h, d] * o[b, i, h,
// d], one warp per (b, i, h) row in memory order (S: the queries' length).
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
// f32 backward 2: dK, dV.  Grid (key tiles of BKV, Hkv, B).  For each of the G
// query heads of the KV head and each live query tile of 64 rows: the
// transposed scores and dP^T (thread (ty, tx): keys ty*4 .. +3, rows tx + 16
// j), then dV += P^T dO and dK += dS^T (q * scale) as outer products over
// the rows (thread: keys ty*4 .. +3, columns cg*64 + tx*4 .. +3).
// ---------------------------------------------------------------------------
template <typename T, int D, int DG = D, bool POS = false>
__global__ void __launch_bounds__(kThreads)
fa_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dr,
            T* __restrict__ dk, T* __restrict__ dv,
            const int* __restrict__ q_pos, const int* __restrict__ k_pos,
            int Sq, int Skv, int Hq, int Hkv, int causal, int window,
            float scale) {
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
  const long long q_rs = (long long)Hq * DG, k_rs = (long long)Hkv * DG;
  const long long k_base = (long long)b * Skv * k_rs + (long long)hk * DG;

  stage_rows<T, D, LD, BKV, DG>(k_s, k + k_base, k_rs, k0, Skv, 1.f, tid);
  stage_rows<T, D, LD, BKV, DG>(v_s, v + k_base, k_rs, k0, Skv, 1.f, tid);

  float dka[4][4 * CG], dva[4][4 * CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) {
      dka[i][c] = 0.f;
      dva[i][c] = 0.f;
    }

  // live query tiles: rows at or below the tile's keys (causal), rows whose
  // window still reaches them; with positions every tile
  const int q_lo = causal && !POS ? (k0 / kBQ) * kBQ : 0;
  const int q_hi = window > 0 && !POS ? min(Sq, k0 + BKV - 1 + window) : Sq;
  const int* qp_b = POS ? q_pos + (long long)b * Sq : nullptr;
  int kpos[4];
  if constexpr (POS) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      kpos[i] = pos_at(k_pos + (long long)b * Skv, k0 + ty * 4 + i, Skv);
  }
  const float inv_skv = 1.f / Skv;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long q_base = (long long)b * Sq * q_rs + (long long)h * DG;
    const float* lse_h = lse + ((long long)b * Hq + h) * Sq;
    const float* dr_h = dr + ((long long)b * Hq + h) * Sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += kBQ) {
      __syncthreads();   // the previous tile is consumed; k_s/v_s are ready
      stage_rows<T, D, LD, kBQ, DG>(q_s, q + q_base, q_rs, q0, Sq, scale,
                                    tid);
      stage_rows<T, D, LD, kBQ, DG>(do_s, dout + q_base, q_rs, q0, Sq, 1.f,
                                    tid);
      for (int r = tid; r < kBQ; r += kThreads) {
        lse_s[r] = q0 + r < Sq ? lse_h[q0 + r] : 0.f;
        dr_s[r] = q0 + r < Sq ? dr_h[q0 + r] : 0.f;
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
          if constexpr (POS) {
            const bool in = qp < Sq && k0 + ty * 4 + i < Skv;
            const bool ok =
                in && pos_ok(kpos[i], pos_at(qp_b, qp, Sq), causal, window);
            // a row that saw no key weighs every key 1 / Skv, in dV alone
            p[i] = ok ? expf(s[i][j] - lse_s[r])
                      : (in && lse_s[r] < kEmptyLse ? inv_skv : 0.f);
            ds[i] = ok ? p[i] * (dp[i][j] - dr_s[r]) : 0.f;
          } else {
            const bool ok =
                qp < Sq && key_ok(k0 + ty * 4 + i, qp, Skv, causal, window);
            p[i] = ok ? expf(s[i][j] - lse_s[r]) : 0.f;
            ds[i] = p[i] * (dp[i][j] - dr_s[r]);
          }
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
    if (row >= Skv) continue;
    T* dko = dk + k_base + row * k_rs;
    T* dvo = dv + k_base + row * k_rs;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (DG < D && cg * 64 + tx * 4 + e >= DG) continue;
        dko[cg * 64 + tx * 4 + e] = from_f32<T>(dka[i][cg * 4 + e]);
        dvo[cg * 64 + tx * 4 + e] = from_f32<T>(dva[i][cg * 4 + e]);
      }
  }
}

// ---------------------------------------------------------------------------
// f32 backward 3: dQ.  Grid (query tiles, Hq, B).  Thread (ty, tx): rows
// ty*8 .. +7; in the score phase keys tx + 16 j of the key tile, in the
// dS.K phase columns cg*64 + tx*4 .. +3.
// ---------------------------------------------------------------------------
template <typename T, int D, int BK, int DG = D, bool POS = false>
__global__ void __launch_bounds__(kThreads)
fa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dr,
          T* __restrict__ dq, const int* __restrict__ q_pos,
          const int* __restrict__ k_pos, int Sq, int Skv, int Hq, int Hkv,
          int causal, int window, float scale) {
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
  const long long q_rs = (long long)Hq * DG, k_rs = (long long)Hkv * DG;
  const long long q_base = (long long)b * Sq * q_rs + (long long)h * DG;
  const long long k_base = (long long)b * Skv * k_rs + (long long)hk * DG;

  stage_rows<T, D, LD, kBQ, DG>(q_s, q + q_base, q_rs, q0, Sq, scale, tid);
  stage_rows<T, D, LD, kBQ, DG>(do_s, dout + q_base, q_rs, q0, Sq, 1.f,
                                tid);
  float lse_r[8], dr_r[8], acc[8][4 * CG];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty * 8 + i;
    const long long at = ((long long)b * Hq + h) * Sq + row;
    lse_r[i] = row < Sq ? lse[at] : 0.f;
    dr_r[i] = row < Sq ? dr[at] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) acc[i][c] = 0.f;
  }

  const int k_hi = causal && !POS ? min(Skv, q0 + kBQ) : Skv;
  const int k_lo = window > 0 && !POS ? max(0, q0 - window + 1) : 0;
  const int* qp_b = POS ? q_pos + (long long)b * Sq : nullptr;
  const int* kp_b = POS ? k_pos + (long long)b * Skv : nullptr;
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();
    stage_rows<T, D, LD, BK, DG>(k_s, k + k_base, k_rs, k0, Skv, 1.f, tid);
    stage_rows<T, D, LD, BK, DG>(v_s, v + k_base, k_rs, k0, Skv, 1.f, tid);
    int kpos[KPT];
    if constexpr (POS) {
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kpos[j] = pos_at(kp_b, k0 + tx + 16 * j, Skv);
    }
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
        bool ok;
        if constexpr (POS)
          ok = qp < Sq && k0 + tx + 16 * j < Skv &&
               pos_ok(kpos[j], pos_at(qp_b, qp, Sq), causal, window);
        else
          ok = qp < Sq && key_ok(k0 + tx + 16 * j, qp, Skv, causal, window);
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
    if (row >= Sq) continue;
    T* o = dq + q_base + row * q_rs;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (DG == D || cg * 64 + tx * 4 + e < DG)
          o[cg * 64 + tx * 4 + e] = from_f32<T>(acc[i][cg * 4 + e] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: shared helpers
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kWG = 128;           // one warpgroup a block
constexpr int kTile = 64;          // query rows and keys a tile
constexpr uint32_t kAtom = 1024;   // 8 swizzled rows of 128 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the reference's masked score -1e30 in the base-2 kernels' units, and the
// start of their running maximum under the position masks
constexpr float kMask2 = kNegInf * kLog2e;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// the first 1024-byte boundary of dynamic shared memory (swizzle atoms)
__device__ __forceinline__ uint32_t smem_base(const void* p) {
  return (smem_u32(p) + kAtom - 1) & ~(kAtom - 1);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (no read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes, zeros when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// this thread's cp.async writes, visible to the async proxy wgmma reads by
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (given in bytes, encoded in 16-byte units)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}
// A 64-row tile as load_tile writes it, as a K-major operand (rows are M or
// N, the D axis is K), at k-step kk (16 columns): within a column block the
// step moves the start by 32 bytes, the swizzle is applied to the address
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return gmma_desc(tile + (kk >> 2) * (kTile * 128) + (kk & 3) * 32, 16,
                   kAtom);
}
// One 64-column block of the same tile as an MN-major B operand (rows are
// K, the block's 64 columns are N, read transposed), at k-step kk (16
// rows): groups of 8 rows are 1024 bytes apart (stride offset); the leading
// offset, the distance to a next column block, is kTile * 128 bytes
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 16 * 128, kTile * 128, kAtom);
}

// Rows [row0, row0 + kTile) of one head of a (B, S, H, DG) bf16 tensor
// into the swizzled tile at `dst` (1024-byte aligned): D / 64 column
// blocks of kTile rows of 128 bytes; the 16-byte chunk c of row r sits at
// chunk c ^ (r % 8), wgmma's 128-byte swizzle.  `src` points at (b, 0, h,
// 0); rows are `rs` elements apart; rows >= S, and the chunks past DG
// (DG < D: head dim 80 on tiles of 128), are zeros, read from nowhere.
template <int D, int DG = D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long rs, int row0, int S,
                                          int tid) {
  constexpr int CPR = D / 8;   // 16-byte chunks a row
  static_assert(DG <= D && DG % 8 == 0, "rows of whole chunks");
  static_assert((kTile * CPR) % kWG == 0, "tile / threads");
  // at D 256 the 16 chunks' offsets, invariant in the caller's loop over
  // tiles, would be hoisted out of it and held (the forward then spilled
  // at 255 registers; with the thread index opaque here, 220 and none)
  if constexpr (D > 128) asm volatile("" : "+r"(tid));
#pragma unroll
  for (int it = 0; it < kTile * CPR / kWG; ++it) {
    const int i = tid + it * kWG;
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < S && (DG == D || c < DG / 8);
    cp_async16(dst + (c >> 3) * (kTile * 128) + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               src + (ok ? (row0 + r) * rs + c * 8 : 0), ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // a in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}
// (a, b) = hi + lo, both bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// the wgmma shapes the kernels use
// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared
// memory; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers, B MN-major in
// shared memory (read transposed); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// s (=) A . B^T over D, A and B two 64-row tiles (64 x 64 f32 result)
template <int D>
__device__ __forceinline__ void gemm_abt(float (&s)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, desc_kmajor(a, kk), desc_kmajor(b, kk), kk > 0 ? 1 : 0);
}

// The wgmma A fragments of a 64 x 64 f32 accumulator x, split into bf16
// hi + lo.  Thread (warp w, lane l) holds x[4 j + 2 i + e] at row 16 w +
// l / 4 + 8 i, column 8 j + 2 (l % 4) + e; fragment register r of k-step
// kk (columns 16 kk .. +15) is the pair x[8 kk + 2 r], x[8 kk + 2 r + 1].
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r],
                 lo[kk][r]);
}

// acc = acc * alpha(row) + X . T: X (64 x 64) as its split fragments, T a
// 64-row tile (64 x D).  For each 64-column block of T the product is
// summed on the tensor cores from zero, over these 64 rows of T alone, and
// then added to acc on the CUDA cores in f32, rounded to nearest.  Carried
// in one wgmma accumulator over every query row, the dK and dV rows of the
// first keys of a causal sequence drifted: at B 4, S 2048, Hq 16, Hkv 8,
// D 128 on the H100, dK read 1.12 of the gradient limit; a tile at a time,
// 0.99 (the output's own rounding).
template <int D>
__device__ __forceinline__ void gemm_split_add(float (&acc)[D / 2],
                                               const uint32_t (&hi)[4][4],
                                               const uint32_t (&lo)[4][4],
                                               uint32_t t, float alpha0,
                                               float alpha1) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
    float part[32];   // overwritten by the first product (scale_d 0)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_mnmajor(t + cb * (kTile * 128), kk);
      wgmma_rs(part, hi[kk], db, kk > 0 ? 1 : 0);
      wgmma_rs(part, lo[kk], db, 1);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(part);
    // part[4 j + 2 i + e] is acc[32 cb + 4 j + 2 i + e]: row half i
#pragma unroll
    for (int x = 0; x < 32; ++x)
      acc[32 * cb + x] =
          fmaf(acc[32 * cb + x], (x & 2) ? alpha1 : alpha0, part[x]);
  }
}

// true when some (row, key) pair of the two tiles is masked
__device__ __forceinline__ bool tile_edge(int q0, int k0, int Sq, int Skv,
                                          int causal, int window) {
  return q0 + kTile > Sq || k0 + kTile > Skv ||
         (causal && k0 + kTile - 1 > q0) ||
         (window > 0 && k0 <= q0 + kTile - 1 - window);
}

// The position masks of the 16 columns a thread holds in a 64 x 64 score
// tile (columns 8 j + c0 + e, bit 2 j + e) against its two rows (i):
// vis[i] the visible pairs, in the columns inside [0, n).  `col_pos` reads
// the position of column c (-1 past n), `row_pos` holds the rows'; the
// rows are queries and the columns keys, or (KEY_ROWS: the dK/dV pass's
// transposed tile) the other way round.  The positions are read once
// each and folded into bits, so nothing of them stays live across the
// softmax.
template <bool KEY_ROWS, typename ColPos>
__device__ __forceinline__ void pos_bits(ColPos col_pos, int c_first, int n,
                                         const int (&row_pos)[2], int c0,
                                         int causal, int window,
                                         uint32_t (&vis)[2], uint32_t& in) {
  vis[0] = vis[1] = in = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c_first + 8 * j + c0 + e;
      const int cp = col_pos(c);
      const uint32_t bit = 1u << (2 * j + e);
      if (c < n) in |= bit;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (KEY_ROWS ? pos_ok(row_pos[i], cp, causal, window)
                     : pos_ok(cp, row_pos[i], causal, window))
          vis[i] |= bit;
    }
}

// ---------------------------------------------------------------------------
// bf16 forward: grid (Hq x D / DO, B, query tiles), the last query tile
// first.  A block computes the output columns [c * DO, (c + 1) * DO) of
// its head, c = blockIdx.x % (D / DO): all of D up to D 128; at D 256 two
// blocks share a head, each with all of S (the scores are recomputed) and
// half of the output, since the whole row of 256 f32 a thread (128
// registers beside S and P's fragments) would spill.  Thread (warp w, lane
// l) owns rows q0 + 16 w + l / 4 (+ 8) and, of each 8-column block of S
// and of the output, columns 2 (l % 4) and + 1.  Shared memory: Q, then
// two stages of (K, the block's DO columns of V).
// ---------------------------------------------------------------------------
template <int D>
__host__ __device__ constexpr int fwd_cols() {
  return D > 128 ? D / 2 : D;
}

// D is the width the block computes on, DG the tensors' head dim (DG < D:
// zero columns past DG, never written)
template <int D, int DG = D, bool POS = false>
__global__ void __launch_bounds__(kWG, 2)
fa_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos, int Sq, int Skv, int Hq,
                    int Hkv, int causal, int window, float scale_log2) {
  constexpr int DO = fwd_cols<D>(), NC = D / DO;
  constexpr uint32_t T = kTile * D * 2;     // bytes of a Q or K tile
  constexpr uint32_t TV = kTile * DO * 2;   // bytes of a V tile
  extern __shared__ uint8_t smem[];
  const uint32_t s_q = smem_base(smem);
  const int h = blockIdx.x / NC, cb = blockIdx.x % NC, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = q0 + (tid >> 5) * 16 + (lane >> 2);
  const int c0 = (lane & 3) * 2;
  const long long q_rs = (long long)Hq * DG, k_rs = (long long)Hkv * DG;
  const long long q_base = (long long)b * Sq * q_rs + (long long)h * DG;
  const long long k_base = (long long)b * Skv * k_rs + (long long)hk * DG;
  // the real columns of the block's DO columns of V (DG < D: one block)
  constexpr int DOG = DO - (D - DG);

  // live key tiles: below the diagonal (causal), inside the window; with
  // positions every tile
  const int k_hi = causal && !POS ? min(Skv, q0 + kTile) : Skv;
  const int k_lo = window > 0 && !POS ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kTile, t_hi = (k_hi + kTile - 1) / kTile;
  const int* kp_b = POS ? k_pos + (long long)b * Skv : nullptr;
  int rpos[2] = {0, 0};
  if constexpr (POS) {
    rpos[0] = pos_at(q_pos + (long long)b * Sq, row, Sq);
    rpos[1] = pos_at(q_pos + (long long)b * Sq, row + 8, Sq);
  }

  const bf16* v_cols = v + k_base + cb * DO;
  load_tile<D, DG>(s_q, q + q_base, q_rs, q0, Sq, tid);
  load_tile<D, DG>(s_q + T, k + k_base, k_rs, t_lo * kTile, Skv, tid);
  load_tile<DO, DOG>(s_q + 2 * T, v_cols, k_rs, t_lo * kTile, Skv, tid);
  cp_async_commit();

  // the position masks start at the masked score, so that a row that sees
  // no key weighs each key exp2(0) = 1
  constexpr float kStart = POS ? kMask2 : kNegInf;
  float o[DO / 2], m[2] = {kStart, kStart}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) o[i] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const uint32_t s_k = s_q + T + ((t - t_lo) & 1) * (T + TV);
    const uint32_t s_v = s_k + T;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();   // tile t has landed; tile t - 1's stage is free
    if (t + 1 < t_hi) {
      const uint32_t n_k = s_q + T + ((t + 1 - t_lo) & 1) * (T + TV);
      load_tile<D, DG>(n_k, k + k_base, k_rs, (t + 1) * kTile, Skv, tid);
      load_tile<DO, DOG>(n_k + T, v_cols, k_rs, (t + 1) * kTile, Skv, tid);
    }
    cp_async_commit();

    // scores of this tile alone: not carried, overwritten by the first
    // product (scale_d 0), dead while P V runs
    float s[32];
    fence_regs(s);
    wg_fence();
    gemm_abt<D>(s, s_q, s_k);
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    // online softmax in base 2: x = s * scale * log2(e); masked x = -inf
    // (position masks: kMask2 in range, -inf past Skv)
    const int k0 = t * kTile;
    const bool edge = POS || tile_edge(q0, k0, Sq, Skv, causal, window);
    uint32_t vis[2], in;
    if constexpr (POS)
      pos_bits<false>([&](int c) { return pos_at(kp_b, c, Skv); }, k0, Skv,
                      rpos, c0, causal, window, vis, in);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * i + e] * scale_log2;
          if constexpr (POS) {
            const uint32_t bit = 1u << (2 * j + e);
            if (!(vis[i] & bit)) x = (in & bit) ? kMask2 : -INFINITY;
          } else if (edge && !key_ok(k0 + 8 * j + c0 + e, row + 8 * i, Skv,
                                     causal, window)) {
            x = -INFINITY;
          }
          s[4 * j + 2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // m starts at kNegInf (finite): a row with no valid key yet keeps
      // alpha = 1 and p = 0 (positions: m starts at kMask2, and such a row
      // weighs its masked keys 1 until a visible key's alpha = 0 drops
      // them)
      alpha[i] = exp2f(m[i] - mx);
      m[i] = mx;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * j + 2 * i + e] - mx);
          s[4 * j + 2 * i + e] = p;
          ps += p;
        }
      l[i] = l[i] * alpha[i] + ps;   // this thread's share of the row sum
    }

    // o = o * alpha + P V, P split into bf16 hi + lo
    uint32_t ph[4][4], pl[4][4];
    split_frags(s, ph, pl);
    gemm_split_add<DO>(o, ph, pl, s_v, alpha[0], alpha[1]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qp = row + 8 * i;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    bf16* og = out + q_base + qp * q_rs + cb * DO + c0;
#pragma unroll
    for (int j = 0; j < DO / 8; ++j)
      if (DOG == DO || 8 * j + c0 < DOG)
        *reinterpret_cast<uint32_t*>(og + 8 * j) =
            pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    // a row with no valid key (none exists for rows < Sq) gets lse = +inf,
    // so the backward's P = exp(s - lse) is 0 there
    if ((lane & 3) == 0 && cb == 0)
      lse[((long long)b * Hq + h) * Sq + qp] =
          li > 0.f ? (m[i] + log2f(li)) * kLn2 : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// bf16 backward, dK and dV: grid (Hkv x D / DO, B, key tiles), the first
// key tile first.  The block keeps its K and V tiles and walks the (head,
// query tile) steps of the G heads of its group, streaming Q, dO and the
// rows' lse and Dr through two stages.  S^T = K Q^T and dP^T = V dO^T put
// the keys on the accumulator's rows, so P^T and dS^T are already the A
// fragments of dV += P^T dO and dK += dS^T Q.  As in the forward, a block
// owns the columns [c * DO, (c + 1) * DO) of dK and dV (fwd_cols): all of
// D up to D 128; at D 256 two blocks share a key tile, each computing S^T
// and dP^T over the whole of D and keeping half of the accumulators (128
// f32 a thread, as at D 128: the whole 256 would need 256 registers
// before S and dP).  D 80 computes on tiles of 128 (DG 80: zero columns
// past 80, never written).
// ---------------------------------------------------------------------------
template <int D, int DG = D, bool POS = false>
__global__ void __launch_bounds__(kWG, 2)
fa_dkdv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dr, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos, int Sq, int Skv, int Hq,
                     int Hkv, int causal, int window, float scale,
                     float scale_log2) {
  constexpr int DO = fwd_cols<D>(), NC = D / DO;
  constexpr int DOG = DO - (D - DG);   // the real columns of the block's DO
  constexpr uint32_t T = kTile * D * 2;
  // the block's DO columns start this far into a tile
  constexpr uint32_t kCols = (DO / 64) * (kTile * 128);
  extern __shared__ uint8_t smem[];
  // K, V, then two stages of (Q, dO), then two stages of (lse, Dr) rows
  const uint32_t s_k = smem_base(smem), s_v = s_k + T;
  float* rows_s = reinterpret_cast<float*>(smem + (s_k - smem_u32(smem)) +
                                           6 * T);
  const int hk = blockIdx.x / NC, cb = blockIdx.x % NC, b = blockIdx.y;
  const int k0 = blockIdx.z * kTile;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31;
  const int key = k0 + (tid >> 5) * 16 + (lane >> 2);
  const int c0 = (lane & 3) * 2;
  const long long q_rs = (long long)Hq * DG, k_rs = (long long)Hkv * DG;
  const long long k_base = (long long)b * Skv * k_rs + (long long)hk * DG;

  // live query tiles: rows at or below the tile's keys (causal), rows whose
  // window still reaches them; every one of the Sq rows without either, or
  // with positions
  const int q_lo = causal && !POS ? k0 : 0;
  const int q_hi = window > 0 && !POS ? min(Sq, k0 + kTile - 1 + window)
                                      : Sq;
  const int* qp_b = POS ? q_pos + (long long)b * Sq : nullptr;
  int kpos[2] = {0, 0};
  if constexpr (POS) {
    kpos[0] = pos_at(k_pos + (long long)b * Skv, key, Skv);
    kpos[1] = pos_at(k_pos + (long long)b * Skv, key + 8, Skv);
  }
  const float inv_skv = 1.f / Skv;
  const int t_lo = q_lo / kTile;
  const int nt = (q_hi + kTile - 1) / kTile - t_lo;
  const int n = G * nt;

  auto load_step = [&](int it, int st) {
    const int h = hk * G + it / nt, q0 = (t_lo + it % nt) * kTile;
    const long long q_base = (long long)b * Sq * q_rs + (long long)h * DG;
    const uint32_t s_q = s_k + T * (2 + 2 * st);
    load_tile<D, DG>(s_q, q + q_base, q_rs, q0, Sq, tid);
    load_tile<D, DG>(s_q + T, dout + q_base, q_rs, q0, Sq, tid);
    const int r = tid & (kTile - 1);
    const bool ok = q0 + r < Sq;
    const float* src = (tid < kTile ? lse : dr) +
                       ((long long)b * Hq + h) * Sq + (ok ? q0 + r : 0);
    cp_async4(smem_u32(rows_s + (2 * st + tid / kTile) * kTile + r), src, ok);
  };

  load_tile<D, DG>(s_k, k + k_base, k_rs, k0, Skv, tid);
  load_tile<D, DG>(s_v, v + k_base, k_rs, k0, Skv, tid);
  load_step(0, 0);
  cp_async_commit();

  float dka[DO / 2], dva[DO / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    const int stage = it & 1;
    const int q0 = (t_lo + it % nt) * kTile;
    const uint32_t s_q = s_k + T * (2 + 2 * stage), s_do = s_q + T;
    const float* lse_s = rows_s + 2 * stage * kTile;
    const float* dr_s = lse_s + kTile;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();   // step it has landed; step it - 1's stage is free
    if (it + 1 < n) load_step(it + 1, stage ^ 1);
    cp_async_commit();

    float st_[32], dp[32];   // this step's alone (scale_d 0 overwrites)
    fence_regs(st_);
    fence_regs(dp);
    wg_fence();
    gemm_abt<D>(st_, s_k, s_q);    // S^T = K Q^T
    gemm_abt<D>(dp, s_v, s_do);    // dP^T = V dO^T
    wg_commit();
    wg_wait_all();
    fence_regs(st_);
    fence_regs(dp);

    // P^T = exp(S^T * scale - lse), dS^T = P^T (dP^T - Dr); row: key,
    // column: query row.  Position masks: the query rows' positions (a
    // masked pair of a row that saw no key weighs 1 / Skv in dV, dS 0)
    const bool edge = POS || tile_edge(q0, k0, Sq, Skv, causal, window);
    uint32_t vis[2], in;
    if constexpr (POS)
      pos_bits<true>([&](int c) { return pos_at(qp_b, c, Sq); }, q0, Sq,
                     kpos, c0, causal, window, vis, in);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + c0 + e, x = 4 * j + 2 * i + e;
          if constexpr (POS) {
            const uint32_t bit = 1u << (2 * j + e);
            const bool ok = vis[i] & bit;
            const bool empty = (in & bit) && key + 8 * i < Skv &&
                               lse_s[c] < kEmptyLse;
            const float p =
                ok ? exp2f(fmaf(st_[x], scale_log2, -lse_s[c] * kLog2e))
                   : (empty ? inv_skv : 0.f);
            st_[x] = p;
            dp[x] = ok ? p * (dp[x] - dr_s[c]) : 0.f;
          } else {
            const bool ok =
                !edge || (q0 + c < Sq &&
                          key_ok(key + 8 * i, q0 + c, Skv, causal, window));
            const float p =
                ok ? exp2f(fmaf(st_[x], scale_log2, -lse_s[c] * kLog2e))
                   : 0.f;
            st_[x] = p;
            dp[x] = p * (dp[x] - dr_s[c]);
          }
        }

    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
    split_frags(st_, ph, pl);
    split_frags(dp, dh, dl);
    // dV += P^T dO, dK += dS^T Q on the block's DO columns
    gemm_split_add<DO>(dva, ph, pl, s_do + cb * kCols, 1.f, 1.f);
    gemm_split_add<DO>(dka, dh, dl, s_q + cb * kCols, 1.f, 1.f);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = key + 8 * i;
    if (kp >= Skv) continue;
    bf16* dko = dk + k_base + kp * k_rs + cb * DO + c0;
    bf16* dvo = dv + k_base + kp * k_rs + cb * DO + c0;
#pragma unroll
    for (int j = 0; j < DO / 8; ++j) {
      if (DOG < DO && 8 * j + c0 >= DOG) continue;
      *reinterpret_cast<uint32_t*>(dko + 8 * j) = pack_bf16(
          dka[4 * j + 2 * i] * scale, dka[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvo + 8 * j) =
          pack_bf16(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward, dQ: grid (Hq x D / DO, B, query tiles), the last query
// tile first.  The block keeps Q and dO and streams K/V tiles through two
// stages; dQ += dS K with dS split into bf16 hi + lo, on the block's DO
// columns of dQ (two blocks a head at D 256, as the dK/dV pass).
// ---------------------------------------------------------------------------
template <int D, int DG = D, bool POS = false>
__global__ void __launch_bounds__(kWG, 2)
fa_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dr, bf16* __restrict__ dq,
                   const int* __restrict__ q_pos,
                   const int* __restrict__ k_pos, int Sq, int Skv, int Hq,
                   int Hkv, int causal, int window, float scale,
                   float scale_log2) {
  constexpr int DO = fwd_cols<D>(), NC = D / DO;
  constexpr int DOG = DO - (D - DG);
  constexpr uint32_t T = kTile * D * 2;
  constexpr uint32_t kCols = (DO / 64) * (kTile * 128);
  extern __shared__ uint8_t smem[];
  // Q, dO, then two stages of (K, V)
  const uint32_t s_q = smem_base(smem), s_do = s_q + T;
  const int h = blockIdx.x / NC, cb = blockIdx.x % NC, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = q0 + (tid >> 5) * 16 + (lane >> 2);
  const int c0 = (lane & 3) * 2;
  const long long q_rs = (long long)Hq * DG, k_rs = (long long)Hkv * DG;
  const long long q_base = (long long)b * Sq * q_rs + (long long)h * DG;
  const long long k_base = (long long)b * Skv * k_rs + (long long)hk * DG;

  const int k_hi = causal && !POS ? min(Skv, q0 + kTile) : Skv;
  const int k_lo = window > 0 && !POS ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kTile, t_hi = (k_hi + kTile - 1) / kTile;
  const int* kp_b = POS ? k_pos + (long long)b * Skv : nullptr;
  int rpos[2] = {0, 0};
  if constexpr (POS) {
    rpos[0] = pos_at(q_pos + (long long)b * Sq, row, Sq);
    rpos[1] = pos_at(q_pos + (long long)b * Sq, row + 8, Sq);
  }

  load_tile<D, DG>(s_q, q + q_base, q_rs, q0, Sq, tid);
  load_tile<D, DG>(s_do, dout + q_base, q_rs, q0, Sq, tid);
  load_tile<D, DG>(s_q + 2 * T, k + k_base, k_rs, t_lo * kTile, Skv, tid);
  load_tile<D, DG>(s_q + 3 * T, v + k_base, k_rs, t_lo * kTile, Skv, tid);
  cp_async_commit();

  float lse2[2], drr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = ((long long)b * Hq + h) * Sq + row + 8 * i;
    lse2[i] = row + 8 * i < Sq ? lse[at] * kLog2e : 0.f;
    drr[i] = row + 8 * i < Sq ? dr[at] : 0.f;
  }
  float dqa[DO / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) dqa[i] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const uint32_t s_k = s_q + T * (2 + 2 * ((t - t_lo) & 1)), s_v = s_k + T;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    if (t + 1 < t_hi) {
      const uint32_t n_k = s_q + T * (2 + 2 * ((t + 1 - t_lo) & 1));
      load_tile<D, DG>(n_k, k + k_base, k_rs, (t + 1) * kTile, Skv, tid);
      load_tile<D, DG>(n_k + T, v + k_base, k_rs, (t + 1) * kTile, Skv,
                       tid);
    }
    cp_async_commit();

    float s[32], dp[32];   // this tile's alone (scale_d 0 overwrites)
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
    gemm_abt<D>(s, s_q, s_k);     // S = Q K^T
    gemm_abt<D>(dp, s_do, s_v);   // dP = dO V^T
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const int k0 = t * kTile;
    const bool edge = POS || tile_edge(q0, k0, Sq, Skv, causal, window);
    uint32_t vis[2], in;
    if constexpr (POS)
      pos_bits<false>([&](int c) { return pos_at(kp_b, c, Skv); }, k0, Skv,
                      rpos, c0, causal, window, vis, in);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * i + e;
          bool ok;
          if constexpr (POS)
            ok = vis[i] & (1u << (2 * j + e));
          else
            ok = !edge || key_ok(k0 + 8 * j + c0 + e, row + 8 * i, Skv,
                                 causal, window);
          const float p = ok ? exp2f(fmaf(s[x], scale_log2, -lse2[i])) : 0.f;
          dp[x] = p * (dp[x] - drr[i]);
        }

    uint32_t dh[4][4], dl[4][4];
    split_frags(dp, dh, dl);
    // dQ += dS K on the block's DO columns
    gemm_split_add<DO>(dqa, dh, dl, s_k + cb * kCols, 1.f, 1.f);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row + 8 * i;
    if (qp >= Sq) continue;
    bf16* o = dq + q_base + qp * q_rs + cb * DO + c0;
#pragma unroll
    for (int j = 0; j < DO / 8; ++j)
      if (DOG == DO || 8 * j + c0 < DOG)
        *reinterpret_cast<uint32_t*>(o + 8 * j) = pack_bf16(
            dqa[4 * j + 2 * i] * scale, dqa[4 * j + 2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
constexpr int kFwdBK = 64;   // keys per tile, f32 forward
constexpr int kDqBK = 32;    // keys per tile, f32 dQ pass

template <int D>
constexpr int fwd_smem() {
  return ((kBQ + 2 * kFwdBK) * (D + 4) + kFwdBK * (kBQ + 4)) * 4;
}
template <int D>
constexpr int dkdv_smem() {
  return ((2 * 32 + 2 * kBQ) * (D + 4) + 2 * kBQ * (32 + 4) + 2 * kBQ) * 4;
}
template <int D>
constexpr int dq_smem() {
  return ((2 * kBQ + 2 * kDqBK) * (D + 4) + kDqBK * (kBQ + 4)) * 4;
}
// bf16: tiles of kTile x D, the alignment slack, the dK/dV pass's rows
template <int D>
constexpr int wgmma_smem(int tiles, int row_floats) {
  return kAtom + tiles * kTile * D * 2 + row_floats * 4;
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

double scale_of(int D) { return 1.0 / sqrt(static_cast<double>(D)); }

// the position pointers of a launch (null: the index masks)
struct Pos {
  const int* q;
  const int* k;
};

// D: the width the kernel computes on; DG: the tensors' head dim, which
// sets the softmax scale
template <int D, int DG = D, bool POS = false>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* out,
                   void* lse, Pos pos, int B, int Sq, int Skv, int Hq,
                   int Hkv, int causal, int window, cudaStream_t st) {
  auto kern = fa_fwd_kernel<float, D, kFwdBK, DG, POS>;
  constexpr int smem = fwd_smem<D>();
  int rc = set_smem(kern, smem);
  if (rc != 0) return rc;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), pos.q, pos.k, Sq, Skv, Hq, Hkv, causal,
      window, static_cast<float>(scale_of(DG)));
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DG = D, bool POS = false>
int launch_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                    void* lse, Pos pos, int B, int Sq, int Skv, int Hq,
                    int Hkv, int causal, int window, cudaStream_t st) {
  auto kern = fa_fwd_wgmma_kernel<D, DG, POS>;
  // Q, two stages of K and of V's fwd_cols<D>() columns
  constexpr int smem = wgmma_smem<D>(3, 0) + 2 * kTile * fwd_cols<D>() * 2;
  int rc = set_smem(kern, smem);
  if (rc != 0) return rc;
  const dim3 grid(Hq * (D / fwd_cols<D>()), B, (Sq + kTile - 1) / kTile);
  kern<<<grid, kWG, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), pos.q, pos.k, Sq, Skv, Hq, Hkv, causal,
      window, static_cast<float>(scale_of(DG) * 1.4426950408889634));
  return static_cast<int>(cudaGetLastError());
}

// Dr = rowsum(dO * o), the first kernel of either backward (S: Sq)
template <typename T, int D>
int launch_rowdot(const void* o, const void* dout, void* dr, int B, int S,
                  int Hq, cudaStream_t st) {
  const long long rows = (long long)B * S * Hq;
  const int rows_per_block = kThreads / 32;
  const unsigned int n_blocks =
      static_cast<unsigned int>((rows + rows_per_block - 1) / rows_per_block);
  fa_rowdot_kernel<T, D><<<n_blocks, kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(dr), rows, S, Hq);
  return static_cast<int>(cudaGetLastError());
}

// D: the width the kernels compute on; DG: the tensors' head dim, which
// sets the softmax scale
template <int D, int DG = D, bool POS = false>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* dr, void* dq, void* dk, void* dv, Pos pos, int B,
                   int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                   cudaStream_t st) {
  int rc = launch_rowdot<float, DG>(o, dout, dr, B, Sq, Hq, st);
  if (rc != 0) return rc;
  const float scale = static_cast<float>(scale_of(DG));
  auto kv_kern = fa_dkdv_kernel<float, D, DG, POS>;
  constexpr int kv_smem = dkdv_smem<D>();
  rc = set_smem(kv_kern, kv_smem);
  if (rc != 0) return rc;
  kv_kern<<<dim3((Skv + 31) / 32, Hkv, B), kThreads, kv_smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dr),
      static_cast<float*>(dk), static_cast<float*>(dv), pos.q, pos.k, Sq,
      Skv, Hq, Hkv, causal, window, scale);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  auto q_kern = fa_dq_kernel<float, D, kDqBK, DG, POS>;
  constexpr int q_smem = dq_smem<D>();
  rc = set_smem(q_kern, q_smem);
  if (rc != 0) return rc;
  q_kern<<<dim3((Sq + kBQ - 1) / kBQ, Hq, B), kThreads, q_smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dr),
      static_cast<float*>(dq), pos.q, pos.k, Sq, Skv, Hq, Hkv, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DG = D, bool POS = false>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* dr, void* dq, void* dk, void* dv, Pos pos, int B,
                    int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                    cudaStream_t st) {
  int rc = launch_rowdot<bf16, DG>(o, dout, dr, B, Sq, Hq, st);
  if (rc != 0) return rc;
  const float scale = static_cast<float>(scale_of(DG));
  const float scale_log2 =
      static_cast<float>(scale_of(DG) * 1.4426950408889634);
  constexpr int NC = D / fwd_cols<D>();   // blocks a head (two at D 256)

  auto kv_kern = fa_dkdv_wgmma_kernel<D, DG, POS>;
  // K, V, two stages of Q, dO; two stages of 64 lse and 64 Dr
  constexpr int kv_smem = wgmma_smem<D>(6, 4 * kTile);
  rc = set_smem(kv_kern, kv_smem);
  if (rc != 0) return rc;
  kv_kern<<<dim3(Hkv * NC, B, (Skv + kTile - 1) / kTile), kWG, kv_smem,
            st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dr),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), pos.q, pos.k, Sq, Skv,
      Hq, Hkv, causal, window, scale, scale_log2);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  auto q_kern = fa_dq_wgmma_kernel<D, DG, POS>;
  constexpr int q_smem = wgmma_smem<D>(6, 0);   // Q, dO, two stages of K, V
  rc = set_smem(q_kern, q_smem);
  if (rc != 0) return rc;
  q_kern<<<dim3(Hq * NC, B, (Sq + kTile - 1) / kTile), kWG, q_smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dr),
      static_cast<bf16*>(dq), pos.q, pos.k, Sq, Skv, Hq, Hkv, causal, window,
      scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// Skv != Sq only where every key is visible, or where positions mask
bool lengths_ok(int Sq, int Skv, int causal, int window, Pos pos) {
  return Sq == Skv || (!causal && window <= 0) || pos.q != nullptr;
}

// the forward of one type, head dim and mask kind
template <bool POS>
int fwd(int dtype, const void* q, const void* k, const void* v, void* out,
        void* lse, Pos pos, int B, int Sq, int Skv, int Hq, int Hkv, int D,
        int causal, int window, cudaStream_t st) {
  // head dim 80 (zamba2's shared block) on tiles of 128
  if (dtype == 1 && D == 80)
    return launch_fwd_bf16<128, 80, POS>(q, k, v, out, lse, pos, B, Sq, Skv,
                                         Hq, Hkv, causal, window, st);
  if (dtype == 0 && D == 80)
    return launch_fwd_f32<128, 80, POS>(q, k, v, out, lse, pos, B, Sq, Skv,
                                        Hq, Hkv, causal, window, st);
  if (dtype == 1 && D == 256)
    return launch_fwd_bf16<256, 256, POS>(q, k, v, out, lse, pos, B, Sq, Skv,
                                          Hq, Hkv, causal, window, st);
  if (dtype == 0 && D == 256)
    return launch_fwd_f32<256, 256, POS>(q, k, v, out, lse, pos, B, Sq, Skv,
                                         Hq, Hkv, causal, window, st);
  if (dtype == 1 && D == 128)
    return launch_fwd_bf16<128, 128, POS>(q, k, v, out, lse, pos, B, Sq, Skv,
                                          Hq, Hkv, causal, window, st);
  if (dtype == 1 && D == 64)
    return launch_fwd_bf16<64, 64, POS>(q, k, v, out, lse, pos, B, Sq, Skv,
                                        Hq, Hkv, causal, window, st);
  if (dtype == 0 && D == 128)
    return launch_fwd_f32<128, 128, POS>(q, k, v, out, lse, pos, B, Sq, Skv,
                                         Hq, Hkv, causal, window, st);
  if (dtype == 0 && D == 64)
    return launch_fwd_f32<64, 64, POS>(q, k, v, out, lse, pos, B, Sq, Skv,
                                       Hq, Hkv, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the backward of one type, head dim and mask kind
template <bool POS>
int bwd(int dtype, const void* q, const void* k, const void* v,
        const void* o, const void* dout, const void* lse, void* dr, void* dq,
        void* dk, void* dv, Pos pos, int B, int Sq, int Skv, int Hq, int Hkv,
        int D, int causal, int window, cudaStream_t st) {
  // head dim 80 (zamba2's shared block) on tiles of 128
  if (dtype == 1 && D == 80)
    return launch_bwd_bf16<128, 80, POS>(q, k, v, o, dout, lse, dr, dq, dk,
                                         dv, pos, B, Sq, Skv, Hq, Hkv,
                                         causal, window, st);
  if (dtype == 0 && D == 80)
    return launch_bwd_f32<128, 80, POS>(q, k, v, o, dout, lse, dr, dq, dk,
                                        dv, pos, B, Sq, Skv, Hq, Hkv, causal,
                                        window, st);
  if (dtype == 1 && D == 256)
    return launch_bwd_bf16<256, 256, POS>(q, k, v, o, dout, lse, dr, dq, dk,
                                          dv, pos, B, Sq, Skv, Hq, Hkv,
                                          causal, window, st);
  if (dtype == 0 && D == 256)
    return launch_bwd_f32<256, 256, POS>(q, k, v, o, dout, lse, dr, dq, dk,
                                         dv, pos, B, Sq, Skv, Hq, Hkv,
                                         causal, window, st);
  if (dtype == 1 && D == 128)
    return launch_bwd_bf16<128, 128, POS>(q, k, v, o, dout, lse, dr, dq, dk,
                                          dv, pos, B, Sq, Skv, Hq, Hkv,
                                          causal, window, st);
  if (dtype == 1 && D == 64)
    return launch_bwd_bf16<64, 64, POS>(q, k, v, o, dout, lse, dr, dq, dk,
                                        dv, pos, B, Sq, Skv, Hq, Hkv, causal,
                                        window, st);
  if (dtype == 0 && D == 128)
    return launch_bwd_f32<128, 128, POS>(q, k, v, o, dout, lse, dr, dq, dk,
                                         dv, pos, B, Sq, Skv, Hq, Hkv, causal,
                                         window, st);
  if (dtype == 0 && D == 64)
    return launch_bwd_f32<64, 64, POS>(q, k, v, o, dout, lse, dr, dq, dk, dv,
                                       pos, B, Sq, Skv, Hq, Hkv, causal,
                                       window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  D: 64,
// 80, 128 or 256, forward and backward.  q/out (B, Sq, Hq, D), k/v (B,
// Skv, Hkv, D) dense; lse (B, Hq, Sq) f32.  Hq % Hkv == 0.  q_pos (B, Sq)
// and k_pos (B, Skv) int32, both or neither: the position masks (null:
// the index masks, Skv != Sq only with causal == 0 and window == 0).
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* out, void* lse,
                        const void* q_pos, const void* k_pos, int B, int Sq,
                        int Skv, int Hq, int Hkv, int D, int causal,
                        int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Pos pos{static_cast<const int*>(q_pos),
                static_cast<const int*>(k_pos)};
  if ((pos.q == nullptr) != (pos.k == nullptr) ||
      !lengths_ok(Sq, Skv, causal, window, pos))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pos.q != nullptr)
    return fwd<true>(dtype, q, k, v, out, lse, pos, B, Sq, Skv, Hq, Hkv, D,
                     causal, window, st);
  return fwd<false>(dtype, q, k, v, out, lse, pos, B, Sq, Skv, Hq, Hkv, D,
                    causal, window, st);
}

// The forward's tensors and positions, dout (B, Sq, Hq, D) dense, dr (B,
// Hq, Sq) f32 scratch; writes dq (B, Sq, Hq, D) and dk/dv (B, Skv, Hkv, D)
// in the input type.
int flash_attention_bwd(int dtype, const void* q, const void* k,
                        const void* v, const void* o, const void* dout,
                        const void* lse, void* dr, void* dq, void* dk,
                        void* dv, const void* q_pos, const void* k_pos, int B,
                        int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                        int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Pos pos{static_cast<const int*>(q_pos),
                static_cast<const int*>(k_pos)};
  if ((pos.q == nullptr) != (pos.k == nullptr) ||
      !lengths_ok(Sq, Skv, causal, window, pos))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pos.q != nullptr)
    return bwd<true>(dtype, q, k, v, o, dout, lse, dr, dq, dk, dv, pos, B,
                     Sq, Skv, Hq, Hkv, D, causal, window, st);
  return bwd<false>(dtype, q, k, v, o, dout, lse, dr, dq, dk, dv, pos, B,
                    Sq, Skv, Hq, Hkv, D, causal, window, st);
}

}  // extern "C"
