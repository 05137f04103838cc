// Kernel E: the backward of exact-softmax attention on head-packed
// (B, S, H*D) tensors, any head dim D % 64 == 0, bf16 or fp32: dq, dk, dv from q, k,
// v, o and dO. The public sdpa()'s backward (lvd_tpu's `_flash_bwd`, row 3)
// is this kernel with one head.
//
// Replaces lvd_tpu/ops/pallas_attention.py `_pallas_attention_bwd`
// (`_attn_bwd_kernel`, (BH, S, D) layout) and `_pallas_attention_bwd_heads`
// (`_attn_bwd_kernel_heads`, packed). The TPU split the L0 shape off to a
// relayout + (BH, S, D) kernel only because its VMEM could not hold the
// (S, C) fp32 accumulators; here one packed kernel serves every level, and it
// also takes the short-key sites (77 text tokens, 45 and 180 keys), which
// lvd_tpu recomputed through XLA.
//
// Math (per head, as the TPU kernel): P = softmax(Q K^T * scale);
// delta = rowsum(dO * O); dV = P^T dO; dS = P * (dO V^T - delta) * scale;
// dQ = dS K; dK = dS^T Q. P is rounded to the tensors' type for dV, dS for
// dQ and dK (no rounding in fp32, whose products run in TF32); every product
// accumulates in fp32.
//
// Bound on this card: at the self-attention shapes the five (S, S, 64)
// products per head dominate (10 * B * S^2 * C operations), so the backward
// is tensor-core bound; at the 77-key sites it reads q, o, dO and writes dq
// once and is bound by memory. Design, three launches on one stream, no
// atomics:
//   1. stats: per (batch*head, 64-query tile), the base-2 log-sum-exp of the
//      scaled logits (online max over 64-key tiles, as kernel A) and delta;
//      A keeps no softmax statistics, so E recomputes them here.
//   2. dk/dv: per (batch*head, 64-key tile), four warps of 16 keys walk
//      every query tile and accumulate dK and dV in registers.
//   3. dq: per (batch*head, 64-query tile), four warps of 16 queries walk
//      every key tile and accumulate dQ in registers.
// Heads are read at column offset h*D of the packed rows (no relayout).
// Shared memory of the three launches (stats / dk-dv / dq): bf16 D=64
// 38 / 97 / 87 KB; bf16 D=128 54 / 129 / 119 KB; fp32 D=64 54 / 145 /
// 127 KB; fp32 D=128 86 / 209 / 191 KB. The dq launch reads the warp's q
// and dO rows from shared memory at every key tile, so D = 128 in TF32
// does not run out of registers.
// Ragged query and key tails are masked: a query past S_q gets log-sum-exp
// +inf (P = 0), a key past S_k gets P = 0. Launch 2 is skipped when the
// caller needs no dk/dv (cross-attention keys come from the text).
//
// Head dims other than 64 and 128 (any D % 64 == 0, which lvd_tpu's
// predicates take) run a D-sliced form of the same three launches. Launch 1
// sums the logits over D in 64-wide chunks of q and k staged in shared
// memory. In launches 2 and 3, block z of a tile owns columns [64z, 64z + 64)
// of dK and dV, or of dQ: for each tile pair it sums S and dP = dO V^T over
// D in 64-wide chunks (the partial sums kept in the warp's fp32 shared
// tiles, so registers do not grow), then forms P and dS and multiplies them
// into its slice of q, dO or k. Shared memory and registers are those of
// D = 64 plus two (launch 2) or one (launch 3) slice tiles (fp32: 54 / 181 /
// 145 KB); each of the D/64 blocks recomputes S and dP.
#include "common.cuh"

namespace lvd {
namespace {

constexpr int kBT = 64;     // queries or keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLdS = 72;    // fp32 (16, 64) score-tile row stride (288 B)

template <typename T, int D>
struct BwdCfg {
  static constexpr int kLdD = D + kPad<T>;    // q/k/v/dO tile rows
  static constexpr int kLdP = kBT + kPad<T>;  // P / dS rows
  static constexpr int kLdO = D + 8;          // fp32 staging rows of store_rows
  // Per-warp fp32 region: two (16, 64) score tiles, reused as the staging
  // tile of store_rows.
  static constexpr int kWarpF = (2 * 16 * kLdS > 16 * kLdO) ? 2 * 16 * kLdS : 16 * kLdO;
  static constexpr int kTile = kBT * kLdD * (int)sizeof(T);
  static constexpr int kStatsSmem = 2 * kTile + kWarps * 16 * kLdS * 4;
  static constexpr int kDkdvSmem =
      4 * kTile + 2 * kBT * 4 + kWarps * (kWarpF * 4 + 2 * 16 * kLdP * (int)sizeof(T));
  static constexpr int kDqSmem =
      4 * kTile + 2 * kBT * 4 + kWarps * (kWarpF * 4 + 16 * kLdP * (int)sizeof(T));
};

// Copies rows [r0, r0 + 64) of one head into a (64, kLdD) smem tile; rows
// past `rows` are zero.
template <typename T, int D>
__device__ inline void load_tile(T* dst, const T* src, int r0, int rows, int C) {
  constexpr int V = kVecN<T>, DV = D / V, ld = BwdCfg<T, D>::kLdD;
  for (int i = threadIdx.x; i < kBT * DV; i += kThreads) {
    const int r = i / DV, cv = i % DV;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * C + cv * V);
    *reinterpret_cast<uint4*>(dst + r * ld + cv * V) = val;
  }
}

// Writes a warp's (16, D) fp32 accumulators as rows [r0, r0 + 16) of one
// head, through a (16, kLdO) staging tile; rows past `rows` are dropped.
template <typename T, int D, typename Acc>
__device__ inline void store_rows(const Acc (&acc)[D / 16], float* stage, T* dst, int r0,
                                  int rows, int C, int lane) {
  constexpr int V = kVecN<T>, ld = BwdCfg<T, D>::kLdO;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc[n], ld, wmma::mem_row_major);
  __syncwarp();
  const int row = lane >> 1, half = lane & 1;
  if (r0 + row < rows) {
    const float* src = stage + row * ld + half * (D / 2);
    T* out = dst + (size_t)(r0 + row) * C + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; j += V) {
      Vec<T> pack;
#pragma unroll
      for (int e = 0; e < V; ++e) pack.h[e] = from_f<T>(src[j + e]);
      *reinterpret_cast<uint4*>(out + j) = pack.u;
    }
  }
  __syncwarp();
}

// The running row max and sum of one (16, 64) tile of raw logits S of a
// warp (base 2, keys past kvalid masked); each row is owned by two lanes.
__device__ inline void online_stats(const float* S, int kvalid, float scale_log2e, int lane,
                                    float& m_i, float& l_i) {
  const int row = lane >> 1, half = lane & 1;
  const float* srow = S + row * kLdS + half * 32;
  float mx = -INFINITY;
  for (int j = 0; j < 32; ++j)
    if (half * 32 + j < kvalid) mx = fmaxf(mx, srow[j] * scale_log2e);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(m_i, mx);
  float sum = 0.f;
  for (int j = 0; j < 32; ++j)
    if (half * 32 + j < kvalid) sum += exp2f(srow[j] * scale_log2e - m_new);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  l_i = l_i * exp2f(m_i - m_new) + sum;
  m_i = m_new;
  __syncwarp();
}

// Writes query qr's log-sum-exp and delta = rowsum(dO * O) over its D
// columns (two lanes a row, D/2 columns each).
template <typename T>
__device__ inline void store_stats(const T* o, const T* dout, float* lse, float* delta,
                                   float m_i, float l_i, int b, int qr, int Sq, int C,
                                   size_t head, int D, int lane) {
  constexpr int V = kVecN<T>;
  const int half = lane & 1;
  float d = 0.f;
  if (qr < Sq) {
    const T* orow = o + ((size_t)b * Sq + qr) * C + head + half * (D / 2);
    const T* drow = dout + ((size_t)b * Sq + qr) * C + head + half * (D / 2);
    for (int j = 0; j < D / 2; j += V) {
      Vec<T> ov, dv;
      ov.u = *reinterpret_cast<const uint4*>(orow + j);
      dv.u = *reinterpret_cast<const uint4*>(drow + j);
#pragma unroll
      for (int e = 0; e < V; ++e) d += to_f(ov.h[e]) * to_f(dv.h[e]);
    }
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  if (qr < Sq && half == 0) {
    const size_t at = (size_t)blockIdx.x * Sq + qr;
    lse[at] = m_i + log2f(l_i);
    delta[at] = d;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ lse, float* __restrict__ delta, int H, int Sq, int Sk,
                      int C, float scale_log2e) {
  using M = Mma<T>;
  constexpr int kLdD = BwdCfg<T, D>::kLdD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBT * kLdD;
  float* Sw = reinterpret_cast<float*>(Ks + kBT * kLdD);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head = (size_t)h * D;
  load_tile<T, D>(Qs, q + (size_t)b * Sq * C + head, q0, Sq, C);
  __syncthreads();

  typename M::A qf[D / M::K];
#pragma unroll
  for (int kk = 0; kk < D / M::K; ++kk)
    load_op(qf[kk], Qs + warp * 16 * kLdD + kk * M::K, kLdD);
  float* S = Sw + warp * 16 * kLdS;
  float m_i = -INFINITY, l_i = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kBT) {
    __syncthreads();
    load_tile<T, D>(Ks, k + (size_t)b * Sk * C + head, k0, Sk, C);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kBT / 16; ++n) {
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / M::K; ++kk) {
        typename M::BCol kf;
        load_op(kf, Ks + n * 16 * kLdD + kk * M::K, kLdD);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(S + n * 16, acc, kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    online_stats(S, min(kBT, Sk - k0), scale_log2e, lane, m_i, l_i);
  }
  store_stats(o, dout, lse, delta, m_i, l_i, b, q0 + warp * 16 + (lane >> 1), Sq, C, head, D,
              lane);
}

// Loads the per-row statistics of query tile q0: rows past Sq get lse = +inf
// (so P = 0 there) and delta = 0.
__device__ inline void load_stats(float* lse_s, float* delta_s, const float* lse,
                                  const float* delta, int q0, int Sq) {
  for (int i = threadIdx.x; i < kBT; i += kThreads) {
    const bool ok = q0 + i < Sq;
    lse_s[i] = ok ? lse[q0 + i] : INFINITY;
    delta_s[i] = ok ? delta[q0 + i] : 0.f;
  }
}

// P^T and dS^T of a warp's 16 keys against a 64-query tile, from its fp32
// S^T and dP^T tiles and the queries' statistics (queries past S_q have
// lse = +inf, so P = 0).
template <typename T>
__device__ inline void pt_dst_tile(const float* St, const float* dPt, T* Pt, T* dSt, int ldp,
                                   const float* lse_s, const float* delta_s, int lane,
                                   float scale, float scale_log2e) {
  const int row = lane >> 1, half = lane & 1;
  const float* srow = St + row * kLdS + half * 32;
  const float* dprow = dPt + row * kLdS + half * 32;
  T* prow = Pt + row * ldp + half * 32;
  T* dsrow = dSt + row * ldp + half * 32;
  for (int j = 0; j < 32; ++j) {
    const int qi = half * 32 + j;
    const float p = exp2f(srow[j] * scale_log2e - lse_s[qi]);
    prow[j] = from_f<T>(p);
    dsrow[j] = from_f<T>(p * (dprow[j] - delta_s[qi]) * scale);
  }
  __syncwarp();
}

// dS of a warp's 16 queries against a 64-key tile (keys past kvalid give
// P = 0), from its fp32 S and dP tiles and the rows' statistics.
template <typename T>
__device__ inline void ds_tile(const float* S, const float* dP, T* dS, int ldp, int kvalid,
                               float lse_r, float delta_r, int lane, float scale,
                               float scale_log2e) {
  const int row = lane >> 1, half = lane & 1;
  const float* srow = S + row * kLdS + half * 32;
  const float* dprow = dP + row * kLdS + half * 32;
  T* dsrow = dS + row * ldp + half * 32;
  for (int j = 0; j < 32; ++j) {
    const float p = (half * 32 + j < kvalid) ? exp2f(srow[j] * scale_log2e - lse_r) : 0.f;
    dsrow[j] = from_f<T>(p * (dprow[j] - delta_r) * scale);
  }
  __syncwarp();
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk, int C,
                     float scale, float scale_log2e) {
  using M = Mma<T>;
  using Cfg = BwdCfg<T, D>;
  constexpr int kLdD = Cfg::kLdD, kLdP = Cfg::kLdP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBT * kLdD;
  T* Qs = Vs + kBT * kLdD;
  T* Ds = Qs + kBT * kLdD;
  float* lse_s = reinterpret_cast<float*>(Ds + kBT * kLdD);
  float* delta_s = lse_s + kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* St = delta_s + kBT + warp * Cfg::kWarpF;  // S^T (fp32), then staging
  float* dPt = St + 16 * kLdS;
  T* Pt = reinterpret_cast<T*>(delta_s + kBT + kWarps * Cfg::kWarpF) + warp * 2 * 16 * kLdP;
  T* dSt = Pt + 16 * kLdP;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kBT;
  const size_t head = (size_t)h * D;
  const T* qb = q + (size_t)b * Sq * C + head;
  const T* db = dout + (size_t)b * Sq * C + head;
  const float* lse_b = lse + (size_t)blockIdx.x * Sq;
  const float* delta_b = delta + (size_t)blockIdx.x * Sq;
  load_tile<T, D>(Ks, k + (size_t)b * Sk * C + head, k0, Sk, C);
  load_tile<T, D>(Vs, v + (size_t)b * Sk * C + head, k0, Sk, C);

  typename M::Acc dka[D / 16], dva[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dka[n], 0.f);
    wmma::fill_fragment(dva[n], 0.f);
  }
  const T* Kw = Ks + warp * 16 * kLdD;
  const T* Vw = Vs + warp * 16 * kLdD;

  for (int q0 = 0; q0 < Sq; q0 += kBT) {
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<T, D>(Qs, qb, q0, Sq, C);
    load_tile<T, D>(Ds, db, q0, Sq, C);
    load_stats(lse_s, delta_s, lse_b, delta_b, q0, Sq);
    __syncthreads();

    // S^T = K_w Q^T and dP^T = V_w dO^T, (16 keys, 64 queries) each.
#pragma unroll
    for (int n = 0; n < kBT / 16; ++n) {
      typename M::Acc s, dp;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dp, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / M::K; ++kk) {
        typename M::A a;
        typename M::BCol bm;
        load_op(a, Kw + kk * M::K, kLdD);
        load_op(bm, Qs + n * 16 * kLdD + kk * M::K, kLdD);
        wmma::mma_sync(s, a, bm, s);
        load_op(a, Vw + kk * M::K, kLdD);
        load_op(bm, Ds + n * 16 * kLdD + kk * M::K, kLdD);
        wmma::mma_sync(dp, a, bm, dp);
      }
      wmma::store_matrix_sync(St + n * 16, s, kLdS, wmma::mem_row_major);
      wmma::store_matrix_sync(dPt + n * 16, dp, kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    pt_dst_tile(St, dPt, Pt, dSt, kLdP, lse_s, delta_s, lane, scale, scale_log2e);

    // dV += P^T dO; dK += dS^T Q.
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < kBT / M::K; ++kk) {
        typename M::A a;
        typename M::BRow bm;
        load_op(a, Pt + kk * M::K, kLdP);
        load_op(bm, Ds + kk * M::K * kLdD + n * 16, kLdD);
        wmma::mma_sync(dva[n], a, bm, dva[n]);
        load_op(a, dSt + kk * M::K, kLdP);
        load_op(bm, Qs + kk * M::K * kLdD + n * 16, kLdD);
        wmma::mma_sync(dka[n], a, bm, dka[n]);
      }
    }
  }

  const size_t out_b = (size_t)b * Sk * C + head;
  store_rows<T, D>(dka, St, dk + out_b, k0 + warp * 16, Sk, C, lane);
  store_rows<T, D>(dva, St, dv + out_b, k0 + warp * 16, Sk, C, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dq, int H, int Sq, int Sk, int C, float scale,
                   float scale_log2e) {
  using M = Mma<T>;
  using Cfg = BwdCfg<T, D>;
  constexpr int kLdD = Cfg::kLdD, kLdP = Cfg::kLdP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ds = Qs + kBT * kLdD;
  T* Ks = Ds + kBT * kLdD;
  T* Vs = Ks + kBT * kLdD;
  float* lse_s = reinterpret_cast<float*>(Vs + kBT * kLdD);
  float* delta_s = lse_s + kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* S = delta_s + kBT + warp * Cfg::kWarpF;  // logits, then staging
  float* dP = S + 16 * kLdS;
  T* dS = reinterpret_cast<T*>(delta_s + kBT + kWarps * Cfg::kWarpF) + warp * 16 * kLdP;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBT;
  const size_t head = (size_t)h * D;
  load_tile<T, D>(Qs, q + (size_t)b * Sq * C + head, q0, Sq, C);
  load_tile<T, D>(Ds, dout + (size_t)b * Sq * C + head, q0, Sq, C);
  load_stats(lse_s, delta_s, lse + (size_t)blockIdx.x * Sq, delta + (size_t)blockIdx.x * Sq,
             q0, Sq);
  __syncthreads();

  // The warp's q and dO rows are read from shared memory at every key tile
  // (register-resident fragments would not fit at D = 128 in TF32).
  const T* Qw = Qs + warp * 16 * kLdD;
  const T* Dw = Ds + warp * 16 * kLdD;
  typename M::Acc dqa[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dqa[n], 0.f);
  const float lse_r = lse_s[warp * 16 + (lane >> 1)];
  const float delta_r = delta_s[warp * 16 + (lane >> 1)];
  const T* kb = k + (size_t)b * Sk * C + head;
  const T* vb = v + (size_t)b * Sk * C + head;

  for (int k0 = 0; k0 < Sk; k0 += kBT) {
    __syncthreads();
    load_tile<T, D>(Ks, kb, k0, Sk, C);
    load_tile<T, D>(Vs, vb, k0, Sk, C);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kBT / 16; ++n) {
      typename M::Acc s, dp;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dp, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / M::K; ++kk) {
        typename M::A a;
        typename M::BCol bm;
        load_op(a, Qw + kk * M::K, kLdD);
        load_op(bm, Ks + n * 16 * kLdD + kk * M::K, kLdD);
        wmma::mma_sync(s, a, bm, s);
        load_op(a, Dw + kk * M::K, kLdD);
        load_op(bm, Vs + n * 16 * kLdD + kk * M::K, kLdD);
        wmma::mma_sync(dp, a, bm, dp);
      }
      wmma::store_matrix_sync(S + n * 16, s, kLdS, wmma::mem_row_major);
      wmma::store_matrix_sync(dP + n * 16, dp, kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    ds_tile(S, dP, dS, kLdP, min(kBT, Sk - k0), lse_r, delta_r, lane, scale, scale_log2e);
    // dQ += dS K
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < kBT / M::K; ++kk) {
        typename M::A a;
        typename M::BRow bm;
        load_op(a, dS + kk * M::K, kLdP);
        load_op(bm, Ks + kk * M::K * kLdD + n * 16, kLdD);
        wmma::mma_sync(dqa[n], a, bm, dqa[n]);
      }
    }
  }
  store_rows<T, D>(dqa, S, dq + (size_t)b * Sq * C + head, q0 + warp * 16, Sq, C, lane);
}

// ---- The D-sliced form, for head dims other than 64 and 128 ----
// Every tile is (64, 64) of BwdCfg<T, 64>; `a` and `b` are a head's rows at
// column offset d0 (chunks) or at the block's slice.

// S (+)= A_w B^T over one 64-deep chunk, for a warp's 16 rows A_w against
// the tile's 64 rows B, summed into the warp's fp32 (16, 64) tile S.
template <typename T>
__device__ inline void chunk_logits(float* S, const T* Aw, const T* Bs, bool first) {
  using M = Mma<T>;
  constexpr int ld = BwdCfg<T, 64>::kLdD;
#pragma unroll
  for (int n = 0; n < kBT / 16; ++n) {
    typename M::Acc acc;
    if (first) {
      wmma::fill_fragment(acc, 0.f);
    } else {
      wmma::load_matrix_sync(acc, S + n * 16, kLdS, wmma::mem_row_major);
    }
#pragma unroll
    for (int kk = 0; kk < 64; kk += M::K) {
      typename M::A a;
      typename M::BCol bm;
      load_op(a, Aw + kk, ld);
      load_op(bm, Bs + n * 16 * ld + kk, ld);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(S + n * 16, acc, kLdS, wmma::mem_row_major);
  }
}

// acc[n] += A (16, 64, row stride lda) B[:, 16n:16n+16] (64, 64, tile rows).
template <typename T, typename Acc>
__device__ inline void slice_product(Acc (&acc)[4], const T* A, int lda, const T* Bs) {
  using M = Mma<T>;
  constexpr int ld = BwdCfg<T, 64>::kLdD;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int kk = 0; kk < kBT; kk += M::K) {
      typename M::A a;
      typename M::BRow bm;
      load_op(a, A + kk, lda);
      load_op(bm, Bs + kk * ld + n * 16, ld);
      wmma::mma_sync(acc[n], a, bm, acc[n]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_sliced_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ lse, float* __restrict__ delta, int H, int Sq,
                             int Sk, int C, int D, float scale_log2e) {
  constexpr int kLdD = BwdCfg<T, 64>::kLdD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBT * kLdD;
  float* Sw = reinterpret_cast<float*>(Ks + kBT * kLdD);
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head = (size_t)h * D;
  const T* qb = q + (size_t)b * Sq * C + head;
  const T* kb = k + (size_t)b * Sk * C + head;
  float* S = Sw + warp * 16 * kLdS;
  float m_i = -INFINITY, l_i = 0.f;
  for (int k0 = 0; k0 < Sk; k0 += kBT) {
    for (int d0 = 0; d0 < D; d0 += 64) {
      __syncthreads();
      load_tile<T, 64>(Qs, qb + d0, q0, Sq, C);
      load_tile<T, 64>(Ks, kb + d0, k0, Sk, C);
      __syncthreads();
      chunk_logits(S, Qs + warp * 16 * kLdD, Ks, d0 == 0);
    }
    __syncwarp();
    online_stats(S, min(kBT, Sk - k0), scale_log2e, lane, m_i, l_i);
  }
  store_stats(o, dout, lse, delta, m_i, l_i, b, q0 + warp * 16 + (lane >> 1), Sq, C, head, D,
              lane);
}

// Block (head, key tile, z): dK and dV columns [64z, 64z + 64).
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_sliced_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk, int C,
                            int D, float scale, float scale_log2e) {
  using M = Mma<T>;
  using Cfg = BwdCfg<T, 64>;
  constexpr int kLdD = Cfg::kLdD, kLdP = Cfg::kLdP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // chunks at d0
  T* Vs = Ks + kBT * kLdD;
  T* Qs = Vs + kBT * kLdD;
  T* Ds = Qs + kBT * kLdD;
  float* lse_s = reinterpret_cast<float*>(Ds + kBT * kLdD);
  float* delta_s = lse_s + kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* St = delta_s + kBT + warp * Cfg::kWarpF;  // S^T (fp32), then staging
  float* dPt = St + 16 * kLdS;
  T* Pt = reinterpret_cast<T*>(delta_s + kBT + kWarps * Cfg::kWarpF) + warp * 2 * 16 * kLdP;
  T* dSt = Pt + 16 * kLdP;
  T* Qj = reinterpret_cast<T*>(delta_s + kBT + kWarps * Cfg::kWarpF) +
          kWarps * 2 * 16 * kLdP;  // slices
  T* Dj = Qj + kBT * kLdD;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kBT;
  const int slice = blockIdx.z * 64;
  const size_t head = (size_t)h * D;
  const T* qb = q + (size_t)b * Sq * C + head;
  const T* db = dout + (size_t)b * Sq * C + head;
  const T* kb = k + (size_t)b * Sk * C + head;
  const T* vb = v + (size_t)b * Sk * C + head;
  const float* lse_b = lse + (size_t)blockIdx.x * Sq;
  const float* delta_b = delta + (size_t)blockIdx.x * Sq;

  typename M::Acc dka[4], dva[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::fill_fragment(dka[n], 0.f);
    wmma::fill_fragment(dva[n], 0.f);
  }
  for (int q0 = 0; q0 < Sq; q0 += kBT) {
    // S^T = K_w Q^T and dP^T = V_w dO^T over D, (16 keys, 64 queries) each.
    for (int d0 = 0; d0 < D; d0 += 64) {
      __syncthreads();  // every warp is done with the previous chunks and slices
      load_tile<T, 64>(Ks, kb + d0, k0, Sk, C);
      load_tile<T, 64>(Vs, vb + d0, k0, Sk, C);
      load_tile<T, 64>(Qs, qb + d0, q0, Sq, C);
      load_tile<T, 64>(Ds, db + d0, q0, Sq, C);
      if (d0 == 0) {
        load_tile<T, 64>(Qj, qb + slice, q0, Sq, C);
        load_tile<T, 64>(Dj, db + slice, q0, Sq, C);
        load_stats(lse_s, delta_s, lse_b, delta_b, q0, Sq);
      }
      __syncthreads();
      chunk_logits(St, Ks + warp * 16 * kLdD, Qs, d0 == 0);
      chunk_logits(dPt, Vs + warp * 16 * kLdD, Ds, d0 == 0);
    }
    __syncwarp();
    pt_dst_tile(St, dPt, Pt, dSt, kLdP, lse_s, delta_s, lane, scale, scale_log2e);
    // dV[:, slice] += P^T dO[:, slice]; dK[:, slice] += dS^T Q[:, slice].
    slice_product(dva, Pt, kLdP, Dj);
    slice_product(dka, dSt, kLdP, Qj);
  }
  const size_t out_b = (size_t)b * Sk * C + head + slice;
  store_rows<T, 64>(dka, St, dk + out_b, k0 + warp * 16, Sk, C, lane);
  store_rows<T, 64>(dva, St, dv + out_b, k0 + warp * 16, Sk, C, lane);
}

// Block (head, query tile, z): dQ columns [64z, 64z + 64).
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_sliced_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dq, int H, int Sq, int Sk, int C, int D, float scale,
                          float scale_log2e) {
  using M = Mma<T>;
  using Cfg = BwdCfg<T, 64>;
  constexpr int kLdD = Cfg::kLdD, kLdP = Cfg::kLdP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // chunks at d0
  T* Ds = Qs + kBT * kLdD;
  T* Ks = Ds + kBT * kLdD;
  T* Vs = Ks + kBT * kLdD;
  float* lse_s = reinterpret_cast<float*>(Vs + kBT * kLdD);
  float* delta_s = lse_s + kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* S = delta_s + kBT + warp * Cfg::kWarpF;  // logits, then staging
  float* dP = S + 16 * kLdS;
  T* dS = reinterpret_cast<T*>(delta_s + kBT + kWarps * Cfg::kWarpF) + warp * 16 * kLdP;
  T* Kj = reinterpret_cast<T*>(delta_s + kBT + kWarps * Cfg::kWarpF) +
          kWarps * 16 * kLdP;  // the key tile's slice

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBT;
  const int slice = blockIdx.z * 64;
  const size_t head = (size_t)h * D;
  const T* qb = q + (size_t)b * Sq * C + head;
  const T* db = dout + (size_t)b * Sq * C + head;
  const T* kb = k + (size_t)b * Sk * C + head;
  const T* vb = v + (size_t)b * Sk * C + head;
  load_stats(lse_s, delta_s, lse + (size_t)blockIdx.x * Sq, delta + (size_t)blockIdx.x * Sq,
             q0, Sq);
  __syncthreads();
  const float lse_r = lse_s[warp * 16 + (lane >> 1)];
  const float delta_r = delta_s[warp * 16 + (lane >> 1)];
  typename M::Acc dqa[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(dqa[n], 0.f);

  for (int k0 = 0; k0 < Sk; k0 += kBT) {
    // S = Q_w K^T and dP = dO_w V^T over D, (16 queries, 64 keys) each.
    for (int d0 = 0; d0 < D; d0 += 64) {
      __syncthreads();
      load_tile<T, 64>(Qs, qb + d0, q0, Sq, C);
      load_tile<T, 64>(Ds, db + d0, q0, Sq, C);
      load_tile<T, 64>(Ks, kb + d0, k0, Sk, C);
      load_tile<T, 64>(Vs, vb + d0, k0, Sk, C);
      if (d0 == 0) load_tile<T, 64>(Kj, kb + slice, k0, Sk, C);
      __syncthreads();
      chunk_logits(S, Qs + warp * 16 * kLdD, Ks, d0 == 0);
      chunk_logits(dP, Ds + warp * 16 * kLdD, Vs, d0 == 0);
    }
    __syncwarp();
    ds_tile(S, dP, dS, kLdP, min(kBT, Sk - k0), lse_r, delta_r, lane, scale, scale_log2e);
    slice_product(dqa, dS, kLdP, Kj);  // dQ[:, slice] += dS K[:, slice]
  }
  store_rows<T, 64>(dqa, S, dq + (size_t)b * Sq * C + head + slice, q0 + warp * 16, Sq, C,
                    lane);
}

template <typename T>
cudaError_t launch_sliced(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
                          int B, int H, int Sq, int Sk, int C, int D, float scale,
                          cudaStream_t s) {
  using Cfg = BwdCfg<T, 64>;
  constexpr int kDkdvSmem = Cfg::kDkdvSmem + 2 * Cfg::kTile;
  constexpr int kDqSmem = Cfg::kDqSmem + Cfg::kTile;
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto dp = static_cast<const T*>(dout);
  auto lp = static_cast<float*>(lse);
  auto tp = static_cast<float*>(delta);
  const float sl2e = scale * 1.4426950408889634f;
  const int qt = (Sq + kBT - 1) / kBT, kt = (Sk + kBT - 1) / kBT, nd = D / 64;
  cudaError_t err = set_smem(attn_bwd_sliced_stats_kernel<T>, Cfg::kStatsSmem);
  if (err != cudaSuccess) return err;
  attn_bwd_sliced_stats_kernel<T><<<dim3(B * H, qt), kThreads, Cfg::kStatsSmem, s>>>(
      qp, kp, static_cast<const T*>(o), dp, lp, tp, H, Sq, Sk, C, D, sl2e);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (dk != nullptr) {
    if ((err = set_smem(attn_bwd_sliced_dkdv_kernel<T>, kDkdvSmem)) != cudaSuccess) return err;
    attn_bwd_sliced_dkdv_kernel<T><<<dim3(B * H, kt, nd), kThreads, kDkdvSmem, s>>>(
        qp, kp, vp, dp, lp, tp, static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, C, D,
        scale, sl2e);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = set_smem(attn_bwd_sliced_dq_kernel<T>, kDqSmem)) != cudaSuccess) return err;
  attn_bwd_sliced_dq_kernel<T><<<dim3(B * H, qt, nd), kThreads, kDqSmem, s>>>(
      qp, kp, vp, dp, lp, tp, static_cast<T*>(dq), H, Sq, Sk, C, D, scale, sl2e);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   void* dq, void* dk, void* dv, void* lse, void* delta, int B, int H, int Sq,
                   int Sk, int C, float scale, cudaStream_t s) {
  using Cfg = BwdCfg<T, D>;
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto dp = static_cast<const T*>(dout);
  auto lp = static_cast<float*>(lse);
  auto tp = static_cast<float*>(delta);
  const float sl2e = scale * 1.4426950408889634f;
  const dim3 qgrid(B * H, (Sq + kBT - 1) / kBT);
  cudaError_t err = set_smem(attn_bwd_stats_kernel<T, D>, Cfg::kStatsSmem);
  if (err != cudaSuccess) return err;
  attn_bwd_stats_kernel<T, D><<<qgrid, kThreads, Cfg::kStatsSmem, s>>>(
      qp, kp, static_cast<const T*>(o), dp, lp, tp, H, Sq, Sk, C, sl2e);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (dk != nullptr) {
    if ((err = set_smem(attn_bwd_dkdv_kernel<T, D>, Cfg::kDkdvSmem)) != cudaSuccess) return err;
    attn_bwd_dkdv_kernel<T, D><<<dim3(B * H, (Sk + kBT - 1) / kBT), kThreads, Cfg::kDkdvSmem,
                                 s>>>(qp, kp, vp, dp, lp, tp, static_cast<T*>(dk),
                                      static_cast<T*>(dv), H, Sq, Sk, C, scale, sl2e);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = set_smem(attn_bwd_dq_kernel<T, D>, Cfg::kDqSmem)) != cudaSuccess) return err;
  attn_bwd_dq_kernel<T, D><<<qgrid, kThreads, Cfg::kDqSmem, s>>>(
      qp, kp, vp, dp, lp, tp, static_cast<T*>(dq), H, Sq, Sk, C, scale, sl2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lvd

// q, o, dout, dq: (B, Sq, C); k, v, dk, dv: (B, Sk, C); all of one type
// (dtype 0 bf16, 1 fp32), C = H*D with D % 64 == 0 (64 and 128 run their
// own instantiations, every other D the D-sliced form). lse and delta:
// (B*H*Sq) fp32 scratch. dk and dv may both be null (only dq is computed
// then).
LVD_EXPORT int lvd_attention_packed_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, void* dq, void* dk,
                                        void* dv, void* lse, void* delta, int B, int H, int Sq,
                                        int Sk, int C, float scale, int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (H <= 0 || C % H != 0 || Sq <= 0 || Sk <= 0 || (dk == nullptr) != (dv == nullptr))
    return cudaErrorInvalidValue;
  const int D = C / H;
  if (D % 64 != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    if (D == 64)
      return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, Sq, Sk, C, scale, s);
    if (D == 128)
      return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, Sq, Sk, C, scale, s);
    return launch_sliced<T>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, Sq, Sk, C, D, scale,
                            s);
  });
}
