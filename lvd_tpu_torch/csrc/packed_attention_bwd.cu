// Kernel E: the backward of exact-softmax attention on head-packed
// (B, S, H*D) tensors, any head dim D % 64 == 0, bf16 or fp32: dq, dk, dv
// from q, k, v, o, dO and the base-2 log-sum-exp that kernel A wrote in the
// forward. The public sdpa()'s backward (lvd_tpu's `_flash_bwd`, row 3) is
// this kernel with one head.
//
// Replaces lvd_tpu/ops/pallas_attention.py `_pallas_attention_bwd`
// (`_attn_bwd_kernel`, (BH, S, D) layout) and `_pallas_attention_bwd_heads`
// (`_attn_bwd_kernel_heads`, packed). The TPU split the L0 shape off to a
// relayout + (BH, S, D) kernel only because its VMEM could not hold the
// (S, C) fp32 accumulators; here one packed kernel serves every level, and it
// also takes the short-key sites (77 text tokens, 45 and 180 keys), which
// lvd_tpu recomputed through XLA.
//
// Math (per head, as the TPU kernel): P = exp2(S * scale * log2(e) - lse);
// delta = rowsum(dO * O); dV = P^T dO; dS = P * (dO V^T - delta) * scale;
// dQ = dS K; dK = dS^T Q. P is rounded to the tensors' type for dV, dS for
// dQ and dK (fp32 products run in TF32); every product accumulates in fp32.
//
// Bound on this card: at the self-attention shapes the five (S, S, D)
// products per head dominate (10 * B * S^2 * C operations), so the backward
// is tensor-core bound; at the 77-key sites it reads q, o, dO and writes dq
// once and is bound by memory. The log-sum-exp comes from kernel A, so no
// launch recomputes the statistics; three launches on one stream, no
// atomics (deterministic):
//   1. delta: rowsum(dO * O) per (batch*head, query), a memory-bound pass;
//   2. dk/dv: per (64-key tile, batch*head), four warps of 16 keys stream
//      the query tiles (q, dO, lse and delta in a two-stage cp.async ring)
//      and run S^T, dP^T, dV and dK (4 products);
//   3. dq: per (64-query tile, batch*head), four warps of 16 queries stream
//      the 64-key K/V tiles (two-stage cp.async ring) and run S, dP and dQ
//      (3 products).
// That is 7 (S_q, S_k, D) products against the math's 5: dq could instead
// be summed from launch 2 with fp32 atomics (5 products, not reproducible
// run to run); the separate launch keeps the gradient deterministic.
// D = 64 and 128 keep every accumulator in registers on mma.sync (m16n8k16
// bf16, m16n8k8 TF32; csrc/warp_mma.cuh): S^T, dP^T, P^T and dS^T of a warp
// never leave its registers, and the accumulator tiles feed the next
// product's A operand directly. Launch 2 streams 64 queries a tile at D = 64
// and 32 at D = 128, so dK + dV (D floats a thread) and S^T + dP^T (the tile
// width) stay within the register file without spilling.
// Heads are read at column offset h*D of the packed rows (no relayout).
// Ragged query and key tails are masked: a query past S_q gets log-sum-exp
// +inf (P = 0), a key past S_k gets P = 0 (its rows are zero-filled).
// Launch 2 is skipped when the caller needs no dk/dv (cross-attention keys
// come from the text).
//
// Head dims other than 64 and 128 (any D % 64 == 0, which lvd_tpu's
// predicates take) run a D-sliced form of launches 2 and 3 on WMMA: block z
// of a tile owns columns [64z, 64z + 64) of dK and dV, or of dQ: for each
// tile pair it sums S and dP = dO V^T over D in 64-wide chunks (the partial
// sums kept in the warp's fp32 shared tiles, so registers do not grow),
// then forms P and dS and multiplies them into its slice of q, dO or k.
// Shared memory and registers are those of D = 64 plus two (launch 2) or one
// (launch 3) slice tiles (fp32: 181 / 145 KB); each of the D/64 blocks
// recomputes S and dP.
#include "common.cuh"
#include "warp_mma.cuh"

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

// ---- Launch 1: delta = rowsum(dO * O) ----

// One thread per (batch, query, head) row of D values; delta is laid out
// (B*H, Sq) like the log-sum-exp.
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int B, int H, int Sq, int C) {
  constexpr int V = kVecN<T>;
  const int D = C / H;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // head fastest
  if (idx >= (long long)B * Sq * H) return;
  const int h = (int)(idx % H);
  const long long bq = idx / H;
  const int b = (int)(bq / Sq), qq = (int)(bq % Sq);
  const T* orow = o + bq * C + (size_t)h * D;
  const T* drow = dout + bq * C + (size_t)h * D;
  float d = 0.f;
  for (int j = 0; j < D; j += V) {
    Vec<T> ov, dv;
    ov.u = *reinterpret_cast<const uint4*>(orow + j);
    dv.u = *reinterpret_cast<const uint4*>(drow + j);
#pragma unroll
    for (int e = 0; e < V; ++e) d += to_f(ov.h[e]) * to_f(dv.h[e]);
  }
  delta[((size_t)b * H + h) * Sq + qq] = d;
}

// ---- D = 64 and 128: register-resident products on mma.sync ----

template <typename T, int D>
struct RegBwdCfg {
  static constexpr int kLd = D + wm::WarpMma<T>::kPadE;  // tile rows, elements
  static constexpr int kBKey = 64;                       // dk/dv: keys per block
  static constexpr int kBQ = D == 64 ? 64 : 32;          // dk/dv: queries per streamed tile
  static constexpr int kBQd = 64;                        // dq: queries per block
  static constexpr int kBKd = 64;                        // dq: keys per streamed tile
  // dk/dv: K, V, two stages of (q, dO) and of (lse, delta).
  static constexpr int kDkdvSmem = (2 * kBKey + 4 * kBQ) * kLd * (int)sizeof(T) + 4 * kBQ * 4;
  // dq: q, dO, two stages of (K, V).
  static constexpr int kDqSmem = (2 * kBQd + 4 * kBKd) * kLd * (int)sizeof(T);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int H, int Sq, int Sk, int C, float scale, float scale_log2e) {
  using Cfg = RegBwdCfg<T, D>;
  using W = wm::WarpMma<T>;
  constexpr int ld = Cfg::kLd, BQ = Cfg::kBQ, NQ = BQ / 8, ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + Cfg::kBKey * ld;
  T* QDs = Vs + Cfg::kBKey * ld;  // stage s: q at 2s, dO at 2s + 1 (BQ rows each)
  float* stats = reinterpret_cast<float*>(QDs + 4 * BQ * ld);  // stage s: lse, then delta
  const int k0 = blockIdx.x * Cfg::kBKey;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head = (size_t)h * D;
  const T* qb = q + (size_t)b * Sq * C + head;
  const T* db = dout + (size_t)b * Sq * C + head;
  const float* lse_b = lse + (size_t)bh * Sq;
  const float* delta_b = delta + (size_t)bh * Sq;
  const int nq = (Sq + BQ - 1) / BQ;

  // Query tile i into stage i & 1: q and dO asynchronously, the statistics
  // directly (a query past S_q gets lse = +inf, so P = 0).
  auto load_stage = [&](int i) {
    T* qs = QDs + 2 * (i & 1) * BQ * ld;
    wm::cp_rows<T, D>(qs, ld, qb, i * BQ, BQ, Sq, C, kThreads);
    wm::cp_rows<T, D>(qs + BQ * ld, ld, db, i * BQ, BQ, Sq, C, kThreads);
    float* st = stats + 2 * (i & 1) * BQ;
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const int qi = i * BQ + r;
      st[r] = qi < Sq ? lse_b[qi] : INFINITY;
      st[BQ + r] = qi < Sq ? delta_b[qi] : 0.f;
    }
  };
  wm::cp_rows<T, D>(Ks, ld, k + (size_t)b * Sk * C + head, k0, Cfg::kBKey, Sk, C, kThreads);
  wm::cp_rows<T, D>(Vs, ld, v + (size_t)b * Sk * C + head, k0, Cfg::kBKey, Sk, C, kThreads);
  load_stage(0);
  wm::cp_async_commit();

  float dka[ND][4] = {}, dva[ND][4] = {};
  const T* Kw = Ks + warp * 16 * ld;
  const T* Vw = Vs + warp * 16 * ld;
  const int t2 = 2 * (lane % 4);
  for (int i = 0; i < nq; ++i) {
    if (i + 1 < nq) load_stage(i + 1);  // that stage is free since the last barrier
    wm::cp_async_commit();
    wm::cp_async_wait<1>();
    __syncthreads();
    const T* Qt = QDs + 2 * (i & 1) * BQ * ld;
    const T* Dt = Qt + BQ * ld;
    const float* st = stats + 2 * (i & 1) * BQ;

    // S^T = K_w Q^T and dP^T = V_w dO^T: the warp's 16 keys x BQ queries.
    float sa[NQ][4] = {}, dpa[NQ][4] = {};
    wm::mma_rows_nk<T, NQ>(sa, Kw, Qt, ld, D, lane);
    wm::mma_rows_nk<T, NQ>(dpa, Vw, Dt, ld, D, lane);
    // P^T and dS^T in place; element e of tile c is query 8c + t2 + (e & 1).
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * c + t2 + (e & 1);
        const float p = exp2f(fmaf(sa[c][e], scale_log2e, -st[qi]));
        sa[c][e] = p;
        dpa[c][e] = p * (dpa[c][e] - st[BQ + qi]) * scale;
      }
    }
    // dV += P^T dO; dK += dS^T Q.
    wm::mma_acc_kn<T, NQ, ND>(dva, sa, Dt, ld, lane);
    wm::mma_acc_kn<T, NQ, ND>(dka, dpa, Qt, ld, lane);
    __syncthreads();  // every warp is done with this stage
  }

  const int row0 = k0 + warp * 16 + lane / 4;
  T* dkb = dk + (size_t)b * Sk * C + head + t2;
  T* dvb = dv + (size_t)b * Sk * C + head + t2;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (row0 < Sk) {
      W::store2(dkb + (size_t)row0 * C + 8 * n, dka[n][0], dka[n][1]);
      W::store2(dvb + (size_t)row0 * C + 8 * n, dva[n][0], dva[n][1]);
    }
    if (row0 + 8 < Sk) {
      W::store2(dkb + (size_t)(row0 + 8) * C + 8 * n, dka[n][2], dka[n][3]);
      W::store2(dvb + (size_t)(row0 + 8) * C + 8 * n, dva[n][2], dva[n][3]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int H, int Sq, int Sk,
                   int C, float scale, float scale_log2e) {
  using Cfg = RegBwdCfg<T, D>;
  using W = wm::WarpMma<T>;
  constexpr int ld = Cfg::kLd, BK = Cfg::kBKd, NK = BK / 8, ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ds = Qs + Cfg::kBQd * ld;
  T* KVs = Ds + Cfg::kBQd * ld;  // stage s: K at 2s, V at 2s + 1
  const int q0 = blockIdx.x * Cfg::kBQd;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head = (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * C + head;
  const T* vb = v + (size_t)b * Sk * C + head;
  const int nk = (Sk + BK - 1) / BK;

  wm::cp_rows<T, D>(Qs, ld, q + (size_t)b * Sq * C + head, q0, Cfg::kBQd, Sq, C, kThreads);
  wm::cp_rows<T, D>(Ds, ld, dout + (size_t)b * Sq * C + head, q0, Cfg::kBQd, Sq, C, kThreads);
  wm::cp_rows<T, D>(KVs, ld, kb, 0, BK, Sk, C, kThreads);
  wm::cp_rows<T, D>(KVs + BK * ld, ld, vb, 0, BK, Sk, C, kThreads);
  wm::cp_async_commit();

  // The statistics of the lane's two rows (past S_q: P = 0).
  const int row0 = q0 + warp * 16 + lane / 4;
  const float* lse_b = lse + (size_t)bh * Sq;
  const float* delta_b = delta + (size_t)bh * Sq;
  const float lse0 = row0 < Sq ? lse_b[row0] : INFINITY;
  const float lse1 = row0 + 8 < Sq ? lse_b[row0 + 8] : INFINITY;
  const float dl0 = row0 < Sq ? delta_b[row0] : 0.f;
  const float dl1 = row0 + 8 < Sq ? delta_b[row0 + 8] : 0.f;
  const int t2 = 2 * (lane % 4);

  float dqa[ND][4] = {};
  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {
      T* nxt = KVs + 2 * ((j + 1) & 1) * BK * ld;
      wm::cp_rows<T, D>(nxt, ld, kb, (j + 1) * BK, BK, Sk, C, kThreads);
      wm::cp_rows<T, D>(nxt + BK * ld, ld, vb, (j + 1) * BK, BK, Sk, C, kThreads);
    }
    wm::cp_async_commit();
    wm::cp_async_wait<1>();
    __syncthreads();
    const T* Kt = KVs + 2 * (j & 1) * BK * ld;
    const T* Vt = Kt + BK * ld;

    // S = Q_w K^T and dP = dO_w V^T: the warp's 16 queries x BK keys.
    float sa[NK][4] = {}, dpa[NK][4] = {};
    wm::mma_rows_nk<T, NK>(sa, Qs + warp * 16 * ld, Kt, ld, D, lane);
    wm::mma_rows_nk<T, NK>(dpa, Ds + warp * 16 * ld, Vt, ld, D, lane);
    const bool tail = (j + 1) * BK > Sk;
#pragma unroll
    for (int c = 0; c < NK; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sa[c][e], scale_log2e, e < 2 ? -lse0 : -lse1));
        const float ds = p * (dpa[c][e] - (e < 2 ? dl0 : dl1)) * scale;
        dpa[c][e] = (tail && j * BK + 8 * c + t2 + (e & 1) >= Sk) ? 0.f : ds;
      }
    }
    wm::mma_acc_kn<T, NK, ND>(dqa, dpa, Kt, ld, lane);  // dQ += dS K
    __syncthreads();
  }

  T* dqb = dq + (size_t)b * Sq * C + head + t2;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (row0 < Sq) W::store2(dqb + (size_t)row0 * C + 8 * n, dqa[n][0], dqa[n][1]);
    if (row0 + 8 < Sq) W::store2(dqb + (size_t)(row0 + 8) * C + 8 * n, dqa[n][2], dqa[n][3]);
  }
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int B, int H, int Sq,
                         int C, cudaStream_t s) {
  const long long rows = (long long)B * Sq * H;
  attn_bwd_delta_kernel<T><<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, B, H, Sq, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sliced(const void* q, const void* k, const void* v, const void* dout,
                          void* dq, void* dk, void* dv, const float* lse, const float* delta,
                          int B, int H, int Sq, int Sk, int C, int D, float scale,
                          cudaStream_t s) {
  using Cfg = BwdCfg<T, 64>;
  constexpr int kDkdvSmem = Cfg::kDkdvSmem + 2 * Cfg::kTile;
  constexpr int kDqSmem = Cfg::kDqSmem + Cfg::kTile;
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto dp = static_cast<const T*>(dout);
  const float sl2e = scale * 1.4426950408889634f;
  const int qt = (Sq + kBT - 1) / kBT, kt = (Sk + kBT - 1) / kBT, nd = D / 64;
  cudaError_t err;
  if (dk != nullptr) {
    if ((err = set_smem(attn_bwd_sliced_dkdv_kernel<T>, kDkdvSmem)) != cudaSuccess) return err;
    attn_bwd_sliced_dkdv_kernel<T><<<dim3(B * H, kt, nd), kThreads, kDkdvSmem, s>>>(
        qp, kp, vp, dp, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, C, D,
        scale, sl2e);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = set_smem(attn_bwd_sliced_dq_kernel<T>, kDqSmem)) != cudaSuccess) return err;
  attn_bwd_sliced_dq_kernel<T><<<dim3(B * H, qt, nd), kThreads, kDqSmem, s>>>(
      qp, kp, vp, dp, lse, delta, static_cast<T*>(dq), H, Sq, Sk, C, D, scale, sl2e);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, const float* lse, const float* delta, int B, int H, int Sq,
                   int Sk, int C, float scale, cudaStream_t s) {
  using Cfg = RegBwdCfg<T, D>;
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto dp = static_cast<const T*>(dout);
  const float sl2e = scale * 1.4426950408889634f;
  cudaError_t err;
  if (dk != nullptr) {
    if ((err = set_smem(attn_bwd_dkdv_kernel<T, D>, Cfg::kDkdvSmem)) != cudaSuccess) return err;
    const dim3 grid((Sk + Cfg::kBKey - 1) / Cfg::kBKey, B * H);
    attn_bwd_dkdv_kernel<T, D><<<grid, kThreads, Cfg::kDkdvSmem, s>>>(
        qp, kp, vp, dp, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, C, scale,
        sl2e);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = set_smem(attn_bwd_dq_kernel<T, D>, Cfg::kDqSmem)) != cudaSuccess) return err;
  const dim3 grid((Sq + Cfg::kBQd - 1) / Cfg::kBQd, B * H);
  attn_bwd_dq_kernel<T, D><<<grid, kThreads, Cfg::kDqSmem, s>>>(
      qp, kp, vp, dp, lse, delta, static_cast<T*>(dq), H, Sq, Sk, C, scale, sl2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lvd

// q, o, dout, dq: (B, Sq, C); k, v, dk, dv: (B, Sk, C); all of one type
// (dtype 0 bf16, 1 fp32), C = H*D with D % 64 == 0 (64 and 128 run their
// own kernels, every other D the D-sliced form). lse: (B*H, Sq) fp32, the
// base-2 log-sum-exp kernel A wrote for these q, k (required); delta:
// (B*H, Sq) fp32 scratch. dk and dv may both be null (only dq is computed
// then).
LVD_EXPORT int lvd_attention_packed_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, void* dq, void* dk,
                                        void* dv, const void* lse, void* delta, int B, int H,
                                        int Sq, int Sk, int C, float scale, int dtype,
                                        void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (H <= 0 || C % H != 0 || Sq <= 0 || Sk <= 0 || (dk == nullptr) != (dv == nullptr) ||
      lse == nullptr || delta == nullptr)
    return cudaErrorInvalidValue;
  const int D = C / H;
  if (D % 64 != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto dl = static_cast<float*>(delta);
  return dispatch(dtype, [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    cudaError_t err = launch_delta<T>(o, dout, dl, B, H, Sq, C, s);
    if (err != cudaSuccess) return err;
    if (D == 64) return launch<T, 64>(q, k, v, dout, dq, dk, dv, l, dl, B, H, Sq, Sk, C, scale, s);
    if (D == 128)
      return launch<T, 128>(q, k, v, dout, dq, dk, dv, l, dl, B, H, Sq, Sk, C, scale, s);
    return launch_sliced<T>(q, k, v, dout, dq, dk, dv, l, dl, B, H, Sq, Sk, C, D, scale, s);
  });
}

// Bytes of dynamic shared memory one block of kernel E's dk/dv (kind 0) or
// dq (kind 1) launch takes at head dim D (dtype 0 bf16, 1 fp32): the
// D = 64 / 128 kernels, else the D-sliced form.
LVD_EXPORT long long lvd_attention_packed_bwd_smem(int D, int dtype, int kind) {
  using namespace lvd;
  auto pick = [&](auto tag) -> long long {
    using T = decltype(tag);
    using S = BwdCfg<T, 64>;
    if (D == 64) return kind == 0 ? RegBwdCfg<T, 64>::kDkdvSmem : RegBwdCfg<T, 64>::kDqSmem;
    if (D == 128) return kind == 0 ? RegBwdCfg<T, 128>::kDkdvSmem : RegBwdCfg<T, 128>::kDqSmem;
    return kind == 0 ? S::kDkdvSmem + 2 * S::kTile : S::kDqSmem + S::kTile;
  };
  return dtype == kBF16 ? pick(bf16{}) : pick(float{});
}
