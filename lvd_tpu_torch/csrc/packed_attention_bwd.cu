// Kernel E: the backward of exact-softmax attention on head-packed
// (B, S, H*64) tensors: dq, dk, dv from q, k, v, o and dO.
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
// dQ = dS K; dK = dS^T Q. P is rounded to bf16 for dV, dS for dQ and dK;
// every product accumulates in fp32.
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
// Heads are read at column offset h*64 of the packed rows (no relayout).
// Ragged query and key tails are masked: a query past S_q gets log-sum-exp
// +inf (P = 0), a key past S_k gets P = 0. Launch 2 is skipped when the
// caller needs no dk/dv (cross-attention keys come from the text).
#include "common.cuh"

namespace lvd {
namespace {

constexpr int kD = 64;
constexpr int kBT = 64;     // queries or keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLdb = 80;    // bf16 smem row stride (160 B)
constexpr int kLdf = 72;    // fp32 smem row stride (288 B)

// Copies rows [r0, r0 + 64) of head h into a (64, kLdb) smem tile; rows past
// `rows` are zero.
__device__ inline void load_tile(bf16* dst, const bf16* src, int r0, int rows, int C) {
  for (int i = threadIdx.x; i < kBT * 8; i += kThreads) {
    const int r = i / 8, c8 = i % 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * C + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * kLdb + c8 * 8) = val;
  }
}

// Writes a warp's (16, 64) fp32 accumulators as bf16 rows [r0, r0 + 16) of
// head h, through a (16, kLdf) staging tile; rows past `rows` are dropped.
__device__ inline void store_rows(const FragAcc (&acc)[4], float* stage, bf16* dst, int r0,
                                  int rows, int C, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc[n], kLdf, wmma::mem_row_major);
  __syncwarp();
  const int row = lane >> 1, half = lane & 1;
  if (r0 + row < rows) {
    const float* src = stage + row * kLdf + half * 32;
    bf16* out = dst + (size_t)(r0 + row) * C + half * 32;
#pragma unroll
    for (int j = 0; j < 32; j += 8) {
      Vec8 pack;
#pragma unroll
      for (int e = 0; e < 8; ++e) pack.h[e] = __float2bfloat16(src[j + e]);
      *reinterpret_cast<uint4*>(out + j) = pack.u;
    }
  }
  __syncwarp();
}

constexpr int kStatsSmem = 2 * kBT * kLdb * 2 + kWarps * 16 * kLdf * 4;

__global__ void __launch_bounds__(kThreads)
attn_bwd_stats_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      float* __restrict__ lse, float* __restrict__ delta, int H, int Sq, int Sk,
                      int C, float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBT * kLdb;
  float* Sw = reinterpret_cast<float*>(Ks + kBT * kLdb);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head = (size_t)h * kD;
  load_tile(Qs, q + (size_t)b * Sq * C + head, q0, Sq, C);
  __syncthreads();

  FragA qf[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * kLdb + kk * 16, kLdb);
  float* S = Sw + warp * 16 * kLdf;
  const int row = lane >> 1, half = lane & 1;
  float m_i = -INFINITY, l_i = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kBT) {
    __syncthreads();
    load_tile(Ks, k + (size_t)b * Sk * C + head, k0, Sk, C);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kBT / 16; ++n) {
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        FragBCol kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * kLdb + kk * 16, kLdb);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(S + n * 16, acc, kLdf, wmma::mem_row_major);
    }
    __syncwarp();
    const int kvalid = min(kBT, Sk - k0);
    const float* srow = S + row * kLdf + half * 32;
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

  const int qr = q0 + warp * 16 + row;
  float d = 0.f;
  if (qr < Sq) {
    const bf16* orow = o + ((size_t)b * Sq + qr) * C + head + half * 32;
    const bf16* drow = dout + ((size_t)b * Sq + qr) * C + head + half * 32;
    for (int j = 0; j < 32; j += 8) {
      Vec8 ov, dv;
      ov.u = *reinterpret_cast<const uint4*>(orow + j);
      dv.u = *reinterpret_cast<const uint4*>(drow + j);
#pragma unroll
      for (int e = 0; e < 8; ++e) d += __bfloat162float(ov.h[e]) * __bfloat162float(dv.h[e]);
    }
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  if (qr < Sq && half == 0) {
    const size_t at = (size_t)blockIdx.x * Sq + qr;
    lse[at] = m_i + log2f(l_i);
    delta[at] = d;
  }
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

constexpr int kDkdvSmem = 4 * kBT * kLdb * 2 + 2 * kBT * 4 + kWarps * 16 * (2 * kLdf * 4 + 2 * kLdb * 2);

__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk, int C,
                     float scale, float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBT * kLdb;
  bf16* Qs = Vs + kBT * kLdb;
  bf16* Ds = Qs + kBT * kLdb;
  float* lse_s = reinterpret_cast<float*>(Ds + kBT * kLdb);
  float* delta_s = lse_s + kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* St = delta_s + kBT + warp * 16 * 2 * kLdf;  // P^T (fp32), then staging
  float* dPt = St + 16 * kLdf;
  bf16* Pt = reinterpret_cast<bf16*>(delta_s + kBT + kWarps * 16 * 2 * kLdf) + warp * 16 * 2 * kLdb;
  bf16* dSt = Pt + 16 * kLdb;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kBT;
  const size_t head = (size_t)h * kD;
  const bf16* qb = q + (size_t)b * Sq * C + head;
  const bf16* db = dout + (size_t)b * Sq * C + head;
  const float* lse_b = lse + (size_t)blockIdx.x * Sq;
  const float* delta_b = delta + (size_t)blockIdx.x * Sq;
  load_tile(Ks, k + (size_t)b * Sk * C + head, k0, Sk, C);
  load_tile(Vs, v + (size_t)b * Sk * C + head, k0, Sk, C);

  FragAcc dka[4], dva[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::fill_fragment(dka[n], 0.f);
    wmma::fill_fragment(dva[n], 0.f);
  }
  const int row = lane >> 1, half = lane & 1;
  const bf16* Kw = Ks + warp * 16 * kLdb;
  const bf16* Vw = Vs + warp * 16 * kLdb;

  for (int q0 = 0; q0 < Sq; q0 += kBT) {
    __syncthreads();  // every warp is done with the previous query tile
    load_tile(Qs, qb, q0, Sq, C);
    load_tile(Ds, db, q0, Sq, C);
    load_stats(lse_s, delta_s, lse_b, delta_b, q0, Sq);
    __syncthreads();

    // S^T = K_w Q^T and dP^T = V_w dO^T, (16 keys, 64 queries) each.
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragAcc s, dp;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dp, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        FragA a;
        FragBCol bm;
        wmma::load_matrix_sync(a, Kw + kk * 16, kLdb);
        wmma::load_matrix_sync(bm, Qs + n * 16 * kLdb + kk * 16, kLdb);
        wmma::mma_sync(s, a, bm, s);
        wmma::load_matrix_sync(a, Vw + kk * 16, kLdb);
        wmma::load_matrix_sync(bm, Ds + n * 16 * kLdb + kk * 16, kLdb);
        wmma::mma_sync(dp, a, bm, dp);
      }
      wmma::store_matrix_sync(St + n * 16, s, kLdf, wmma::mem_row_major);
      wmma::store_matrix_sync(dPt + n * 16, dp, kLdf, wmma::mem_row_major);
    }
    __syncwarp();
    {
      const float* srow = St + row * kLdf + half * 32;
      const float* dprow = dPt + row * kLdf + half * 32;
      bf16* prow = Pt + row * kLdb + half * 32;
      bf16* dsrow = dSt + row * kLdb + half * 32;
      for (int j = 0; j < 32; ++j) {
        const int qi = half * 32 + j;
        const float p = exp2f(srow[j] * scale_log2e - lse_s[qi]);
        prow[j] = __float2bfloat16(p);
        dsrow[j] = __float2bfloat16(p * (dprow[j] - delta_s[qi]) * scale);
      }
    }
    __syncwarp();

    // dV += P^T dO; dK += dS^T Q.
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int kk = 0; kk < kBT / 16; ++kk) {
        FragA a;
        FragBRow bm;
        wmma::load_matrix_sync(a, Pt + kk * 16, kLdb);
        wmma::load_matrix_sync(bm, Ds + kk * 16 * kLdb + n * 16, kLdb);
        wmma::mma_sync(dva[n], a, bm, dva[n]);
        wmma::load_matrix_sync(a, dSt + kk * 16, kLdb);
        wmma::load_matrix_sync(bm, Qs + kk * 16 * kLdb + n * 16, kLdb);
        wmma::mma_sync(dka[n], a, bm, dka[n]);
      }
    }
  }

  const size_t out_b = (size_t)b * Sk * C + head;
  store_rows(dka, St, dk + out_b, k0 + warp * 16, Sk, C, lane);
  store_rows(dva, St, dv + out_b, k0 + warp * 16, Sk, C, lane);
}

constexpr int kDqSmem = 4 * kBT * kLdb * 2 + 2 * kBT * 4 + kWarps * 16 * (2 * kLdf * 4 + kLdb * 2);

__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int H, int Sq, int Sk, int C, float scale,
                   float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + kBT * kLdb;
  bf16* Ks = Ds + kBT * kLdb;
  bf16* Vs = Ks + kBT * kLdb;
  float* lse_s = reinterpret_cast<float*>(Vs + kBT * kLdb);
  float* delta_s = lse_s + kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* S = delta_s + kBT + warp * 16 * 2 * kLdf;  // logits, then staging
  float* dP = S + 16 * kLdf;
  bf16* dS = reinterpret_cast<bf16*>(delta_s + kBT + kWarps * 16 * 2 * kLdf) + warp * 16 * kLdb;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBT;
  const size_t head = (size_t)h * kD;
  load_tile(Qs, q + (size_t)b * Sq * C + head, q0, Sq, C);
  load_tile(Ds, dout + (size_t)b * Sq * C + head, q0, Sq, C);
  load_stats(lse_s, delta_s, lse + (size_t)blockIdx.x * Sq, delta + (size_t)blockIdx.x * Sq,
             q0, Sq);
  __syncthreads();

  FragA qf[kD / 16], df[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * kLdb + kk * 16, kLdb);
    wmma::load_matrix_sync(df[kk], Ds + warp * 16 * kLdb + kk * 16, kLdb);
  }
  FragAcc dqa[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(dqa[n], 0.f);
  const int row = lane >> 1, half = lane & 1;
  const float lse_r = lse_s[warp * 16 + row];
  const float delta_r = delta_s[warp * 16 + row];
  const bf16* kb = k + (size_t)b * Sk * C + head;
  const bf16* vb = v + (size_t)b * Sk * C + head;

  for (int k0 = 0; k0 < Sk; k0 += kBT) {
    __syncthreads();
    load_tile(Ks, kb, k0, Sk, C);
    load_tile(Vs, vb, k0, Sk, C);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragAcc s, dp;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dp, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        FragBCol bm;
        wmma::load_matrix_sync(bm, Ks + n * 16 * kLdb + kk * 16, kLdb);
        wmma::mma_sync(s, qf[kk], bm, s);
        wmma::load_matrix_sync(bm, Vs + n * 16 * kLdb + kk * 16, kLdb);
        wmma::mma_sync(dp, df[kk], bm, dp);
      }
      wmma::store_matrix_sync(S + n * 16, s, kLdf, wmma::mem_row_major);
      wmma::store_matrix_sync(dP + n * 16, dp, kLdf, wmma::mem_row_major);
    }
    __syncwarp();
    {
      const int kvalid = min(kBT, Sk - k0);
      const float* srow = S + row * kLdf + half * 32;
      const float* dprow = dP + row * kLdf + half * 32;
      bf16* dsrow = dS + row * kLdb + half * 32;
      for (int j = 0; j < 32; ++j) {
        const float p =
            (half * 32 + j < kvalid) ? exp2f(srow[j] * scale_log2e - lse_r) : 0.f;
        dsrow[j] = __float2bfloat16(p * (dprow[j] - delta_r) * scale);
      }
    }
    __syncwarp();
    // dQ += dS K
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int kk = 0; kk < kBT / 16; ++kk) {
        FragA a;
        FragBRow bm;
        wmma::load_matrix_sync(a, dS + kk * 16, kLdb);
        wmma::load_matrix_sync(bm, Ks + kk * 16 * kLdb + n * 16, kLdb);
        wmma::mma_sync(dqa[n], a, bm, dqa[n]);
      }
    }
  }
  store_rows(dqa, S, dq + (size_t)b * Sq * C + head, q0 + warp * 16, Sq, C, lane);
}

}  // namespace
}  // namespace lvd

// q, o, dout, dq: (B, Sq, C); k, v, dk, dv: (B, Sk, C); all bf16, C = H*64.
// lse and delta: (B*H*Sq) fp32 scratch. dk and dv may both be null (only dq
// is computed then).
LVD_EXPORT int lvd_attention_packed_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, void* dq, void* dk,
                                        void* dv, void* lse, void* delta, int B, int H, int Sq,
                                        int Sk, int C, float scale, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (C != H * kD || C % 8 != 0 || Sq <= 0 || Sk <= 0 || (dk == nullptr) != (dv == nullptr))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const bf16*>(q);
  auto kp = static_cast<const bf16*>(k);
  auto vp = static_cast<const bf16*>(v);
  auto dp = static_cast<const bf16*>(dout);
  auto lp = static_cast<float*>(lse);
  auto tp = static_cast<float*>(delta);
  const float sl2e = scale * 1.4426950408889634f;
  const dim3 qgrid(B * H, (Sq + kBT - 1) / kBT);
  cudaError_t err = set_smem(attn_bwd_stats_kernel, kStatsSmem);
  if (err != cudaSuccess) return err;
  attn_bwd_stats_kernel<<<qgrid, kThreads, kStatsSmem, s>>>(
      qp, kp, static_cast<const bf16*>(o), dp, lp, tp, H, Sq, Sk, C, sl2e);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (dk != nullptr) {
    if ((err = set_smem(attn_bwd_dkdv_kernel, kDkdvSmem)) != cudaSuccess) return err;
    attn_bwd_dkdv_kernel<<<dim3(B * H, (Sk + kBT - 1) / kBT), kThreads, kDkdvSmem, s>>>(
        qp, kp, vp, dp, lp, tp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk, C,
        scale, sl2e);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = set_smem(attn_bwd_dq_kernel, kDqSmem)) != cudaSuccess) return err;
  attn_bwd_dq_kernel<<<qgrid, kThreads, kDqSmem, s>>>(qp, kp, vp, dp, lp, tp,
                                                       static_cast<bf16*>(dq), H, Sq, Sk, C,
                                                       scale, sl2e);
  return cudaGetLastError();
}
