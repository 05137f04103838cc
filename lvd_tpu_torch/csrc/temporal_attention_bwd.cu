// Kernel F: the input gradient (dy only) of the fused temporal double
// self-attention y -> x1 = y + A1(LN1(y)) -> x2 = x1 + A2(LN2(x1)) over the F
// frames of each pixel. Weight and bias gradients are not computed (the
// guided gradient is taken with respect to the latents only).
//
// Replaces lvd_tpu/ops/temporal_attention.py `_pallas_pair_bwd`
// (`_tattn_bwd_kernel`).
//
// Math (as the TPU kernel): recompute LN1 -> attn1 -> +res -> LN2; then
//   dz2 = VJP_A2(u2 = dy);  dx1 = u2 + VJP_LN2(dz2);
//   dz1 = VJP_A1(dx1);      dx0 = dx1 + VJP_LN1(dz1),
// where one attention's VJP, per head h, with P the block-diagonal softmax:
//   dO = u Wo[h]^T; dV = P^T dO; dP = dO V^T;
//   dL = (dP * P - P * rowsum(dP * P)) * scale; dQ = dL K; dK = dL^T Q,
// and dz = [dQ | dK | dV] Wqkv^T summed over heads; the LayerNorm VJP is
// rstd * (g - mean(g) - xhat * mean(g * xhat)) with g = dz * ln_scale.
// q/k/v, P, dO, dL and dQ/dK/dV are rounded to bf16 where the TPU kernel
// rounds them; statistics, products and the cotangent u stay fp32.
//
// Bound on this card: the (C, 3C) and (C, C) projections, run four times
// over the rows (qkv twice, dO and dz twice, and the forward recompute),
// carry almost all of the operations, so the kernel is tensor-core bound.
// Design: like kernel B, one block holds G = 2 pixels x F frames (48 rows at
// F = 24) and works through the whole chain for them; the bf16 rows of the
// residual stream and of the LayerNorm output sit in shared memory beside
// the per-head q/k/v, dO, dQ/dK/dV and the (R, R) probability, dP and dL
// tiles (216 KB at C = 640). The two (R, C) fp32 tensors of the chain, the
// cotangent u and the accumulator of dz (first the forward's output
// projection), do not fit beside them: they live in a workspace in device
// memory private to the block (with a bf16 copy of u as a WMMA operand),
// written and read by the same block, so it stays in L2. Strides let the
// kernel read the frames-major (B, F, P, C) stream at every C (320, 512,
// 640); the TPU fell back to pixels-major with transposes at C = 640.
#include "common.cuh"

namespace lvd {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kD = 64;
constexpr int kLdh = 80;  // bf16 row stride of the per-head (R, 64) tiles

using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

struct BwdLayout {
  int ldc;
  size_t xs, zs, qs, ks, vs, os, dqs, dks, dvs, S, Pf, Pb, Lb, stats, scratch, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int R, int C) {
  BwdLayout L;
  L.ldc = C + 16;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    size_t at = off;
    off += (bytes + 127) / 128 * 128;
    return at;
  };
  L.xs = take((size_t)R * L.ldc * 2);
  L.zs = take((size_t)R * L.ldc * 2);
  L.qs = take((size_t)R * kLdh * 2);
  L.ks = take((size_t)R * kLdh * 2);
  L.vs = take((size_t)R * kLdh * 2);
  L.os = take((size_t)R * kLdh * 2);
  L.dqs = take((size_t)R * kLdh * 2);
  L.dks = take((size_t)R * kLdh * 2);
  L.dvs = take((size_t)R * kLdh * 2);
  L.S = take((size_t)R * R * 4);
  L.Pf = take((size_t)R * R * 4);
  L.Pb = take((size_t)R * R * 2);
  L.Lb = take((size_t)R * R * 2);
  L.stats = take((size_t)4 * R * 4);
  L.scratch = take((size_t)kWarps * 256 * 4);
  L.total = off;
  return L;
}

struct PairWeights {
  const float* ln_s;  // (C,) fp32
  const float* ln_b;  // (C,) fp32
  const bf16* wqkv;   // (C, 3C): [Wq | Wk | Wv]
  const bf16* wo;     // (C, C)
  const float* bo;    // (C,) fp32
};

// The block's shared-memory views and device-memory workspace rows.
struct Tile {
  bf16 *xs, *zs, *qs, *ks, *vs, *os, *dqs, *dks, *dvs, *Pb, *Lb;
  float *S, *Pf, *stats, *scratch;
  float* U;   // (R, C) fp32 cotangent
  float* A;   // (R, C) fp32 accumulator: attn1's projection, then dz
  bf16* UB;   // (R, C) bf16 copy of U
  int R, ldc, C, H, F, valid;
  float eps, scale, scale_log2e;
};

// LayerNorm of the rows of X into Z (bf16), keeping mean and rstd; rows past
// `valid` are zero. One warp per row, one-pass fp32 statistics.
__device__ void ln_rows(const Tile& t, const PairWeights& w, float* mean, float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < t.R; r += kWarps) {
    bf16* dst = t.zs + r * t.ldc;
    if (r >= t.valid) {
      for (int c = lane; c < t.C; c += 32) dst[c] = __float2bfloat16(0.f);
      if (lane == 0) mean[r] = rstd[r] = 0.f;
      continue;
    }
    const bf16* src = t.xs + r * t.ldc;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < t.C; c += 32) {
      const float x = __bfloat162float(src[c]);
      s1 += x;
      s2 += x * x;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mu = s1 / t.C;
    const float rs = rsqrtf(fmaxf(s2 / t.C - mu * mu, 0.f) + t.eps);
    for (int c = lane; c < t.C; c += 32)
      dst[c] = __float2bfloat16((__bfloat162float(src[c]) - mu) * rs * w.ln_s[c] + w.ln_b[c]);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
  }
}

// q, k, v of head h (bf16, (R, 64) each) from Z and Wqkv; then the masked
// block-diagonal softmax: Pf (fp32) and Pb (bf16), zero outside each
// pixel's F x F block and on padded rows.
__device__ void head_probs(const Tile& t, const PairWeights& w, int h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int RT = t.R / 16, C = t.C;
  float* scr = t.scratch + warp * 256;
  for (int i = warp; i < 3 * RT * 4; i += kWarps) {
    const int mat = i / (RT * 4), rt = (i % (RT * 4)) / 4, ct = i % 4;
    const bf16* bcol = w.wqkv + mat * C + h * kD + ct * 16;
    FragAcc acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < C; kk += 16) {
      FragA a;
      FragBRow bm;
      wmma::load_matrix_sync(a, t.zs + rt * 16 * t.ldc + kk, t.ldc);
      wmma::load_matrix_sync(bm, bcol + (size_t)kk * 3 * C, 3 * C);
      wmma::mma_sync(acc, a, bm, acc);
    }
    bf16* dst = (mat == 0 ? t.qs : mat == 1 ? t.ks : t.vs) + rt * 16 * kLdh + ct * 16;
    drain_tile(acc, scr, lane,
               [&](int r, int c, float val) { dst[r * kLdh + c] = __float2bfloat16(val); });
  }
  __syncthreads();
  for (int i = warp; i < RT * RT; i += kWarps) {
    const int a_t = i / RT, b_t = i % RT;
    FragAcc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kD; kk += 16) {
      FragA a;
      FragBCol bm;
      wmma::load_matrix_sync(a, t.qs + a_t * 16 * kLdh + kk, kLdh);
      wmma::load_matrix_sync(bm, t.ks + b_t * 16 * kLdh + kk, kLdh);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(t.S + a_t * 16 * t.R + b_t * 16, acc, t.R, wmma::mem_row_major);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < t.R; r += kThreads) {
    float* pf = t.Pf + r * t.R;
    bf16* pb = t.Pb + r * t.R;
    for (int c = 0; c < t.R; ++c) {
      pf[c] = 0.f;
      pb[c] = __float2bfloat16(0.f);
    }
    if (r < t.valid) {
      const float* srow = t.S + r * t.R;
      const int c0 = (r / t.F) * t.F;
      float mx = -INFINITY;
      for (int c = c0; c < c0 + t.F; ++c) mx = fmaxf(mx, srow[c] * t.scale_log2e);
      float sum = 0.f;
      for (int c = c0; c < c0 + t.F; ++c) sum += exp2f(srow[c] * t.scale_log2e - mx);
      const float inv = 1.f / sum;
      for (int c = c0; c < c0 + t.F; ++c) {
        const float p = exp2f(srow[c] * t.scale_log2e - mx) * inv;
        pf[c] = p;
        pb[c] = __float2bfloat16(p);
      }
    }
  }
  __syncthreads();
}

// Forward recompute of one attention's output projection: for head h,
// o_h = Pb V (bf16) and A (+)= o_h Wo[h] (fp32, device-memory workspace).
__device__ void head_forward_out(const Tile& t, const PairWeights& w, int h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int RT = t.R / 16, CT = t.C / 16;
  float* scr = t.scratch + warp * 256;
  for (int i = warp; i < RT * 4; i += kWarps) {
    const int rt = i / 4, ct = i % 4;
    FragAcc acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < t.R; kk += 16) {
      FragA a;
      FragBRow bm;
      wmma::load_matrix_sync(a, t.Pb + rt * 16 * t.R + kk, t.R);
      wmma::load_matrix_sync(bm, t.vs + kk * kLdh + ct * 16, kLdh);
      wmma::mma_sync(acc, a, bm, acc);
    }
    bf16* dst = t.os + rt * 16 * kLdh + ct * 16;
    drain_tile(acc, scr, lane,
               [&](int r, int c, float val) { dst[r * kLdh + c] = __float2bfloat16(val); });
  }
  __syncthreads();
  for (int i = warp; i < RT * CT; i += kWarps) {
    const int rt = i / CT, ct = i % CT;
    float* tile = t.A + (size_t)rt * 16 * t.C + ct * 16;
    FragAcc acc;
    if (h == 0) {
      wmma::fill_fragment(acc, 0.f);
    } else {
      wmma::load_matrix_sync(acc, tile, t.C, wmma::mem_row_major);
    }
#pragma unroll
    for (int kk = 0; kk < kD; kk += 16) {
      FragA a;
      FragBRow bm;
      wmma::load_matrix_sync(a, t.os + rt * 16 * kLdh + kk, kLdh);
      wmma::load_matrix_sync(bm, w.wo + (size_t)(h * kD + kk) * t.C + ct * 16, t.C);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(tile, acc, t.C, wmma::mem_row_major);
  }
  __syncthreads();
}

// The VJP of one attention at its LayerNorm output Z, for the cotangent U
// (UB in bf16): A = dz = sum_h [dQ | dK | dV]_h Wqkv_h^T.
__device__ void attn_backward(const Tile& t, const PairWeights& w) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int RT = t.R / 16, CT = t.C / 16, C = t.C;
  float* scr = t.scratch + warp * 256;
  for (int h = 0; h < t.H; ++h) {
    head_probs(t, w, h);
    // dO = UB Wo[h]^T: (R, 64), Wo[h] read column-major from its 64 rows.
    for (int i = warp; i < RT * 4; i += kWarps) {
      const int rt = i / 4, ct = i % 4;
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
      const bf16* wcol = w.wo + (size_t)(h * kD + ct * 16) * C;
      for (int kk = 0; kk < C; kk += 16) {
        FragA a;
        FragBCol bm;
        wmma::load_matrix_sync(a, t.UB + (size_t)rt * 16 * C + kk, C);
        wmma::load_matrix_sync(bm, wcol + kk, C);
        wmma::mma_sync(acc, a, bm, acc);
      }
      bf16* dst = t.os + rt * 16 * kLdh + ct * 16;
      drain_tile(acc, scr, lane,
                 [&](int r, int c, float val) { dst[r * kLdh + c] = __float2bfloat16(val); });
    }
    __syncthreads();
    // dV = Pb^T dO (R, 64) and dP = dO V^T (R, R) into S.
    for (int i = warp; i < RT * 4 + RT * RT; i += kWarps) {
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
      if (i < RT * 4) {
        const int rt = i / 4, ct = i % 4;
        for (int kk = 0; kk < t.R; kk += 16) {
          FragACol a;
          FragBRow bm;
          wmma::load_matrix_sync(a, t.Pb + kk * t.R + rt * 16, t.R);
          wmma::load_matrix_sync(bm, t.os + kk * kLdh + ct * 16, kLdh);
          wmma::mma_sync(acc, a, bm, acc);
        }
        bf16* dst = t.dvs + rt * 16 * kLdh + ct * 16;
        drain_tile(acc, scr, lane,
                   [&](int r, int c, float val) { dst[r * kLdh + c] = __float2bfloat16(val); });
      } else {
        const int j = i - RT * 4, a_t = j / RT, b_t = j % RT;
#pragma unroll
        for (int kk = 0; kk < kD; kk += 16) {
          FragA a;
          FragBCol bm;
          wmma::load_matrix_sync(a, t.os + a_t * 16 * kLdh + kk, kLdh);
          wmma::load_matrix_sync(bm, t.vs + b_t * 16 * kLdh + kk, kLdh);
          wmma::mma_sync(acc, a, bm, acc);
        }
        wmma::store_matrix_sync(t.S + a_t * 16 * t.R + b_t * 16, acc, t.R, wmma::mem_row_major);
      }
    }
    __syncthreads();
    // Softmax VJP within each pixel's block.
    for (int r = threadIdx.x; r < t.R; r += kThreads) {
      bf16* lrow = t.Lb + r * t.R;
      for (int c = 0; c < t.R; ++c) lrow[c] = __float2bfloat16(0.f);
      if (r < t.valid) {
        const float* dp = t.S + r * t.R;
        const float* p = t.Pf + r * t.R;
        const int c0 = (r / t.F) * t.F;
        float s = 0.f;
        for (int c = c0; c < c0 + t.F; ++c) s += dp[c] * p[c];
        for (int c = c0; c < c0 + t.F; ++c)
          lrow[c] = __float2bfloat16((dp[c] * p[c] - p[c] * s) * t.scale);
      }
    }
    __syncthreads();
    // dQ = dL K and dK = dL^T Q, (R, 64) each.
    for (int i = warp; i < 2 * RT * 4; i += kWarps) {
      const bool is_k = i >= RT * 4;
      const int rt = (i % (RT * 4)) / 4, ct = i % 4;
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < t.R; kk += 16) {
        FragBRow bm;
        if (is_k) {
          FragACol a;
          wmma::load_matrix_sync(a, t.Lb + kk * t.R + rt * 16, t.R);
          wmma::load_matrix_sync(bm, t.qs + kk * kLdh + ct * 16, kLdh);
          wmma::mma_sync(acc, a, bm, acc);
        } else {
          FragA a;
          wmma::load_matrix_sync(a, t.Lb + rt * 16 * t.R + kk, t.R);
          wmma::load_matrix_sync(bm, t.ks + kk * kLdh + ct * 16, kLdh);
          wmma::mma_sync(acc, a, bm, acc);
        }
      }
      bf16* dst = (is_k ? t.dks : t.dqs) + rt * 16 * kLdh + ct * 16;
      drain_tile(acc, scr, lane,
                 [&](int r, int c, float val) { dst[r * kLdh + c] = __float2bfloat16(val); });
    }
    __syncthreads();
    // A (+)= [dQ | dK | dV] [Wq_h | Wk_h | Wv_h]^T, Wqkv read column-major.
    for (int i = warp; i < RT * CT; i += kWarps) {
      const int rt = i / CT, ct = i % CT;
      float* tile = t.A + (size_t)rt * 16 * C + ct * 16;
      FragAcc acc;
      if (h == 0) {
        wmma::fill_fragment(acc, 0.f);
      } else {
        wmma::load_matrix_sync(acc, tile, C, wmma::mem_row_major);
      }
      const bf16* wrow = w.wqkv + (size_t)ct * 16 * 3 * C + h * kD;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const bf16* src = (m == 0 ? t.dqs : m == 1 ? t.dks : t.dvs) + rt * 16 * kLdh;
#pragma unroll
        for (int kk = 0; kk < kD; kk += 16) {
          FragA a;
          FragBCol bm;
          wmma::load_matrix_sync(a, src + kk, kLdh);
          wmma::load_matrix_sync(bm, wrow + m * C + kk, 3 * C);
          wmma::mma_sync(acc, a, bm, acc);
        }
      }
      wmma::store_matrix_sync(tile, acc, C, wmma::mem_row_major);
    }
    __syncthreads();
  }
}

// U += VJP of the LayerNorm of X at dz = A. With `out` null, UB gets bf16(U);
// otherwise bf16(U) is written to the output rows instead.
__device__ void ln_backward(const Tile& t, const PairWeights& w, const float* mean,
                            const float* rstd, bf16* out, long long sF, long long sP, int p0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C = t.C;
  for (int r = warp; r < t.valid; r += kWarps) {
    const bf16* x = t.xs + r * t.ldc;
    float* dz = t.A + (size_t)r * C;
    float* u = t.U + (size_t)r * C;
    const float mu = mean[r], rs = rstd[r];
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float g = dz[c] * w.ln_s[c];
      m1 += g;
      m2 += g * (__bfloat162float(x[c]) - mu) * rs;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, off);
      m2 += __shfl_xor_sync(0xffffffffu, m2, off);
    }
    m1 /= C;
    m2 /= C;
    bf16* dst = out == nullptr ? t.UB + (size_t)r * C
                               : out + (r % t.F) * sF + (long long)(p0 + r / t.F) * sP;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (__bfloat162float(x[c]) - mu) * rs;
      const float g = dz[c] * w.ln_s[c];
      const float val = u[c] + rs * (g - m1 - xhat * m2);
      u[c] = val;
      dst[c] = __float2bfloat16(val);
    }
  }
}

// Rows r = g*F + f of the block: frame f of pixel p0 + g, from x (strided).
__device__ void load_rows(const Tile& t, const bf16* x, long long sF, long long sP, int p0) {
  const int c8n = t.C / 8;
  for (int e = threadIdx.x; e < t.R * c8n; e += kThreads) {
    const int r = e / c8n, c8 = e % c8n;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < t.valid)
      val = *reinterpret_cast<const uint4*>(x + (r % t.F) * sF + (long long)(p0 + r / t.F) * sP +
                                            c8 * 8);
    *reinterpret_cast<uint4*>(t.xs + r * t.ldc + c8 * 8) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
temporal_pair_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                         bf16* __restrict__ dx, PairWeights w1, PairWeights w2, float* ws, int F,
                         int P, int C, int H, long long sB, long long sF, long long sP, int G,
                         int R, float eps, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L = bwd_layout(R, C);
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * G;
  const size_t block = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const size_t nblocks = (size_t)gridDim.x * gridDim.y;
  const size_t rc = (size_t)R * C;

  Tile t;
  t.xs = reinterpret_cast<bf16*>(smem + L.xs);
  t.zs = reinterpret_cast<bf16*>(smem + L.zs);
  t.qs = reinterpret_cast<bf16*>(smem + L.qs);
  t.ks = reinterpret_cast<bf16*>(smem + L.ks);
  t.vs = reinterpret_cast<bf16*>(smem + L.vs);
  t.os = reinterpret_cast<bf16*>(smem + L.os);
  t.dqs = reinterpret_cast<bf16*>(smem + L.dqs);
  t.dks = reinterpret_cast<bf16*>(smem + L.dks);
  t.dvs = reinterpret_cast<bf16*>(smem + L.dvs);
  t.S = reinterpret_cast<float*>(smem + L.S);
  t.Pf = reinterpret_cast<float*>(smem + L.Pf);
  t.Pb = reinterpret_cast<bf16*>(smem + L.Pb);
  t.Lb = reinterpret_cast<bf16*>(smem + L.Lb);
  t.stats = reinterpret_cast<float*>(smem + L.stats);
  t.scratch = reinterpret_cast<float*>(smem + L.scratch);
  t.U = ws + block * rc;
  t.A = ws + (nblocks + block) * rc;
  t.UB = reinterpret_cast<bf16*>(ws + 2 * nblocks * rc) + block * rc;
  t.R = R;
  t.ldc = L.ldc;
  t.C = C;
  t.H = H;
  t.F = F;
  t.valid = min(G, P - p0) * F;
  t.eps = eps;
  t.scale = scale;
  t.scale_log2e = scale * 1.4426950408889634f;
  float* mean1 = t.stats;
  float* rstd1 = mean1 + R;
  float* mean2 = rstd1 + R;
  float* rstd2 = mean2 + R;
  const bf16* xb = x + b * sB;
  const bf16* dyb = dy + b * sB;

  // Forward recompute: x1 = x0 + A1(LN1(x0)), in place in xs; z2 = LN2(x1).
  load_rows(t, xb, sF, sP, p0);
  __syncthreads();
  ln_rows(t, w1, mean1, rstd1);
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    head_probs(t, w1, h);
    head_forward_out(t, w1, h);
  }
  for (int e = threadIdx.x; e < t.valid * C; e += kThreads) {
    const int r = e / C, c = e % C;
    const float attn = bf16_round(t.A[(size_t)r * C + c] + w1.bo[c]);
    t.xs[r * t.ldc + c] = __float2bfloat16(__bfloat162float(t.xs[r * t.ldc + c]) + attn);
  }
  __syncthreads();
  ln_rows(t, w2, mean2, rstd2);
  // u = dy (fp32 and bf16); padded rows zero.
  for (int e = threadIdx.x; e < R * C; e += kThreads) {
    const int r = e / C, c = e % C;
    bf16 v = __float2bfloat16(0.f);
    if (r < t.valid) v = dyb[(r % F) * sF + (long long)(p0 + r / F) * sP + c];
    t.U[e] = __bfloat162float(v);
    t.UB[e] = v;
  }
  __syncthreads();

  // dx1 = u + VJP_LN2(VJP_A2(u)).
  attn_backward(t, w2);
  ln_backward(t, w2, mean2, rstd2, nullptr, sF, sP, p0);
  __syncthreads();

  // dx0 = dx1 + VJP_LN1(VJP_A1(dx1)), with x0 and z1 recomputed.
  load_rows(t, xb, sF, sP, p0);
  __syncthreads();
  ln_rows(t, w1, mean1, rstd1);
  __syncthreads();
  attn_backward(t, w1);
  ln_backward(t, w1, mean1, rstd1, dx + b * sB, sF, sP, p0);
}

int pick_tile(int F, int C, int& G, int& R) {
  const int candidates[2] = {2, 1};
  for (int g : candidates) {
    const int r = round_up(g * F, 16);
    if (r <= 64 && bwd_layout(r, C).total <= (size_t)kMaxSmem) {
      G = g;
      R = r;
      return 0;
    }
  }
  return -1;
}

}  // namespace
}  // namespace lvd

// Bytes of device-memory workspace lvd_temporal_pair_bwd needs (-1 if the
// shape is not supported).
LVD_EXPORT long long lvd_temporal_pair_bwd_workspace(int B, int F, int P, int C) {
  using namespace lvd;
  int G = 0, R = 0;
  if (F <= 0 || P <= 0 || C % 16 != 0 || pick_tile(F, C, G, R) != 0) return -1;
  const long long nblocks = (long long)B * ((P + G - 1) / G);
  return nblocks * R * C * 10;
}

// x, dy, dx: bf16 with element (b, f, p, c) at b*sB + f*sF + p*sP + c (strides
// in elements; c contiguous). Per attention i: ln scale/bias (C,) fp32,
// wqkv (C, 3C) bf16, wo (C, C) bf16, bo (C,) fp32. ws: the workspace,
// lvd_temporal_pair_bwd_workspace bytes. C = H*64.
LVD_EXPORT int lvd_temporal_pair_bwd(const void* x, const void* dy, void* dx, const void* ln1_s,
                                     const void* ln1_b, const void* wqkv1, const void* wo1,
                                     const void* bo1, const void* ln2_s, const void* ln2_b,
                                     const void* wqkv2, const void* wo2, const void* bo2,
                                     void* ws, int B, int F, int P, int C, int H, long long sB,
                                     long long sF, long long sP, float eps, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  int G = 0, R = 0;
  if (C != H * kD || C % 16 != 0 || F <= 0 || P <= 0 || pick_tile(F, C, G, R) != 0)
    return cudaErrorInvalidValue;
  const int smem = (int)bwd_layout(R, C).total;
  cudaError_t err = set_smem(temporal_pair_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  PairWeights w1{static_cast<const float*>(ln1_s), static_cast<const float*>(ln1_b),
                 static_cast<const bf16*>(wqkv1), static_cast<const bf16*>(wo1),
                 static_cast<const float*>(bo1)};
  PairWeights w2{static_cast<const float*>(ln2_s), static_cast<const float*>(ln2_b),
                 static_cast<const bf16*>(wqkv2), static_cast<const bf16*>(wo2),
                 static_cast<const float*>(bo2)};
  dim3 grid((P + G - 1) / G, B);
  temporal_pair_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<bf16*>(dx), w1, w2,
      static_cast<float*>(ws), F, P, C, H, sB, sF, sP, G, R, eps, 1.0f / sqrtf((float)kD));
  return cudaGetLastError();
}
