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
// q/k/v, P, dO, dL and dQ/dK/dV are rounded to the stream's type (bf16 or
// fp32) where the TPU kernel rounds them; statistics, products and the
// cotangent u stay fp32. fp32 runs its products in TF32.
//
// Bound on this card: the (C, 3C) and (C, C) projections (qkv of both
// attentions, the forward's output projection, and per attention VJP dO
// and dz: 15 C^2 multiply-adds a row) carry almost all of the operations,
// so the kernel is tensor-core bound. Strides let both forms read the
// frames-major (B, F, P, C) stream and the pixels-major one at every C.
//
// bf16 (the `wgmma` form; C = 64 H <= 640, F <= 64): kernel B's block, 64
// rows of G = 64 / F whole pixels (row r: pixel r / F, frame r % F; rows
// past the block's pixels are zero and never stored), the per-pixel key
// mask on the accumulator fragment; one persistent block per SM walks the
// 64-row tiles. A producer warp streams the weights through a ring of 16 KB
// stages (two 64 x 64 boxes, one per consumer warpgroup, TMA with the
// 128-byte swizzle) in the order the consumers use them; two consumer
// warpgroups take the heads in pairs (warpgroup j: head 2 i + j; an odd H
// leaves warpgroup 1 a head whose products run on other weights or zeros
// and are never stored). Per tile:
//  1. the forward (kernel B's): LN1 -> q/k/v -> attention -> the output
//     projection + bias + the residual x0 = x1, written into the output
//     rows (the block's own; dx0 replaces it at the end); LN2 -> q/k/v of
//     attention 2. q/k/v of both attentions are kept, rounded, as swizzled
//     64 x 64 tiles in the block's workspace (15 C^2 products a row, none
//     recomputed), staged through shared memory and written with 16-byte
//     stores; each LayerNorm's mean and rstd stay in shared memory;
//  2. the VJP of attention 2 with u = dy, rounded into a swizzled 64 x C u
//     tile: per head, q/k/v from the workspace into the warpgroup's head
//     tiles (cp.async, under the dO products), dO = u Wo[h]^T (Wo's rows of
//     the head as K-major boxes), S =
//     q k^T and P on the fragment, dV = P^T dO, dP = dO V^T, dL on the
//     fragment, dQ = dL K, dK = dL^T Q (P^T and dL^T read from shared
//     memory through the transpose bits, no transposed copies), dq/dk/dv
//     rounded, staged in the q, k and dO tiles and written over the head's
//     q/k/v tiles in the workspace; then dz =
//     [dq | dk | dv] Wqkv^T in 64-column blocks per warpgroup, the
//     workspace tiles streamed back by bulk copies through the ring
//     (a proxy fence and an mbarrier hand them to the producer), each
//     beside the K-major boxes of Wqkv's rows; dz in fp32 into shared
//     memory over the u and head tiles; LN2's VJP as row reductions, dx1 =
//     u + VJP_LN2(dz) in fp32 into the workspace;
//  3. the same for attention 1 with u = dx1, then dx0 = dx1 + VJP_LN1(dz)
//     rounded into the output rows.
// Shared memory: the z / u tile (8 KB a head), the head-output tile with k
// and v (phase 1) or five head tiles a warpgroup (80 KB), four LayerNorm
// statistics and the ring: 6 stages at C = 320, 4 at 512, 2 at 640, 218-226
// KB. Workspace: 64 KB a head for each resident block (a block per SM, so
// 42 MB at C = 320 of the 50 MB L2). With fewer than four stages no dz
// product is kept in flight across a stage pair. Timing variants on an
// H100 (PERF.md): without the weight loads the kernel was barely faster;
// the per-head attention steps, the LayerNorm passes and the workspace
// traffic, which stall both warpgroups together, set its pace.
//
// fp32 (the `wgmma` form at F <= 64 in fp32, on TF32 wgmma): a chain of
// passes, csrc/pair_bwd_tf32.cu.
//
// F > 64, and fp32 when named (the `wmma` form, the first version): like kernel B's
// first version, one block holds G = 2 pixels x F frames (48 rows at
// F = 24) and works through the whole chain for them; the rows of the
// residual stream and of the LayerNorm output sit in shared memory beside
// the per-head q/k/v, dO, dQ/dK/dV and the (R, R) probability, dP and dL
// tiles (216 KB at C = 640). The two (R, C) fp32 tensors of the chain, the
// cotangent u and the accumulator of dz (first the forward's output
// projection), do not fit beside them: they live in a workspace in device
// memory private to the block (with a copy of u as a WMMA operand),
// written and read by the same block, so it stays in L2.
// Tiles: the first of G = 2, 1 pixels whose layout fits 227 KB with the
// residual rows x in shared memory; if none fits, x moves to the block's
// device-memory workspace too (it is read by the LayerNorms and updated by
// the residual add, never a WMMA operand) and the G search runs again. At
// F = 24: bf16 C = 320, 512, 640 take G = 2 (R = 48; 151, 187, 211 KB); fp32
// C = 320 and 512 take G = 1 (R = 32; 170 and 218 KB), C = 640 G = 1 with x
// in the workspace (R = 32; 169 KB).
//
// The wrapper's launch plan (ops/temporal_attention.py `bwd_launch_plan`:
// the form, rows a block, pixels a block) is passed in, and a plan the form
// was not built for is refused.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "warp_mma.cuh"

namespace lvd {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kD = 64;

struct BwdLayout {
  int ldc, ldh;
  bool xs_smem;
  size_t xs, zs, qs, ks, vs, os, dqs, dks, dvs, S, Pf, Pb, Lb, stats, scratch, total;
};

template <typename T>
__host__ __device__ inline BwdLayout bwd_layout(int R, int C, bool xs_smem) {
  BwdLayout L;
  L.ldc = C + kPad<T>;
  L.ldh = kD + kPad<T>;
  L.xs_smem = xs_smem;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    size_t at = off;
    off += (bytes + 127) / 128 * 128;
    return at;
  };
  const size_t head = (size_t)R * L.ldh * sizeof(T);
  L.xs = xs_smem ? take((size_t)R * L.ldc * sizeof(T)) : 0;
  L.zs = take((size_t)R * L.ldc * sizeof(T));
  L.qs = take(head);
  L.ks = take(head);
  L.vs = take(head);
  L.os = take(head);
  L.dqs = take(head);
  L.dks = take(head);
  L.dvs = take(head);
  L.S = take((size_t)R * R * 4);
  L.Pf = take((size_t)R * R * 4);
  L.Pb = take((size_t)R * R * sizeof(T));
  L.Lb = take((size_t)R * R * sizeof(T));
  L.stats = take((size_t)4 * R * 4);
  L.scratch = take((size_t)kWarps * 256 * 4);
  L.total = off;
  return L;
}

template <typename T>
struct PairWeights {
  const float* ln_s;  // (C,) fp32
  const float* ln_b;  // (C,) fp32
  const T* wqkv;      // (C, 3C): [Wq | Wk | Wv]
  const T* wo;        // (C, C)
  const float* bo;    // (C,) fp32
};

// The block's shared-memory views and device-memory workspace rows.
template <typename T>
struct Tile {
  T *xs, *zs, *qs, *ks, *vs, *os, *dqs, *dks, *dvs, *Pb, *Lb;
  float *S, *Pf, *stats, *scratch;
  float* U;  // (R, C) fp32 cotangent
  float* A;  // (R, C) fp32 accumulator: attn1's projection, then dz
  T* UB;     // (R, C) copy of U in T
  int R, ldx, ldc, ldh, C, H, F, valid;
  float eps, scale, scale_log2e;
};

// LayerNorm of the rows of X into Z, keeping mean and rstd; rows past
// `valid` are zero. One warp per row, one-pass fp32 statistics.
template <typename T>
__device__ void ln_rows(const Tile<T>& t, const PairWeights<T>& w, float* mean, float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < t.R; r += kWarps) {
    T* dst = t.zs + r * t.ldc;
    if (r >= t.valid) {
      for (int c = lane; c < t.C; c += 32) dst[c] = from_f<T>(0.f);
      if (lane == 0) mean[r] = rstd[r] = 0.f;
      continue;
    }
    const T* src = t.xs + (size_t)r * t.ldx;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < t.C; c += 32) {
      const float x = to_f(src[c]);
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
      dst[c] = from_f<T>((to_f(src[c]) - mu) * rs * w.ln_s[c] + w.ln_b[c]);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
  }
}

// q, k, v of head h ((R, 64) each) from Z and Wqkv; then the masked
// block-diagonal softmax: Pf (fp32) and Pb (T), zero outside each pixel's
// F x F block and on padded rows.
template <typename T>
__device__ void head_probs(const Tile<T>& t, const PairWeights<T>& w, int h) {
  using M = Mma<T>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int RT = t.R / 16, C = t.C, ldh = t.ldh;
  float* scr = t.scratch + warp * 256;
  for (int i = warp; i < 3 * RT * 4; i += kWarps) {
    const int mat = i / (RT * 4), rt = (i % (RT * 4)) / 4, ct = i % 4;
    const T* bcol = w.wqkv + mat * C + h * kD + ct * 16;
    typename M::Acc acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < C; kk += M::K) {
      typename M::A a;
      typename M::BRow bm;
      load_op(a, t.zs + rt * 16 * t.ldc + kk, t.ldc);
      load_op(bm, bcol + (size_t)kk * 3 * C, 3 * C);
      wmma::mma_sync(acc, a, bm, acc);
    }
    T* dst = (mat == 0 ? t.qs : mat == 1 ? t.ks : t.vs) + rt * 16 * ldh + ct * 16;
    drain_tile(acc, scr, lane,
               [&](int r, int c, float val) { dst[r * ldh + c] = from_f<T>(val); });
  }
  __syncthreads();
  for (int i = warp; i < RT * RT; i += kWarps) {
    const int a_t = i / RT, b_t = i % RT;
    typename M::Acc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kD; kk += M::K) {
      typename M::A a;
      typename M::BCol bm;
      load_op(a, t.qs + a_t * 16 * ldh + kk, ldh);
      load_op(bm, t.ks + b_t * 16 * ldh + kk, ldh);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(t.S + a_t * 16 * t.R + b_t * 16, acc, t.R, wmma::mem_row_major);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < t.R; r += kThreads) {
    float* pf = t.Pf + r * t.R;
    T* pb = t.Pb + r * t.R;
    for (int c = 0; c < t.R; ++c) {
      pf[c] = 0.f;
      pb[c] = from_f<T>(0.f);
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
        pb[c] = from_f<T>(p);
      }
    }
  }
  __syncthreads();
}

// Forward recompute of one attention's output projection: for head h,
// o_h = Pb V (T) and A (+)= o_h Wo[h] (fp32, device-memory workspace).
template <typename T>
__device__ void head_forward_out(const Tile<T>& t, const PairWeights<T>& w, int h) {
  using M = Mma<T>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int RT = t.R / 16, CT = t.C / 16, ldh = t.ldh;
  float* scr = t.scratch + warp * 256;
  for (int i = warp; i < RT * 4; i += kWarps) {
    const int rt = i / 4, ct = i % 4;
    typename M::Acc acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < t.R; kk += M::K) {
      typename M::A a;
      typename M::BRow bm;
      load_op(a, t.Pb + rt * 16 * t.R + kk, t.R);
      load_op(bm, t.vs + kk * ldh + ct * 16, ldh);
      wmma::mma_sync(acc, a, bm, acc);
    }
    T* dst = t.os + rt * 16 * ldh + ct * 16;
    drain_tile(acc, scr, lane,
               [&](int r, int c, float val) { dst[r * ldh + c] = from_f<T>(val); });
  }
  __syncthreads();
  for (int i = warp; i < RT * CT; i += kWarps) {
    const int rt = i / CT, ct = i % CT;
    float* tile = t.A + (size_t)rt * 16 * t.C + ct * 16;
    typename M::Acc acc;
    if (h == 0) {
      wmma::fill_fragment(acc, 0.f);
    } else {
      wmma::load_matrix_sync(acc, tile, t.C, wmma::mem_row_major);
    }
#pragma unroll
    for (int kk = 0; kk < kD; kk += M::K) {
      typename M::A a;
      typename M::BRow bm;
      load_op(a, t.os + rt * 16 * ldh + kk, ldh);
      load_op(bm, w.wo + (size_t)(h * kD + kk) * t.C + ct * 16, t.C);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(tile, acc, t.C, wmma::mem_row_major);
  }
  __syncthreads();
}

// The VJP of one attention at its LayerNorm output Z, for the cotangent U
// (UB in T): A = dz = sum_h [dQ | dK | dV]_h Wqkv_h^T.
template <typename T>
__device__ void attn_backward(const Tile<T>& t, const PairWeights<T>& w) {
  using M = Mma<T>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int RT = t.R / 16, CT = t.C / 16, C = t.C, ldh = t.ldh;
  float* scr = t.scratch + warp * 256;
  for (int h = 0; h < t.H; ++h) {
    head_probs(t, w, h);
    // dO = UB Wo[h]^T: (R, 64), Wo[h] read column-major from its 64 rows.
    for (int i = warp; i < RT * 4; i += kWarps) {
      const int rt = i / 4, ct = i % 4;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
      const T* wcol = w.wo + (size_t)(h * kD + ct * 16) * C;
      for (int kk = 0; kk < C; kk += M::K) {
        typename M::A a;
        typename M::BCol bm;
        load_op(a, t.UB + (size_t)rt * 16 * C + kk, C);
        load_op(bm, wcol + kk, C);
        wmma::mma_sync(acc, a, bm, acc);
      }
      T* dst = t.os + rt * 16 * ldh + ct * 16;
      drain_tile(acc, scr, lane,
                 [&](int r, int c, float val) { dst[r * ldh + c] = from_f<T>(val); });
    }
    __syncthreads();
    // dV = Pb^T dO (R, 64) and dP = dO V^T (R, R) into S.
    for (int i = warp; i < RT * 4 + RT * RT; i += kWarps) {
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
      if (i < RT * 4) {
        const int rt = i / 4, ct = i % 4;
        for (int kk = 0; kk < t.R; kk += M::K) {
          typename M::ACol a;
          typename M::BRow bm;
          load_op(a, t.Pb + kk * t.R + rt * 16, t.R);
          load_op(bm, t.os + kk * ldh + ct * 16, ldh);
          wmma::mma_sync(acc, a, bm, acc);
        }
        T* dst = t.dvs + rt * 16 * ldh + ct * 16;
        drain_tile(acc, scr, lane,
                   [&](int r, int c, float val) { dst[r * ldh + c] = from_f<T>(val); });
      } else {
        const int j = i - RT * 4, a_t = j / RT, b_t = j % RT;
#pragma unroll
        for (int kk = 0; kk < kD; kk += M::K) {
          typename M::A a;
          typename M::BCol bm;
          load_op(a, t.os + a_t * 16 * ldh + kk, ldh);
          load_op(bm, t.vs + b_t * 16 * ldh + kk, ldh);
          wmma::mma_sync(acc, a, bm, acc);
        }
        wmma::store_matrix_sync(t.S + a_t * 16 * t.R + b_t * 16, acc, t.R, wmma::mem_row_major);
      }
    }
    __syncthreads();
    // Softmax VJP within each pixel's block.
    for (int r = threadIdx.x; r < t.R; r += kThreads) {
      T* lrow = t.Lb + r * t.R;
      for (int c = 0; c < t.R; ++c) lrow[c] = from_f<T>(0.f);
      if (r < t.valid) {
        const float* dp = t.S + r * t.R;
        const float* p = t.Pf + r * t.R;
        const int c0 = (r / t.F) * t.F;
        float s = 0.f;
        for (int c = c0; c < c0 + t.F; ++c) s += dp[c] * p[c];
        for (int c = c0; c < c0 + t.F; ++c)
          lrow[c] = from_f<T>((dp[c] * p[c] - p[c] * s) * t.scale);
      }
    }
    __syncthreads();
    // dQ = dL K and dK = dL^T Q, (R, 64) each.
    for (int i = warp; i < 2 * RT * 4; i += kWarps) {
      const bool is_k = i >= RT * 4;
      const int rt = (i % (RT * 4)) / 4, ct = i % 4;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < t.R; kk += M::K) {
        typename M::BRow bm;
        if (is_k) {
          typename M::ACol a;
          load_op(a, t.Lb + kk * t.R + rt * 16, t.R);
          load_op(bm, t.qs + kk * ldh + ct * 16, ldh);
          wmma::mma_sync(acc, a, bm, acc);
        } else {
          typename M::A a;
          load_op(a, t.Lb + rt * 16 * t.R + kk, t.R);
          load_op(bm, t.ks + kk * ldh + ct * 16, ldh);
          wmma::mma_sync(acc, a, bm, acc);
        }
      }
      T* dst = (is_k ? t.dks : t.dqs) + rt * 16 * ldh + ct * 16;
      drain_tile(acc, scr, lane,
                 [&](int r, int c, float val) { dst[r * ldh + c] = from_f<T>(val); });
    }
    __syncthreads();
    // A (+)= [dQ | dK | dV] [Wq_h | Wk_h | Wv_h]^T, Wqkv read column-major.
    for (int i = warp; i < RT * CT; i += kWarps) {
      const int rt = i / CT, ct = i % CT;
      float* tile = t.A + (size_t)rt * 16 * C + ct * 16;
      typename M::Acc acc;
      if (h == 0) {
        wmma::fill_fragment(acc, 0.f);
      } else {
        wmma::load_matrix_sync(acc, tile, C, wmma::mem_row_major);
      }
      const T* wrow = w.wqkv + (size_t)ct * 16 * 3 * C + h * kD;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const T* src = (m == 0 ? t.dqs : m == 1 ? t.dks : t.dvs) + rt * 16 * ldh;
#pragma unroll
        for (int kk = 0; kk < kD; kk += M::K) {
          typename M::A a;
          typename M::BCol bm;
          load_op(a, src + kk, ldh);
          load_op(bm, wrow + m * C + kk, 3 * C);
          wmma::mma_sync(acc, a, bm, acc);
        }
      }
      wmma::store_matrix_sync(tile, acc, C, wmma::mem_row_major);
    }
    __syncthreads();
  }
}

// U += VJP of the LayerNorm of X at dz = A. With `out` null, UB gets U in T;
// otherwise U in T is written to the output rows instead.
template <typename T>
__device__ void ln_backward(const Tile<T>& t, const PairWeights<T>& w, const float* mean,
                            const float* rstd, T* out, long long sF, long long sP, int p0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C = t.C;
  for (int r = warp; r < t.valid; r += kWarps) {
    const T* x = t.xs + (size_t)r * t.ldx;
    float* dz = t.A + (size_t)r * C;
    float* u = t.U + (size_t)r * C;
    const float mu = mean[r], rs = rstd[r];
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float g = dz[c] * w.ln_s[c];
      m1 += g;
      m2 += g * (to_f(x[c]) - mu) * rs;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, off);
      m2 += __shfl_xor_sync(0xffffffffu, m2, off);
    }
    m1 /= C;
    m2 /= C;
    T* dst = out == nullptr ? t.UB + (size_t)r * C
                            : out + (r % t.F) * sF + (long long)(p0 + r / t.F) * sP;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (to_f(x[c]) - mu) * rs;
      const float g = dz[c] * w.ln_s[c];
      const float val = u[c] + rs * (g - m1 - xhat * m2);
      u[c] = val;
      dst[c] = from_f<T>(val);
    }
  }
}

// Rows r = g*F + f of the block: frame f of pixel p0 + g, from x (strided).
template <typename T>
__device__ void load_rows(const Tile<T>& t, const T* x, long long sF, long long sP, int p0) {
  constexpr int V = kVecN<T>;
  const int cvn = t.C / V;
  for (int e = threadIdx.x; e < t.R * cvn; e += kThreads) {
    const int r = e / cvn, cv = e % cvn;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < t.valid)
      val = *reinterpret_cast<const uint4*>(x + (r % t.F) * sF + (long long)(p0 + r / t.F) * sP +
                                            cv * V);
    *reinterpret_cast<uint4*>(t.xs + (size_t)r * t.ldx + cv * V) = val;
  }
}

// Workspace per block, in elements of R*C: U and A (fp32), UB and, when the
// layout keeps x out of shared memory, X (in T).
template <typename T>
__host__ __device__ inline size_t ws_bytes_per_row_col(bool xs_smem) {
  return 8 + sizeof(T) * (xs_smem ? 1 : 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
temporal_pair_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                         PairWeights<T> w1, PairWeights<T> w2, float* ws, int F, int P, int C,
                         int H, long long sB, long long sF, long long sP, int G, int R,
                         bool xs_smem, float eps, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L = bwd_layout<T>(R, C, xs_smem);
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * G;
  const size_t block = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const size_t nblocks = (size_t)gridDim.x * gridDim.y;
  const size_t rc = (size_t)R * C;

  Tile<T> t;
  t.zs = reinterpret_cast<T*>(smem + L.zs);
  t.qs = reinterpret_cast<T*>(smem + L.qs);
  t.ks = reinterpret_cast<T*>(smem + L.ks);
  t.vs = reinterpret_cast<T*>(smem + L.vs);
  t.os = reinterpret_cast<T*>(smem + L.os);
  t.dqs = reinterpret_cast<T*>(smem + L.dqs);
  t.dks = reinterpret_cast<T*>(smem + L.dks);
  t.dvs = reinterpret_cast<T*>(smem + L.dvs);
  t.S = reinterpret_cast<float*>(smem + L.S);
  t.Pf = reinterpret_cast<float*>(smem + L.Pf);
  t.Pb = reinterpret_cast<T*>(smem + L.Pb);
  t.Lb = reinterpret_cast<T*>(smem + L.Lb);
  t.stats = reinterpret_cast<float*>(smem + L.stats);
  t.scratch = reinterpret_cast<float*>(smem + L.scratch);
  t.U = ws + block * rc;
  t.A = ws + (nblocks + block) * rc;
  T* ws_t = reinterpret_cast<T*>(ws + 2 * nblocks * rc);
  t.UB = ws_t + block * rc;
  if (xs_smem) {
    t.xs = reinterpret_cast<T*>(smem + L.xs);
    t.ldx = L.ldc;
  } else {
    t.xs = ws_t + (nblocks + block) * rc;
    t.ldx = C;
  }
  t.R = R;
  t.ldc = L.ldc;
  t.ldh = L.ldh;
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
  const T* xb = x + b * sB;
  const T* dyb = dy + b * sB;

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
    const float attn = round_to<T>(t.A[(size_t)r * C + c] + w1.bo[c]);
    T* xr = t.xs + (size_t)r * t.ldx + c;
    *xr = from_f<T>(to_f(*xr) + attn);
  }
  __syncthreads();
  ln_rows(t, w2, mean2, rstd2);
  // u = dy (fp32 and T); padded rows zero.
  for (int e = threadIdx.x; e < R * C; e += kThreads) {
    const int r = e / C, c = e % C;
    T v = from_f<T>(0.f);
    if (r < t.valid) v = dyb[(r % F) * sF + (long long)(p0 + r / F) * sP + c];
    t.U[e] = to_f(v);
    t.UB[e] = v;
  }
  __syncthreads();

  // dx1 = u + VJP_LN2(VJP_A2(u)).
  attn_backward(t, w2);
  ln_backward(t, w2, mean2, rstd2, (T*)nullptr, sF, sP, p0);
  __syncthreads();

  // dx0 = dx1 + VJP_LN1(VJP_A1(dx1)), with x0 and z1 recomputed.
  load_rows(t, xb, sF, sP, p0);
  __syncthreads();
  ln_rows(t, w1, mean1, rstd1);
  __syncthreads();
  attn_backward(t, w1);
  ln_backward(t, w1, mean1, rstd1, dx + b * sB, sF, sP, p0);
}

template <typename T>
int pick_tile(int F, int C, int& G, int& R, bool& xs_smem) {
  for (int in_smem = 1; in_smem >= 0; --in_smem) {
    const int candidates[2] = {2, 1};
    for (int g : candidates) {
      const int r = round_up(g * F, 16);
      if (r <= 64 && bwd_layout<T>(r, C, in_smem).total <= (size_t)kMaxSmem) {
        G = g;
        R = r;
        xs_smem = in_smem;
        return 0;
      }
    }
  }
  return -1;
}

template <typename T>
long long workspace_bytes(int B, int F, int P, int C) {
  int G = 0, R = 0;
  bool xs_smem = true;
  if (pick_tile<T>(F, C, G, R, xs_smem) != 0) return -1;
  const long long nblocks = (long long)B * ((P + G - 1) / G);
  return nblocks * R * C * (long long)ws_bytes_per_row_col<T>(xs_smem);
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, void* dx, const void* const* wts, void* ws,
                   int B, int F, int P, int C, int H, long long sB, long long sF, long long sP,
                   float eps, int row_block, int pixels, cudaStream_t stream) {
  int G = 0, R = 0;
  bool xs_smem = true;
  if (pick_tile<T>(F, C, G, R, xs_smem) != 0 || row_block != R || pixels != G)
    return cudaErrorInvalidValue;
  const int smem = (int)bwd_layout<T>(R, C, xs_smem).total;
  cudaError_t err = set_smem(temporal_pair_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  auto weights = [&](int i) {
    return PairWeights<T>{static_cast<const float*>(wts[5 * i]),
                          static_cast<const float*>(wts[5 * i + 1]),
                          static_cast<const T*>(wts[5 * i + 2]),
                          static_cast<const T*>(wts[5 * i + 3]),
                          static_cast<const float*>(wts[5 * i + 4])};
  };
  dim3 grid((P + G - 1) / G, B);
  temporal_pair_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), weights(0),
      weights(1), static_cast<float*>(ws), F, P, C, H, sB, sF, sP, G, R, xs_smem, eps,
      1.0f / sqrtf((float)kD));
  return cudaGetLastError();
}

// ---- bf16: persistent blocks, TMA weight ring + wgmma ----

template <int NH>
struct WgBwd {
  static constexpr int C = 64 * NH;
  static constexpr int kThreads = 2 * 128 + 32;  // consumer warpgroups, then the producer warp
  static constexpr int NP = (NH + 1) / 2;        // head pairs; output blocks of a warpgroup
  static constexpr int kBox = 8192;              // one 64 x 64 bf16 tile
  static constexpr int kStage = 2 * kBox;        // one box of each warpgroup
  static constexpr int kR1 = NH * kBox;          // the z tile, then the u tile
  // Phase 1: the head-output tile and k, v of each warpgroup; phases 2-3:
  // five head tiles a warpgroup (q, k, v, dO, and P, then dL).
  static constexpr int kR2 = NH * kBox + 4 * kBox > 10 * kBox ? NH * kBox + 4 * kBox : 10 * kBox;
  static constexpr int kLdDz = C + 8;  // dz's row stride in floats (2 wavefronts a float2 store)
  static_assert(64 * kLdDz * 4 <= kR1 + kR2, "dz overlays R1 and R2");
  static constexpr int kStats = 4 * 64 * 4;  // mean and rstd of both LayerNorms
  static constexpr int kFixed = kR1 + kR2 + kStats + 256 + 1024;
  static constexpr int kFit = (kMaxSmem - kFixed) / kStage;
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static_assert(kStages >= 2, "the ring needs two stages");
  static constexpr int kSmem = kStages * kStage + kFixed;
  // Workspace of one resident block: q/k/v of each attention as 3 NH
  // swizzled 64 x 64 tiles (overwritten in place by dq/dk/dv), then dx1 in
  // fp32 (64 x C).
  static constexpr long long kWsQkv = 3LL * NH * kBox;
  static constexpr long long kWs = 2 * kWsQkv + 64LL * C * 4;
  static_assert(kWs == 65536LL * NH, "lvd_temporal_pair_bwd_workspace counts 64 KB a head");
};

struct BwdArgs {
  const bf16* x;
  const bf16* dy;
  bf16* dx;
  const float* ln_s[2];
  const float* ln_b[2];
  const float* bo[2];
  unsigned char* ws;
  long long sB, sF, sP;
  int F, P, G;            // frames, pixels, pixels a 64-row tile
  int tiles_p, tiles;     // pixel tiles per batch, and in all
  float eps, scale, scale_log2e;
};

template <int NH>
__global__ void __launch_bounds__(WgBwd<NH>::kThreads, 1)
temporal_pair_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_qkv1,
                               const __grid_constant__ CUtensorMap tm_o1,
                               const __grid_constant__ CUtensorMap tm_qkv2,
                               const __grid_constant__ CUtensorMap tm_o2, const BwdArgs a) {
  using W = WgBwd<NH>;
  constexpr int NS = W::kStages, C = W::C, NP = W::NP;
  constexpr int VN = C / 8, VI = (VN + 31) / 32;  // 16-byte vectors of a bf16 row; of a lane
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem;
  bf16* t1 = reinterpret_cast<bf16*>(smem + NS * W::kStage);  // z tile / u tile, NH boxes
  bf16* t2 = t1 + NH * 4096;                                    // R2
  float* dz = reinterpret_cast<float*>(t1);                     // (64, kLdDz) over R1 and R2
  float* stats = reinterpret_cast<float*>(smem + NS * W::kStage + W::kR1 + W::kR2);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 256);
  uint64_t* empty = full + NS;
  uint64_t* ready = empty + NS;  // [2]: the dq/dk/dv tiles of attention 2, then 1, are written
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* wsb = a.ws + (size_t)blockIdx.x * W::kWs;
  bf16* qkv1 = reinterpret_cast<bf16*>(wsb);
  bf16* qkv2 = reinterpret_cast<bf16*>(wsb + W::kWsQkv);
  float* dx1 = reinterpret_cast<float*>(wsb + 2 * W::kWsQkv);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // every consumer warp
    }
    for (int i = 0; i < 2; ++i) hop::mbar_init(&ready[i], 256);  // every consumer thread
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp: one lane issues every load, in the consumers' order
    if (lane == 0) {
      int v = 0;
      auto claim = [&]() {
        const int s = v % NS;
        if (v >= NS) hop::mbar_wait(&empty[s], (v / NS - 1) & 1);
        ++v;
        return s;
      };
      // A stage of two 64 x 64 weight boxes: warpgroup h's at (c0 + dc h, r0 + dr h).
      auto boxes = [&](const CUtensorMap* map, int c0, int r0, int dc, int dr) {
        const int s = claim();
        hop::mbar_expect_tx(&full[s], W::kStage);
        for (int h = 0; h < 2; ++h)
          hop::tma_load_2d(ring + s * W::kStage + h * W::kBox, map, &full[s], c0 + dc * h,
                           r0 + dr * h);
      };
      // A stage holding one 64 x 64 workspace tile (both warpgroups read it).
      auto tile = [&](const bf16* src) {
        const int s = claim();
        hop::mbar_expect_tx(&full[s], W::kBox);
        hop::bulk_load(ring + s * W::kStage, src, W::kBox, &full[s]);
      };
      for (int t = blockIdx.x, it = 0; t < a.tiles; t += gridDim.x, ++it) {
        for (int at = 0; at < 2; ++at) {  // the forward: q/k/v of both attentions, attn1's output
          const CUtensorMap* mq = at ? &tm_qkv2 : &tm_qkv1;
          for (int j = 0; j < NP; ++j)  // head pair j: k, v and q of heads 2 j and 2 j + 1
            for (int m = 0; m < 3; ++m)
              for (int kt = 0; kt < NH; ++kt)
                boxes(mq, (m == 2 ? 0 : m + 1) * C + 128 * j, 64 * kt, 64, 0);
          if (at == 0)
            for (int i = 0; i < NP; ++i)  // output blocks 2 i and 2 i + 1
              for (int kt = 0; kt < NH; ++kt) boxes(&tm_o1, 128 * i, 64 * kt, 64, 0);
        }
        for (int ph = 0; ph < 2; ++ph) {  // the VJPs of attention 2, then of attention 1
          const CUtensorMap* mq = ph ? &tm_qkv1 : &tm_qkv2;
          const CUtensorMap* mo = ph ? &tm_o1 : &tm_o2;
          const bf16* dqkv = ph ? qkv1 : qkv2;
          for (int j = 0; j < NP; ++j)  // dO of heads 2 j, 2 j + 1: Wo's rows of each head
            for (int kt = 0; kt < NH; ++kt) boxes(mo, 64 * kt, 128 * j, 0, 64);
          hop::mbar_wait(&ready[ph], it & 1);
          hop::fence_proxy_async_global();
          for (int i = 0; i < NP; ++i)  // dz blocks 2 i, 2 i + 1: dqkv tile kt, Wqkv's rows
            for (int kt = 0; kt < 3 * NH; ++kt) {
              tile(dqkv + kt * 4096);
              boxes(mq, 64 * kt, 128 * i, 0, 64);
            }
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x, wg = warp / 4, wq = warp % 4, t128 = tid % 128;
  const int r4 = lane / 4, cq = 2 * (lane % 4);
  const int ra = 16 * wq + r4, rb = ra + 8;  // this thread's two accumulator rows
  int u = 0, done = 0;  // stages are consumed in order; `done`: the first not yet released
  auto release_to = [&](int end) {
    for (; done < end; ++done) {
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[done % NS]);
    }
  };
  // acc = A (64 x C, NH swizzled boxes) times this warpgroup's boxes of the
  // next NH stages: MN-major (a 64-column block of W) or K-major (64 rows of
  // W, read as W^T); one group a stage, one group in flight.
  auto gemm = [&](const bf16* A, float (&acc)[32], auto mn_major) {
#pragma unroll
    for (int kt = 0; kt < NH; ++kt) {
      hop::mbar_wait(&full[u % NS], (u / NS) & 1);
      const bf16* Bs = reinterpret_cast<const bf16*>(ring + (u % NS) * W::kStage) + wg * 4096;
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = hop::desc_sw128(A + kt * 4096 + kk * 16);
        if constexpr (decltype(mn_major)::value)
          hop::wgmma_ss_n64_tn(acc, da, hop::desc_sw128_mn(Bs + kk * 16 * 64, 8192),
                               kt > 0 || kk > 0);
        else
          hop::wgmma_ss_n64(acc, da, hop::desc_sw128(Bs + kk * 16), kt > 0 || kk > 0);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      release_to(u);
      ++u;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    release_to(u);
  };
  const auto mn = std::true_type{};
  const auto kmaj = std::false_type{};
  // dz block = dqkv (64 x 3C, the workspace tiles streamed as stage pairs:
  // the tile, then Wqkv's rows of both warpgroups' blocks) times Wqkv^T.
  auto gemm_dz = [&](float (&acc)[32]) {
#pragma unroll 1
    for (int kt = 0; kt < 3 * NH; ++kt) {
      if constexpr (NS < 4) {  // the ring cannot hold two pairs: none in flight across pairs
        hop::wgmma_wait<0>();
        hop::fence_regs(acc);
        release_to(u);
      }
      hop::mbar_wait(&full[u % NS], (u / NS) & 1);
      hop::mbar_wait(&full[(u + 1) % NS], ((u + 1) / NS) & 1);
      const bf16* As = reinterpret_cast<const bf16*>(ring + (u % NS) * W::kStage);
      const bf16* Bs = reinterpret_cast<const bf16*>(ring + ((u + 1) % NS) * W::kStage) +
                       wg * 4096;
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_ss_n64(acc, hop::desc_sw128(As + kk * 16), hop::desc_sw128(Bs + kk * 16),
                          kt > 0 || kk > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      release_to(u);
      u += 2;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    release_to(u);
  };
  // A 64 x 64 accumulator block rounded to bf16 into a swizzled tile (shared
  // or global memory).
  auto store_tile = [&](bf16* t, const float* acc) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      *reinterpret_cast<uint32_t*>(t + ra * 64 + ((c ^ r4) * 8) + cq) =
          pack_bf16(acc[4 * c], acc[4 * c + 1]);
      *reinterpret_cast<uint32_t*>(t + rb * 64 + ((c ^ r4) * 8) + cq) =
          pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
    }
  };
  // A 64 x 64 tile (8 KB) copied by the warpgroup's 128 threads, 16 bytes
  // each at a time: shared to global (the workspace) with plain stores, or
  // global to shared with asynchronous copies (cp.async, awaited later).
  auto copy_out = [&](bf16* dst, const bf16* src) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<uint4*>(dst)[t128 + 128 * i] =
          reinterpret_cast<const uint4*>(src)[t128 + 128 * i];
  };
  auto copy_in_async = [&](bf16* dst, const bf16* src) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wm::cp_async16(dst + 8 * (t128 + 128 * i), src + 8 * (t128 + 128 * i), true);
  };
  // An accumulator block rounded into the register A operand of a product.
  auto pack_a = [&](uint32_t (&ra_)[4][4], const float* acc) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      ra_[c / 2][(c % 2) * 2] = pack_bf16(acc[4 * c], acc[4 * c + 1]);
      ra_[c / 2][(c % 2) * 2 + 1] = pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
    }
  };
  // The block-diagonal softmax of one head's scores in place: each row over
  // the keys of its own pixel [lo, lo + F), exact max, exp2 with the scale
  // folded in; zero elsewhere.
  auto softmax = [&](float (&s)[32], int lo_a, int lo_b) {
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * c + cq + e;
        if (key >= lo_a && key < lo_a + a.F) mxa = fmaxf(mxa, s[4 * c + e]);
        if (key >= lo_b && key < lo_b + a.F) mxb = fmaxf(mxb, s[4 * c + 2 + e]);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
    }
    const float ma = mxa * a.scale_log2e, mb = mxb * a.scale_log2e;
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * c + cq + e;
        float& pa_ = s[4 * c + e];
        float& pb_ = s[4 * c + 2 + e];
        pa_ = (key >= lo_a && key < lo_a + a.F) ? exp2f(fmaf(pa_, a.scale_log2e, -ma)) : 0.f;
        pb_ = (key >= lo_b && key < lo_b + a.F) ? exp2f(fmaf(pb_, a.scale_log2e, -mb)) : 0.f;
        suma += pa_;
        sumb += pb_;
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      suma += __shfl_xor_sync(0xffffffffu, suma, off);
      sumb += __shfl_xor_sync(0xffffffffu, sumb, off);
    }
    const float ia = 1.f / suma, ib = 1.f / sumb;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      s[4 * c] *= ia;
      s[4 * c + 1] *= ia;
      s[4 * c + 2] *= ib;
      s[4 * c + 3] *= ib;
    }
  };

#pragma unroll 1
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int p0 = (t % a.tiles_p) * a.G;
    const int valid = min(a.G, a.P - p0) * a.F;  // row r < valid: pixel p0 + r / F, frame r % F
    const long long base = (t / a.tiles_p) * a.sB;
    auto row_at = [&](int r) {
      return base + (r % a.F) * a.sF + (long long)(p0 + r / a.F) * a.sP;
    };
    const int lo_a = ra / a.F * a.F, lo_b = rb / a.F * a.F;  // this thread's rows' keys

    // LayerNorm of the block's rows of src into the z tile (t1), keeping each
    // row's mean and rstd; rows past the block's pixels are zero. Each warp
    // takes rows warp + 8 i, two rows' loads in flight; a lane's scale and
    // bias stay in registers (kernel B's LayerNorm, with half its rows in
    // flight: this kernel's other live values leave fewer registers).
    auto layer_norm = [&](const bf16* src, int at, float* mean, float* rstd) {
      constexpr int RI = 2;
      const float* ln_s = a.ln_s[at];
      const float* ln_b = a.ln_b[at];
      float4 gs[VI][2], gb[VI][2];
#pragma unroll
      for (int i = 0; i < VI; ++i) {
        const int vv = (lane + 32 * i) % VN;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          gs[i][h] = *reinterpret_cast<const float4*>(ln_s + 8 * vv + 4 * h);
          gb[i][h] = *reinterpret_cast<const float4*>(ln_b + 8 * vv + 4 * h);
        }
      }
#pragma unroll 1
      for (int r0 = warp; r0 < 64; r0 += 8 * RI) {
        Vec<bf16> pk[RI][VI];
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int r = r0 + 8 * j;
          const bf16* row = src + (r < valid ? row_at(r) : 0);
#pragma unroll
          for (int i = 0; i < VI; ++i) {
            const int vv = lane + 32 * i;
            pk[j][i].u = make_uint4(0, 0, 0, 0);
            if (r < valid && vv < VN) pk[j][i].u = *reinterpret_cast<const uint4*>(row + 8 * vv);
          }
        }
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int r = r0 + 8 * j;
          float s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int i = 0; i < VI; ++i)
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float v = __bfloat162float(pk[j][i].h[e]);
              s1 += v;
              s2 += v * v;
            }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
          }
          const float mu = s1 / C;
          const float rs = rsqrtf(fmaxf(s2 / C - mu * mu, 0.f) + a.eps);
          if (lane == 0) {
            mean[r] = mu;
            rstd[r] = rs;
          }
#pragma unroll
          for (int i = 0; i < VI; ++i) {
            const int vv = lane + 32 * i;
            if (vv >= VN) continue;
            Vec<bf16> z;
            const float sc[8] = {gs[i][0].x, gs[i][0].y, gs[i][0].z, gs[i][0].w,
                                 gs[i][1].x, gs[i][1].y, gs[i][1].z, gs[i][1].w};
            const float bi[8] = {gb[i][0].x, gb[i][0].y, gb[i][0].z, gb[i][0].w,
                                 gb[i][1].x, gb[i][1].y, gb[i][1].z, gb[i][1].w};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float v = __bfloat162float(pk[j][i].h[e]);
              z.h[e] = __float2bfloat16(r < valid ? (v - mu) * rs * sc[e] + bi[e] : 0.f);
            }
            *reinterpret_cast<uint4*>(t1 + (vv / 8) * 4096 + r * 64 + (((vv % 8) ^ (r % 8)) * 8)) =
                z.u;
          }
        }
      }
    };

    // The VJP of LayerNorm `at` over the block's valid rows, with dz in
    // shared memory: out = u + rstd (g - mean(g) - xhat mean(g xhat)), g =
    // dz * scale, all fp32. Attention 2 (at = 1): x = x1 (in the output
    // rows), u = dy, out = dx1 into the workspace; attention 1 (at = 0): x =
    // x0, u = dx1, out = dx0 rounded into the output rows. Each warp takes
    // rows warp + 8 i, each lane the same vectors of every row.
    auto ln_vjp = [&](int at) {
      const float* ln_s = a.ln_s[at];
      const float* mean = stats + 128 * at;
      const float* rstd = mean + 64;
      const bf16* xs = at ? a.dx : a.x;
      float4 gs[VI][2];
#pragma unroll
      for (int i = 0; i < VI; ++i) {
        const int vv = (lane + 32 * i) % VN;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          gs[i][h] = *reinterpret_cast<const float4*>(ln_s + 8 * vv + 4 * h);
      }
#pragma unroll 1
      for (int r = warp; r < valid; r += 8) {
        const long long at_r = row_at(r);
        const float mu = mean[r], rs = rstd[r];
        // xhat and g of this lane's vectors: once for the row sums, again for
        // the output (reloaded rather than kept, to spare registers); u is
        // loaded with the first pass.
        auto load = [&](int i, float (&xh)[8], float (&g)[8]) {
          const int vv = lane + 32 * i;
          Vec<bf16> xv;
          xv.u = *reinterpret_cast<const uint4*>(xs + at_r + 8 * vv);
          const float4 d0 = *reinterpret_cast<const float4*>(dz + r * W::kLdDz + 8 * vv);
          const float4 d1 = *reinterpret_cast<const float4*>(dz + r * W::kLdDz + 8 * vv + 4);
          const float dd[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
          const float sc[8] = {gs[i][0].x, gs[i][0].y, gs[i][0].z, gs[i][0].w,
                               gs[i][1].x, gs[i][1].y, gs[i][1].z, gs[i][1].w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            xh[e] = (__bfloat162float(xv.h[e]) - mu) * rs;
            g[e] = dd[e] * sc[e];
          }
        };
        float m1 = 0.f, m2 = 0.f;
        float uu[VI][8];
#pragma unroll
        for (int i = 0; i < VI; ++i) {
          const int vv = lane + 32 * i;
          if (vv >= VN) continue;
          if (at) {
            Vec<bf16> dv;
            dv.u = *reinterpret_cast<const uint4*>(a.dy + at_r + 8 * vv);
#pragma unroll
            for (int e = 0; e < 8; ++e) uu[i][e] = __bfloat162float(dv.h[e]);
          } else {
            const float4 u0 = *reinterpret_cast<const float4*>(dx1 + r * C + 8 * vv);
            const float4 u1 = *reinterpret_cast<const float4*>(dx1 + r * C + 8 * vv + 4);
            uu[i][0] = u0.x, uu[i][1] = u0.y, uu[i][2] = u0.z, uu[i][3] = u0.w;
            uu[i][4] = u1.x, uu[i][5] = u1.y, uu[i][6] = u1.z, uu[i][7] = u1.w;
          }
          float xh[8], g[8];
          load(i, xh, g);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            m1 += g[e];
            m2 += g[e] * xh[e];
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          m1 += __shfl_xor_sync(0xffffffffu, m1, off);
          m2 += __shfl_xor_sync(0xffffffffu, m2, off);
        }
        m1 /= C;
        m2 /= C;
#pragma unroll
        for (int i = 0; i < VI; ++i) {
          const int vv = lane + 32 * i;
          if (vv >= VN) continue;
          float xh[8], g[8], o[8];
          load(i, xh, g);
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = uu[i][e] + rs * (g[e] - m1 - xh[e] * m2);
          if (at) {
            float* w1 = dx1 + r * C + 8 * vv;
            *reinterpret_cast<float4*>(w1) = make_float4(o[0], o[1], o[2], o[3]);
            *reinterpret_cast<float4*>(w1 + 4) = make_float4(o[4], o[5], o[6], o[7]);
          } else {
            Vec<bf16> ob;
#pragma unroll
            for (int e = 0; e < 8; ++e) ob.h[e] = __float2bfloat16(o[e]);
            *reinterpret_cast<uint4*>(a.dx + at_r + 8 * vv) = ob.u;
          }
        }
      }
    };

    // ---- 1. the forward: x1 = x0 + A1(LN1(x0)) into the output rows, z2 =
    // LN2(x1), q/k/v of both attentions into the workspace ----
    hop::bar_sync(1, 256);  // the last tile's readers of t1, t2, stats and dz are done
    layer_norm(a.x, 0, stats, stats + 64);
    hop::fence_proxy_async();
    hop::bar_sync(1, 256);  // the z tile is in place
    {
      bf16* os = t2;                           // head outputs, NH boxes
      bf16* ks = t2 + NH * 4096 + wg * 8192;   // k, v of this warpgroup's head
      bf16* vs = ks + 4096;
#pragma unroll 1
      for (int j = 0; j < NP; ++j) {
        const int head = 2 * j + wg;
        const bool own = head < NH;
        uint32_t qa[4][4];
        float acc[32];
        gemm(t1, acc, mn);  // k
        store_tile(ks, acc);
        gemm(t1, acc, mn);  // v
        store_tile(vs, acc);
        gemm(t1, acc, mn);  // q, staged in the head's output tile until its output
        pack_a(qa, acc);
        if (own) store_tile(os + head * 4096, acc);
        hop::fence_proxy_async();
        hop::bar_sync(2 + wg, 128);  // k, v (and q) of the head are in place
        if (own) {  // kept for attention 1's VJP
          copy_out(qkv1 + head * 4096, os + head * 4096);
          copy_out(qkv1 + (NH + head) * 4096, ks);
          copy_out(qkv1 + (2 * NH + head) * 4096, vs);
        }

        float sacc[32];
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_rs_n64(sacc, qa[kk], hop::desc_sw128(ks + kk * 16), kk > 0);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(sacc);
        softmax(sacc, lo_a, lo_b);
        uint32_t pa[4][4];
        pack_a(pa, sacc);
        float oacc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) oacc[e] = 0.f;
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_rs_n64_tn(oacc, pa[kk], hop::desc_sw128(vs + kk * 16 * 64));
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(oacc);
        hop::bar_sync(2 + wg, 128);  // q's copy is done before the output takes its tile
        if (own) store_tile(os + head * 4096, oacc);
      }
      hop::fence_proxy_async();
      hop::bar_sync(1, 256);  // every head's output is in place

      // The output projection, + bias, rounded, + the residual x0: x1 into
      // the output rows (kernel B's epilogue).
      const float* bo = a.bo[0];
#pragma unroll 1
      for (int i = 0; i < NP; ++i) {
        const int blk = 2 * i + wg;
        float acc[32];
        gemm(os, acc, mn);
        if (blk >= NH) continue;
        const long long at_a = ra < valid ? row_at(ra) : -1, at_b = rb < valid ? row_at(rb) : -1;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = 64 * blk + 8 * c + cq;
          const float b0 = bo[col], b1 = bo[col + 1];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const long long at_r = hf ? at_b : at_a;
            if (at_r < 0) continue;
            const float2 y = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(a.x + at_r + col));
            const float o0 = round_to<bf16>(acc[4 * c + 2 * hf] + b0);
            const float o1 = round_to<bf16>(acc[4 * c + 2 * hf + 1] + b1);
            *reinterpret_cast<uint32_t*>(a.dx + at_r + col) = pack_bf16(y.x + o0, y.y + o1);
          }
        }
      }
    }
    hop::bar_sync(1, 256);  // x1 is written, and every product reading the z tile is done
    layer_norm(a.dx, 1, stats + 128, stats + 192);
    hop::fence_proxy_async();
    hop::bar_sync(1, 256);  // the z2 tile is in place
#pragma unroll 1
    for (int j = 0; j < NP; ++j) {
      const int head = 2 * j + wg;
      bf16* stage = t2 + wg * 5 * 4096;  // this warpgroup's q, k, v tiles of phases 2-3
      float acc[32];
#pragma unroll 1
      for (int m = 1; m < 4; ++m) {  // k, v, q into stage tiles m % 3
        gemm(t1, acc, mn);
        store_tile(stage + (m % 3) * 4096, acc);
      }
      hop::bar_sync(2 + wg, 128);  // the tiles are in place
      if (head < NH)
        for (int m = 0; m < 3; ++m) copy_out(qkv2 + (m * NH + head) * 4096, stage + m * 4096);
      hop::bar_sync(2 + wg, 128);  // copied before the next pair's tiles
    }

    // ---- 2., 3. the VJPs of attention 2 (ph 0), then of attention 1 ----
#pragma unroll 1
    for (int ph = 0; ph < 2; ++ph) {
      const int at = 1 - ph;
      bf16* qkv = ph ? qkv1 : qkv2;
      hop::bar_sync(1, 256);  // every product reading t1 or t2 is done; dx1 is written
      // The cotangent u rounded to bf16 into the u tile (t1): dy, then dx1.
      for (int e = tid; e < 64 * VN; e += 256) {
        const int r = e / VN, vv = e % VN;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r < valid) {
          if (ph == 0) {
            val = *reinterpret_cast<const uint4*>(a.dy + row_at(r) + 8 * vv);
          } else {
            const float4 u0 = *reinterpret_cast<const float4*>(dx1 + r * C + 8 * vv);
            const float4 u1 = *reinterpret_cast<const float4*>(dx1 + r * C + 8 * vv + 4);
            val = make_uint4(pack_bf16(u0.x, u0.y), pack_bf16(u0.z, u0.w), pack_bf16(u1.x, u1.y),
                             pack_bf16(u1.z, u1.w));
          }
        }
        *reinterpret_cast<uint4*>(t1 + (vv / 8) * 4096 + r * 64 + (((vv % 8) ^ (r % 8)) * 8)) =
            val;
      }
      hop::fence_proxy_async();
      hop::bar_sync(1, 256);  // the u tile is in place

      bf16* qs = t2 + wg * 5 * 4096;
      bf16* ks = qs + 4096;
      bf16* vs = ks + 4096;
      bf16* dos = vs + 4096;
      bf16* ps = dos + 4096;  // P, then dL
#pragma unroll 1
      for (int j = 0; j < NP; ++j) {
        const int head = 2 * j + wg;
        const bool own = head < NH;
        hop::bar_sync(2 + wg, 128);  // the last head's tiles are no longer read
        if (own)  // q, k, v of the head from the workspace, under the dO products
          for (int m = 0; m < 3; ++m) copy_in_async(qs + m * 4096, qkv + (m * NH + head) * 4096);
        wm::cp_async_commit();
        float acc[32];
        gemm(t1, acc, kmaj);  // dO = u Wo[head]^T
        uint32_t doa[4][4];
        store_tile(dos, acc);
        pack_a(doa, acc);
        wm::cp_async_wait<0>();
        hop::fence_proxy_async();
        hop::bar_sync(2 + wg, 128);  // q, k, v and dO are in place

        float sacc[32], dpacc[32];
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // S = q k^T
          hop::wgmma_ss_n64(sacc, hop::desc_sw128(qs + kk * 16), hop::desc_sw128(ks + kk * 16),
                            kk > 0);
        hop::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dP = dO V^T
          hop::wgmma_rs_n64(dpacc, doa[kk], hop::desc_sw128(vs + kk * 16), kk > 0);
        hop::wgmma_commit();
        hop::wgmma_wait<1>();
        hop::fence_regs(sacc);
        softmax(sacc, lo_a, lo_b);  // P, fp32
        store_tile(ps, sacc);
        hop::wgmma_wait<0>();
        hop::fence_regs(dpacc);
        hop::fence_proxy_async();
        hop::bar_sync(2 + wg, 128);  // P is in place

        {
          float dvacc[32];
          hop::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // dV = P^T dO
            hop::wgmma_ss_n64_tt(dvacc, hop::desc_sw128(ps + kk * 16 * 64),
                                 hop::desc_sw128(dos + kk * 16 * 64), kk > 0);
          hop::wgmma_commit();
          hop::wgmma_wait<0>();  // done before dL takes P's tile and registers
          hop::fence_regs(dvacc);
          hop::bar_sync(2 + wg, 128);  // every warp's dV products have read P and dO
          store_tile(dos, dvacc);      // dV, staged in dO's tile
        }
        // dL = (dP P - P rowsum(dP P)) * scale, over each row's keys.
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            dpacc[4 * c + e] *= sacc[4 * c + e];
            dpacc[4 * c + 2 + e] *= sacc[4 * c + 2 + e];
            sa += dpacc[4 * c + e];
            sb += dpacc[4 * c + 2 + e];
          }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          sa += __shfl_xor_sync(0xffffffffu, sa, off);
          sb += __shfl_xor_sync(0xffffffffu, sb, off);
        }
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            dpacc[4 * c + e] = (dpacc[4 * c + e] - sacc[4 * c + e] * sa) * a.scale;
            dpacc[4 * c + 2 + e] = (dpacc[4 * c + 2 + e] - sacc[4 * c + 2 + e] * sb) * a.scale;
          }
        uint32_t dla[4][4];
        pack_a(dla, dpacc);
        store_tile(ps, dpacc);
        hop::fence_proxy_async();
        hop::bar_sync(2 + wg, 128);  // dL is in place

        float dqacc[32], dkacc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) dqacc[e] = 0.f;
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dQ = dL K
          hop::wgmma_rs_n64_tn(dqacc, dla[kk], hop::desc_sw128(ks + kk * 16 * 64));
        hop::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dK = dL^T Q
          hop::wgmma_ss_n64_tt(dkacc, hop::desc_sw128(ps + kk * 16 * 64),
                               hop::desc_sw128(qs + kk * 16 * 64), kk > 0);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(dqacc);
        hop::fence_regs(dkacc);
        hop::bar_sync(2 + wg, 128);  // every warp's products have read q and k
        store_tile(qs, dqacc);       // dQ and dK, staged in q's and k's tiles
        store_tile(ks, dkacc);
        hop::bar_sync(2 + wg, 128);
        if (own)  // over the head's q, k, v in the workspace
          for (int m = 0; m < 3; ++m)
            copy_out(qkv + (m * NH + head) * 4096, m == 2 ? dos : qs + m * 4096);
      }
      // The dq/dk/dv tiles are written: the producer may stream them.
      hop::fence_proxy_async_global();
      hop::mbar_arrive(&ready[ph]);
      hop::bar_sync(1, 256);  // both warpgroups are done with t1 and t2: dz overlays them
#pragma unroll 1
      for (int i = 0; i < NP; ++i) {
        const int blk = 2 * i + wg;
        float acc[32];
        gemm_dz(acc);
        if (blk >= NH) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = 64 * blk + 8 * c + cq;
          *reinterpret_cast<float2*>(dz + ra * W::kLdDz + col) =
              make_float2(acc[4 * c], acc[4 * c + 1]);
          *reinterpret_cast<float2*>(dz + rb * W::kLdDz + col) =
              make_float2(acc[4 * c + 2], acc[4 * c + 3]);
        }
      }
      hop::bar_sync(1, 256);  // dz is in place
      ln_vjp(at);
    }
  }
}

template <int NH>
cudaError_t launch_wgmma_h(const void* x, const void* dy, void* dx, const void* const* wts,
                           void* ws, int B, int F, int P, int G, long long sB, long long sF,
                           long long sP, float eps, int grid, cudaStream_t stream) {
  using W = WgBwd<NH>;
  constexpr int C = W::C;
  CUtensorMap tq1, to1, tq2, to2;
  cudaError_t err = make_map_2d(&tq1, wts[2], C, 3 * C, 64);
  if (err == cudaSuccess) err = make_map_2d(&to1, wts[3], C, C, 64);
  if (err == cudaSuccess) err = make_map_2d(&tq2, wts[7], C, 3 * C, 64);
  if (err == cudaSuccess) err = make_map_2d(&to2, wts[8], C, C, 64);
  if (err == cudaSuccess) err = set_smem(temporal_pair_bwd_wgmma_kernel<NH>, W::kSmem);
  if (err != cudaSuccess) return err;
  BwdArgs a;
  a.x = static_cast<const bf16*>(x);
  a.dy = static_cast<const bf16*>(dy);
  a.dx = static_cast<bf16*>(dx);
  for (int i = 0; i < 2; ++i) {
    a.ln_s[i] = static_cast<const float*>(wts[5 * i]);
    a.ln_b[i] = static_cast<const float*>(wts[5 * i + 1]);
    a.bo[i] = static_cast<const float*>(wts[5 * i + 4]);
  }
  a.ws = static_cast<unsigned char*>(ws);
  a.sB = sB;
  a.sF = sF;
  a.sP = sP;
  a.F = F;
  a.P = P;
  a.G = G;
  a.tiles_p = (P + G - 1) / G;
  a.tiles = B * a.tiles_p;
  a.eps = eps;
  a.scale = 1.0f / sqrtf((float)kD);
  a.scale_log2e = a.scale * 1.4426950408889634f;
  temporal_pair_bwd_wgmma_kernel<NH><<<grid, W::kThreads, W::kSmem, stream>>>(tq1, to1, tq2,
                                                                              to2, a);
  return cudaGetLastError();
}

// The wgmma form's grid: one persistent block per SM (its shared memory
// admits one), or one per 64-row tile where there are fewer tiles.
int wgmma_grid(int B, int F, int P) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const long long tiles = (long long)B * ((P + 64 / F - 1) / (64 / F));
  return (int)(tiles < sms ? tiles : sms);
}

// The wgmma form at H heads, or its shared memory (smem_only).
long long wgmma_heads(const void* x, const void* dy, void* dx, const void* const* wts, void* ws,
                      int B, int F, int P, int H, int G, long long sB, long long sF,
                      long long sP, float eps, int grid, cudaStream_t s, bool smem_only) {
#define LVD_HEADS(nh)                                                                     \
  (smem_only ? (long long)WgBwd<nh>::kSmem                                                \
             : (long long)launch_wgmma_h<nh>(x, dy, dx, wts, ws, B, F, P, G, sB, sF, sP,  \
                                              eps, grid, s))
  switch (H) {
    case 1: return LVD_HEADS(1);
    case 2: return LVD_HEADS(2);
    case 3: return LVD_HEADS(3);
    case 4: return LVD_HEADS(4);
    case 5: return LVD_HEADS(5);
    case 6: return LVD_HEADS(6);
    case 7: return LVD_HEADS(7);
    case 8: return LVD_HEADS(8);
    case 9: return LVD_HEADS(9);
    default: return LVD_HEADS(10);
  }
#undef LVD_HEADS
}

}  // namespace

// The fp32 form on TF32 wgmma (csrc/pair_bwd_tf32.cu).
long long pair_bwd_tf32_workspace(int B, int F, int P, int C);
cudaError_t pair_bwd_tf32(const void* x, const void* dy, void* dx, const void* const* wts,
                          void* ws, int B, int F, int P, int C, long long sB, long long sF,
                          long long sP, float eps, cudaStream_t s);
constexpr int kTf32RowBlock = 128;  // its projections' output tiles: 128 rows a block

}  // namespace lvd

// Bytes of device-memory workspace lvd_temporal_pair_bwd needs for this
// shape, form and type (-1 if the shape or type is not supported): the
// wgmma form's 64 KB a head for each of its resident blocks, the first
// version's per-tile rows.
LVD_EXPORT long long lvd_temporal_pair_bwd_workspace(int B, int F, int P, int C, int form,
                                                     int dtype) {
  using namespace lvd;
  if (B <= 0 || F <= 0 || P <= 0 || C % 64 != 0) return -1;
  if (form == 1) {
    if (C > 640 || F > 64) return -1;
    if (dtype == kF32) return pair_bwd_tf32_workspace(B, F, P, C);
    if (dtype != kBF16) return -1;
    const int grid = wgmma_grid(B, F, P);
    return grid <= 0 ? -1 : (long long)grid * 65536LL * (C / 64);
  }
  if (form != 0) return -1;
  if (dtype == kBF16) return workspace_bytes<bf16>(B, F, P, C);
  if (dtype == kF32) return workspace_bytes<float>(B, F, P, C);
  return -1;
}

// x, dy, dx: (dtype 0 bf16, 1 fp32) with element (b, f, p, c) at b*sB + f*sF
// + p*sP + c (strides in elements; c contiguous). Per attention i: ln
// scale/bias (C,) fp32, wqkv (C, 3C) and wo (C, C) in x's type, bo (C,) fp32.
// ws: the workspace, lvd_temporal_pair_bwd_workspace bytes for the same
// form. C = H*64. form 1 is the wgmma form (H <= 10, F <= 64): in bf16
// row_block 64 and pixels 64 / F, in fp32 (csrc/pair_bwd_tf32.cu) row_block
// 128 (its projections' tiles) and pixels 1 (its attention passes); form 0
// the first version (row_block and pixels its tile search's R and G); a
// plan the form was not built for is refused.
LVD_EXPORT int lvd_temporal_pair_bwd(const void* x, const void* dy, void* dx, const void* ln1_s,
                                     const void* ln1_b, const void* wqkv1, const void* wo1,
                                     const void* bo1, const void* ln2_s, const void* ln2_b,
                                     const void* wqkv2, const void* wo2, const void* bo2,
                                     void* ws, int B, int F, int P, int C, int H, long long sB,
                                     long long sF, long long sP, float eps, int form,
                                     int row_block, int pixels, int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (C != H * kD || F <= 0 || P <= 0 || B <= 0) return cudaErrorInvalidValue;
  const void* wts[10] = {ln1_s, ln1_b, wqkv1, wo1, bo1, ln2_s, ln2_b, wqkv2, wo2, bo2};
  auto s = static_cast<cudaStream_t>(stream);
  if (form == 1 && dtype == kF32) {
    if (H < 1 || H > 10 || F > 64 || row_block != kTf32RowBlock || pixels != 1)
      return cudaErrorInvalidValue;
    return (int)pair_bwd_tf32(x, dy, dx, wts, ws, B, F, P, C, sB, sF, sP, eps, s);
  }
  if (form == 1) {
    if (dtype != kBF16 || H < 1 || H > 10 || F > 64 || row_block != 64 || pixels != 64 / F)
      return cudaErrorInvalidValue;
    const int grid = wgmma_grid(B, F, P);
    if (grid <= 0) return cudaErrorInvalidValue;
    return (int)wgmma_heads(x, dy, dx, wts, ws, B, F, P, H, pixels, sB, sF, sP, eps, grid, s,
                            false);
  }
  if (form != 0) return cudaErrorInvalidValue;
  return dispatch(dtype, [&](auto tag) {
    return launch<decltype(tag)>(x, dy, dx, wts, ws, B, F, P, C, H, sB, sF, sP, eps, row_block,
                                 pixels, s);
  });
}

// Bytes of dynamic shared memory one block of kernel F's wgmma form takes
// at H heads (1..10); 0 for any other count.
LVD_EXPORT long long lvd_temporal_pair_bwd_smem(int H) {
  using namespace lvd;
  if (H < 1 || H > 10) return 0;
  return wgmma_heads(nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1, 1, H, 1, 0, 0, 0, 0.f, 0,
                     nullptr, true);
}
