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
// Tiles: the first of G = 2, 1 pixels whose layout fits 227 KB with the
// residual rows x in shared memory; if none fits, x moves to the block's
// device-memory workspace too (it is read by the LayerNorms and updated by
// the residual add, never a WMMA operand) and the G search runs again. At
// F = 24: bf16 C = 320, 512, 640 take G = 2 (R = 48; 151, 187, 211 KB); fp32
// C = 320 and 512 take G = 1 (R = 32; 170 and 218 KB), C = 640 G = 1 with x
// in the workspace (R = 32; 169 KB).
#include "common.cuh"

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
                   float eps, cudaStream_t stream) {
  int G = 0, R = 0;
  bool xs_smem = true;
  if (pick_tile<T>(F, C, G, R, xs_smem) != 0) return cudaErrorInvalidValue;
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

}  // namespace
}  // namespace lvd

// Bytes of device-memory workspace lvd_temporal_pair_bwd needs for this shape
// and type (-1 if the shape or type is not supported).
LVD_EXPORT long long lvd_temporal_pair_bwd_workspace(int B, int F, int P, int C, int dtype) {
  using namespace lvd;
  if (F <= 0 || P <= 0 || C % 64 != 0) return -1;
  if (dtype == kBF16) return workspace_bytes<bf16>(B, F, P, C);
  if (dtype == kF32) return workspace_bytes<float>(B, F, P, C);
  return -1;
}

// x, dy, dx: (dtype 0 bf16, 1 fp32) with element (b, f, p, c) at b*sB + f*sF
// + p*sP + c (strides in elements; c contiguous). Per attention i: ln
// scale/bias (C,) fp32, wqkv (C, 3C) and wo (C, C) in x's type, bo (C,) fp32.
// ws: the workspace, lvd_temporal_pair_bwd_workspace bytes. C = H*64.
LVD_EXPORT int lvd_temporal_pair_bwd(const void* x, const void* dy, void* dx, const void* ln1_s,
                                     const void* ln1_b, const void* wqkv1, const void* wo1,
                                     const void* bo1, const void* ln2_s, const void* ln2_b,
                                     const void* wqkv2, const void* wo2, const void* bo2,
                                     void* ws, int B, int F, int P, int C, int H, long long sB,
                                     long long sF, long long sP, float eps, int dtype,
                                     void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (C != H * kD || F <= 0 || P <= 0) return cudaErrorInvalidValue;
  const void* wts[10] = {ln1_s, ln1_b, wqkv1, wo1, bo1, ln2_s, ln2_b, wqkv2, wo2, bo2};
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    return launch<decltype(tag)>(x, dy, dx, wts, ws, B, F, P, C, H, sB, sF, sP, eps, s);
  });
}
