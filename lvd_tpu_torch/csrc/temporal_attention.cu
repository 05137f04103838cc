// Kernel B: the fused temporal double self-attention of a temporal
// BasicTransformerBlock, LN1 -> attn1 -> +res -> LN2 -> attn2 -> +res over
// the F frames of each pixel.
//
// Replaces lvd_tpu/ops/temporal_attention.py `_pallas_pair` (`_tattn_kernel`).
//
// Bound on this card: the (C, 3C) qkv and (C, C) output projections carry
// almost all of the operations (the per-pixel F x F attention is tiny), so at
// C = 320..640 the pair is tensor-core bound; unfused it would instead move
// the (B, F, P, C) stream through device memory ~10 times (LN, q, k, v,
// concat, out, twice). Design: one block per (batch, group of G pixels)
// holds the G*F rows of its pixels in shared memory (bf16 residual, LN output
// and per-head outputs) and runs both attentions there, so the stream is
// read once and written once. q/k/v for one head at a time come from WMMA
// products against the weights in device memory (L2-resident); the F x F
// attention runs as one (R, R) product masked to its per-pixel blocks, with
// an exact softmax (running max; the TPU kernel's clamped no-max exp2 is not
// carried over). Strides make the kernel take both the frames-major
// (B, F, P, C) stream and the pixels-major (B, P, F, C) one. Rounding points
// follow the plain version: q/k/v, probabilities, per-head outputs and the
// projected output are in the stream's type (bf16 or fp32), statistics and
// accumulations fp32; fp32 runs its products in TF32.
//
// Tiles: the first of G = 4, 2, 1 pixels (R = G*F rows rounded up to 16)
// whose layout fits 227 KB with the residual rows in shared memory; if none
// fits, the residual rows live in the output tensor itself (each block owns
// its rows; they are read by the LayerNorm and updated by the residual add,
// never a WMMA operand) and the same G search runs again. At F = 24: bf16
// C = 320 and 512 take G = 2 (R = 48; 139 and 193 KB), C = 640 G = 1
// (R = 32; 152 KB); fp32 C = 320 takes G = 1 (R = 32; 166 KB), C = 512 and
// 640 G = 1 with the residual in the output (R = 32; 173 and 205 KB).
#include "common.cuh"

namespace lvd {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kD = 64;

struct PairLayout {
  int R, ldc, ldh;
  bool ys_smem;
  size_t ys, lns, os, qs, ks, vs, S, P, scratch, total;
};

template <typename T>
__host__ __device__ inline PairLayout pair_layout(int R, int C, bool ys_smem) {
  PairLayout L;
  L.R = R;
  L.ldc = C + kPad<T>;
  L.ldh = kD + kPad<T>;
  L.ys_smem = ys_smem;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    size_t at = off;
    off += (bytes + 127) / 128 * 128;
    return at;
  };
  const size_t row_bytes = (size_t)R * L.ldc * sizeof(T);
  L.ys = ys_smem ? take(row_bytes) : 0;
  L.lns = take(row_bytes);
  L.os = take(row_bytes);
  L.qs = take((size_t)R * L.ldh * sizeof(T));
  L.ks = take((size_t)R * L.ldh * sizeof(T));
  L.vs = take((size_t)R * L.ldh * sizeof(T));
  L.S = take((size_t)R * R * 4);
  L.P = take((size_t)R * R * sizeof(T));
  L.scratch = take((size_t)kWarps * 256 * 4);
  L.total = off;
  return L;
}

template <typename T>
struct AttnWeights {
  const float* ln_s;  // (C,) fp32
  const float* ln_b;  // (C,) fp32
  const T* wqkv;      // (C, 3C): [Wq | Wk | Wv]
  const T* wo;        // (C, C)
  const float* bo;    // (C,) fp32
};

// The residual rows of the block: in shared memory (stride ldc) or in the
// output tensor (row r = g*F + f at f*sF + (p0 + g)*sP).
template <typename T>
struct Rows {
  T* base;
  int ldc;
  bool smem;
  long long sF, sP;
  int F, p0;
  __device__ T* row(int r) const {
    return smem ? base + r * ldc : base + (r % F) * sF + (long long)(p0 + r / F) * sP;
  }
};

template <typename T>
__device__ void one_attention(const AttnWeights<T>& w, const Rows<T>& ys, T* lns, T* os, T* qs,
                              T* ks, T* vs, float* S, T* P, float* scratch, int R, int ldc,
                              int ldh, int C, int H, int F, int valid_rows, float eps,
                              float scale_log2e) {
  using M = Mma<T>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int RT = R / 16;

  // LayerNorm, one warp per row, fp32 statistics (m2 - mean^2).
  for (int r = warp; r < R; r += kWarps) {
    T* dst = lns + r * ldc;
    if (r >= valid_rows) {
      for (int c = lane; c < C; c += 32) dst[c] = from_f<T>(0.f);
      continue;
    }
    const T* src = ys.row(r);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float x = to_f(src[c]);
      s1 += x;
      s2 += x * x;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mean = s1 / C;
    const float var = fmaxf(s2 / C - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    for (int c = lane; c < C; c += 32) {
      const float x = to_f(src[c]);
      dst[c] = from_f<T>((x - mean) * rstd * w.ln_s[c] + w.ln_b[c]);
    }
  }
  __syncthreads();

  float* scr = scratch + warp * 256;
  for (int h = 0; h < H; ++h) {
    // q, k, v of head h: three (R, 64) products over C.
    for (int t = warp; t < 3 * RT * 4; t += kWarps) {
      const int mat = t / (RT * 4);
      const int rt = (t % (RT * 4)) / 4;
      const int ct = t % 4;
      const T* bcol = w.wqkv + mat * C + h * kD + ct * 16;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < C; kk += M::K) {
        typename M::A a;
        typename M::BRow bm;
        load_op(a, lns + rt * 16 * ldc + kk, ldc);
        load_op(bm, bcol + (size_t)kk * 3 * C, 3 * C);
        wmma::mma_sync(acc, a, bm, acc);
      }
      T* dst = (mat == 0 ? qs : mat == 1 ? ks : vs) + rt * 16 * ldh + ct * 16;
      drain_tile(acc, scr, lane,
                 [&](int r, int c, float val) { dst[r * ldh + c] = from_f<T>(val); });
    }
    __syncthreads();

    // Logits for all row pairs of the tile; the softmax keeps each pixel's block.
    for (int t = warp; t < RT * RT; t += kWarps) {
      const int i = t / RT, j = t % RT;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD; kk += M::K) {
        typename M::A a;
        typename M::BCol bm;
        load_op(a, qs + i * 16 * ldh + kk, ldh);
        load_op(bm, ks + j * 16 * ldh + kk, ldh);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(S + i * 16 * R + j * 16, acc, R, wmma::mem_row_major);
    }
    __syncthreads();

    for (int r = tid; r < R; r += kThreads) {
      T* prow = P + r * R;
      for (int c = 0; c < R; ++c) prow[c] = from_f<T>(0.f);
      if (r < valid_rows) {
        const float* srow = S + r * R;
        const int c0 = (r / F) * F;
        float mx = -INFINITY;
        for (int c = c0; c < c0 + F; ++c) mx = fmaxf(mx, srow[c] * scale_log2e);
        float sum = 0.f;
        for (int c = c0; c < c0 + F; ++c) sum += exp2f(srow[c] * scale_log2e - mx);
        const float inv = 1.f / sum;
        for (int c = c0; c < c0 + F; ++c)
          prow[c] = from_f<T>(exp2f(srow[c] * scale_log2e - mx) * inv);
      }
    }
    __syncthreads();

    // Head output P V, written into its 64 columns of the concatenated output.
    for (int t = warp; t < RT * 4; t += kWarps) {
      const int i = t / 4, j = t % 4;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < R; kk += M::K) {
        typename M::A a;
        typename M::BRow bm;
        load_op(a, P + i * 16 * R + kk, R);
        load_op(bm, vs + kk * ldh + j * 16, ldh);
        wmma::mma_sync(acc, a, bm, acc);
      }
      T* dst = os + i * 16 * ldc + h * kD + j * 16;
      drain_tile(acc, scr, lane,
                 [&](int r, int c, float val) { dst[r * ldc + c] = from_f<T>(val); });
    }
    __syncthreads();
  }

  // Output projection + bias, then the residual add on the valid rows.
  const int CT = C / 16;
  for (int t = warp; t < RT * CT; t += kWarps) {
    const int i = t / CT, j = t % CT;
    typename M::Acc acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < C; kk += M::K) {
      typename M::A a;
      typename M::BRow bm;
      load_op(a, os + i * 16 * ldc + kk, ldc);
      load_op(bm, w.wo + (size_t)kk * C + j * 16, C);
      wmma::mma_sync(acc, a, bm, acc);
    }
    const float* bias = w.bo + j * 16;
    drain_tile(acc, scr, lane, [&](int r, int c, float val) {
      const int row = i * 16 + r;
      if (row >= valid_rows) return;
      T* dst = ys.row(row) + j * 16 + c;
      const float attn = round_to<T>(val + bias[c]);
      *dst = from_f<T>(to_f(*dst) + attn);
    });
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
temporal_pair_kernel(const T* __restrict__ x, T* __restrict__ out, AttnWeights<T> w1,
                     AttnWeights<T> w2, int F, int P, int C, int H, long long sB, long long sF,
                     long long sP, int G, int R, bool ys_smem, float eps, float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PairLayout L = pair_layout<T>(R, C, ys_smem);
  T* lns = reinterpret_cast<T*>(smem + L.lns);
  T* os = reinterpret_cast<T*>(smem + L.os);
  T* qs = reinterpret_cast<T*>(smem + L.qs);
  T* ks = reinterpret_cast<T*>(smem + L.ks);
  T* vs = reinterpret_cast<T*>(smem + L.vs);
  float* S = reinterpret_cast<float*>(smem + L.S);
  T* Pm = reinterpret_cast<T*>(smem + L.P);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * G;
  const int g_here = min(G, P - p0);
  const int valid_rows = g_here * F;
  const int ldc = L.ldc;
  constexpr int V = kVecN<T>;
  const int cvn = C / V;
  const T* xb = x + b * sB;
  T* ob = out + b * sB;
  const Rows<T> ys{ys_smem ? reinterpret_cast<T*>(smem + L.ys) : ob, ldc, ys_smem, sF, sP, F, p0};

  // Row r = g*F + f holds frame f of pixel p0 + g (padded rows are zero).
  for (int e = threadIdx.x; e < R * cvn; e += kThreads) {
    const int r = e / cvn, cv = e % cvn;
    if (!ys_smem && r >= valid_rows) continue;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid_rows) {
      const int g = r / F, f = r % F;
      val = *reinterpret_cast<const uint4*>(xb + f * sF + (p0 + g) * sP + cv * V);
    }
    *reinterpret_cast<uint4*>(ys.row(r) + cv * V) = val;
  }
  __syncthreads();

  one_attention(w1, ys, lns, os, qs, ks, vs, S, Pm, scratch, R, ldc, L.ldh, C, H, F, valid_rows,
                eps, scale_log2e);
  one_attention(w2, ys, lns, os, qs, ks, vs, S, Pm, scratch, R, ldc, L.ldh, C, H, F, valid_rows,
                eps, scale_log2e);

  if (!ys_smem) return;  // the rows already live in the output
  for (int e = threadIdx.x; e < valid_rows * cvn; e += kThreads) {
    const int r = e / cvn, cv = e % cvn;
    const int g = r / F, f = r % F;
    *reinterpret_cast<uint4*>(ob + f * sF + (p0 + g) * sP + cv * V) =
        *reinterpret_cast<const uint4*>(ys.row(r) + cv * V);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, const void* const* wts, int B, int F, int P, int C,
                   int H, long long sB, long long sF, long long sP, float eps,
                   cudaStream_t stream) {
  int G = 0, R = 0;
  bool ys_smem = true;
  for (int in_smem = 1; in_smem >= 0 && G == 0; --in_smem) {
    const int candidates[3] = {4, 2, 1};
    for (int g : candidates) {
      const int r = round_up(g * F, 16);
      if (r <= 128 && pair_layout<T>(r, C, in_smem).total <= (size_t)kMaxSmem) {
        G = g;
        R = r;
        ys_smem = in_smem;
        break;
      }
    }
  }
  if (G == 0) return cudaErrorInvalidValue;
  const int smem = (int)pair_layout<T>(R, C, ys_smem).total;
  cudaError_t err = set_smem(temporal_pair_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  auto weights = [&](int i) {
    return AttnWeights<T>{static_cast<const float*>(wts[5 * i]),
                          static_cast<const float*>(wts[5 * i + 1]),
                          static_cast<const T*>(wts[5 * i + 2]),
                          static_cast<const T*>(wts[5 * i + 3]),
                          static_cast<const float*>(wts[5 * i + 4])};
  };
  dim3 grid((P + G - 1) / G, B);
  const float scale_log2e = (1.0f / sqrtf((float)kD)) * 1.4426950408889634f;
  temporal_pair_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), weights(0), weights(1), F, P, C, H, sB, sF,
      sP, G, R, ys_smem, eps, scale_log2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lvd

// x/out: (dtype 0 bf16, 1 fp32) with element (b, f, p, c) at b*sB + f*sF +
// p*sP + c (strides in elements; c contiguous). Per attention i: ln
// scale/bias (C,) fp32, wqkv (C, 3C) and wo (C, C) in x's type, bo (C,) fp32.
// C = H*64.
LVD_EXPORT int lvd_temporal_pair(const void* x, void* out, const void* ln1_s, const void* ln1_b,
                                 const void* wqkv1, const void* wo1, const void* bo1,
                                 const void* ln2_s, const void* ln2_b, const void* wqkv2,
                                 const void* wo2, const void* bo2, int B, int F, int P, int C,
                                 int H, long long sB, long long sF, long long sP, float eps,
                                 int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (C != H * kD || F <= 0 || P <= 0) return cudaErrorInvalidValue;
  const void* wts[10] = {ln1_s, ln1_b, wqkv1, wo1, bo1, ln2_s, ln2_b, wqkv2, wo2, bo2};
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    return launch<decltype(tag)>(x, out, wts, B, F, P, C, H, sB, sF, sP, eps, s);
  });
}
