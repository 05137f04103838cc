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
// projected output are bf16, statistics and accumulations fp32.
#include "common.cuh"

namespace lvd {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kD = 64;
constexpr int kLdh = 80;  // bf16 row stride of the per-head q/k/v tiles

struct PairLayout {
  int R, ldc;
  size_t ys, lns, os, qs, ks, vs, S, P, scratch, total;
};

__host__ __device__ inline PairLayout pair_layout(int R, int C) {
  PairLayout L;
  L.R = R;
  L.ldc = C + 16;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    size_t at = off;
    off += (bytes + 127) / 128 * 128;
    return at;
  };
  L.ys = take((size_t)R * L.ldc * 2);
  L.lns = take((size_t)R * L.ldc * 2);
  L.os = take((size_t)R * L.ldc * 2);
  L.qs = take((size_t)R * kLdh * 2);
  L.ks = take((size_t)R * kLdh * 2);
  L.vs = take((size_t)R * kLdh * 2);
  L.S = take((size_t)R * R * 4);
  L.P = take((size_t)R * R * 2);
  L.scratch = take((size_t)kWarps * 256 * 4);
  L.total = off;
  return L;
}

struct AttnWeights {
  const float* ln_s;   // (C,) fp32
  const float* ln_b;   // (C,) fp32
  const bf16* wqkv;    // (C, 3C): [Wq | Wk | Wv]
  const bf16* wo;      // (C, C)
  const float* bo;     // (C,) fp32
};

__device__ void one_attention(const AttnWeights& w, bf16* ys, bf16* lns, bf16* os, bf16* qs,
                              bf16* ks, bf16* vs, float* S, bf16* P, float* scratch, int R,
                              int ldc, int C, int H, int F, int valid_rows, float eps,
                              float scale_log2e) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int RT = R / 16;

  // LayerNorm, one warp per row, fp32 statistics (m2 - mean^2).
  for (int r = warp; r < R; r += kWarps) {
    bf16* dst = lns + r * ldc;
    if (r >= valid_rows) {
      for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* src = ys + r * ldc;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float x = __bfloat162float(src[c]);
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
      const float x = __bfloat162float(src[c]);
      dst[c] = __float2bfloat16((x - mean) * rstd * w.ln_s[c] + w.ln_b[c]);
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
      const bf16* bcol = w.wqkv + mat * C + h * kD + ct * 16;
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < C; kk += 16) {
        FragA a;
        FragBRow bm;
        wmma::load_matrix_sync(a, lns + rt * 16 * ldc + kk, ldc);
        wmma::load_matrix_sync(bm, bcol + (size_t)kk * 3 * C, 3 * C);
        wmma::mma_sync(acc, a, bm, acc);
      }
      bf16* dst = (mat == 0 ? qs : mat == 1 ? ks : vs) + rt * 16 * kLdh + ct * 16;
      drain_tile(acc, scr, lane,
                 [&](int r, int c, float val) { dst[r * kLdh + c] = __float2bfloat16(val); });
    }
    __syncthreads();

    // Logits for all row pairs of the tile; the softmax keeps each pixel's block.
    for (int t = warp; t < RT * RT; t += kWarps) {
      const int i = t / RT, j = t % RT;
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD; kk += 16) {
        FragA a;
        FragBCol bm;
        wmma::load_matrix_sync(a, qs + i * 16 * kLdh + kk, kLdh);
        wmma::load_matrix_sync(bm, ks + j * 16 * kLdh + kk, kLdh);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(S + i * 16 * R + j * 16, acc, R, wmma::mem_row_major);
    }
    __syncthreads();

    for (int r = tid; r < R; r += kThreads) {
      bf16* prow = P + r * R;
      for (int c = 0; c < R; ++c) prow[c] = __float2bfloat16(0.f);
      if (r < valid_rows) {
        const float* srow = S + r * R;
        const int c0 = (r / F) * F;
        float mx = -INFINITY;
        for (int c = c0; c < c0 + F; ++c) mx = fmaxf(mx, srow[c] * scale_log2e);
        float sum = 0.f;
        for (int c = c0; c < c0 + F; ++c) sum += exp2f(srow[c] * scale_log2e - mx);
        const float inv = 1.f / sum;
        for (int c = c0; c < c0 + F; ++c)
          prow[c] = __float2bfloat16(exp2f(srow[c] * scale_log2e - mx) * inv);
      }
    }
    __syncthreads();

    // Head output P V, written into its 64 columns of the concatenated output.
    for (int t = warp; t < RT * 4; t += kWarps) {
      const int i = t / 4, j = t % 4;
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < R; kk += 16) {
        FragA a;
        FragBRow bm;
        wmma::load_matrix_sync(a, P + i * 16 * R + kk, R);
        wmma::load_matrix_sync(bm, vs + kk * kLdh + j * 16, kLdh);
        wmma::mma_sync(acc, a, bm, acc);
      }
      bf16* dst = os + i * 16 * ldc + h * kD + j * 16;
      drain_tile(acc, scr, lane,
                 [&](int r, int c, float val) { dst[r * ldc + c] = __float2bfloat16(val); });
    }
    __syncthreads();
  }

  // Output projection + bias, then the residual add, in place in ys.
  const int CT = C / 16;
  for (int t = warp; t < RT * CT; t += kWarps) {
    const int i = t / CT, j = t % CT;
    FragAcc acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < C; kk += 16) {
      FragA a;
      FragBRow bm;
      wmma::load_matrix_sync(a, os + i * 16 * ldc + kk, ldc);
      wmma::load_matrix_sync(bm, w.wo + (size_t)kk * C + j * 16, C);
      wmma::mma_sync(acc, a, bm, acc);
    }
    bf16* dst = ys + i * 16 * ldc + j * 16;
    const float* bias = w.bo + j * 16;
    drain_tile(acc, scr, lane, [&](int r, int c, float val) {
      const float attn = bf16_round(val + bias[c]);
      dst[r * ldc + c] = __float2bfloat16(__bfloat162float(dst[r * ldc + c]) + attn);
    });
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
temporal_pair_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, AttnWeights w1,
                     AttnWeights w2, int F, int P, int C, int H, long long sB, long long sF,
                     long long sP, int G, int R, float eps, float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PairLayout L = pair_layout(R, C);
  bf16* ys = reinterpret_cast<bf16*>(smem + L.ys);
  bf16* lns = reinterpret_cast<bf16*>(smem + L.lns);
  bf16* os = reinterpret_cast<bf16*>(smem + L.os);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.qs);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.ks);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.vs);
  float* S = reinterpret_cast<float*>(smem + L.S);
  bf16* Pm = reinterpret_cast<bf16*>(smem + L.P);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * G;
  const int g_here = min(G, P - p0);
  const int valid_rows = g_here * F;
  const int ldc = L.ldc;
  const int c8n = C / 8;

  // Row r = g*F + f holds frame f of pixel p0 + g.
  for (int e = threadIdx.x; e < R * c8n; e += kThreads) {
    const int r = e / c8n, c8 = e % c8n;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid_rows) {
      const int g = r / F, f = r % F;
      val = *reinterpret_cast<const uint4*>(x + b * sB + f * sF + (p0 + g) * sP + c8 * 8);
    }
    *reinterpret_cast<uint4*>(ys + r * ldc + c8 * 8) = val;
  }
  __syncthreads();

  one_attention(w1, ys, lns, os, qs, ks, vs, S, Pm, scratch, R, ldc, C, H, F, valid_rows, eps,
                scale_log2e);
  one_attention(w2, ys, lns, os, qs, ks, vs, S, Pm, scratch, R, ldc, C, H, F, valid_rows, eps,
                scale_log2e);

  for (int e = threadIdx.x; e < valid_rows * c8n; e += kThreads) {
    const int r = e / c8n, c8 = e % c8n;
    const int g = r / F, f = r % F;
    *reinterpret_cast<uint4*>(out + b * sB + f * sF + (p0 + g) * sP + c8 * 8) =
        *reinterpret_cast<const uint4*>(ys + r * ldc + c8 * 8);
  }
}

}  // namespace
}  // namespace lvd

// x/out: bf16 with element (b, f, p, c) at b*sB + f*sF + p*sP + c (strides in
// elements; c contiguous). Per attention i: ln scale/bias (C,) fp32,
// wqkv (C, 3C) bf16, wo (C, C) bf16, bo (C,) fp32. C = H*64, C % 16 == 0.
LVD_EXPORT int lvd_temporal_pair(const void* x, void* out, const void* ln1_s, const void* ln1_b,
                                 const void* wqkv1, const void* wo1, const void* bo1,
                                 const void* ln2_s, const void* ln2_b, const void* wqkv2,
                                 const void* wo2, const void* bo2, int B, int F, int P, int C,
                                 int H, long long sB, long long sF, long long sP, float eps,
                                 void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (C != H * kD || C % 16 != 0 || F <= 0 || P <= 0) return cudaErrorInvalidValue;
  int G = 0, R = 0;
  const int candidates[3] = {4, 2, 1};
  for (int g : candidates) {
    const int r = round_up(g * F, 16);
    if (r <= 128 && pair_layout(r, C).total <= (size_t)kMaxSmem) {
      G = g;
      R = r;
      break;
    }
  }
  if (G == 0) return cudaErrorInvalidValue;
  const int smem = (int)pair_layout(R, C).total;
  cudaError_t err = set_smem(temporal_pair_kernel, smem);
  if (err != cudaSuccess) return err;
  AttnWeights w1{static_cast<const float*>(ln1_s), static_cast<const float*>(ln1_b),
                 static_cast<const bf16*>(wqkv1), static_cast<const bf16*>(wo1),
                 static_cast<const float*>(bo1)};
  AttnWeights w2{static_cast<const float*>(ln2_s), static_cast<const float*>(ln2_b),
                 static_cast<const bf16*>(wqkv2), static_cast<const bf16*>(wo2),
                 static_cast<const float*>(bo2)};
  dim3 grid((P + G - 1) / G, B);
  const float scale_log2e = (1.0f / sqrtf((float)kD)) * 1.4426950408889634f;
  temporal_pair_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), w1, w2, F, P, C, H, sB, sF, sP, G,
      R, eps, scale_log2e);
  return cudaGetLastError();
}
