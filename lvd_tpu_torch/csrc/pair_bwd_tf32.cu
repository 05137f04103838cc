// Kernel F's fp32 form on Hopper: the input gradient (dy only) of the fused
// temporal double self-attention y -> x1 = y + A1(LN1(y)) -> x2 = x1 +
// A2(LN2(x1)) over the F frames of each pixel, in fp32 with TF32 products.
//
// Replaces lvd_tpu/ops/temporal_attention.py `_pallas_pair_bwd`
// (`_tattn_bwd_kernel`) for fp32 streams, beside the bf16 `wgmma` form and
// the first version in csrc/temporal_attention_bwd.cu, whose entry point
// (form 1, fp32) launches it.
//
// Math (as the first version): recompute LN1 -> attn1 -> +res -> LN2 ->
// qkv2; dz2 = VJP_A2(dy); dx1 = dy + VJP_LN2(dz2); dz1 = VJP_A1(dx1); dx0 =
// dx1 + VJP_LN1(dz1). Statistics, softmax, residuals, the LayerNorm VJPs and
// every accumulator stay fp32; every product operand is rounded to TF32
// (round to nearest, ties away) before it reaches a product, as the first
// version's WMMA loads round it, so this form reads as TF32 and not as bf16.
//
// Bound on this card: the (C, 3C) and (C, C) projections, 15 C^2
// multiply-adds a row, carry ~93% of the operations (the per-pixel F x F
// attention steps the rest at F = 24), so it is tensor-core bound at TF32's
// rate; the first version, one block per pixel pair on WMMA with its chain
// through a workspace, ran at 65x its bound (PERF.md). In fp32 every tile is
// twice the bytes of bf16's, and the bf16 form's one fused kernel already
// fills 218-226 KB of shared memory and 168 registers, so this form splits
// the chain into passes instead, each sized for the card:
//  - the seven projections on one TMA + TF32 `wgmma` GEMM
//    (`temporal_pair_bwd_tf32_gemm`): 128 x BN output tiles (BN = 128 where
//    N % 128 == 0, else 64), two consumer warpgroups of m64nBNk8 and a
//    producer warp keeping a four-stage ring of 128 x 32 A and BN x 32 B
//    fp32 boxes (128-byte swizzle, K-major both: TF32 `wgmma` takes no
//    transposed operand, so the weights are staged once per call in both
//    orientations, rounded, `temporal_pair_bwd_tf32_stage`); the epilogue
//    adds the output bias and the residual (x1 = y + o Wo1 + bo1) in fp32.
//    Shared memory: 128 KB (BN 128) or 96 KB (BN 64, two blocks an SM);
//  - LayerNorm (`..._ln`) and its VJP plus the residual (`..._ln_vjp`), one
//    warp a row, statistics in fp32, the LN output written TF32-rounded (it
//    is only ever a product operand);
//  - the attention of (pixel, head) pairs (`..._attn`, `..._attn_vjp`) on
//    mma.sync m16n8k8 TF32 (csrc/warp_mma.cuh): an F x F x 64 product is
//    far below `wgmma`'s 64-row tile, so a warp takes 16 frames (queries,
//    then in the VJP keys) of one pair, F rounded up to FP = 16..64 with the
//    keys past F masked; a block holds 4 / (FP / 16) pairs (two at F = 24:
//    88 KB for the VJP, FP x 68 fp32 a head tile). S, the fp32 softmax, P V
//    or dP = dO V^T, dL and dQ = dL K stay in registers; P^T and dL^T go
//    through shared memory for dV = P^T dO and dK = dL^T Q. The VJP writes
//    dq, dk, dv over the pair's own q, k, v.
// The intermediates cross device memory: 12 C + 4 fp32 a row of workspace
// (1.06 GB at (1, 24, 2880, 320)) plus the staged weights, 15 C^2.
// Rows keep the stream's order (frames-major or pixels-major): the
// projections and the row passes do not care, and the attention passes
// find a pixel's F rows through the strides.
#include "common.cuh"
#include "hopper.cuh"
#include "warp_mma.cuh"

namespace lvd {
namespace {

constexpr int kHd = 64;          // head dim
constexpr int kGemmRows = 128;   // rows a GEMM block: two consumer warpgroups of m64
constexpr int kGemmStages = 4;

template <int BN>
struct Tf32Gemm {
  static constexpr int kThreads = 2 * 128 + 32;  // consumer warpgroups, then the producer warp
  static constexpr int kA = kGemmRows * 128;      // 128 rows x 32 fp32
  static constexpr int kB = BN * 128;             // BN rows x 32 fp32
  static constexpr int kStage = kA + kB;
  static constexpr int kSmem = kGemmStages * kStage + 256 + 1024;  // + barriers, alignment
};

struct GemmEpilogue {
  const float* bias;  // (N,) added in fp32, or null
  const float* res;   // (M, N) added in fp32, or null
  float* out;         // (M, N)
};

// out (M, N) = A (M, K) B^T (+ bias) (+ res), with A and B = Bt (N, K) fp32
// row-major and already TF32-rounded; K % 32 == 0, N % BN == 0.
template <int BN>
__global__ void __launch_bounds__(Tf32Gemm<BN>::kThreads, 1)
temporal_pair_bwd_tf32_gemm(const __grid_constant__ CUtensorMap tm_a,
                            const __grid_constant__ CUtensorMap tm_b, GemmEpilogue ep, int M,
                            int N, int K) {
  using G = Tf32Gemm<BN>;
  constexpr int NS = kGemmStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * G::kStage);
  uint64_t* empty = full + NS;
  const int m0 = blockIdx.x * kGemmRows, n0 = blockIdx.y * BN;
  const int nk = K / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // every consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp: one lane issues every TMA load
    if (lane == 0) {
      for (int v = 0; v < nk; ++v) {
        const int s = v % NS;
        if (v >= NS) hop::mbar_wait(&empty[s], (v / NS - 1) & 1);
        unsigned char* st = ring + s * G::kStage;
        hop::mbar_expect_tx(&full[s], G::kStage);
        hop::tma_load_2d(st, &tm_a, &full[s], 32 * v, m0);
        hop::tma_load_2d(st + G::kA, &tm_b, &full[s], 32 * v, n0);
      }
    }
    return;
  }
  const int wg = warp / 4, wq = warp % 4, r4 = lane / 4, cq = 2 * (lane % 4);
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  for (int v = 0; v < nk; ++v) {
    const int s = v % NS;
    hop::mbar_wait(&full[s], (v / NS) & 1);
    const float* A = reinterpret_cast<const float*>(ring + s * G::kStage) + wg * 64 * 32;
    const float* B = reinterpret_cast<const float*>(ring + s * G::kStage + G::kA);
    hop::fence_regs(acc);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (BN == 128) {
        hop::wgmma_tf32_n128(acc, hop::desc_sw128(A + kk * 8), hop::desc_sw128(B + kk * 8),
                             v > 0 || kk > 0);
      } else {
        hop::wgmma_tf32_n64(acc, hop::desc_sw128(A + kk * 8), hop::desc_sw128(B + kk * 8),
                            v > 0 || kk > 0);
      }
    }
    hop::wgmma_commit();
    hop::wgmma_wait<1>();  // the previous stage's products are done: release it
    if (v > 0) {
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[(v - 1) % NS]);
    }
  }
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);

  // Column n0 + 8 c + cq (+1) of row m0 + 64 wg + 16 wq + r4 is acc[4 c (+1)]
  // (+ 2 for row + 8).
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int col = n0 + 8 * c + cq;
    float2 b = make_float2(0.f, 0.f);
    if (ep.bias != nullptr) b = *reinterpret_cast<const float2*>(ep.bias + col);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + 64 * wg + 16 * wq + r4 + 8 * hf;
      if (row >= M) continue;
      const size_t at = (size_t)row * N + col;
      float2 o = make_float2(acc[4 * c + 2 * hf] + b.x, acc[4 * c + 2 * hf + 1] + b.y);
      if (ep.res != nullptr) {
        const float2 r = *reinterpret_cast<const float2*>(ep.res + at);
        o.x += r.x;
        o.y += r.y;
      }
      *reinterpret_cast<float2*>(ep.out + at) = o;
    }
  }
}

// LayerNorm of R rows of C (one warp a row, C % 32 == 0, C <= 640) with
// one-pass fp32 statistics (as lvd_tpu's): z = xhat * scale + bias,
// TF32-rounded; stats[2 r] = mean, stats[2 r + 1] = rstd.
__global__ void __launch_bounds__(256)
temporal_pair_bwd_tf32_ln(const float* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ bias, float* __restrict__ z,
                          float* __restrict__ stats, int R, int C, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= R) return;
  const float* xr = x + (size_t)row * C;
  const int n = C / 32;
  float v[20];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    if (i < n) {
      v[i] = xr[lane + 32 * i];
      s += v[i];
      s2 += v[i] * v[i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mean = s / C;
  const float rstd = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + eps);
  float* zr = z + (size_t)row * C;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    if (i < n) {
      const int c = lane + 32 * i;
      zr[c] = hop::tf32_rna((v[i] - mean) * rstd * scale[c] + bias[c]);
    }
  }
  if (lane == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = rstd;
  }
}

// out = resid + VJP_LN(dz): g = dz * scale, xhat from x and its stats,
// rstd * (g - mean(g) - xhat * mean(g * xhat)), in fp32; out_round, where
// given, gets the same rows TF32-rounded (the next product's operand).
__global__ void __launch_bounds__(256)
temporal_pair_bwd_tf32_ln_vjp(const float* __restrict__ dz, const float* __restrict__ x,
                              const float* __restrict__ stats, const float* __restrict__ scale,
                              const float* __restrict__ resid, float* __restrict__ out,
                              float* __restrict__ out_round, int R, int C) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= R) return;
  const size_t base = (size_t)row * C;
  const float mean = stats[2 * row], rstd = stats[2 * row + 1];
  const int n = C / 32;
  float g[20], xh[20];
  float m1 = 0.f, m2 = 0.f;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    if (i < n) {
      const int c = lane + 32 * i;
      g[i] = dz[base + c] * scale[c];
      xh[i] = (x[base + c] - mean) * rstd;
      m1 += g[i];
      m2 += g[i] * xh[i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m1 += __shfl_xor_sync(0xffffffffu, m1, o);
    m2 += __shfl_xor_sync(0xffffffffu, m2, o);
  }
  m1 /= C;
  m2 /= C;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    if (i < n) {
      const int c = lane + 32 * i;
      const float o = resid[base + c] + rstd * (g[i] - m1 - xh[i] * m2);
      out[base + c] = o;
      if (out_round != nullptr) out_round[base + c] = hop::tf32_rna(o);
    }
  }
}

// The rows of a pixel: element (b, f, p, 0) of the stream is row
// (b sB + f sF + p sP) / C.
struct PixelRows {
  long long sB, sF, sP;
  int F, P, C;
  __device__ long long row(int b, int p, int f) const {
    return (b * sB + f * sF + p * sP) / C;
  }
};

// The attention passes' tiles at FP = F rounded up to 16 frames: a (pixel,
// head) pair's q, k, v (and dO) as FP x kLdt fp32 tiles, frames past F zero;
// a warp owns one 16-row tile of a pair (its queries, then in the VJP its
// keys), and a block holds kPairs pairs: 4 at F <= 16, 2 at F <= 32, 1
// past (three warps at F <= 48).
template <int FP>
struct AttnTiles {
  static constexpr int kLdt = kHd + wm::WarpMma<float>::kPadE;  // 68: conflict-free fragments
  static constexpr int kLdp = FP + 4;                           // a P^T / dL^T row
  static constexpr int kRowTiles = FP / 16;
  static constexpr int kPairs = kRowTiles >= 3 ? 1 : 4 / kRowTiles;
  static constexpr int kWarps = kPairs * kRowTiles;
  static constexpr int kHead = FP * kLdt;
  static constexpr int kFwd = 3 * kHead;                   // q, k, v
  static constexpr int kVjp = 4 * kHead + 2 * FP * kLdp;   // q, k, v, dO, P^T, dL^T
};

// Starts the copy of the block's pairs' head tiles (cp.async, 16 bytes a
// thread a step, all in flight at once): matrix m of `mats` at column m *
// mstride + h * 64 of the (R, ld) buffer src, frames [0, F) of the pair's
// pixel; frames past F and pairs past `pairs` zero-filled. The values stay
// as stored: the fragment loads round every operand to TF32.
template <int FP>
__device__ inline void load_heads(float* tiles, int per_pair, const float* src, size_t ld,
                                  int mats, int mstride, const PixelRows& pr, int H, int pairs) {
  using T = AttnTiles<FP>;
  constexpr int kV = kHd / 4;  // 16-byte pieces a head row
  const int n = T::kPairs * mats * FP * kV;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c4 = e % kV, f = e / kV % FP, m = e / (kV * FP) % mats, j = e / (kV * FP * mats);
    const int pair = blockIdx.x * T::kPairs + j;
    const bool ok = pair < pairs && f < pr.F;
    const int px = ok ? pair / H : 0, h = ok ? pair % H : 0;
    const float* at = src + (ok ? pr.row(px / pr.P, px % pr.P, f) * ld : 0) + m * mstride +
                      h * kHd + 4 * c4;
    wm::cp_async16(tiles + j * per_pair + m * T::kHead + f * T::kLdt + 4 * c4, at, ok);
  }
  wm::cp_async_commit();
}

// A warp's 16 query rows of S = q k^T (keys in FP / 8 accumulator tiles), scaled,
// keys past F masked, softmax in fp32 in place: row g holds keys 8 n + 2 t
// (+1) in s[n][0..1], row g + 8 in s[n][2..3] (g = lane / 4, t = lane % 4).
template <int FP>
__device__ inline void softmax_tile(float (&s)[FP / 8][4], const float* q, const float* k, int F,
                                    float scale, int lane) {
  using T = AttnTiles<FP>;
#pragma unroll
  for (int n = 0; n < FP / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  wm::mma_rows_nk<float, FP / 8>(s, q, k, T::kLdt, kHd, lane);
  const int t = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < FP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = 8 * n + 2 * t + (e & 1) < F ? s[n][e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int n = 0; n < FP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = expf(s[n][e] - mx[e >> 1]);
      sum[e >> 1] += s[n][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    sum[r] = 1.f / sum[r];
  }
#pragma unroll
  for (int n = 0; n < FP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] *= sum[e >> 1];
  }
}

// c[n] += A B over `depth` (a multiple of 8): A rows from a row-major tile
// (k contiguous), B from a tile whose rows are k (n contiguous), e.g. dV =
// P^T dO with P^T's rows and dO's.
template <int NT>
__device__ inline void mma_rows_kn(float (&c)[NT][4], const float* a, int lda, const float* b,
                                   int ldb, int depth, int lane) {
  using W = wm::WarpMma<float>;
#pragma unroll
  for (int kk = 0; kk < depth; kk += W::K) {
    uint32_t af[4];
    W::load_a(af, a + kk, lda, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b0[2], b1[2];
      W::load_b_rows(b0, b1, b + kk * ldb + np * 16, ldb, lane);
      W::mma(c[2 * np], af, b0);
      W::mma(c[2 * np + 1], af, b1);
    }
  }
}

// Stores a warp's 16 x 64 accumulator (rows r0 + g (+8) of the pair, those
// below F) TF32-rounded at column col0 of the (R, ld) buffer dst.
__device__ inline void store_head(float* dst, size_t ld, int col0, const float (&c)[8][4],
                                  const PixelRows& pr, int px, int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int f = r0 + g + 8 * hf;
    if (f >= pr.F) continue;
    float* row = dst + pr.row(px / pr.P, px % pr.P, f) * ld + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(hop::tf32_rna(c[n][2 * hf]), hop::tf32_rna(c[n][2 * hf + 1]));
    }
  }
}

// The forward attention of (pixel, head) pairs on mma.sync m16n8k8 TF32:
// o = softmax(q k^T / 8) v, written TF32-rounded into o (R, C) (the output
// projection's operand). `pairs` = B P H.
template <int FP>
__global__ void __launch_bounds__(AttnTiles<FP>::kWarps * 32)
temporal_pair_bwd_tf32_attn(const float* __restrict__ qkv, float* __restrict__ o, PixelRows pr,
                            int H, int pairs, float scale) {
  using T = AttnTiles<FP>;
  extern __shared__ float sm[];
  load_heads<FP>(sm, T::kFwd, qkv, 3 * (size_t)pr.C, 3, pr.C, pr, H, pairs);
  wm::cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = warp / T::kRowTiles, r0 = 16 * (warp % T::kRowTiles);
  const int pair = blockIdx.x * T::kPairs + j;
  if (pair >= pairs) return;
  const float* q = sm + j * T::kFwd;
  const float* k = q + T::kHead;
  const float* v = k + T::kHead;
  float s[FP / 8][4], acc[8][4] = {};
  softmax_tile<FP>(s, q + r0 * T::kLdt, k, pr.F, scale, lane);
  wm::mma_acc_kn<float, FP / 8, 8>(acc, s, v, T::kLdt, lane);  // P rounded to TF32 as the A operand
  store_head(o, pr.C, (pair % H) * kHd, acc, pr, pair / H, r0, lane);
}

// The VJP of (pixel, head) pairs' attention at their q/k/v on mma.sync
// m16n8k8 TF32: from q, k, v in qkv (R, 3C) and dO in dout (R, C), per warp
// (16 query rows) P, dP = dO V^T, dL = (dP * P - P rowsum(dP * P)) * scale
// (TF32-rounded) and dQ = dL K in registers; P^T and dL^T through shared
// memory, then per warp (16 key rows) dV = P^T dO and dK = dL^T Q; dq, dk,
// dv written TF32-rounded (dz's operand) over the pair's own q, k, v.
template <int FP>
__global__ void __launch_bounds__(AttnTiles<FP>::kWarps * 32)
temporal_pair_bwd_tf32_attn_vjp(float* __restrict__ qkv, const float* __restrict__ dout,
                                PixelRows pr, int H, int pairs, float scale) {
  using T = AttnTiles<FP>;
  extern __shared__ float sm[];
  const size_t ld = 3 * (size_t)pr.C;
  load_heads<FP>(sm, T::kVjp, qkv, ld, 3, pr.C, pr, H, pairs);
  load_heads<FP>(sm + 3 * T::kHead, T::kVjp, dout, pr.C, 1, 0, pr, H, pairs);
  wm::cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int j = warp / T::kRowTiles, r0 = 16 * (warp % T::kRowTiles);
  const int pair = blockIdx.x * T::kPairs + j;
  float* base = sm + j * T::kVjp;
  const float* q = base;
  const float* k = q + T::kHead;
  const float* v = k + T::kHead;
  const float* dO = v + T::kHead;
  float* Pt = base + 4 * T::kHead;  // P^T (FP x kLdp), then dL^T
  float* Lt = Pt + FP * T::kLdp;
  float p[FP / 8][4], d[FP / 8][4] = {}, acc[8][4] = {};
  softmax_tile<FP>(p, q + r0 * T::kLdt, k, pr.F, scale, lane);
  wm::mma_rows_nk<float, FP / 8>(d, dO + r0 * T::kLdt, v, T::kLdt, kHd, lane);  // dP
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < FP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) rs[e >> 1] += d[n][e] * p[n][e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
  }
#pragma unroll
  for (int n = 0; n < FP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      d[n][e] = hop::tf32_rna((d[n][e] * p[n][e] - p[n][e] * rs[e >> 1]) * scale);
      // Query rows past F add nothing to dK and dV.
      const int i = r0 + g + 8 * (e >> 1), key = 8 * n + 2 * t + (e & 1);
      Pt[key * T::kLdp + i] = i < pr.F ? p[n][e] : 0.f;
      Lt[key * T::kLdp + i] = i < pr.F ? d[n][e] : 0.f;
    }
  }
  wm::mma_acc_kn<float, FP / 8, 8>(acc, d, k, T::kLdt, lane);  // dQ
  __syncthreads();  // every P^T and dL^T column is in; q, k, v are read only from shared memory now
  if (pair >= pairs) return;
  const int px = pair / H, col = (pair % H) * kHd;
  store_head(qkv, ld, col, acc, pr, px, r0, lane);
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  mma_rows_kn<8>(acc, Lt + r0 * T::kLdp, T::kLdp, q, T::kLdt, FP, lane);  // dK
  store_head(qkv, ld, pr.C + col, acc, pr, px, r0, lane);
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // dV, P rounded to TF32 as its fragments load
  mma_rows_kn<8>(acc, Pt + r0 * T::kLdp, T::kLdp, dO, T::kLdt, FP, lane);
  store_head(qkv, ld, 2 * pr.C + col, acc, pr, px, r0, lane);
}

// Launches both attention passes at F <= FP (vjp false: the forward).
template <int FP>
cudaError_t attn_fp(bool vjp, float* qkv, float* o, const PixelRows& pr, int H, int pairs,
                    float scale, cudaStream_t s) {
  using T = AttnTiles<FP>;
  const int blocks = (pairs + T::kPairs - 1) / T::kPairs;
  const int smem = T::kPairs * (vjp ? T::kVjp : T::kFwd) * 4;
  cudaError_t err = vjp ? set_smem(temporal_pair_bwd_tf32_attn_vjp<FP>, smem)
                        : set_smem(temporal_pair_bwd_tf32_attn<FP>, smem);
  if (err != cudaSuccess) return err;
  if (vjp) {
    temporal_pair_bwd_tf32_attn_vjp<FP><<<blocks, T::kWarps * 32, smem, s>>>(qkv, o, pr, H,
                                                                            pairs, scale);
  } else {
    temporal_pair_bwd_tf32_attn<FP><<<blocks, T::kWarps * 32, smem, s>>>(qkv, o, pr, H, pairs,
                                                                         scale);
  }
  return cudaGetLastError();
}

// The attention pass at F frames (F <= 64): the forward o from qkv, or (vjp)
// dq, dk, dv over qkv from dO in o.
cudaError_t attn(bool vjp, float* qkv, float* o, const PixelRows& pr, int B, int H,
                 cudaStream_t s) {
  const int pairs = B * pr.P * H;
  const float scale = 1.0f / sqrtf((float)kHd);
  if (pr.F <= 16) return attn_fp<16>(vjp, qkv, o, pr, H, pairs, scale, s);
  if (pr.F <= 32) return attn_fp<32>(vjp, qkv, o, pr, H, pairs, scale, s);
  if (pr.F <= 48) return attn_fp<48>(vjp, qkv, o, pr, H, pairs, scale, s);
  return attn_fp<64>(vjp, qkv, o, pr, H, pairs, scale, s);
}

// dst = src TF32-rounded, (rows, cols) as it is or transposed to (cols,
// rows): the per-call staging of the weights in both orientations.
__global__ void __launch_bounds__(256)
temporal_pair_bwd_tf32_stage(const float* __restrict__ src, float* __restrict__ dst, int rows,
                             int cols, int transpose) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int j = ty; j < 32; j += 8) {
    const int r = r0 + j, c = c0 + tx;
    if (r < rows && c < cols) tile[j][tx] = hop::tf32_rna(src[(size_t)r * cols + c]);
  }
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    if (transpose) {
      const int r = c0 + j, c = r0 + tx;  // dst (cols, rows)
      if (r < cols && c < rows) dst[(size_t)r * rows + c] = tile[tx][j];
    } else {
      const int r = r0 + j, c = c0 + tx;
      if (r < rows && c < cols) dst[(size_t)r * cols + c] = tile[j][tx];
    }
  }
}

__global__ void temporal_pair_bwd_tf32_round(const float* src, float* dst, long long n) {
  hop::tf32_round_rows(src, dst, n);
}

template <int BN>
cudaError_t gemm_bn(const float* a, const float* bt, int M, int N, int K, GemmEpilogue ep,
                    cudaStream_t s) {
  using G = Tf32Gemm<BN>;
  CUtensorMap ta, tb;
  cudaError_t err = make_map_2d_f32(&ta, a, M, K, kGemmRows);
  if (err == cudaSuccess) err = make_map_2d_f32(&tb, bt, N, K, BN);
  if (err == cudaSuccess) err = set_smem(temporal_pair_bwd_tf32_gemm<BN>, G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kGemmRows - 1) / kGemmRows, N / BN);
  temporal_pair_bwd_tf32_gemm<BN><<<grid, G::kThreads, G::kSmem, s>>>(ta, tb, ep, M, N, K);
  return cudaGetLastError();
}

cudaError_t gemm(const float* a, const float* bt, int M, int N, int K, GemmEpilogue ep,
                 cudaStream_t s) {
  return N % 128 == 0 ? gemm_bn<128>(a, bt, M, N, K, ep, s) : gemm_bn<64>(a, bt, M, N, K, ep, s);
}

size_t align_floats(size_t n) { return (n + 63) / 64 * 64; }  // 256-byte aligned buffers

// The workspace's buffers in fp32 elements, in order: z, o, x1, u, dz, dx1
// (R x C each), qkv1, qkv2 (R x 3C), stats1, stats2 (R x 2), then the staged
// weights wqkv1, wqkv1^T, wqkv2, wqkv2^T (3C^2 each), wo1, wo1^T, wo2^T (C^2).
struct Workspace {
  float *z, *o, *x1, *u, *dz, *dx1, *qkv1, *qkv2, *st1, *st2;
  float *wq1, *wq1t, *wq2, *wq2t, *wo1, *wo1t, *wo2;
  size_t floats;
};

Workspace carve(float* base, long long R, int C) {
  Workspace w;
  size_t off = 0;
  auto take = [&](size_t n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += align_floats(n);
    return p;
  };
  const size_t rc = (size_t)R * C, cc = (size_t)C * C;
  w.z = take(rc);
  w.o = take(rc);
  w.x1 = take(rc);
  w.u = take(rc);
  w.dz = take(rc);
  w.dx1 = take(rc);
  w.qkv1 = take(3 * rc);
  w.qkv2 = take(3 * rc);
  w.st1 = take(2 * (size_t)R);
  w.st2 = take(2 * (size_t)R);
  w.wq1 = take(3 * cc);
  w.wq1t = take(3 * cc);
  w.wq2 = take(3 * cc);
  w.wq2t = take(3 * cc);
  w.wo1 = take(cc);
  w.wo1t = take(cc);
  w.wo2 = take(cc);
  w.floats = off;
  return w;
}

cudaError_t stage(const void* src, float* dst, int rows, int cols, int transpose,
                  cudaStream_t s) {
  const dim3 grid((cols + 31) / 32, (rows + 31) / 32);
  temporal_pair_bwd_tf32_stage<<<grid, 256, 0, s>>>(static_cast<const float*>(src), dst, rows,
                                                      cols, transpose);
  return cudaGetLastError();
}

}  // namespace

// Bytes of workspace the fp32 form takes for (B, F, P, C).
long long pair_bwd_tf32_workspace(int B, int F, int P, int C) {
  return (long long)carve(nullptr, (long long)B * F * P, C).floats * 4;
}

// The fp32 form: x, dy, dx (R = B F P rows of C, fp32, rows in the
// stream's order; element (b, f, p, c) at b sB + f sF + p sP + c); wts as
// lvd_temporal_pair_bwd takes them (ln1 scale, bias, wqkv1 (C, 3C), wo1
// (C, C), bo1, then attention 2's); ws pair_bwd_tf32_workspace bytes. C =
// 64 H <= 640, F <= 64.
cudaError_t pair_bwd_tf32(const void* x_, const void* dy_, void* dx_, const void* const* wts,
                          void* ws, int B, int F, int P, int C, long long sB, long long sF,
                          long long sP, float eps, cudaStream_t s) {
  const long long R = (long long)B * F * P;
  if (R > 0x7fffffffLL / 3) return cudaErrorInvalidValue;
  const int M = (int)R;
  const float* x = static_cast<const float*>(x_);
  const float* dy = static_cast<const float*>(dy_);
  float* dx = static_cast<float*>(dx_);
  auto f32 = [&](int i) { return static_cast<const float*>(wts[i]); };
  Workspace w = carve(static_cast<float*>(ws), R, C);
  const PixelRows pr{sB, sF, sP, F, P, C};
  const int H = C / kHd;
  const dim3 rows((M + 7) / 8);
  cudaError_t err = cudaSuccess;
  // Each pass runs only if every earlier one launched; the first error is returned.
  auto run = [&](auto pass) {
    if (err == cudaSuccess) err = pass();
  };
  auto launched = [] { return cudaGetLastError(); };
  // The weights, rounded, in the orientations the products read K-major.
  run([&] { return stage(wts[2], w.wq1, C, 3 * C, 0, s); });
  run([&] { return stage(wts[2], w.wq1t, C, 3 * C, 1, s); });
  run([&] { return stage(wts[3], w.wo1, C, C, 0, s); });
  run([&] { return stage(wts[3], w.wo1t, C, C, 1, s); });
  run([&] { return stage(wts[7], w.wq2, C, 3 * C, 0, s); });
  run([&] { return stage(wts[7], w.wq2t, C, 3 * C, 1, s); });
  run([&] { return stage(wts[8], w.wo2, C, C, 0, s); });
  // The forward: LN1 -> qkv1 -> attention 1 -> x1 = y + o Wo1 + bo1 -> LN2 -> qkv2.
  run([&] {
    temporal_pair_bwd_tf32_ln<<<rows, 256, 0, s>>>(x, f32(0), f32(1), w.z, w.st1, M, C, eps);
    return launched();
  });
  run([&] { return gemm(w.z, w.wq1t, M, 3 * C, C, {nullptr, nullptr, w.qkv1}, s); });
  run([&] { return attn(false, w.qkv1, w.o, pr, B, H, s); });
  run([&] { return gemm(w.o, w.wo1t, M, C, C, {f32(4), x, w.x1}, s); });
  run([&] {
    temporal_pair_bwd_tf32_ln<<<rows, 256, 0, s>>>(w.x1, f32(5), f32(6), w.z, w.st2, M, C, eps);
    return launched();
  });
  run([&] { return gemm(w.z, w.wq2t, M, 3 * C, C, {nullptr, nullptr, w.qkv2}, s); });
  // Attention 2's VJP with u = dy: dO2 = u Wo2^T, dq/dk/dv over qkv2, dz2.
  run([&] {
    temporal_pair_bwd_tf32_round<<<1056, 256, 0, s>>>(dy, w.u, R * C);
    return launched();
  });
  run([&] { return gemm(w.u, w.wo2, M, C, C, {nullptr, nullptr, w.o}, s); });
  run([&] { return attn(true, w.qkv2, w.o, pr, B, H, s); });
  run([&] { return gemm(w.qkv2, w.wq2, M, C, 3 * C, {nullptr, nullptr, w.dz}, s); });
  run([&] {
    temporal_pair_bwd_tf32_ln_vjp<<<rows, 256, 0, s>>>(w.dz, w.x1, w.st2, f32(5), dy, w.dx1,
                                                        w.u, M, C);
    return launched();
  });
  // Attention 1's VJP with u = dx1, then dx0 = dx1 + VJP_LN1(dz1).
  run([&] { return gemm(w.u, w.wo1, M, C, C, {nullptr, nullptr, w.o}, s); });
  run([&] { return attn(true, w.qkv1, w.o, pr, B, H, s); });
  run([&] { return gemm(w.qkv1, w.wq1, M, C, 3 * C, {nullptr, nullptr, w.dz}, s); });
  run([&] {
    temporal_pair_bwd_tf32_ln_vjp<<<rows, 256, 0, s>>>(w.dz, x, w.st1, f32(0), w.dx1, dx,
                                                        nullptr, M, C);
    return launched();
  });
  return err;
}

}  // namespace lvd
