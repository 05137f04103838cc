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
//  - the seven projections on the shared TMA + TF32 `wgmma` GEMM
//    (csrc/pair_tf32.cuh `gemm`, with kernel B's fp32 form): persistent
//    128 x BN output tiles, the weights staged once per call in both
//    orientations, rounded (`stage`); the epilogue adds the output bias and
//    the residual (x1 = y + o Wo1 + bo1) in fp32;
//  - LayerNorm (the shared `ln`) and its VJP plus the residual (`ln_vjp`),
//    one warp a row, statistics in fp32, the LN output written TF32-rounded
//    (it is only ever a product operand);
//  - the attention of (pixel, head) pairs (the shared forward `attn_forward`,
//    and `attn_vjp`) on mma.sync m16n8k8 TF32 (csrc/warp_mma.cuh): a warp
//    takes 16 frames (queries, then in the VJP keys) of one pair, F rounded
//    up to FP = 16..64 with the keys past F masked; a block holds 4 / (FP /
//    16) pairs (two at F = 24: 88 KB for the VJP, FP x 68 fp32 a head tile).
//    S, the fp32 softmax, P V or dP = dO V^T, dL and dQ = dL K stay in
//    registers; P^T and dL^T go through shared memory for dV = P^T dO and
//    dK = dL^T Q. The VJP writes dq, dk, dv over the pair's own q, k, v.
// The intermediates cross device memory: 12 C + 4 fp32 a row of workspace
// (1.06 GB at (1, 24, 2880, 320)) plus the staged weights, 15 C^2.
// Rows keep the stream's order (frames-major or pixels-major): the
// projections and the row passes do not care, and the attention passes
// find a pixel's F rows through the strides.
#define LVD_PAIR_TF32 temporal_pair_bwd_tf32
#include "pair_tf32.cuh"

namespace lvd {
namespace temporal_pair_bwd_tf32 {

// out = resid + VJP_LN(dz): g = dz * scale, xhat from x and its stats,
// rstd * (g - mean(g) - xhat * mean(g * xhat)), in fp32; out_round, where
// given, gets the same rows TF32-rounded (the next product's operand).
__global__ void __launch_bounds__(256)
ln_vjp_kernel(const float* __restrict__ dz, const float* __restrict__ x,
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

// The VJP of (pixel, head) pairs' attention at their q/k/v on mma.sync
// m16n8k8 TF32: from q, k, v in qkv (R, 3C) and dO in dout (R, C), per warp
// (16 query rows) P, dP = dO V^T, dL = (dP * P - P rowsum(dP * P)) * scale
// (TF32-rounded) and dQ = dL K in registers; P^T and dL^T through shared
// memory, then per warp (16 key rows) dV = P^T dO and dK = dL^T Q; dq, dk,
// dv written TF32-rounded (dz's operand) over the pair's own q, k, v.
template <int FP>
__global__ void __launch_bounds__(AttnTiles<FP>::kWarps * 32)
attn_vjp_kernel(float* __restrict__ qkv, const float* __restrict__ dout, PixelRows pr, int H,
                int pairs, float scale) {
  using T = AttnTiles<FP>;
  extern __shared__ float sm[];
  __shared__ long long rows[T::kPairs * FP];
  __shared__ int cols[T::kPairs];
  const size_t ld = 3 * (size_t)pr.C;
  pair_rows<FP>(rows, cols, pr, H, pairs);
  load_heads<FP, 3>(sm, T::kVjp, qkv, ld, pr.C, rows, cols);
  load_heads<FP, 1>(sm + 3 * T::kHead, T::kVjp, dout, pr.C, 0, rows, cols);
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
  const int col = cols[j];
  const long long* prow = rows + j * FP;
  store_head(qkv, ld, col, acc, prow, r0, lane);
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  mma_rows_kn<8>(acc, Lt + r0 * T::kLdp, T::kLdp, q, T::kLdt, FP, lane);  // dK
  store_head(qkv, ld, pr.C + col, acc, prow, r0, lane);
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // dV, P rounded to TF32 as its fragments load
  mma_rows_kn<8>(acc, Pt + r0 * T::kLdp, T::kLdp, dO, T::kLdt, FP, lane);
  store_head(qkv, ld, 2 * pr.C + col, acc, prow, r0, lane);
}

// The VJP attention pass at F frames (F <= 64): dq, dk, dv over qkv from dO in
// dout.
cudaError_t attn_vjp(float* qkv, const float* dout, const PixelRows& pr, int B, int H,
                     cudaStream_t s) {
  const int pairs = B * pr.P * H;
  const float scale = 1.0f / sqrtf((float)kHd);
  return by_frames(pr.F, [&](auto fp) {
    constexpr int FP = decltype(fp)::value;
    using T = AttnTiles<FP>;
    const int smem = T::kPairs * T::kVjp * 4;
    const cudaError_t err = set_smem(attn_vjp_kernel<FP>, smem);
    if (err != cudaSuccess) return err;
    attn_vjp_kernel<FP><<<(pairs + T::kPairs - 1) / T::kPairs, T::kWarps * 32, smem, s>>>(
        qkv, dout, pr, H, pairs, scale);
    return cudaGetLastError();
  });
}

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

}  // namespace temporal_pair_bwd_tf32

// Bytes of workspace the fp32 form takes for (B, F, P, C).
long long pair_bwd_tf32_workspace(int B, int F, int P, int C) {
  return (long long)temporal_pair_bwd_tf32::carve(nullptr, (long long)B * F * P, C).floats * 4;
}

// The fp32 form: x, dy, dx (R = B F P rows of C, fp32, rows in the
// stream's order; element (b, f, p, c) at b sB + f sF + p sP + c); wts as
// lvd_temporal_pair_bwd takes them (ln1 scale, bias, wqkv1 (C, 3C), wo1
// (C, C), bo1, then attention 2's); ws pair_bwd_tf32_workspace bytes. C =
// 64 H <= 640, F <= 64.
cudaError_t pair_bwd_tf32(const void* x_, const void* dy_, void* dx_, const void* const* wts,
                          void* ws, int B, int F, int P, int C, long long sB, long long sF,
                          long long sP, float eps, cudaStream_t s) {
  using namespace temporal_pair_bwd_tf32;
  const long long R = (long long)B * F * P;
  if (R > 0x7fffffffLL / 3) return cudaErrorInvalidValue;
  const int M = (int)R;
  const float* x = static_cast<const float*>(x_);
  const float* dy = static_cast<const float*>(dy_);
  float* dx = static_cast<float*>(dx_);
  auto f32 = [&](int i) { return static_cast<const float*>(wts[i]); };
  Workspace w = carve(static_cast<float*>(ws), R, C);
  const PixelRows pr = PixelRows::of(sB, sF, sP, F, P, C);
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
  run([&] { return ln(x, f32(0), f32(1), w.z, w.st1, M, C, eps, s); });
  run([&] { return gemm(w.z, w.wq1t, M, 3 * C, C, {nullptr, nullptr, w.qkv1}, s); });
  run([&] { return attn_forward(w.qkv1, w.o, pr, B, H, s); });
  run([&] { return gemm(w.o, w.wo1t, M, C, C, {f32(4), x, w.x1}, s); });
  run([&] { return ln(w.x1, f32(5), f32(6), w.z, w.st2, M, C, eps, s); });
  run([&] { return gemm(w.z, w.wq2t, M, 3 * C, C, {nullptr, nullptr, w.qkv2}, s); });
  // Attention 2's VJP with u = dy: dO2 = u Wo2^T, dq/dk/dv over qkv2, dz2.
  run([&] {
    round_kernel<<<1056, 256, 0, s>>>(dy, w.u, R * C);
    return launched();
  });
  run([&] { return gemm(w.u, w.wo2, M, C, C, {nullptr, nullptr, w.o}, s); });
  run([&] { return attn_vjp(w.qkv2, w.o, pr, B, H, s); });
  run([&] { return gemm(w.qkv2, w.wq2, M, C, 3 * C, {nullptr, nullptr, w.dz}, s); });
  run([&] {
    ln_vjp_kernel<<<rows, 256, 0, s>>>(w.dz, w.x1, w.st2, f32(5), dy, w.dx1, w.u, M, C);
    return launched();
  });
  // Attention 1's VJP with u = dx1, then dx0 = dx1 + VJP_LN1(dz1).
  run([&] { return gemm(w.u, w.wo1, M, C, C, {nullptr, nullptr, w.o}, s); });
  run([&] { return attn_vjp(w.qkv1, w.o, pr, B, H, s); });
  run([&] { return gemm(w.qkv1, w.wq1, M, C, 3 * C, {nullptr, nullptr, w.dz}, s); });
  run([&] {
    ln_vjp_kernel<<<rows, 256, 0, s>>>(w.dz, x, w.st1, f32(0), w.dx1, dx, nullptr, M, C);
    return launched();
  });
  return err;
}

}  // namespace lvd
