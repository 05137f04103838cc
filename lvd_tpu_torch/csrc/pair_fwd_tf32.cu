// Kernel B's fp32 form on Hopper: the fused temporal double self-attention
// y -> x1 = y + A1(LN1(y)) -> x2 = x1 + A2(LN2(x1)) over the F frames of
// each pixel, in fp32 with TF32 products.
//
// Replaces lvd_tpu/ops/temporal_attention.py `_pallas_pair` (`_tattn_kernel`)
// for fp32 streams, beside the bf16 `wgmma` form and the first version in
// csrc/temporal_attention.cu, whose entry point (form 1, fp32) launches it.
//
// Bound on this card: the (C, 3C) and (C, C) projections, 8 C^2
// multiply-adds a row, carry nearly all of the operations, so the pair is
// tensor-core bound at TF32's rate. The first version holds one pixel's
// 24 rows a block at F = 24 (32 rows of which 24 are frames) and reads all
// four weight matrices from L2 for them: 4.7 GB a call at (1, 24, 2880,
// 320), 37x its bound. fp32 tiles are twice bf16's, so the bf16 form's one
// fused kernel (224 KB) cannot hold them; this form is a chain of passes
// per attention, each sized for the card, on the kernels it shares with
// kernel F's fp32 form (csrc/pair_tf32.cuh):
//  - LN (`ln`): z = LN(x), TF32-rounded;
//  - [q | k | v] = z Wqkv (`gemm`, 128-row tiles: the weights are read once
//    per 128 rows, not once per pixel);
//  - the F x F attention per (pixel, head) on mma.sync TF32
//    (`attn_forward`), o TF32-rounded over z's buffer;
//  - o Wo + bo + residual in the GEMM's epilogue: attention 1 writes x1 into
//    the output tensor, attention 2 reads its residual there and overwrites
//    it (each thread reads an element before it writes it).
// The weights are staged per call transposed and TF32-rounded (`stage`):
// TF32 `wgmma` reads both operands K-major. Workspace: z-or-o (R x C) and
// qkv (R x 3C) fp32 plus the staged weights (8 C^2), 354 MB at (1, 24, 2880,
// 320). Rounding points are those of the first version: every product
// operand TF32 (round to nearest, ties away), LayerNorm statistics,
// softmax (exact max), bias and residuals fp32. Rows keep the stream's order
// (frames-major or pixels-major): the row passes and the projections do not
// care, and the attention pass finds a pixel's F rows through the strides.
#define LVD_PAIR_TF32 temporal_pair_fwd_tf32
#include "pair_tf32.cuh"

namespace lvd {
namespace temporal_pair_fwd_tf32 {

// The workspace's buffers in fp32 elements, in order: z (also o), R x C;
// qkv, R x 3C; the staged weights wqkv1^T, wqkv2^T (3C^2 each), wo1^T,
// wo2^T (C^2 each).
struct Workspace {
  float *z, *qkv, *wq1t, *wq2t, *wo1t, *wo2t;
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
  w.qkv = take(3 * rc);
  w.wq1t = take(3 * cc);
  w.wq2t = take(3 * cc);
  w.wo1t = take(cc);
  w.wo2t = take(cc);
  w.floats = off;
  return w;
}

}  // namespace temporal_pair_fwd_tf32

// Bytes of workspace the fp32 form takes for (B, F, P, C).
long long pair_fwd_tf32_workspace(int B, int F, int P, int C) {
  return (long long)temporal_pair_fwd_tf32::carve(nullptr, (long long)B * F * P, C).floats * 4;
}

// The fp32 form: x, out (R = B F P rows of C, fp32, rows in the stream's
// order; element (b, f, p, c) at b sB + f sF + p sP + c); wts as
// lvd_temporal_pair takes them (ln1 scale, bias, wqkv1 (C, 3C), wo1 (C, C),
// bo1, then attention 2's); ws pair_fwd_tf32_workspace bytes. C = 64 H <=
// 640, F <= 64.
cudaError_t pair_fwd_tf32(const void* x_, void* out_, const void* const* wts, void* ws, int B,
                          int F, int P, int C, long long sB, long long sF, long long sP,
                          float eps, cudaStream_t s) {
  using namespace temporal_pair_fwd_tf32;
  const long long R = (long long)B * F * P;
  if (R > 0x7fffffffLL / 3) return cudaErrorInvalidValue;
  const int M = (int)R;
  const float* x = static_cast<const float*>(x_);
  float* out = static_cast<float*>(out_);
  auto f32 = [&](int i) { return static_cast<const float*>(wts[i]); };
  Workspace w = carve(static_cast<float*>(ws), R, C);
  const PixelRows pr = PixelRows::of(sB, sF, sP, F, P, C);
  const int H = C / kHd;
  cudaError_t err = cudaSuccess;
  // Each pass runs only if every earlier one launched; the first error is returned.
  auto run = [&](auto pass) {
    if (err == cudaSuccess) err = pass();
  };
  // The weights, rounded and transposed: the products read them K-major.
  run([&] { return stage(wts[2], w.wq1t, C, 3 * C, 1, s); });
  run([&] { return stage(wts[3], w.wo1t, C, C, 1, s); });
  run([&] { return stage(wts[7], w.wq2t, C, 3 * C, 1, s); });
  run([&] { return stage(wts[8], w.wo2t, C, C, 1, s); });
  // Attention 1: x1 = y + attn1(LN1(y)), into the output.
  run([&] { return ln(x, f32(0), f32(1), w.z, nullptr, M, C, eps, s); });
  run([&] { return gemm(w.z, w.wq1t, M, 3 * C, C, {nullptr, nullptr, w.qkv}, s); });
  run([&] { return attn_forward(w.qkv, w.z, pr, B, H, s); });
  run([&] { return gemm(w.z, w.wo1t, M, C, C, {f32(4), x, out}, s); });
  // Attention 2: x2 = x1 + attn2(LN2(x1)), over x1 in the output.
  run([&] { return ln(out, f32(5), f32(6), w.z, nullptr, M, C, eps, s); });
  run([&] { return gemm(w.z, w.wq2t, M, 3 * C, C, {nullptr, nullptr, w.qkv}, s); });
  run([&] { return attn_forward(w.qkv, w.z, pr, B, H, s); });
  run([&] { return gemm(w.z, w.wo2t, M, C, C, {f32(9), out, out}, s); });
  return err;
}

}  // namespace lvd
