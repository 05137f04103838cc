// The TF32 wgmma GEMM that kernels B's and F's fp32 forms share
// (lvd_tpu_torch/csrc/pair_tf32.cuh), at a tile width the caller names:
// built and called by probes/tf32_gemm_widths.py.
#define LVD_PAIR_TF32 probe_tf32
#include "pair_tf32.cuh"

// out (M, N) = a (M, K) bt^T (+ bias) (+ res) in 128 x bn tiles (bn 64,
// 128, 160 or 192, dividing N) through a ring of `stages` stages; the
// operands TF32-rounded already.
extern "C" __attribute__((visibility("default"))) int probe_tf32_gemm(
    int bn, int stages, const float* a, const float* bt, const float* bias, const float* res,
    float* out, int M, int N, int K, void* stream) {
  using namespace lvd::probe_tf32;
  const GemmEpilogue ep{bias, res, out};
  auto s = static_cast<cudaStream_t>(stream);
#define LVD_CASE(w, ns) \
  if (bn == w && stages == ns) return gemm_bn<w, ns>(a, bt, M, N, K, ep, s);
  LVD_CASE(64, 4) LVD_CASE(64, 6) LVD_CASE(128, 3) LVD_CASE(128, 4) LVD_CASE(160, 2)
  LVD_CASE(160, 4) LVD_CASE(192, 2) LVD_CASE(192, 4)
#undef LVD_CASE
  return cudaErrorInvalidValue;
}
