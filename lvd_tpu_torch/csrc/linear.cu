// Kernel H: the resident-weights linear y = x W (+ b) on (R, K) rows, and
// its transposed form dx = dy W^T for the backward, bf16 or fp32.
//
// Replaces lvd_tpu/ops/linear_fused.py `_fused_rows` (`_linear_kernel`,
// `_linear_kernel_nobias`), which lvd_tpu routes under LVD_FUSED_LINEAR=1 to
// the q/k/v and output projections of the fused attention path; its custom
// VJP takes dx through the same kernel on W^T.
//
// Bound on this card: at the projection shapes (K = N = 640 or 1280, R up
// to 34560 rows) 2*R*K*N operations against (R*K + K*N + R*N) elements, so
// the product is tensor-core bound. Design: a plain tiled GEMM
// (tile_gemm.cuh) - one block per (64-row, 64-column) output tile, K in
// 32-wide chunks staged in shared memory (29 KB bf16, 37 KB fp32), WMMA
// with fp32 accumulation (TF32 for fp32), the bias added in fp32 before the
// one rounding to the output type, as `_linear_kernel` does. Ragged rows
// (48 x 77 text tokens) are masked. With `trans_w` the weight (N, K) is read
// as its transpose: the chunk loader gathers W[n, k0:k0+32] rows and writes
// them transposed into the (32, 64) B chunk, so no transposed copy of W is
// ever made. No double buffering yet: the loads and the products of a chunk
// do not overlap.
#include "tile_gemm.cuh"

namespace lvd {
namespace {

template <typename T, bool kTransW>
__global__ void __launch_bounds__(TileGemm<T>::kThreads)
linear_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
              T* __restrict__ y, int R, int K, int N) {
  using G = TileGemm<T>;
  constexpr int V = kVecN<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = G::a_chunk(smem);
  T* Bs = G::b_chunk(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * G::BM;
  const int n0 = blockIdx.y * G::BN;

  typename G::Acc acc[G::BN / 16];
  G::zero(acc);
  for (int k0 = 0; k0 < K; k0 += G::BK) {
    __syncthreads();  // every warp is done with the previous chunk
    for (int e = tid; e < G::BM * (G::BK / V); e += G::kThreads) {
      const int r = e / (G::BK / V), cv = e % (G::BK / V);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < R) val = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * K + k0 + cv * V);
      *reinterpret_cast<uint4*>(As + r * G::kLdA + cv * V) = val;
    }
    if constexpr (kTransW) {
      // B[k][n] = W[n0 + n][k0 + k], W (N, K) row-major.
      for (int e = tid; e < G::BN * (G::BK / V); e += G::kThreads) {
        const int n = e / (G::BK / V), cv = e % (G::BK / V);
        Vec<T> val;
        val.u = *reinterpret_cast<const uint4*>(w + (size_t)(n0 + n) * K + k0 + cv * V);
#pragma unroll
        for (int i = 0; i < V; ++i) Bs[(cv * V + i) * G::kLdB + n] = val.h[i];
      }
    } else {
      // B[k][n] = W[k0 + k][n0 + n], W (K, N) row-major.
      for (int e = tid; e < G::BK * (G::BN / V); e += G::kThreads) {
        const int k = e / (G::BN / V), cv = e % (G::BN / V);
        *reinterpret_cast<uint4*>(Bs + k * G::kLdB + cv * V) =
            *reinterpret_cast<const uint4*>(w + (size_t)(k0 + k) * N + n0 + cv * V);
      }
    }
    __syncthreads();
    G::mma_chunk(acc, As, Bs, warp);
  }

  G::store_tile(acc, G::stage(smem, warp), warp, lane, [&](int r, int c, float v) {
    if (r0 + r >= R) return;
    const float b = bias == nullptr ? 0.f : to_f(bias[n0 + c]);
    y[(size_t)(r0 + r) * N + n0 + c] = from_f<T>(v + b);
  });
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y, int R, int K, int N,
                   int trans_w, cudaStream_t stream) {
  using G = TileGemm<T>;
  const dim3 grid((R + G::BM - 1) / G::BM, N / G::BN);
  auto xs = static_cast<const T*>(x);
  auto ws = static_cast<const T*>(w);
  auto bs = static_cast<const T*>(bias);
  auto ys = static_cast<T*>(y);
  cudaError_t err;
  if (trans_w) {
    if ((err = set_smem(linear_kernel<T, true>, G::kSmem)) != cudaSuccess) return err;
    linear_kernel<T, true><<<grid, G::kThreads, G::kSmem, stream>>>(xs, ws, bs, ys, R, K, N);
  } else {
    if ((err = set_smem(linear_kernel<T, false>, G::kSmem)) != cudaSuccess) return err;
    linear_kernel<T, false><<<grid, G::kThreads, G::kSmem, stream>>>(xs, ws, bs, ys, R, K, N);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace lvd

// x: (R, K); w: (K, N), or (N, K) read transposed with trans_w; bias: (N,)
// or null; y: (R, N); all of one type (dtype 0 bf16, 1 fp32). K % 32 == 0,
// N % 64 == 0.
LVD_EXPORT int lvd_linear(const void* x, const void* w, const void* bias, void* y, int R, int K,
                          int N, int trans_w, int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (R <= 0 || K <= 0 || N <= 0 || K % 32 != 0 || N % 64 != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    return launch<decltype(tag)>(x, w, bias, y, R, K, N, trans_w, s);
  });
}
