// Kernel H: the resident-weights linear y = x W (+ b) on (R, K) rows, and
// its transposed form dx = dy W^T for the backward, bf16 or fp32.
//
// Replaces lvd_tpu/ops/linear_fused.py `_fused_rows` (`_linear_kernel`,
// `_linear_kernel_nobias`), which lvd_tpu routes under LVD_FUSED_LINEAR=1 to
// the q/k/v and output projections of the fused attention path; its custom
// VJP takes dx through the same kernel on W^T.
//
// Bound on this card: at the projection shapes (K = N = 640 or 1280, R up
// to 34560 rows, and the 48 x 77 text rows) 2*R*K*N operations against
// (R*K + K*N + R*N) elements, so the product is tensor-core bound. lvd_tpu's
// predicate gives K % 128 == 0 and N % 128 == 0; R is ragged.
//
// bf16: a warp-specialised wgmma GEMM, one block per (128-row, 128-column)
// output tile (not persistent), the tile loop `WgTile` of hopper.cuh
// (shared with kernel J) with a ring of four stages. One producer warp keeps
// the ring in flight with TMA: a (128 rows, 64-deep K) tile of x and the
// matching (64-deep K, 128 columns) tile of W, 32 KB a stage, 128-byte
// swizzled, on 2-D tensor maps; rows past R read as zero. Two consumer
// warpgroups each own 64 rows x 128 columns (m64n128k16, accumulators in
// registers, one group of products kept in flight while the next stage is
// waited for). The two forms differ only in W's operand: the forward reads
// W (K, N) N-contiguous as an MN-major B (two 64-column TMA boxes), the
// dx form reads W (N, K) K-contiguous as a K-major B (one box of 128
// rows); no transposed copy of W is made. The epilogue adds the bias in
// fp32 before the one rounding to bf16, as `_linear_kernel` does, and
// writes 16-byte stores through the warpgroup's own rows of the first two
// A stages (free once its last product completed); rows past R are not
// stored.
//
// fp32 (TF32): wgmma takes TF32 operands only K-major, so the forward's W
// would need a transpose in shared memory. Instead: mma.sync m16n8k8 with
// register accumulators, eight warps a (128, 128) tile (each 32 x 64), K
// in 32-deep chunks through a three-stage cp.async ring (rows padded by 16
// bytes, or 32 for the (K, N) tile, so the fragment reads are free of bank
// conflicts), the same fp32 bias epilogue.
#include "common.cuh"
#include "hopper.cuh"
#include "warp_mma.cuh"

namespace lvd {
namespace {

// ---- bf16: TMA ring + wgmma ----

using WgLin = WgTile<4, false>;  // both forms' layout (kTransW changes only W's boxes)

template <bool kTransW>
__global__ void __launch_bounds__(WgLin::kThreads, 1)
linear_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w, const bf16* __restrict__ bias,
                    bf16* __restrict__ y, int R, int K, int N) {
  using C = WgLin;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int n0 = blockIdx.x * C::BN, r0 = blockIdx.y * C::BM;
  float acc[64];
  if (!WgTile<4, kTransW>::run(smem, &tm_x, &tm_w, r0, n0, K / C::BK, acc)) return;

  // Stage through this warpgroup's rows of the A tiles of stages 0 and 1.
  const int wg = threadIdx.x / 128;
  bf16* stage = reinterpret_cast<bf16*>(smem) + wg * 64 * 64;
  hop::store_acc_bf16<2>(acc, stage, C::kStageBytes / 2, bias == nullptr ? nullptr : bias + n0,
                         y + (size_t)(r0 + wg * 64) * N + n0, N, R - r0 - wg * 64);
}

cudaError_t launch_wgmma(const void* x, const void* w, const void* bias, void* y, int R, int K,
                         int N, int trans_w, cudaStream_t stream) {
  using C = WgLin;
  CUtensorMap tx, tw;
  cudaError_t err = make_map_2d(&tx, x, R, K, C::BM);
  if (err == cudaSuccess)
    err = trans_w ? make_map_2d(&tw, w, N, K, C::BN) : make_map_2d(&tw, w, K, N, C::BK);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / C::BN, (R + C::BM - 1) / C::BM);
  auto bs = static_cast<const bf16*>(bias);
  auto ys = static_cast<bf16*>(y);
  if (trans_w) {
    if ((err = set_smem(linear_wgmma_kernel<true>, C::kSmem)) != cudaSuccess) return err;
    linear_wgmma_kernel<true><<<grid, C::kThreads, C::kSmem, stream>>>(tx, tw, bs, ys, R, K, N);
  } else {
    if ((err = set_smem(linear_wgmma_kernel<false>, C::kSmem)) != cudaSuccess) return err;
    linear_wgmma_kernel<false><<<grid, C::kThreads, C::kSmem, stream>>>(tx, tw, bs, ys, R, K, N);
  }
  return cudaGetLastError();
}

// ---- fp32: mma.sync TF32 + cp.async ring ----

struct F32Lin {
  static constexpr int BM = 128, BN = 128, BK = 32, kStages = 3, kWarps = 8;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kLdA = BK + 4;   // x tile (128, 32) and the (N, K) W tile (128, 32)
  static constexpr int kLdB = BN + 8;   // the (K, N) W tile (32, 128)
  static constexpr int kATile = BM * kLdA;  // floats
  static constexpr int kBTile = BN * kLdA > BK * kLdB ? BN * kLdA : BK * kLdB;
  static constexpr int kStage = kATile + kBTile;
  static constexpr int kSmem = kStages * kStage * 4;  // 108 KB
};

template <bool kTransW>
__device__ __forceinline__ void lin_load_f32(float* As, float* Bs, const float* x, const float* w,
                                             int r0, int n0, int k0, int R, int K, int N) {
  using C = F32Lin;
  for (int e = threadIdx.x; e < C::BM * (C::BK / 4); e += C::kThreads) {
    const int r = e / (C::BK / 4), cv = e % (C::BK / 4);
    const bool ok = r0 + r < R;
    wm::cp_async16(As + r * C::kLdA + cv * 4, x + (ok ? (size_t)(r0 + r) * K + k0 + cv * 4 : 0),
                   ok);
  }
  if constexpr (kTransW) {  // Bs[n][k] = W[n0 + n][k0 + k], W (N, K)
    for (int e = threadIdx.x; e < C::BN * (C::BK / 4); e += C::kThreads) {
      const int n = e / (C::BK / 4), cv = e % (C::BK / 4);
      wm::cp_async16(Bs + n * C::kLdA + cv * 4, w + (size_t)(n0 + n) * K + k0 + cv * 4, true);
    }
  } else {  // Bs[k][n] = W[k0 + k][n0 + n], W (K, N)
    for (int e = threadIdx.x; e < C::BK * (C::BN / 4); e += C::kThreads) {
      const int k = e / (C::BN / 4), cv = e % (C::BN / 4);
      wm::cp_async16(Bs + k * C::kLdB + cv * 4, w + (size_t)(k0 + k) * N + n0 + cv * 4, true);
    }
  }
}

template <bool kTransW>
__global__ void __launch_bounds__(F32Lin::kThreads)
linear_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ y, int R, int K, int N) {
  using C = F32Lin;
  using W = wm::WarpMma<float>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int n0 = blockIdx.x * C::BN, r0 = blockIdx.y * C::BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm_ = warp % 4, wn = warp / 4;  // rows 32 wm_, columns 64 wn
  const int nk = K / C::BK;

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < nk)
      lin_load_f32<kTransW>(ring + s * C::kStage, ring + s * C::kStage + C::kATile, x, w, r0, n0,
                            s * C::BK, R, K, N);
    wm::cp_async_commit();
  }
  float acc[2][8][4] = {};
  for (int j = 0; j < nk; ++j) {
    wm::cp_async_wait<C::kStages - 2>();
    __syncthreads();  // stage j landed for all; stage j - 1 is free
    const int nxt = j + C::kStages - 1;
    if (nxt < nk) {
      float* st = ring + (nxt % C::kStages) * C::kStage;
      lin_load_f32<kTransW>(st, st + C::kATile, x, w, r0, n0, nxt * C::BK, R, K, N);
    }
    wm::cp_async_commit();
    const float* As = ring + (j % C::kStages) * C::kStage;
    const float* Bs = As + C::kATile;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 8) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) W::load_a(a[mt], As + (32 * wm_ + 16 * mt) * C::kLdA + kk, C::kLdA, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b0[2], b1[2];
        if constexpr (kTransW) {
          W::load_b_nk(b0, b1, Bs + (64 * wn + 16 * np) * C::kLdA + kk, C::kLdA, lane);
        } else {
          W::load_b_rows(b0, b1, Bs + kk * C::kLdB + 64 * wn + 16 * np, C::kLdB, lane);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          W::mma(acc[mt][2 * np], a[mt], b0);
          W::mma(acc[mt][2 * np + 1], a[mt], b1);
        }
      }
    }
  }
  wm::cp_async_wait<0>();

  const int g = lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row = r0 + 32 * wm_ + 16 * mt + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n0 + 64 * wn + 8 * nt + cq;
      const float b0 = bias == nullptr ? 0.f : bias[col];
      const float b1 = bias == nullptr ? 0.f : bias[col + 1];
      if (row < R) W::store2(y + (size_t)row * N + col, acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      if (row + 8 < R)
        W::store2(y + (size_t)(row + 8) * N + col, acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
  }
}

cudaError_t launch_f32(const void* x, const void* w, const void* bias, void* y, int R, int K,
                       int N, int trans_w, cudaStream_t stream) {
  using C = F32Lin;
  const dim3 grid(N / C::BN, (R + C::BM - 1) / C::BM);
  auto xs = static_cast<const float*>(x);
  auto ws = static_cast<const float*>(w);
  auto bs = static_cast<const float*>(bias);
  auto ys = static_cast<float*>(y);
  cudaError_t err;
  if (trans_w) {
    if ((err = set_smem(linear_f32_kernel<true>, C::kSmem)) != cudaSuccess) return err;
    linear_f32_kernel<true><<<grid, C::kThreads, C::kSmem, stream>>>(xs, ws, bs, ys, R, K, N);
  } else {
    if ((err = set_smem(linear_f32_kernel<false>, C::kSmem)) != cudaSuccess) return err;
    linear_f32_kernel<false><<<grid, C::kThreads, C::kSmem, stream>>>(xs, ws, bs, ys, R, K, N);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace lvd

// x: (R, K); w: (K, N), or (N, K) read transposed with trans_w; bias: (N,)
// or null; y: (R, N); all of one type (dtype 0 bf16: the wgmma form, K % 64
// == 0; 1 fp32: the mma.sync form, K % 32 == 0); N % 128 == 0.
LVD_EXPORT int lvd_linear(const void* x, const void* w, const void* bias, void* y, int R, int K,
                          int N, int trans_w, int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (R <= 0 || K <= 0 || N <= 0 || N % 128 != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (K % WgLin::BK != 0) return cudaErrorInvalidValue;
    return launch_wgmma(x, w, bias, y, R, K, N, trans_w, s);
  }
  if (dtype == kF32) {
    if (K % F32Lin::BK != 0) return cudaErrorInvalidValue;
    return launch_f32(x, w, bias, y, R, K, N, trans_w, s);
  }
  return cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one block of kernel H takes (dtype 0 bf16,
// 1 fp32).
LVD_EXPORT long long lvd_linear_smem(int dtype) {
  using namespace lvd;
  return dtype == kBF16 ? WgLin::kSmem : F32Lin::kSmem;
}
