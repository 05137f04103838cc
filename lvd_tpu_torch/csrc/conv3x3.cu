// Kernel I: the 3x3 SAME convolution on channels-last frames, as an
// implicit GEMM, with an optional GroupNorm-apply + SiLU prologue:
//   row 12: y = conv3x3(z) + bias,  z = silu(x * a + b)   (a, b per frame)
//   row 13: y = conv3x3(x)                                (no bias)
// on (N, H, W, Cin) input and a (9, Cin, Cout) weight, bf16 or fp32.
//
// Replaces lvd_tpu/ops/spatial_conv_fused.py `_fused` (`_kernel`; lvd_tpu
// routes it to every resnet conv it fits under LVD_ENABLE_FUSED_SC=1) and
// lvd_tpu/ops/conv3x3.py `_conv3x3_pallas` (`_conv_kernel`, its public
// conv3x3()). The two TPU kernels differ in how they cut the plane to fit
// VMEM (whole plane with row-shifted dots, or halo row windows of a padded
// copy); here one kernel serves both, with the prologue a template switch.
//
// Bound on this card: 18*Cin*Cout operations per output pixel against
// (Cin + Cout) elements of traffic, so at the UNet's widths (Cin >= 320) the
// conv is tensor-core bound; unfused, z makes a round trip through device
// memory between the norm and the conv. Design: the tiled GEMM of
// tile_gemm.cuh over M = the frame's H*W pixels (flattened, ragged: 45 and
// 180 are not multiples of 64), N = Cout, K = 9 taps x Cin in 32-wide
// chunks. One block owns 64 pixels of one frame x 64 output channels. For
// each (tap, chunk) it gathers the input pixel (y + dy, x + dx) of each of
// its 64 pixels, applies the prologue in fp32 and rounds z to the tensor's
// type as lvd_tpu's z scratch holds it, and stores the (64, 32) A chunk;
// the (32, 64) B chunk is the tap's weight rows. SAME padding zeroes z, not
// x: a tap that falls outside the image (an H edge, or a W edge that would
// wrap to the neighbouring row in the flattened plane) contributes 0, and
// the prologue is never applied to padding (silu(b) != 0). The prologue is
// recomputed for each of the 9 taps and the input is re-read from L2 per
// tap and per 64-channel output slice: simple, not yet fast. Shared memory:
// 29 KB bf16, 37 KB fp32. Cin and Cout need only be multiples of 8 (the
// chunks mask their channel tails), as lvd_tpu's predicate allows.
#include "tile_gemm.cuh"

namespace lvd {
namespace {

template <typename T, bool kPrologue>
__global__ void __launch_bounds__(TileGemm<T>::kThreads)
conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ b, const T* __restrict__ w,
               const T* __restrict__ bias, T* __restrict__ y, int H, int W, int Cin, int Cout) {
  using G = TileGemm<T>;
  constexpr int V = kVecN<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = G::a_chunk(smem);
  T* Bs = G::b_chunk(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int HW = H * W;
  const int r0 = blockIdx.x * G::BM;
  const int n0 = blockIdx.y * G::BN;
  const int frame = blockIdx.z;
  const T* xf = x + (size_t)frame * HW * Cin;
  const float* af = kPrologue ? a + (size_t)frame * Cin : nullptr;
  const float* bf = kPrologue ? b + (size_t)frame * Cin : nullptr;

  typename G::Acc acc[G::BN / 16];
  G::zero(acc);
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const T* wt = w + (size_t)tap * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += G::BK) {
      __syncthreads();  // every warp is done with the previous chunk
      // A: z of input pixel (py + dy, px + dx) for each output pixel.
      for (int e = tid; e < G::BM * (G::BK / V); e += G::kThreads) {
        const int i = e / (G::BK / V), cv = e % (G::BK / V);
        const int r = r0 + i, c = c0 + cv * V;
        Vec<T> z;
        z.u = make_uint4(0, 0, 0, 0);
        if (r < HW && c < Cin) {
          const int sy = r / W + dy, sx = r % W + dx;
          if (sy >= 0 && sy < H && sx >= 0 && sx < W) {
            z.u = *reinterpret_cast<const uint4*>(xf + ((size_t)sy * W + sx) * Cin + c);
            if constexpr (kPrologue) {
#pragma unroll
              for (int j = 0; j < V; ++j) {
                const float v = to_f(z.h[j]) * af[c + j] + bf[c + j];
                z.h[j] = from_f<T>(v / (1.f + expf(-v)));
              }
            }
          }
        }
        *reinterpret_cast<uint4*>(As + i * G::kLdA + cv * V) = z.u;
      }
      // B: rows c0..c0+31 of the tap's (Cin, Cout) weight, columns n0..n0+63.
      for (int e = tid; e < G::BK * (G::BN / V); e += G::kThreads) {
        const int k = e / (G::BN / V), cv = e % (G::BN / V);
        uint4 val = make_uint4(0, 0, 0, 0);
        if (c0 + k < Cin && n0 + cv * V < Cout)
          val = *reinterpret_cast<const uint4*>(wt + (size_t)(c0 + k) * Cout + n0 + cv * V);
        *reinterpret_cast<uint4*>(Bs + k * G::kLdB + cv * V) = val;
      }
      __syncthreads();
      G::mma_chunk(acc, As, Bs, warp);
    }
  }

  T* yf = y + (size_t)frame * HW * Cout;
  G::store_tile(acc, G::stage(smem, warp), warp, lane, [&](int r, int c, float v) {
    if (r0 + r >= HW || n0 + c >= Cout) return;
    const float bv = bias == nullptr ? 0.f : to_f(bias[n0 + c]);
    yf[(size_t)(r0 + r) * Cout + n0 + c] = from_f<T>(v + bv);
  });
}

template <typename T, bool kPrologue>
cudaError_t launch(const void* x, const void* a, const void* b, const void* w, const void* bias,
                   void* y, int N, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  using G = TileGemm<T>;
  cudaError_t err = set_smem(conv3x3_kernel<T, kPrologue>, G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H * W + G::BM - 1) / G::BM, (Cout + G::BN - 1) / G::BN, N);
  conv3x3_kernel<T, kPrologue><<<grid, G::kThreads, G::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(y), H, W, Cin, Cout);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lvd

// x: (N, H, W, Cin); w: (9, Cin, Cout) [tap = 3*(dy+1) + (dx+1)]; bias:
// (Cout,) or null; y: (N, H, W, Cout); all of one type (dtype 0 bf16, 1
// fp32). With `prologue`, a and b are (N, Cin) fp32 and the conv reads
// silu(x * a + b); without it a and b are ignored. Cin % 8 == 0,
// Cout % 8 == 0.
LVD_EXPORT int lvd_conv3x3(const void* x, const void* a, const void* b, const void* w,
                           const void* bias, void* y, int N, int H, int W, int Cin, int Cout,
                           int prologue, int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (N <= 0 || H <= 0 || W <= 0 || Cin % 8 != 0 || Cout % 8 != 0 || Cin <= 0 || Cout <= 0 ||
      (prologue && (a == nullptr || b == nullptr)))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    return prologue ? launch<T, true>(x, a, b, w, bias, y, N, H, W, Cin, Cout, s)
                    : launch<T, false>(x, a, b, w, bias, y, N, H, W, Cin, Cout, s);
  });
}
