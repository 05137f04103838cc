// Kernel D: GroupNorm-apply + SiLU + (3,1,1) temporal convolution
//   y[f] = z[f-1] W0 + z[f] W1 + z[f+1] W2 + bias,  z = silu(x*a + b),
// with z = 0 outside [0, F), on the frames-major (B, F, P, C) stream.
//
// Replaces lvd_tpu/ops/temp_conv_fused.py `_fused` (`_kernel`,
// `_kernel_cat3`, `_kernel_rowshift`; the three are TPU tile-fill variants of
// one function). The GroupNorm statistics (a, b per (batch, channel)) stay a
// stock reduction, as they stayed XLA.
//
// Bound on this card: 6*C operations per output element against 4 bytes of
// traffic, so at C >= 320 the kernel is tensor-core bound; unfused, z would
// make a round trip through device memory between the norm and the conv.
// Design: one block per (8-pixel tile, 64 output channels, batch). Its
// output rows are ordered (frame, pixel), so with z stored for frames -1..F
// in the same order the three taps are the same z matrix read at row offsets
// 0, 8 and 16: each tap is one WMMA product, no shifted copies. z is formed
// in fp32 while it is loaded, in 64-channel chunks, and rounded to bf16 as
// the plain version rounds it; the 3 x 64 x 64 weight chunk sits beside it.
#include "common.cuh"

namespace lvd {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPB = 8;      // pixels per block
constexpr int kNB = 64;     // output channels per block
constexpr int kKC = 64;     // input-channel chunk
constexpr int kLdz = 80;    // bf16 smem row stride (160 B)
constexpr int kMaxTiles = 8;  // accumulator tiles per warp: F <= 32

inline int tconv_smem(int Mt) {
  return (Mt * 16 + 2 * kPB) * kLdz * 2 + 3 * kKC * kLdz * 2 + kWarps * 256 * 4;
}

__global__ void __launch_bounds__(kThreads)
temp_conv_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ bsh, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, bf16* __restrict__ out, int F, int P, int C,
                 int Mt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int zrows = Mt * 16 + 2 * kPB;
  bf16* zs = reinterpret_cast<bf16*>(smem);
  bf16* ws = zs + zrows * kLdz;
  float* scratch = reinterpret_cast<float*>(ws + 3 * kKC * kLdz);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p0 = blockIdx.x * kPB;
  const int n0 = blockIdx.y * kNB;
  const int b = blockIdx.z;
  const int ntiles = Mt * (kNB / 16);

  FragAcc acc[kMaxTiles];
#pragma unroll
  for (int j = 0; j < kMaxTiles; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int c0 = 0; c0 < C; c0 += kKC) {
    __syncthreads();  // the previous chunk is consumed
    // z row zr = (f + 1) * kPB + p for frames f = -1..F (zero outside [0, F)).
    for (int e = tid; e < zrows * (kKC / 8); e += kThreads) {
      const int zr = e / (kKC / 8), c8 = e % (kKC / 8);
      const int f = zr / kPB - 1, p = zr % kPB;
      Vec8 z;
      if (f >= 0 && f < F && p0 + p < P) {
        Vec8 xv;
        xv.u = *reinterpret_cast<const uint4*>(x + (((size_t)b * F + f) * P + p0 + p) * C + c0 +
                                               c8 * 8);
        const float* ac = a + (size_t)b * C + c0 + c8 * 8;
        const float* bc = bsh + (size_t)b * C + c0 + c8 * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = __bfloat162float(xv.h[i]) * ac[i] + bc[i];
          z.h[i] = __float2bfloat16(v / (1.f + __expf(-v)));
        }
      } else {
        z.u = make_uint4(0, 0, 0, 0);
      }
      *reinterpret_cast<uint4*>(zs + zr * kLdz + c8 * 8) = z.u;
    }
    for (int e = tid; e < 3 * kKC * (kNB / 8); e += kThreads) {
      const int k = e / (kKC * (kNB / 8));
      const int r = (e / (kNB / 8)) % kKC, c8 = e % (kNB / 8);
      *reinterpret_cast<uint4*>(ws + (k * kKC + r) * kLdz + c8 * 8) =
          *reinterpret_cast<const uint4*>(w + ((size_t)k * C + c0 + r) * C + n0 + c8 * 8);
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) {
      const int t = warp + kWarps * j;
      if (t < ntiles) {
        const int mt = t / (kNB / 16), nt = t % (kNB / 16);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
#pragma unroll
          for (int kk = 0; kk < kKC; kk += 16) {
            FragA fa;
            FragBRow fb;
            wmma::load_matrix_sync(fa, zs + (mt * 16 + k * kPB) * kLdz + kk, kLdz);
            wmma::load_matrix_sync(fb, ws + (k * kKC + kk) * kLdz + nt * 16, kLdz);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
      }
    }
  }

  float* scr = scratch + warp * 256;
#pragma unroll
  for (int j = 0; j < kMaxTiles; ++j) {
    const int t = warp + kWarps * j;
    if (t < ntiles) {
      const int mt = t / (kNB / 16), nt = t % (kNB / 16);
      wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = mt * 16 + e / 16;  // r = f * kPB + p
        const int f = r / kPB, p = r % kPB;
        const int c = n0 + nt * 16 + e % 16;
        if (f < F && p0 + p < P) {
          const float y = bf16_round(scr[e]) + __bfloat162float(bias[c]);
          out[(((size_t)b * F + f) * P + p0 + p) * C + c] = __float2bfloat16(y);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace
}  // namespace lvd

// x/out: (B, F, P, C) bf16; a, b: (B, C) fp32; w: (3, C, C) bf16 [tap][in][out];
// bias: (C,) bf16. C % 64 == 0, F <= 32.
LVD_EXPORT int lvd_temp_conv(const void* x, const void* a, const void* b, const void* w,
                             const void* bias, void* out, int B, int F, int P, int C,
                             void* stream) {
  using namespace lvd;
  cudaGetLastError();
  const int Mt = (F * kPB + 15) / 16;
  if (C % kNB != 0 || F <= 0 || P <= 0 || Mt * (kNB / 16) > kWarps * kMaxTiles)
    return cudaErrorInvalidValue;
  const int smem = tconv_smem(Mt);
  cudaError_t err = set_smem(temp_conv_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((P + kPB - 1) / kPB, C / kNB, B);
  temp_conv_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const bf16*>(w), static_cast<const bf16*>(bias), static_cast<bf16*>(out), F, P,
      C, Mt);
  return cudaGetLastError();
}
