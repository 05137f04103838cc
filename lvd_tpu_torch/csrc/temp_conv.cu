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
// in fp32 while it is loaded, in 64-channel chunks, and rounded to the
// stream's type as the plain version rounds it; the 3 x 64 x 64 weight
// chunk sits beside it. Shared memory at F = 24: 71 KB in bf16, 121 KB in
// fp32 (same tiles, TF32 products, z not rounded).
#include "common.cuh"

namespace lvd {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPB = 8;      // pixels per block
constexpr int kNB = 64;     // output channels per block
constexpr int kKC = 64;     // input-channel chunk
constexpr int kMaxTiles = 8;  // accumulator tiles per warp: F <= 32

template <typename T>
constexpr int kLdz = kKC + kPad<T>;  // z / weight smem row stride

template <typename T>
inline int tconv_smem(int Mt) {
  return (Mt * 16 + 2 * kPB) * kLdz<T> * (int)sizeof(T) +
         3 * kKC * kLdz<T> * (int)sizeof(T) + kWarps * 256 * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
temp_conv_kernel(const T* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ bsh, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ out, int F, int P, int C, int Mt) {
  using M = Mma<T>;
  constexpr int ldz = kLdz<T>;
  constexpr int V = kVecN<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int zrows = Mt * 16 + 2 * kPB;
  T* zs = reinterpret_cast<T*>(smem);
  T* ws = zs + zrows * ldz;
  float* scratch = reinterpret_cast<float*>(ws + 3 * kKC * ldz);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p0 = blockIdx.x * kPB;
  const int n0 = blockIdx.y * kNB;
  const int b = blockIdx.z;
  const int ntiles = Mt * (kNB / 16);

  typename M::Acc acc[kMaxTiles];
#pragma unroll
  for (int j = 0; j < kMaxTiles; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int c0 = 0; c0 < C; c0 += kKC) {
    __syncthreads();  // the previous chunk is consumed
    // z row zr = (f + 1) * kPB + p for frames f = -1..F (zero outside [0, F)).
    for (int e = tid; e < zrows * (kKC / V); e += kThreads) {
      const int zr = e / (kKC / V), cv = e % (kKC / V);
      const int f = zr / kPB - 1, p = zr % kPB;
      Vec<T> z;
      if (f >= 0 && f < F && p0 + p < P) {
        Vec<T> xv;
        xv.u = *reinterpret_cast<const uint4*>(x + (((size_t)b * F + f) * P + p0 + p) * C + c0 +
                                               cv * V);
        const float* ac = a + (size_t)b * C + c0 + cv * V;
        const float* bc = bsh + (size_t)b * C + c0 + cv * V;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float v = to_f(xv.h[i]) * ac[i] + bc[i];
          z.h[i] = from_f<T>(v / (1.f + __expf(-v)));
        }
      } else {
        z.u = make_uint4(0, 0, 0, 0);
      }
      *reinterpret_cast<uint4*>(zs + zr * ldz + cv * V) = z.u;
    }
    for (int e = tid; e < 3 * kKC * (kNB / V); e += kThreads) {
      const int k = e / (kKC * (kNB / V));
      const int r = (e / (kNB / V)) % kKC, cv = e % (kNB / V);
      *reinterpret_cast<uint4*>(ws + (k * kKC + r) * ldz + cv * V) =
          *reinterpret_cast<const uint4*>(w + ((size_t)k * C + c0 + r) * C + n0 + cv * V);
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
          for (int kk = 0; kk < kKC; kk += M::K) {
            typename M::A fa;
            typename M::BRow fb;
            load_op(fa, zs + (mt * 16 + k * kPB) * ldz + kk, ldz);
            load_op(fb, ws + (k * kKC + kk) * ldz + nt * 16, ldz);
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
          const float y = round_to<T>(scr[e]) + to_f(bias[c]);
          out[(((size_t)b * F + f) * P + p0 + p) * C + c] = from_f<T>(y);
        }
      }
      __syncwarp();
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* b, const void* w, const void* bias,
                   void* out, int B, int F, int P, int C, int Mt, cudaStream_t stream) {
  const int smem = tconv_smem<T>(Mt);
  cudaError_t err = set_smem(temp_conv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((P + kPB - 1) / kPB, C / kNB, B);
  temp_conv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(out), F, P, C, Mt);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lvd

// x/out: (B, F, P, C) and w: (3, C, C) [tap][in][out], bias: (C,), all of one
// type (dtype 0 bf16, 1 fp32); a, b: (B, C) fp32. C % 64 == 0, F <= 32.
LVD_EXPORT int lvd_temp_conv(const void* x, const void* a, const void* b, const void* w,
                             const void* bias, void* out, int B, int F, int P, int C, int dtype,
                             void* stream) {
  using namespace lvd;
  cudaGetLastError();
  const int Mt = (F * kPB + 15) / 16;
  if (C % kNB != 0 || F <= 0 || P <= 0 || Mt * (kNB / 16) > kWarps * kMaxTiles)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    return launch<decltype(tag)>(x, a, b, w, bias, out, B, F, P, C, Mt, s);
  });
}
