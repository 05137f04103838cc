// Kernel C: the fused GEGLU feed-forward
//   out = ((x W1h + b1h) * gelu(x W1g + b1g)) W2 + b2
// on (R, C) rows, with the 4C-wide inner activation kept on chip.
//
// Replaces lvd_tpu/ops/geglu_fused.py `_fused_rows_resident`
// (`_geglu_kernel_resident`).
//
// Bound on this card: at C = 320..640 the two products do ~12*C*C operations
// per row against ~4*C bytes of row traffic, so the kernel is tensor-core
// bound; unfused, the (R, 8C) projection and the (R, 4C) gated activation
// would each make a round trip through device memory (354 MB and 177 MB per
// L0 instance in bf16). Design: one block per 32-row tile keeps its x rows in
// shared memory and walks the inner dimension in 64-wide chunks: h and g for
// the chunk come from WMMA products (fp32), the gate is applied in fp32 and
// rounded to bf16 in shared memory, and the chunk is multiplied straight into
// W2, accumulating the (32, C) output in registers. The weights are read
// from device memory (L2-resident: 3*C*4C bf16 is at most 9.8 MB). C is a
// template parameter (C = 64*NF) so the output accumulators stay in
// registers. fp32 tensors take the same tiles with fp32 x rows and gated
// chunk in shared memory (116 KB at C = 640, against 72 KB in bf16) and
// TF32 products; the gated chunk is not rounded.
#include "common.cuh"

namespace lvd {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 32;   // rows per block
constexpr int kBI = 64;   // inner chunk
constexpr int kLdf = 72;  // fp32 smem row stride

template <typename T, int NF>
constexpr int geglu_smem() {
  return kBM * (64 * NF + kPad<T>) * (int)sizeof(T) + 2 * kBM * kLdf * 4 +
         kBM * (kBI + kPad<T>) * (int)sizeof(T) + kWarps * 256 * 4;
}

template <typename T, int NF>
__global__ void __launch_bounds__(kThreads)
geglu_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
             const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out, int R,
             int I, int exact) {
  using M = Mma<T>;
  constexpr int C = 64 * NF;
  constexpr int kLdx = C + kPad<T>;
  constexpr int kLda = kBI + kPad<T>;
  constexpr int CT = C / 16;
  constexpr int V = kVecN<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  float* hs = reinterpret_cast<float*>(xs + kBM * kLdx);
  float* gs = hs + kBM * kLdf;
  T* as = reinterpret_cast<T*>(gs + kBM * kLdf);
  float* scratch = reinterpret_cast<float*>(as + kBM * kLda);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * kBM;

  for (int e = tid; e < kBM * (C / V); e += kThreads) {
    const int r = e / (C / V), cv = e % (C / V);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < R) val = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * C + cv * V);
    *reinterpret_cast<uint4*>(xs + r * kLdx + cv * V) = val;
  }
  __syncthreads();

  typename M::Acc acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  // h/g tile of this warp within the (32, 64) chunk.
  const int hr = warp / 4, hc = warp % 4;
  const size_t ld1 = 2 * (size_t)I;

  for (int i0 = 0; i0 < I; i0 += kBI) {
    typename M::Acc ah, ag;
    wmma::fill_fragment(ah, 0.f);
    wmma::fill_fragment(ag, 0.f);
    const T* bh = w1 + i0 + hc * 16;
    const T* bg = bh + I;
#pragma unroll 4
    for (int kk = 0; kk < C; kk += M::K) {
      typename M::A a;
      typename M::BRow fb;
      load_op(a, xs + hr * 16 * kLdx + kk, kLdx);
      load_op(fb, bh + kk * ld1, (unsigned)ld1);
      wmma::mma_sync(ah, a, fb, ah);
      load_op(fb, bg + kk * ld1, (unsigned)ld1);
      wmma::mma_sync(ag, a, fb, ag);
    }
    wmma::store_matrix_sync(hs + hr * 16 * kLdf + hc * 16, ah, kLdf, wmma::mem_row_major);
    wmma::store_matrix_sync(gs + hr * 16 * kLdf + hc * 16, ag, kLdf, wmma::mem_row_major);
    __syncthreads();

    for (int e = tid; e < kBM * kBI; e += kThreads) {
      const int r = e / kBI, c = e % kBI;
      const float hv = hs[r * kLdf + c] + to_f(b1[i0 + c]);
      const float gv = gs[r * kLdf + c] + to_f(b1[I + i0 + c]);
      as[r * kLda + c] = from_f<T>(hv * gelu(gv, exact));
    }
    __syncthreads();

#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int t = warp + kWarps * f;
      const int rt = t / CT, ct = t % CT;
#pragma unroll
      for (int kk = 0; kk < kBI; kk += M::K) {
        typename M::A a;
        typename M::BRow fb;
        load_op(a, as + rt * 16 * kLda + kk, kLda);
        load_op(fb, w2 + (size_t)(i0 + kk) * C + ct * 16, C);
        wmma::mma_sync(acc[f], a, fb, acc[f]);
      }
    }
    // The next chunk's first __syncthreads orders these reads of `as`
    // before it is rewritten.
  }

  float* scr = scratch + warp * 256;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int t = warp + kWarps * f;
    const int rt = t / CT, ct = t % CT;
    wmma::store_matrix_sync(scr, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = r0 + rt * 16 + e / 16, c = ct * 16 + e % 16;
      if (r < R) out[(size_t)r * C + c] = from_f<T>(scr[e] + to_f(b2[c]));
    }
    __syncwarp();
  }
}

template <typename T, int NF>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                   void* out, int R, int I, int exact, cudaStream_t stream) {
  constexpr int smem = geglu_smem<T, NF>();
  cudaError_t err = set_smem(geglu_kernel<T, NF>, smem);
  if (err != cudaSuccess) return err;
  geglu_kernel<T, NF><<<(R + kBM - 1) / kBM, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), R, I, exact);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_c(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* out, int R, int C, int I, int exact,
                     cudaStream_t s) {
  switch (C / 64) {
    case 1: return launch<T, 1>(x, w1, b1, w2, b2, out, R, I, exact, s);
    case 2: return launch<T, 2>(x, w1, b1, w2, b2, out, R, I, exact, s);
    case 3: return launch<T, 3>(x, w1, b1, w2, b2, out, R, I, exact, s);
    case 4: return launch<T, 4>(x, w1, b1, w2, b2, out, R, I, exact, s);
    case 5: return launch<T, 5>(x, w1, b1, w2, b2, out, R, I, exact, s);
    case 6: return launch<T, 6>(x, w1, b1, w2, b2, out, R, I, exact, s);
    case 7: return launch<T, 7>(x, w1, b1, w2, b2, out, R, I, exact, s);
    case 8: return launch<T, 8>(x, w1, b1, w2, b2, out, R, I, exact, s);
    case 9: return launch<T, 9>(x, w1, b1, w2, b2, out, R, I, exact, s);
    default: return launch<T, 10>(x, w1, b1, w2, b2, out, R, I, exact, s);
  }
}

}  // namespace
}  // namespace lvd

// x: (R, C), w1: (C, 2I) = [W1h | W1g], b1: (2I,), w2: (I, C), b2: (C,),
// out: (R, C); all of one type (dtype 0 bf16, 1 fp32). C in {64, 128, ...,
// 640}, I % 64 == 0.
LVD_EXPORT int lvd_geglu(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, int R, int C, int I, int exact, int dtype,
                         void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (C % 64 != 0 || C < 64 || C > 640 || I % kBI != 0 || R <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    return launch_c<decltype(tag)>(x, w1, b1, w2, b2, out, R, C, I, exact, s);
  });
}
