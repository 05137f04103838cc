// Kernel G: the input gradient of the GEGLU feed-forward
//   out = ((x W1h + b1h) * gelu(x W1g + b1g)) W2 + b2,
// dx = (d_inner * gelu(g)) W1h^T + (d_inner * h * gelu'(g)) W1g^T with
// d_inner = dy W2^T, on (R, C) rows, the 4C-wide inner activation recomputed
// on chip. Weight and bias gradients are not computed (the guided gradient
// is taken with respect to the latents only).
//
// Replaces lvd_tpu/ops/geglu_fused.py `_fused_rows_bwd_resident`
// (`_geglu_bwd_kernel_resident`).
//
// Bound on this card: four products of 2*C*4C operations per row (h, g,
// d_inner and the two halves of dx), 40*R*C^2 in all against ~6*C bytes of
// row traffic, so the kernel is tensor-core bound; unfused, h, g, d_inner
// and the two gated cotangents would each cross device memory (4C wide).
// Design: one block per 32-row tile holds its x and dy rows in shared
// memory and walks the inner dimension in 64-wide chunks: h, g and d_inner
// for the chunk come from WMMA products (fp32); gelu(g) and gelu'(g) are
// formed in fp32 in the form LVD_GELU_FORM names (closed-form value and
// derivative, as lvd_tpu's `_gelu_val_grad`) and the two gated cotangents
// are rounded to bf16 in shared memory; dx accumulates in an fp32 (32, C)
// tile in shared memory rather than in registers, since kernel C's
// register-resident output already needs 252 registers at C = 640 and this
// kernel carries two more operands. Weights are read from device memory
// (L2-resident, at most 9.8 MB). Shared memory at C = 640: 200 KB in bf16.
// fp32 tensors (TF32 products, no rounding of the gated cotangents) hold
// their x and dy rows in fp32, and the (32, C) fp32 dx tile no longer fits
// beside them (288 KB): dx accumulates in the fp32 output itself, whose
// rows the wrapper pads to a multiple of 32 (207 KB of shared memory).
//
// Every other width lvd_tpu gives its resident dx kernel (C % 64 != 0, such
// as C = 72, C > 640 such as 1280 with inner 1024 in bf16, or inner % 64 !=
// 0) takes a general form: grid (32-row tiles, 64-wide dx column slices).
// Each block keeps its (32, 64) dx slice in WMMA accumulators (one 16x16
// tile per warp) and, for every 64-wide inner chunk, recomputes h, g and
// d_inner over all of C from staged (32, 64) x / dy chunks and (64, 64)
// weight chunks, zero past C, past inner and past R, so any C and inner
// work. Its blocks redo the gated chunks once per slice: it is for
// correctness at widths no UNet shape has, not for speed.
#include "common.cuh"

namespace lvd {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 32;   // rows per block
constexpr int kBI = 64;   // inner chunk
constexpr int kLdf = 72;  // fp32 smem row stride

// dx accumulates in shared memory for bf16, in the fp32 output for fp32.
template <typename T>
constexpr bool kDxInSmem = sizeof(T) == 2;

template <typename T>
inline int geglu_bwd_smem(int C) {
  return 2 * kBM * (C + kPad<T>) * (int)sizeof(T) + 3 * kBM * kLdf * 4 +
         2 * kBM * (kBI + kPad<T>) * (int)sizeof(T) + (kDxInSmem<T> ? kBM * (C + 8) * 4 : 0);
}

// (gelu(g), gelu'(g)) in fp32. Tanh form: g * sigmoid(2z), z = sqrt(2/pi) *
// (g + 0.044715 g^3); exact form: g * Phi(g) with derivative Phi + g * phi.
__device__ inline void gelu_val_grad(float g, int exact, float& val, float& grad) {
  if (exact) {
    const float cdf = 0.5f * (1.f + erff(g * 0.70710678118654752f));
    const float pdf = 0.3989422804014327f * expf(-0.5f * g * g);
    val = g * cdf;
    grad = cdf + g * pdf;
  } else {
    const float z = g + 0.044715f * g * g * g;
    const float sig = 1.f / (1.f + exp2f(-2.302208563834158f * z));
    val = g * sig;
    grad = sig + g * sig * (1.f - sig) * 1.5957691216057308f * (1.f + 3.f * 0.044715f * g * g);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
geglu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ w1,
                 const T* __restrict__ b1, const T* __restrict__ w2, T* __restrict__ dx, int R,
                 int C, int I, int exact) {
  using M = Mma<T>;
  constexpr int V = kVecN<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = C + kPad<T>, lda = kBI + kPad<T>;
  T* xs = reinterpret_cast<T*>(smem);
  T* dys = xs + kBM * ldx;
  float* hs = reinterpret_cast<float*>(dys + kBM * ldx);
  float* gs = hs + kBM * kLdf;
  float* ds = gs + kBM * kLdf;
  T* dhs = reinterpret_cast<T*>(ds + kBM * kLdf);
  T* dgs = dhs + kBM * lda;

  const int tid = threadIdx.x, warp = tid / 32;
  const int r0 = blockIdx.x * kBM;
  // The (32, C) fp32 dx accumulator: in shared memory, or the block's rows
  // of the (padded) fp32 output.
  float* dxs;
  int ldd;
  if constexpr (kDxInSmem<T>) {
    dxs = reinterpret_cast<float*>(dgs + kBM * lda);
    ldd = C + 8;
  } else {
    dxs = reinterpret_cast<float*>(dx) + (size_t)r0 * C;
    ldd = C;
  }
  const int cvn = C / V;
  for (int e = tid; e < kBM * cvn; e += kThreads) {
    const int r = e / cvn, cv = e % cvn;
    uint4 xv = make_uint4(0, 0, 0, 0), dv = make_uint4(0, 0, 0, 0);
    if (r0 + r < R) {
      xv = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * C + cv * V);
      dv = *reinterpret_cast<const uint4*>(dy + (size_t)(r0 + r) * C + cv * V);
    }
    *reinterpret_cast<uint4*>(xs + r * ldx + cv * V) = xv;
    *reinterpret_cast<uint4*>(dys + r * ldx + cv * V) = dv;
  }
  __syncthreads();

  // Tile of this warp within the (32, 64) chunk of h, g and d_inner.
  const int hr = warp / 4, hc = warp % 4;
  const size_t ld1 = 2 * (size_t)I;
  const int CT = C / 16;

  for (int i0 = 0; i0 < I; i0 += kBI) {
    {
      typename M::Acc ah, ag, ad;
      wmma::fill_fragment(ah, 0.f);
      wmma::fill_fragment(ag, 0.f);
      wmma::fill_fragment(ad, 0.f);
      const T* bh = w1 + i0 + hc * 16;
      const T* w2t = w2 + (size_t)(i0 + hc * 16) * C;
      for (int kk = 0; kk < C; kk += M::K) {
        typename M::A a;
        typename M::BRow fb;
        load_op(a, xs + hr * 16 * ldx + kk, ldx);
        load_op(fb, bh + kk * ld1, (unsigned)ld1);
        wmma::mma_sync(ah, a, fb, ah);
        load_op(fb, bh + I + kk * ld1, (unsigned)ld1);
        wmma::mma_sync(ag, a, fb, ag);
        typename M::BCol fc;  // W2[chunk]^T: (C, 64) read column-major from (64, C) rows
        load_op(a, dys + hr * 16 * ldx + kk, ldx);
        load_op(fc, w2t + kk, C);
        wmma::mma_sync(ad, a, fc, ad);
      }
      const int at = hr * 16 * kLdf + hc * 16;
      wmma::store_matrix_sync(hs + at, ah, kLdf, wmma::mem_row_major);
      wmma::store_matrix_sync(gs + at, ag, kLdf, wmma::mem_row_major);
      wmma::store_matrix_sync(ds + at, ad, kLdf, wmma::mem_row_major);
    }
    __syncthreads();

    for (int e = tid; e < kBM * kBI; e += kThreads) {
      const int r = e / kBI, c = e % kBI;
      const float hv = hs[r * kLdf + c] + to_f(b1[i0 + c]);
      const float gv = gs[r * kLdf + c] + to_f(b1[I + i0 + c]);
      const float d = ds[r * kLdf + c];
      float u, du;
      gelu_val_grad(gv, exact, u, du);
      dhs[r * lda + c] = from_f<T>(d * u);
      dgs[r * lda + c] = from_f<T>(d * hv * du);
    }
    __syncthreads();

    // dx += dh W1h[:, chunk]^T + dg W1g[:, chunk]^T (W1 read column-major).
    for (int t = warp; t < 2 * CT; t += kWarps) {
      const int rt = t / CT, ct = t % CT;
      float* tile = dxs + rt * 16 * ldd + ct * 16;
      typename M::Acc acc;
      if (i0 == 0) {
        wmma::fill_fragment(acc, 0.f);
      } else {
        wmma::load_matrix_sync(acc, tile, ldd, wmma::mem_row_major);
      }
      const T* wt = w1 + (size_t)ct * 16 * ld1 + i0;
#pragma unroll
      for (int kk = 0; kk < kBI; kk += M::K) {
        typename M::A a;
        typename M::BCol fb;
        load_op(a, dhs + rt * 16 * lda + kk, lda);
        load_op(fb, wt + kk, (unsigned)ld1);
        wmma::mma_sync(acc, a, fb, acc);
        load_op(a, dgs + rt * 16 * lda + kk, lda);
        load_op(fb, wt + I + kk, (unsigned)ld1);
        wmma::mma_sync(acc, a, fb, acc);
      }
      wmma::store_matrix_sync(tile, acc, ldd, wmma::mem_row_major);
    }
    // The next chunk's first __syncthreads orders these reads of dhs/dgs
    // before they are rewritten; each dx tile stays with one warp.
  }
  if constexpr (!kDxInSmem<T>) return;  // dx already holds the result
  __syncthreads();

  for (int e = tid; e < kBM * cvn; e += kThreads) {
    const int r = e / cvn, cv = e % cvn;
    if (r0 + r >= R) continue;
    Vec<T> pack;
#pragma unroll
    for (int j = 0; j < V; ++j) pack.h[j] = from_f<T>(dxs[r * ldd + cv * V + j]);
    *reinterpret_cast<uint4*>(dx + (size_t)(r0 + r) * C + cv * V) = pack.u;
  }
}

// The general form: block (row tile, 64-wide dx column slice).
template <typename T>
struct SlicedCfg {
  static constexpr int kLd = kBI + kPad<T>;  // rows of every staged (., 64) tile
  static constexpr int kRowTile = kBM * kLd * (int)sizeof(T);
  static constexpr int kWTile = kBI * kLd * (int)sizeof(T);
  // x, dy, dh, dg row tiles; three weight tiles; h, g, d_inner in fp32.
  static constexpr int kSmem = 4 * kRowTile + 3 * kWTile + 3 * kBM * kLdf * 4;
};

// Stages a (rows, 64) tile: dst[r][c] = src[(r0 + r) * ld + c0 + c], zero
// where r0 + r >= nr or c0 + c >= nc.
template <typename T>
__device__ inline void stage_tile(T* dst, const T* src, int rows, int r0, int nr, int c0, int nc,
                                  size_t ld) {
  constexpr int kLd = SlicedCfg<T>::kLd;
  for (int e = threadIdx.x; e < rows * kBI; e += kThreads) {
    const int r = e / kBI, c = e % kBI;
    dst[r * kLd + c] = (r0 + r < nr && c0 + c < nc) ? src[(size_t)(r0 + r) * ld + c0 + c]
                                                    : from_f<T>(0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
geglu_bwd_sliced_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const T* __restrict__ w1, const T* __restrict__ b1,
                        const T* __restrict__ w2, T* __restrict__ dx, int R, int C, int I,
                        int exact) {
  using M = Mma<T>;
  using Cfg = SlicedCfg<T>;
  constexpr int kLd = Cfg::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* dys = xs + kBM * kLd;
  T* dhs = dys + kBM * kLd;
  T* dgs = dhs + kBM * kLd;
  T* wa = dgs + kBM * kLd;  // W1h, W1g and W2 chunks
  T* wb = wa + kBI * kLd;
  T* wc = wb + kBI * kLd;
  float* hs = reinterpret_cast<float*>(wc + kBI * kLd);
  float* gs = hs + kBM * kLdf;
  float* ds = gs + kBM * kLdf;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * kBM, n0 = blockIdx.y * kBI;
  const int hr = warp / 4, hc = warp % 4;  // the warp's 16x16 tile of every (32, 64) tile
  const size_t ld1 = 2 * (size_t)I;
  typename M::Acc dxa;
  wmma::fill_fragment(dxa, 0.f);

  for (int i0 = 0; i0 < I; i0 += kBI) {
    // h, g and d_inner = dy W2^T of inner chunk [i0, i0 + 64), over all of C.
    typename M::Acc ah, ag, ad;
    wmma::fill_fragment(ah, 0.f);
    wmma::fill_fragment(ag, 0.f);
    wmma::fill_fragment(ad, 0.f);
    for (int k0 = 0; k0 < C; k0 += kBI) {
      __syncthreads();  // every warp is done with the staged tiles
      stage_tile(xs, x, kBM, r0, R, k0, C, C);
      stage_tile(dys, dy, kBM, r0, R, k0, C, C);
      stage_tile(wa, w1, kBI, k0, C, i0, I, ld1);           // W1h[k0.., i0..]
      stage_tile(wb, w1 + I, kBI, k0, C, i0, I, ld1);       // W1g[k0.., i0..]
      stage_tile(wc, w2, kBI, i0, I, k0, C, (size_t)C);     // W2[i0.., k0..]
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBI; kk += M::K) {
        typename M::A a;
        typename M::BRow fb;
        typename M::BCol fc;  // W2 chunk^T: element (c, i) of W2[i][c]
        load_op(a, xs + hr * 16 * kLd + kk, kLd);
        load_op(fb, wa + kk * kLd + hc * 16, kLd);
        wmma::mma_sync(ah, a, fb, ah);
        load_op(fb, wb + kk * kLd + hc * 16, kLd);
        wmma::mma_sync(ag, a, fb, ag);
        load_op(a, dys + hr * 16 * kLd + kk, kLd);
        load_op(fc, wc + hc * 16 * kLd + kk, kLd);
        wmma::mma_sync(ad, a, fc, ad);
      }
    }
    const int at = hr * 16 * kLdf + hc * 16;
    wmma::store_matrix_sync(hs + at, ah, kLdf, wmma::mem_row_major);
    wmma::store_matrix_sync(gs + at, ag, kLdf, wmma::mem_row_major);
    wmma::store_matrix_sync(ds + at, ad, kLdf, wmma::mem_row_major);
    __syncthreads();

    // The gated cotangents (zero past inner), and the W1 rows of the slice.
    for (int e = tid; e < kBM * kBI; e += kThreads) {
      const int r = e / kBI, c = e % kBI;
      float dh = 0.f, dg = 0.f;
      if (i0 + c < I) {
        const float hv = hs[r * kLdf + c] + to_f(b1[i0 + c]);
        const float gv = gs[r * kLdf + c] + to_f(b1[I + i0 + c]);
        const float d = ds[r * kLdf + c];
        float u, du;
        gelu_val_grad(gv, exact, u, du);
        dh = d * u;
        dg = d * hv * du;
      }
      dhs[r * kLd + c] = from_f<T>(dh);
      dgs[r * kLd + c] = from_f<T>(dg);
    }
    stage_tile(wa, w1, kBI, n0, C, i0, I, ld1);      // W1h[n0.., i0..]
    stage_tile(wb, w1 + I, kBI, n0, C, i0, I, ld1);  // W1g[n0.., i0..]
    __syncthreads();

    // dx[:, slice] += dh W1h[slice, chunk]^T + dg W1g[slice, chunk]^T.
#pragma unroll
    for (int kk = 0; kk < kBI; kk += M::K) {
      typename M::A a;
      typename M::BCol fb;
      load_op(a, dhs + hr * 16 * kLd + kk, kLd);
      load_op(fb, wa + hc * 16 * kLd + kk, kLd);
      wmma::mma_sync(dxa, a, fb, dxa);
      load_op(a, dgs + hr * 16 * kLd + kk, kLd);
      load_op(fb, wb + hc * 16 * kLd + kk, kLd);
      wmma::mma_sync(dxa, a, fb, dxa);
    }
  }
  // hs is free: every warp passed the last gate step's barrier. Each warp
  // drains its own tile.
  float* scratch = hs + warp * 256;
  static_assert(kWarps * 256 <= 3 * kBM * kLdf, "drain scratch");
  __syncthreads();
  drain_tile(dxa, scratch, lane, [&](int r, int c, float v) {
    const int row = r0 + hr * 16 + r, col = n0 + hc * 16 + c;
    if (row < R && col < C) dx[(size_t)row * C + col] = from_f<T>(v);
  });
}

// Whether the fast form (dx rows resident in one block) takes this width.
inline bool resident_width(int C, int I) {
  return C % 64 == 0 && C >= 64 && C <= 640 && I % kBI == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, const void* w1, const void* b1,
                   const void* w2, void* dx, int R, int C, int I, int exact,
                   cudaStream_t stream) {
  if (!resident_width(C, I)) {
    constexpr int smem = SlicedCfg<T>::kSmem;
    cudaError_t err = set_smem(geglu_bwd_sliced_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((R + kBM - 1) / kBM, (C + kBI - 1) / kBI);
    geglu_bwd_sliced_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(w1),
        static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<T*>(dx), R, C, I,
        exact);
    return cudaGetLastError();
  }
  const int smem = geglu_bwd_smem<T>(C);
  cudaError_t err = set_smem(geglu_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  geglu_bwd_kernel<T><<<(R + kBM - 1) / kBM, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<T*>(dx), R, C, I, exact);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lvd

// x, dy: (R, C); dx: (R, C), with rows padded to a multiple of 32 for fp32
// where the resident form runs (C % 64 == 0, C <= 640, I % 64 == 0); w1:
// (C, 2I) = [W1h | W1g]; b1: (2I,); w2: (I, C); all of one type (dtype 0
// bf16, 1 fp32). Any C > 0 and I > 0: other widths take the general form.
LVD_EXPORT int lvd_geglu_bwd(const void* x, const void* dy, const void* w1, const void* b1,
                             const void* w2, void* dx, int R, int C, int I, int exact, int dtype,
                             void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (C <= 0 || I <= 0 || R <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    return launch<decltype(tag)>(x, dy, w1, b1, w2, dx, R, C, I, exact, s);
  });
}
