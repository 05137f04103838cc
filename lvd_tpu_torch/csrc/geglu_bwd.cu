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
// Every 64-row block streams all 3*C*4C weights (L2-resident), as kernel C
// does, ~65 operations a weight byte.
//
// bf16 (the `wgmma` form; C = 64..640 step 64, inner % 64 == 0): kernel C's
// structure (csrc/geglu.cu). One block per 64 rows, warp-specialised: a
// producer warp loads the block's x and dy tiles once (C/64 swizzled TMA
// boxes each, rows past R read as zero) and streams the weights through a
// ring of 16 KB stages (up to 8). Per 64-wide inner chunk k, in order:
//  - GEMM1: C/64 stages of the interleaved W1 (the wrapper's
//    `interleave_w1` copy, as kernel C reads it): warpgroup j computes
//    [h | g] for its 32 inner columns 64 k + 32 j .. as one m64n64 product
//    over C, so h and g of a column sit in the same thread's registers;
//  - d_inner: ceil(C/128) stages of W2 rows 64 k .. (two 64-column K-tiles
//    a stage, K-major): warpgroup j computes dy W2[64 k + 32 j .., :]^T as
//    an m64n32 product, whose accumulator holds the same columns in the
//    same threads as the [h | g] one;
//  - the gate in registers: gelu(g) and gelu'(g) in fp32 (LVD_GELU_FORM's
//    form, closed-form value and derivative as lvd_tpu's `_gelu_val_grad`),
//    the two gated cotangents dh = d_inner gelu(g) and dg = d_inner h
//    gelu'(g) rounded to bf16 (where lvd_tpu rounds them) into a 64 x 128
//    cotangent tile in shared memory whose 64-column box j is warpgroup
//    j's [dh32 | dg32], the interleaved W1's column order; a named barrier
//    of both warpgroups first (the previous chunk's GEMM2 is done with the
//    tile), a proxy fence and a second barrier after;
//  - GEMM2: dx[:, the warpgroup's columns] += cot [W1h | W1g][:, chunk]^T,
//    one stage per 32 dx columns (for each warpgroup two 32-row boxes of
//    the interleaved W1: its dx columns as rows, the chunk's 128 columns as
//    K, K-major), m64n32 products, one group in flight (each stage is
//    released behind the next, so a ring shorter than the pieces never
//    waits on itself), the last under the next chunk's GEMM1. GEMM1 takes
//    two K-tiles a group where the ring has four stages, one at C = 640.
// Each warpgroup writes NW = C / (2 split) dx columns, in fp32 accumulators
// (NW / 2 a thread, beside 32 [h | g] and 16 d_inner ones). At C >= 384
// `split` = 2 blocks share each 64-row tile, each writing half of dx's
// columns and recomputing h, g and d_inner, so a thread's accumulators stay
// at most 128 of the 168 registers 9 warps a block leave it; the 32-column
// pieces divide every split evenly between the warpgroups (160 columns each
// at C = 320 and 640, 128 at 512), so no product is computed twice. The
// wrapper's launch plan (ops/geglu_fused.py `bwd_launch_plan`: form, rows a
// block, inner columns a chunk, blocks on one row tile) is passed in, and
// a plan the form was not built for is refused. Shared memory: x and dy
// tiles, the 16 KB cotangent tile and the ring, 224 KB at every width
// (8 stages at C = 320, 5 at 512, 3 at 640).
//
// fp32 (the `wgmma` form on TF32, `geglu_bwd_tf32_kernel`; the same widths):
// the same block, chunks and warpgroup columns on m64nNk8 TF32 products.
// TF32 `wgmma` reads both operands K-major only, so GEMM1's B is W1's
// interleaved copy transposed, (2I, C), which the wrapper stages once a
// call beside it; every operand (x, dy, both W1 copies, W2) is rounded to
// TF32 once a call by `geglu_bwd_round_kernel` (round to nearest, ties
// away: the first version's load rounding), and the cotangents in the
// gate. A tile is twice bf16's bytes, so only x stays resident (64 x C
// fp32, C/32 128-byte boxes): dy's K-tiles come through the ring beside
// W2's, one 16 KB stage (dy 64 x 32, W2 64 x 32) per 32 columns of C. A
// chunk takes C/32 GEMM1 stages (both warpgroups' 64 rows of W1^T x 32),
// C/32 d_inner stages and NW/16 GEMM2 stages (for each warpgroup 16 rows
// of the interleaved W1 x the chunk's 128 columns, four 2 KB boxes), with
// m64n64 / m64n32 / m64n16 products; dx in 16-column pieces, NW/2 fp32
// accumulators a thread. Shared memory: x (64 C x 4 bytes), the 32 KB
// cotangent tile (four 64 x 32 K-tiles) and the ring: 7 stages at C = 320,
// 6 at 384, 4 at 512, 2 at 640, 227 KB at most.
//
// The first version (the `wmma` form, when asked for by name, in either
// type): one block per 32-row tile holds its x and dy rows in shared
// memory and walks the inner dimension in 64-wide chunks: h, g and d_inner
// for the chunk come from WMMA products (fp32); the two gated cotangents
// are rounded to the stream's type in shared memory; dx accumulates in an
// fp32 (32, C) tile in shared memory. Weights are read from device memory
// (L2-resident). Shared memory at C = 640: 200 KB in bf16. fp32 tensors
// (TF32 products, no rounding of the gated cotangents) hold their x and dy
// rows in fp32, and the (32, C) fp32 dx tile no longer fits beside them
// (288 KB): dx accumulates in the fp32 output itself, whose rows the
// wrapper pads to a multiple of 32 (207 KB of shared memory).
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
#include "hopper.cuh"

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

// ---- bf16: TMA weight ring + wgmma ----

template <int NF>
struct WgBwd {
  static constexpr int BM = 64;                  // rows a block
  static constexpr int kThreads = 2 * 128 + 32;  // consumer warpgroups, then the producer warp
  static constexpr int C = 64 * NF;
  static constexpr int kSplit = NF >= 6 ? 2 : 1;  // blocks on one 64-row tile
  static constexpr int NW = C / (2 * kSplit);     // dx columns of one warpgroup
  static constexpr int NG = (NW + 31) / 32;       // its 32-column GEMM2 pieces (stages)
  static constexpr int ND = (NF + 1) / 2;         // d_inner stages: two K-tiles of W2 each
  static constexpr int U = NF + ND + NG;          // stages an inner chunk takes
  static constexpr int kStage = 16384;            // two 64 x 64 (or four 32 x 64) bf16 boxes
  static constexpr int kX = NF * 8192;            // the x tile, and the dy tile
  static constexpr int kCot = 2 * 8192;           // the cotangent tile
  static constexpr int kFixed = 2 * kX + kCot + 256 + 1024;  // + barriers, alignment slack
  static constexpr int kFit = (kMaxSmem - kFixed) / kStage;
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static constexpr int kSmem = kStages * kStage + kFixed;
};

template <int NF>
__global__ void __launch_bounds__(WgBwd<NF>::kThreads, 1)
geglu_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_dy,
                       const __grid_constant__ CUtensorMap tm_w1,
                       const __grid_constant__ CUtensorMap tm_w1n,
                       const __grid_constant__ CUtensorMap tm_w2, const bf16* __restrict__ b1,
                       bf16* __restrict__ dx, int R, int I, int exact) {
  using G = WgBwd<NF>;
  constexpr int NS = G::kStages, U = G::U, C = G::C, NW = G::NW;
  // One group in flight holds its stages, so a group of two K-tiles needs a
  // ring of four (three at C = 640 take one K-tile a group).
  constexpr int kPair = NS >= 4 ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem;
  bf16* xs = reinterpret_cast<bf16*>(smem + NS * G::kStage);
  bf16* dys = xs + NF * 4096;
  bf16* cot = dys + NF * 4096;
  uint64_t* full = reinterpret_cast<uint64_t*>(cot + 2 * 4096);
  uint64_t* empty = full + NS;
  uint64_t* xfull = empty + NS;
  const int r0 = blockIdx.x * G::BM;
  const int n0 = blockIdx.y * 2 * NW;  // this block's first dx column
  const int nk = I / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // every consumer warp
    }
    hop::mbar_init(xfull, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp: one lane issues every TMA load
    if (lane == 0) {
      hop::mbar_expect_tx(xfull, 2 * G::kX);
      for (int kt = 0; kt < NF; ++kt) {
        hop::tma_load_2d(xs + kt * 4096, &tm_x, xfull, 64 * kt, r0);
        hop::tma_load_2d(dys + kt * 4096, &tm_dy, xfull, 64 * kt, r0);
      }
      // Stage v (chunk k = v / U, j = v % U): for j < NF, interleaved W1
      // rows 64 j .. x blocks 2 k and 2 k + 1 (warpgroup h's [h32 | g32]);
      // then W2 rows 64 k .. x K-tiles 2 e and 2 e + 1 (e = j - NF); then
      // for piece p, interleaved W1 rows n0 + NW wg + 32 p .. (32 of them)
      // x blocks 2 k + h, at (2 wg + h) * 4 KB.
      for (int v = 0; v < nk * U; ++v) {
        const int s = v % NS, k = v / U, j = v % U;
        if (v >= NS) hop::mbar_wait(&empty[s], (v / NS - 1) & 1);
        bf16* st = reinterpret_cast<bf16*>(ring + s * G::kStage);
        if (j < NF) {
          hop::mbar_expect_tx(&full[s], G::kStage);
          for (int h = 0; h < 2; ++h)
            hop::tma_load_2d(st + h * 4096, &tm_w1, &full[s], 64 * (2 * k + h), 64 * j);
        } else if (j < NF + G::ND) {
          const int kt0 = 2 * (j - NF), n = NF - kt0 < 2 ? 1 : 2;
          hop::mbar_expect_tx(&full[s], n * 8192);
          for (int t = 0; t < n; ++t)
            hop::tma_load_2d(st + t * 4096, &tm_w2, &full[s], 64 * (kt0 + t), 64 * k);
        } else {
          const int p = j - NF - G::ND;
          hop::mbar_expect_tx(&full[s], G::kStage);
          for (int wg = 0; wg < 2; ++wg)
            for (int h = 0; h < 2; ++h)
              hop::tma_load_2d(st + (2 * wg + h) * 2048, &tm_w1n, &full[s], 64 * (2 * k + h),
                               n0 + NW * wg + 32 * p);
        }
      }
    }
    return;
  }
  auto wait_full = [&](int uu) { hop::mbar_wait(&full[uu % NS], (uu / NS) & 1); };
  auto release = [&](int uu) {
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[uu % NS]);
  };

  // Warpgroup wg: inner columns 64 k + 32 wg .. + 31 of each chunk, dx
  // columns n0 + NW wg .. + NW - 1.
  const int wg = warp / 4, wq = warp % 4;
  const int r4 = lane / 4, cq = 2 * (lane % 4);
  float acc[G::NG][16];
#pragma unroll
  for (int p = 0; p < G::NG; ++p)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[p][e] = 0.f;
  float hg[32], dd[16];
  // Stages are consumed in order; `done` is the first not yet released.
  int u = 0, done = 0;
  auto release_to = [&](int end) {
    for (; done < end; ++done) release(done);
  };
  hop::mbar_wait(xfull, 0);
  for (int k = 0; k < nk; ++k) {
    // GEMM1: [h | g] = x [W1h | W1g] over C, kPair K-tiles a group; its
    // first wait retires the previous chunk's last GEMM2 group.
#pragma unroll
    for (int kt = 0; kt < NF; kt += kPair) {
      const int n = NF - kt < kPair ? NF - kt : kPair;
      wait_full(u);
      if (n == 2) wait_full(u + 1);
      hop::fence_regs(hg);
      hop::wgmma_fence();
#pragma unroll
      for (int t = 0; t < kPair; ++t) {
        if (t < n) {
          const bf16* Bs =
              reinterpret_cast<const bf16*>(ring + ((u + t) % NS) * G::kStage) + wg * 4096;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma_ss_n64_tn(hg, hop::desc_sw128(xs + (kt + t) * 4096 + kk * 16),
                                 hop::desc_sw128_mn(Bs + kk * 16 * 64, 8192),
                                 kt + t > 0 || kk > 0);
        }
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      release_to(u);
      u += n;
    }
    // d_inner = dy W2[64 k + 32 wg .. + 31, :]^T, two K-tiles a stage.
#pragma unroll
    for (int e = 0; e < G::ND; ++e) {
      wait_full(u);
      const bf16* Bs = reinterpret_cast<const bf16*>(ring + (u % NS) * G::kStage) + wg * 2048;
      hop::fence_regs(dd);
      hop::wgmma_fence();
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (2 * e + t < NF) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma_ss_n32(dd, hop::desc_sw128(dys + (2 * e + t) * 4096 + kk * 16),
                              hop::desc_sw128(Bs + t * 4096 + kk * 16), e + t > 0 || kk > 0);
        }
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      release_to(u);
      ++u;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(hg);
    hop::fence_regs(dd);
    release_to(u);

    // The gate: inner column i0 + 8 c + cq (+1) has h in hg[4 c (+1)], g in
    // hg[4 (c + 4) (+1)] and d_inner in dd[4 c (+1)]; + 2 for row r4 + 8.
    // Both warpgroups' GEMM2 of the previous chunk has retired (each one's
    // wait above), so the cotangent tile is free once both are here.
    hop::bar_sync(1, 256);
    bf16* ct = cot + wg * 4096;
    const int i0 = 64 * k + 32 * wg;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 8 * c + cq;
      const float2 bh =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + i0 + col));
      const float2 bg =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + I + i0 + col));
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float h0 = hg[4 * c + 2 * hf] + bh.x, h1 = hg[4 * c + 2 * hf + 1] + bh.y;
        const float g0 = hg[4 * (c + 4) + 2 * hf] + bg.x;
        const float g1 = hg[4 * (c + 4) + 2 * hf + 1] + bg.y;
        const float d0 = dd[4 * c + 2 * hf], d1 = dd[4 * c + 2 * hf + 1];
        float u0, du0, u1, du1;
        gelu_val_grad(g0, exact, u0, du0);
        gelu_val_grad(g1, exact, u1, du1);
        const int row = 16 * wq + r4 + 8 * hf;
        *reinterpret_cast<uint32_t*>(ct + row * 64 + ((c ^ r4) * 8) + cq) =
            pack_bf16(d0 * u0, d1 * u1);
        *reinterpret_cast<uint32_t*>(ct + row * 64 + (((c + 4) ^ r4) * 8) + cq) =
            pack_bf16(d0 * h0 * du0, d1 * h1 * du1);
      }
    }
    hop::fence_proxy_async();
    hop::bar_sync(2, 256);  // both halves of the cotangent tile are in place

    // GEMM2: the warpgroup's dx piece p += cot (64 x 128) times its 32 rows
    // of the interleaved W1 (K-major), one group a stage, each releasing
    // the stage before it (a ring shorter than the pieces would otherwise
    // wait on itself); the last stays in flight under the next GEMM1.
#pragma unroll
    for (int p = 0; p < G::NG; ++p, ++u) {
      wait_full(u);
      const bf16* Bs =
          reinterpret_cast<const bf16*>(ring + (u % NS) * G::kStage) + wg * 2 * 2048;
      hop::fence_regs(acc[p]);
      hop::wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_ss_n32(acc[p], hop::desc_sw128(cot + h * 4096 + kk * 16),
                            hop::desc_sw128(Bs + h * 2048 + kk * 16), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      release_to(u);
    }
  }
  hop::wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < G::NG; ++p) hop::fence_regs(acc[p]);
  release_to(u);

  // dx column n0 + NW wg + 32 p + 8 c + cq (+1) is acc[p][4 c (+1)] (+ 2
  // for row r4 + 8); a piece reaching past NW (NW % 32 != 0) stores only
  // its own columns.
  bf16* dxw = dx + n0 + NW * wg;
#pragma unroll
  for (int p = 0; p < G::NG; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 32 * p + 8 * c + cq;
      if (col >= NW) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 16 * wq + r4 + 8 * hf;
        if (row < R)
          *reinterpret_cast<uint32_t*>(dxw + (size_t)row * C + col) =
              pack_bf16(acc[p][4 * c + 2 * hf], acc[p][4 * c + 2 * hf + 1]);
      }
    }
}

template <int NF>
cudaError_t launch_wgmma(const void* x, const void* dy, const void* w1, const void* b1,
                         const void* w2, void* dx, int R, int I, int exact,
                         cudaStream_t stream) {
  using G = WgBwd<NF>;
  constexpr int C = G::C;
  CUtensorMap tx, tdy, tw1, tw1n, tw2;
  cudaError_t err = make_map_2d(&tx, x, R, C, 64);
  if (err == cudaSuccess) err = make_map_2d(&tdy, dy, R, C, 64);
  if (err == cudaSuccess) err = make_map_2d(&tw1, w1, C, 2 * I, 64);
  if (err == cudaSuccess) err = make_map_2d(&tw1n, w1, C, 2 * I, 32);
  if (err == cudaSuccess) err = make_map_2d(&tw2, w2, I, C, 64);
  if (err == cudaSuccess) err = set_smem(geglu_bwd_wgmma_kernel<NF>, G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + G::BM - 1) / G::BM, G::kSplit);
  geglu_bwd_wgmma_kernel<NF><<<grid, G::kThreads, G::kSmem, stream>>>(
      tx, tdy, tw1, tw1n, tw2, static_cast<const bf16*>(b1), static_cast<bf16*>(dx), R, I, exact);
  return cudaGetLastError();
}

// ---- fp32: TMA weight ring + TF32 wgmma ----

template <int NF>
struct WgBwdF32 {
  static constexpr int BM = 64;                  // rows a block
  static constexpr int kThreads = 2 * 128 + 32;  // consumer warpgroups, then the producer warp
  static constexpr int C = 64 * NF;
  static constexpr int NK = 2 * NF;               // 32-column (128-byte) K-tiles of C
  static constexpr int kSplit = NF >= 6 ? 2 : 1;  // blocks on one 64-row tile
  static constexpr int NW = C / (2 * kSplit);     // dx columns of one warpgroup
  static constexpr int NG = NW / 16;              // its 16-column GEMM2 pieces (stages)
  static constexpr int U = 2 * NK + NG;           // stages an inner chunk takes
  static constexpr int kStage = 16384;            // two 64 x 32 fp32 boxes (or eight 16 x 32)
  static constexpr int kX = NK * 8192;            // the x tile
  static constexpr int kCot = 4 * 8192;           // the cotangent tile: four 64 x 32 K-tiles
  static constexpr int kFixed = kX + kCot + 256 + 1024;  // + barriers, alignment slack
  static constexpr int kFit = (kMaxSmem - kFixed) / kStage;
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static constexpr int kSmem = kStages * kStage + kFixed;
  static_assert(kStages >= 2, "the fp32 ring needs two stages");
};

template <int NF>
__global__ void __launch_bounds__(WgBwdF32<NF>::kThreads, 1)
geglu_bwd_tf32_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_dy,
                      const __grid_constant__ CUtensorMap tm_w1t,
                      const __grid_constant__ CUtensorMap tm_w1n,
                      const __grid_constant__ CUtensorMap tm_w2, const float* __restrict__ b1,
                      float* __restrict__ dx, int R, int I, int exact) {
  using G = WgBwdF32<NF>;
  constexpr int NS = G::kStages, U = G::U, C = G::C, NW = G::NW, NK = G::NK;
  constexpr int kPair = NS >= 4 ? 2 : 1;  // K-tiles a GEMM1 group (one group in flight)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem;
  float* xs = reinterpret_cast<float*>(smem + NS * G::kStage);
  float* cot = xs + NK * 2048;
  uint64_t* full = reinterpret_cast<uint64_t*>(cot + 4 * 2048);
  uint64_t* empty = full + NS;
  uint64_t* xfull = empty + NS;
  const int r0 = blockIdx.x * G::BM;
  const int n0 = blockIdx.y * 2 * NW;  // this block's first dx column
  const int nk = I / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // every consumer warp
    }
    hop::mbar_init(xfull, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp: one lane issues every TMA load
    if (lane == 0) {
      hop::mbar_expect_tx(xfull, G::kX);
      for (int kt = 0; kt < NK; ++kt) hop::tma_load_2d(xs + kt * 2048, &tm_x, xfull, 32 * kt, r0);
      // Stage v (chunk k = v / U, j = v % U): for j < NK, K-tile j of W1^T's
      // rows 128 k + 64 h .. (warpgroup h's [h32 | g32], interleaved); then
      // for e = j - NK < NK, K-tile e of dy's rows and of W2's rows 64 k ..;
      // then for piece p, for each warpgroup, 16 rows n0 + NW wg + 16 p .. of
      // the interleaved W1 x its columns 128 k + 32 h .., at (4 wg + h) * 2 KB.
      for (int v = 0; v < nk * U; ++v) {
        const int s = v % NS, k = v / U, j = v % U;
        if (v >= NS) hop::mbar_wait(&empty[s], (v / NS - 1) & 1);
        float* st = reinterpret_cast<float*>(ring + s * G::kStage);
        hop::mbar_expect_tx(&full[s], G::kStage);
        if (j < NK) {
          for (int h = 0; h < 2; ++h)
            hop::tma_load_2d(st + h * 2048, &tm_w1t, &full[s], 32 * j, 128 * k + 64 * h);
        } else if (j < 2 * NK) {
          hop::tma_load_2d(st, &tm_dy, &full[s], 32 * (j - NK), r0);
          hop::tma_load_2d(st + 2048, &tm_w2, &full[s], 32 * (j - NK), 64 * k);
        } else {
          const int p = j - 2 * NK;
          for (int wg = 0; wg < 2; ++wg)
            for (int h = 0; h < 4; ++h)
              hop::tma_load_2d(st + (4 * wg + h) * 512, &tm_w1n, &full[s], 128 * k + 32 * h,
                               n0 + NW * wg + 16 * p);
        }
      }
    }
    return;
  }
  auto wait_full = [&](int uu) { hop::mbar_wait(&full[uu % NS], (uu / NS) & 1); };
  auto stage = [&](int uu) { return reinterpret_cast<const float*>(ring + (uu % NS) * G::kStage); };

  // Warpgroup wg: inner columns 64 k + 32 wg .. + 31 of each chunk, dx
  // columns n0 + NW wg .. + NW - 1.
  const int wg = warp / 4, wq = warp % 4;
  const int r4 = lane / 4, cq = 2 * (lane % 4);
  float acc[G::NG][8];
#pragma unroll
  for (int p = 0; p < G::NG; ++p)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[p][e] = 0.f;
  float hg[32], dd[16];
  // Stages are consumed in order; `done` is the first not yet released.
  int u = 0, done = 0;
  auto release_to = [&](int end) {
    for (; done < end; ++done) {
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[done % NS]);
    }
  };
  hop::mbar_wait(xfull, 0);
  for (int k = 0; k < nk; ++k) {
    // GEMM1: [h | g] = x [W1h | W1g] over C, kPair K-tiles a group; its
    // first wait retires the previous chunk's last GEMM2 group.
#pragma unroll
    for (int kt = 0; kt < NK; kt += kPair) {
      const int n = NK - kt < kPair ? NK - kt : kPair;
      wait_full(u);
      if (n == 2) wait_full(u + 1);
      hop::fence_regs(hg);
      hop::wgmma_fence();
#pragma unroll
      for (int t = 0; t < kPair; ++t) {
        if (t < n) {
          const float* Bs = stage(u + t) + wg * 2048;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma_tf32_n64(hg, hop::desc_sw128(xs + (kt + t) * 2048 + kk * 8),
                                hop::desc_sw128(Bs + kk * 8), kt + t > 0 || kk > 0);
        }
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      release_to(u);
      u += n;
    }
    // d_inner = dy W2[64 k + 32 wg .. + 31, :]^T, one K-tile of dy and of W2
    // a stage.
#pragma unroll
    for (int e = 0; e < NK; ++e) {
      wait_full(u);
      const float* st = stage(u);
      hop::fence_regs(dd);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_tf32_n32(dd, hop::desc_sw128(st + kk * 8),
                            hop::desc_sw128(st + 2048 + wg * 1024 + kk * 8), e > 0 || kk > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      release_to(u);
      ++u;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(hg);
    hop::fence_regs(dd);
    release_to(u);

    // The gate: inner column i0 + 8 c + cq (+1) has h in hg[4 c (+1)], g in
    // hg[4 (c + 4) (+1)] and d_inner in dd[4 c (+1)]; + 2 for row r4 + 8.
    // dh and dg, rounded to TF32 as GEMM2's operand, go to the warpgroup's
    // two K-tiles of the cotangent tile (64 rows x 32 fp32 each, 16-byte
    // chunk c of row r at c ^ (r % 8)). Both warpgroups' GEMM2 of the
    // previous chunk has retired (each one's wait above), so the tile is free
    // once both are here.
    hop::bar_sync(1, 256);
    float* ct = cot + wg * 2 * 2048;
    const int i0 = 64 * k + 32 * wg;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 8 * c + cq;
      const float2 bh = *reinterpret_cast<const float2*>(b1 + i0 + col);
      const float2 bg = *reinterpret_cast<const float2*>(b1 + I + i0 + col);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float h0 = hg[4 * c + 2 * hf] + bh.x, h1 = hg[4 * c + 2 * hf + 1] + bh.y;
        const float g0 = hg[4 * (c + 4) + 2 * hf] + bg.x;
        const float g1 = hg[4 * (c + 4) + 2 * hf + 1] + bg.y;
        const float d0 = dd[4 * c + 2 * hf], d1 = dd[4 * c + 2 * hf + 1];
        float u0, du0, u1, du1;
        gelu_val_grad(g0, exact, u0, du0);
        gelu_val_grad(g1, exact, u1, du1);
        const int row = 16 * wq + r4 + 8 * hf;
        const int at = row * 32 + (((col >> 2) ^ r4) << 2) + (col & 3);
        *reinterpret_cast<float2*>(ct + at) =
            make_float2(hop::tf32_rna(d0 * u0), hop::tf32_rna(d1 * u1));
        *reinterpret_cast<float2*>(ct + 2048 + at) =
            make_float2(hop::tf32_rna(d0 * h0 * du0), hop::tf32_rna(d1 * h1 * du1));
      }
    }
    hop::fence_proxy_async();
    hop::bar_sync(2, 256);  // all four K-tiles of the cotangent tile are in place

    // GEMM2: the warpgroup's dx piece p += cot (64 x 128) times its 16 rows
    // of the interleaved W1 (K-major), one group a stage, each releasing the
    // stage before it; the last stays in flight under the next GEMM1.
#pragma unroll
    for (int p = 0; p < G::NG; ++p, ++u) {
      wait_full(u);
      const float* Bs = stage(u) + wg * 4 * 512;
      hop::fence_regs(acc[p]);
      hop::wgmma_fence();
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_tf32_n16(acc[p], hop::desc_sw128(cot + h * 2048 + kk * 8),
                              hop::desc_sw128(Bs + h * 512 + kk * 8), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      release_to(u);
    }
  }
  hop::wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < G::NG; ++p) hop::fence_regs(acc[p]);
  release_to(u);

  // dx column n0 + NW wg + 16 p + 8 c + cq (+1) is acc[p][4 c (+1)] (+ 2 for
  // row r4 + 8).
  float* dxw = dx + n0 + NW * wg;
#pragma unroll
  for (int p = 0; p < G::NG; ++p)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 16 * p + 8 * c + cq;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 16 * wq + r4 + 8 * hf;
        if (row < R)
          *reinterpret_cast<float2*>(dxw + (size_t)row * C + col) =
              make_float2(acc[p][4 * c + 2 * hf], acc[p][4 * c + 2 * hf + 1]);
      }
    }
}

template <int NF>
cudaError_t launch_tf32(const void* x, const void* dy, const void* w1, const void* w1t,
                        const void* b1, const void* w2, void* dx, int R, int I, int exact,
                        cudaStream_t stream) {
  using G = WgBwdF32<NF>;
  constexpr int C = G::C;
  CUtensorMap tx, tdy, tw1t, tw1n, tw2;
  cudaError_t err = make_map_2d_f32(&tx, x, R, C, 64);
  if (err == cudaSuccess) err = make_map_2d_f32(&tdy, dy, R, C, 64);
  if (err == cudaSuccess) err = make_map_2d_f32(&tw1t, w1t, 2 * (long long)I, C, 64);
  if (err == cudaSuccess) err = make_map_2d_f32(&tw1n, w1, C, 2 * I, 16);
  if (err == cudaSuccess) err = make_map_2d_f32(&tw2, w2, I, C, 64);
  if (err == cudaSuccess) err = set_smem(geglu_bwd_tf32_kernel<NF>, G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + G::BM - 1) / G::BM, G::kSplit);
  geglu_bwd_tf32_kernel<NF><<<grid, G::kThreads, G::kSmem, stream>>>(
      tx, tdy, tw1t, tw1n, tw2, static_cast<const float*>(b1), static_cast<float*>(dx), R, I,
      exact);
  return cudaGetLastError();
}

// The TF32 form at one width, or its shared memory (smem_only).
template <int NF>
long long tf32_width(const void* x, const void* dy, const void* w1, const void* w1t,
                     const void* b1, const void* w2, void* dx, int R, int I, int exact, int split,
                     cudaStream_t s, bool smem_only) {
  if (smem_only) return WgBwdF32<NF>::kSmem;
  if (split != WgBwdF32<NF>::kSplit) return cudaErrorInvalidValue;
  return launch_tf32<NF>(x, dy, w1, w1t, b1, w2, dx, R, I, exact, s);
}

long long tf32_c(const void* x, const void* dy, const void* w1, const void* w1t, const void* b1,
                 const void* w2, void* dx, int R, int C, int I, int exact, int split,
                 cudaStream_t s, bool smem_only) {
#define LVD_WIDTH(nf) \
  tf32_width<nf>(x, dy, w1, w1t, b1, w2, dx, R, I, exact, split, s, smem_only)
  switch (C / 64) {
    case 1: return LVD_WIDTH(1);
    case 2: return LVD_WIDTH(2);
    case 3: return LVD_WIDTH(3);
    case 4: return LVD_WIDTH(4);
    case 5: return LVD_WIDTH(5);
    case 6: return LVD_WIDTH(6);
    case 7: return LVD_WIDTH(7);
    case 8: return LVD_WIDTH(8);
    case 9: return LVD_WIDTH(9);
    default: return LVD_WIDTH(10);
  }
#undef LVD_WIDTH
}

__global__ void geglu_bwd_round_kernel(const float* src, float* dst, long long n) {
  hop::tf32_round_rows(src, dst, n);
}

// Whether the resident forms (wgmma, and the first version's) take this width.
inline bool resident_width(int C, int I) {
  return C % 64 == 0 && C >= 64 && C <= 640 && I % kBI == 0;
}

enum BwdForm { kFormWmma = 0, kFormWgmma = 1, kFormGeneral = 2 };

// The wgmma form at one width, or its shared memory (smem_only).
template <int NF>
long long wgmma_width(const void* x, const void* dy, const void* w1, const void* b1,
                      const void* w2, void* dx, int R, int I, int exact, int split,
                      cudaStream_t s, bool smem_only) {
  if (smem_only) return WgBwd<NF>::kSmem;
  if (split != WgBwd<NF>::kSplit) return cudaErrorInvalidValue;
  return launch_wgmma<NF>(x, dy, w1, b1, w2, dx, R, I, exact, s);
}

long long wgmma_c(const void* x, const void* dy, const void* w1, const void* b1, const void* w2,
                  void* dx, int R, int C, int I, int exact, int split, cudaStream_t s,
                  bool smem_only) {
#define LVD_WIDTH(nf) wgmma_width<nf>(x, dy, w1, b1, w2, dx, R, I, exact, split, s, smem_only)
  switch (C / 64) {
    case 1: return LVD_WIDTH(1);
    case 2: return LVD_WIDTH(2);
    case 3: return LVD_WIDTH(3);
    case 4: return LVD_WIDTH(4);
    case 5: return LVD_WIDTH(5);
    case 6: return LVD_WIDTH(6);
    case 7: return LVD_WIDTH(7);
    case 8: return LVD_WIDTH(8);
    case 9: return LVD_WIDTH(9);
    default: return LVD_WIDTH(10);
  }
#undef LVD_WIDTH
}

template <typename T>
cudaError_t launch_wmma(const void* x, const void* dy, const void* w1, const void* b1,
                        const void* w2, void* dx, int R, int C, int I, int exact,
                        cudaStream_t stream) {
  const int smem = geglu_bwd_smem<T>(C);
  cudaError_t err = set_smem(geglu_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  geglu_bwd_kernel<T><<<(R + kBM - 1) / kBM, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<T*>(dx), R, C, I, exact);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_general(const void* x, const void* dy, const void* w1, const void* b1,
                           const void* w2, void* dx, int R, int C, int I, int exact,
                           cudaStream_t stream) {
  constexpr int smem = SlicedCfg<T>::kSmem;
  cudaError_t err = set_smem(geglu_bwd_sliced_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kBM - 1) / kBM, (C + kBI - 1) / kBI);
  geglu_bwd_sliced_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<T*>(dx), R, C, I, exact);
  return cudaGetLastError();
}

// Whether the launch plan (rows a block, inner columns a chunk, blocks on
// one row tile) is the one the form was built for at this width.
inline bool plan_fits(int form, int C, int I, int row_block, int inner_chunk, int split) {
  if (inner_chunk != kBI) return false;  // every form walks the inner dim in 64s
  if (form == kFormWgmma) return resident_width(C, I) && row_block == 64;  // split: per width
  if (form == kFormWmma) return resident_width(C, I) && row_block == kBM && split == 1;
  return form == kFormGeneral && row_block == kBM && split == (C + kBI - 1) / kBI;
}

}  // namespace
}  // namespace lvd

// x, dy: (R, C); dx: (R, C), with rows padded to a multiple of 32 for fp32
// where the first version's resident form runs; w1: (C, 2I), [W1h | W1g],
// or for the wgmma form (form 1, bf16, C = 64..640 step 64, I % 64 == 0)
// with its columns interleaved in 32s as kernel C's; b1: (2I,) as stored;
// w2: (I, C); all of one type (dtype 0 bf16, 1 fp32). form 0 is the first
// version (C = 64..640 step 64, I % 64 == 0), form 2 the general form (any
// C and I). row_block, inner_chunk and split are the wrapper's launch plan;
// one the form was not built for is refused.
LVD_EXPORT int lvd_geglu_bwd(const void* x, const void* dy, const void* w1, const void* b1,
                             const void* w2, void* dx, int R, int C, int I, int exact, int form,
                             int row_block, int inner_chunk, int split, int dtype,
                             void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (C <= 0 || I <= 0 || R <= 0 || !plan_fits(form, C, I, row_block, inner_chunk, split) ||
      (form == kFormWgmma && dtype != kBF16))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (form == kFormWgmma)
    return (int)wgmma_c(x, dy, w1, b1, w2, dx, R, C, I, exact, split, s, false);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    return form == kFormWmma ? launch_wmma<T>(x, dy, w1, b1, w2, dx, R, C, I, exact, s)
                             : launch_general<T>(x, dy, w1, b1, w2, dx, R, C, I, exact, s);
  });
}

// The fp32 wgmma form (TF32, C = 64..640 step 64, I % 64 == 0): x, dy (R,
// C), w1 (C, 2I) interleaved in 32s as kernel C's and w1t = w1^T (2I, C),
// w2 (I, C), each already rounded to TF32 (lvd_geglu_bwd_round); b1 (2I,) as
// stored; dx (R, C). row_block, inner_chunk and split are the wrapper's
// launch plan; one the form was not built for is refused.
LVD_EXPORT int lvd_geglu_bwd_tf32(const void* x, const void* dy, const void* w1,
                                  const void* w1t, const void* b1, const void* w2, void* dx,
                                  int R, int C, int I, int exact, int row_block, int inner_chunk,
                                  int split, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (C <= 0 || I <= 0 || R <= 0 || !plan_fits(kFormWgmma, C, I, row_block, inner_chunk, split))
    return cudaErrorInvalidValue;
  return (int)tf32_c(x, dy, w1, w1t, b1, w2, dx, R, C, I, exact, split,
                     static_cast<cudaStream_t>(stream), false);
}

// dst = src rounded to TF32 (round to nearest, ties away, as the first
// version rounds its operands), n fp32 values; src and dst may be the same.
LVD_EXPORT int lvd_geglu_bwd_round(const void* src, void* dst, long long n, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (n <= 0) return cudaErrorInvalidValue;
  const long long want = (n / 4 + 255) / 256;
  const int blocks = (int)(want < 1 ? 1 : want > 1056 ? 1056 : want);  // 8 a SM at most
  geglu_bwd_round_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), n);
  return cudaGetLastError();
}

// Bytes of dynamic shared memory one block of kernel G's wgmma form takes
// at width C (C = 64..640 step 64) in bf16 (dtype 0) or fp32 (1); 0 for
// any other width.
LVD_EXPORT long long lvd_geglu_bwd_smem(int C, int dtype) {
  using namespace lvd;
  if (C % 64 != 0 || C < 64 || C > 640) return 0;
  if (dtype == kF32)
    return tf32_c(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, C, 64, 0, 0,
                  nullptr, true);
  return wgmma_c(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, C, 64, 0, 0, nullptr,
                 true);
}
