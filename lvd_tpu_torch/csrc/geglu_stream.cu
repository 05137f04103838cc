// Kernel J: the k-streaming GEGLU feed-forward
//   out = ((x W1h + b1h) * gelu(x W1g + b1g)) W2 + b2
// on (R, C) rows, for widths whose weights do not stay resident.
//
// Replaces lvd_tpu/ops/geglu_fused.py `_fused_rows` in its k-streaming
// branch (`_geglu_kernel`), which lvd_tpu takes where 3*C*inner*itemsize
// exceeds 10 MiB: C = 1280 in bf16, C >= 640 in fp32.
//
// Bound on this card: 6*R*C*inner operations against 2*R*C + 3*C*inner
// elements of traffic. At (8640, 1280, inner 5120) that is 340 GFLOP against
// 83 MB in bf16: tensor-core bound (0.34 ms in bf16, 0.69 ms in TF32). The
// weights (39 MB in bf16, 79 MB in fp32) are read once per 16-row block,
// mostly from L2.
//
// Design: one block of eight warps per 16-row tile. At C = 1280 the block's
// (16, C) fp32 output accumulator takes 80 floats a thread, and kernel C's
// register-resident form (up to C = 640) would need 160 at its 32 rows, so
// here the accumulator lives in shared memory, as the TPU kernel keeps it in
// a VMEM scratch. The block walks the inner dimension in 128-wide chunks:
//   1. h and g of the chunk: a K loop over C in 64-deep steps stages
//      x[:, k:k+64] and the W1h / W1g rows k..k+64 of the chunk in shared
//      memory (zero past C and past R); warp w owns h and g columns
//      [16w, 16w + 16) of the chunk in fp32 WMMA accumulators;
//   2. the gate in fp32 (b1, then the GELU form LVD_GELU_FORM names),
//      rounded to T into a (16, 128) shared tile;
//   3. acc += gated W2[chunk, :]: W2 is staged in (128, 128) column tiles
//      (zero past C); warp w loads its (16, 16) accumulator tile of each
//      column tile from shared memory, runs the 128-deep product and stores
//      it back.
// The epilogue adds b2 in fp32 and writes rows < R, columns < C in T. The
// rounding points are the TPU kernel's: h and g in fp32, the gated chunk in
// T, W2 accumulated in fp32. fp32 tensors take the same tiles in TF32 (the
// gated chunk is not rounded).
// Takes C % 8 == 0 (16-byte vector loads; tails past C are masked) and
// inner % 128 == 0 (the wrapper asks 256, as lvd_tpu does). Shared memory:
// the accumulator 16 x (Cs + 8) fp32, one staging buffer shared by steps 1
// and 3, the gated tile and a per-warp (2, 16, 16) fp32 h/g scratch:
// 137.5 KB in bf16 and 175.5 KB in fp32 at C = 1280. Cs is the output
// column slice of one block: C rounded up to 128 wherever that fits (every
// width up to 2688 in bf16 and 2048 in fp32), else the widest multiple of
// 128 that does, with a second grid dimension over the slices (a separate
// instantiation, so the one-slice form keeps its code). Each slice's
// block recomputes the gated chunks over the full C; lvd_tpu streams any
// width, and this keeps the port's J from refusing one.
#include "common.cuh"

namespace lvd {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 16;   // rows per block
constexpr int kBI = 128;  // inner chunk (8 warps x 16 columns)
constexpr int kBK = 64;   // depth of one step of the h/g product
constexpr int kBN = 128;  // W2 column tile (8 warps x 16 columns)

template <typename T>
struct StreamCfg {
  static constexpr int kLdX = kBK + kPad<T>;       // x stage rows
  static constexpr int kLdW1 = 2 * kBI + kPad<T>;  // W1 stage rows: [h | g]
  static constexpr int kLdW2 = kBN + kPad<T>;      // W2 stage rows
  static constexpr int kLdG = kBI + kPad<T>;       // gated tile rows
  static constexpr int kXBytes = kBM * kLdX * (int)sizeof(T);
  static constexpr int kW1Bytes = kBK * kLdW1 * (int)sizeof(T);
  static constexpr int kW2Bytes = kBI * kLdW2 * (int)sizeof(T);
  static constexpr int kStageBytes =
      kXBytes + kW1Bytes > kW2Bytes ? kXBytes + kW1Bytes : kW2Bytes;
  static constexpr int kGatedBytes = kBM * kLdG * (int)sizeof(T);
  static constexpr int kScratchBytes = kWarps * 2 * 256 * 4;

  // Accumulator row stride (floats) for an output slice of cs columns (a
  // multiple of the W2 tile), and the block's shared memory.
  __host__ __device__ static int ld_acc(int cs) { return cs + 8; }
  __host__ __device__ static int smem(int cs) {
    return kBM * ld_acc(cs) * 4 + kStageBytes + kGatedBytes + kScratchBytes;
  }
  // The widest output slice (a multiple of kBN, at most C rounded up to kBN)
  // whose block fits in shared memory.
  static int slice(int C) {
    int cs = round_up(C, kBN);
    while (cs > kBN && smem(cs) > kMaxSmem) cs -= kBN;
    return cs;
  }
};

// kSliced: a grid over output-column slices of cs columns (blockIdx.y);
// otherwise one block covers every column (cs unused), the form every
// width up to 2688 in bf16 and 2048 in fp32 takes.
template <typename T, bool kSliced>
__global__ void __launch_bounds__(kThreads)
geglu_stream_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                    const T* __restrict__ b1, const T* __restrict__ w2,
                    const T* __restrict__ b2, T* __restrict__ out, int R, int C, int I,
                    int cs, int exact) {
  using M = Mma<T>;
  using Cfg = StreamCfg<T>;
  constexpr int V = kVecN<T>;
  constexpr int kLdX = Cfg::kLdX, kLdW1 = Cfg::kLdW1, kLdW2 = Cfg::kLdW2, kLdG = Cfg::kLdG;
  extern __shared__ __align__(128) unsigned char smem[];
  const int c_pad = round_up(C, kBN);
  const int lda = Cfg::ld_acc(kSliced ? cs : c_pad);
  float* acc = reinterpret_cast<float*>(smem);
  unsigned char* stage = smem + kBM * lda * 4;
  T* xs = reinterpret_cast<T*>(stage);
  T* w1s = reinterpret_cast<T*>(stage + Cfg::kXBytes);
  T* w2s = reinterpret_cast<T*>(stage);
  T* gated = reinterpret_cast<T*>(stage + Cfg::kStageBytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* scr = reinterpret_cast<float*>(stage + Cfg::kStageBytes + Cfg::kGatedBytes) +
               warp * 512;
  const int r0 = blockIdx.x * kBM;
  const size_t ld1 = 2 * (size_t)I;
  // Output columns [n_lo, n_hi) of this block's slice, within C rounded up.
  const int n_lo = kSliced ? blockIdx.y * cs : 0;
  const int n_hi = kSliced ? min(n_lo + cs, c_pad) : c_pad;

  for (int e = tid; e < kBM * lda; e += kThreads) acc[e] = 0.f;

  for (int i0 = 0; i0 < I; i0 += kBI) {
    // 1. h and g of the chunk, columns [16w, 16w + 16) of it for warp w.
    typename M::Acc ah, ag;
    wmma::fill_fragment(ah, 0.f);
    wmma::fill_fragment(ag, 0.f);
    for (int k0 = 0; k0 < C; k0 += kBK) {
      __syncthreads();  // every warp is done with the stage buffer
      for (int e = tid; e < kBM * (kBK / V); e += kThreads) {
        const int r = e / (kBK / V), col = k0 + (e % (kBK / V)) * V;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r0 + r < R && col < C)
          val = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * C + col);
        *reinterpret_cast<uint4*>(xs + r * kLdX + col - k0) = val;
      }
      for (int e = tid; e < kBK * (2 * kBI / V); e += kThreads) {
        const int r = e / (2 * kBI / V), col = (e % (2 * kBI / V)) * V;
        const int src = col < kBI ? i0 + col : I + i0 + col - kBI;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (k0 + r < C) val = *reinterpret_cast<const uint4*>(w1 + (size_t)(k0 + r) * ld1 + src);
        *reinterpret_cast<uint4*>(w1s + r * kLdW1 + col) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += M::K) {
        typename M::A a;
        typename M::BRow fb;
        load_op(a, xs + kk, kLdX);
        load_op(fb, w1s + kk * kLdW1 + warp * 16, kLdW1);
        wmma::mma_sync(ah, a, fb, ah);
        load_op(fb, w1s + kk * kLdW1 + kBI + warp * 16, kLdW1);
        wmma::mma_sync(ag, a, fb, ag);
      }
    }

    // 2. The gate in fp32, rounded to T.
    wmma::store_matrix_sync(scr, ah, 16, wmma::mem_row_major);
    wmma::store_matrix_sync(scr + 256, ag, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, c = warp * 16 + e % 16;
      const float hv = scr[e] + to_f(b1[i0 + c]);
      const float gv = scr[256 + e] + to_f(b1[I + i0 + c]);
      gated[r * kLdG + c] = from_f<T>(hv * gelu(gv, exact));
    }

    // 3. acc += gated W2[i0:i0+128, slice], one 128-column tile at a time.
    for (int n0 = n_lo; n0 < n_hi; n0 += kBN) {
      __syncthreads();  // the gated tile is complete; the stage buffer is free
      for (int e = tid; e < kBI * (kBN / V); e += kThreads) {
        const int r = e / (kBN / V), col = n0 + (e % (kBN / V)) * V;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (col < C) val = *reinterpret_cast<const uint4*>(w2 + (size_t)(i0 + r) * C + col);
        *reinterpret_cast<uint4*>(w2s + r * kLdW2 + col - n0) = val;
      }
      __syncthreads();
      float* tile = acc + (n0 - n_lo) + warp * 16;
      typename M::Acc o;
      wmma::load_matrix_sync(o, tile, lda, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBI; kk += M::K) {
        typename M::A a;
        typename M::BRow fb;
        load_op(a, gated + kk, kLdG);
        load_op(fb, w2s + kk * kLdW2 + warp * 16, kLdW2);
        wmma::mma_sync(o, a, fb, o);
      }
      wmma::store_matrix_sync(tile, o, lda, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // Vectors of the slice's valid columns.
  const int wv = kSliced ? (min(n_lo + cs, C) - n_lo) / V : C / V;
  for (int e = tid; e < kBM * wv; e += kThreads) {
    const int r = e / wv, col = (e % wv) * V;
    if (r0 + r >= R) continue;
    Vec<T> pack;
#pragma unroll
    for (int j = 0; j < V; ++j)
      pack.h[j] = from_f<T>(acc[r * lda + col + j] + to_f(b2[n_lo + col + j]));
    *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * C + n_lo + col) = pack.u;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                   void* out, int R, int C, int I, int exact, cudaStream_t stream) {
  const int cs = StreamCfg<T>::slice(C);
  const int smem = StreamCfg<T>::smem(cs);
  const bool sliced = cs < round_up(C, kBN);
  auto kernel = sliced ? geglu_stream_kernel<T, true> : geglu_stream_kernel<T, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kBM - 1) / kBM, (C + cs - 1) / cs);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), R, C, I, cs,
      exact);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lvd

// x: (R, C), w1: (C, 2I) = [W1h | W1g], b1: (2I,), w2: (I, C), b2: (C,),
// out: (R, C); all of one type (dtype 0 bf16, 1 fp32). C % 8 == 0,
// I % 128 == 0, any R > 0, any C (column slices where C is too wide for
// one block's accumulator).
LVD_EXPORT int lvd_geglu_stream(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int R, int C, int I, int exact,
                                int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (C <= 0 || C % 8 != 0 || I <= 0 || I % kBI != 0 || R <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    return launch<decltype(tag)>(x, w1, b1, w2, b2, out, R, C, I, exact, s);
  });
}
