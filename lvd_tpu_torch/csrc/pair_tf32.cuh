// The passes that the fp32 forms of kernel B (csrc/pair_fwd_tf32.cu, the
// forward) and kernel F (csrc/pair_bwd_tf32.cu, dy) share: the fused
// temporal pair in fp32 with TF32 products, split into passes that each fit
// the card (fp32 tiles are twice bf16's, and the bf16 forms' one fused
// kernel already fills 218-226 KB of shared memory).
//
//  - `gemm`: out (M, N) = A (M, K) B^T (+ bias) (+ res) on TMA + TF32
//    `wgmma`, persistent: one block an SM walks 128 x BN output tiles, the
//    row tile's BN-column tiles one after another (so the blocks running at
//    once share their A rows, which are read from device memory about once),
//    two consumer warpgroups of m64nBNk8 and a producer warp keeping a
//    four-stage ring of 128 x 32 A and BN x 32 B fp32 boxes (128-byte
//    swizzle, K-major both: TF32 `wgmma` takes no transposed operand, so the
//    weights are staged per call in the orientation each product reads,
//    rounded, `stage`). The producer runs into the next tile while the
//    consumers store the last one. The epilogue adds the bias and the
//    residual in fp32; each thread reads an element of `res` before it
//    writes the same element of `out`, so the two may be one buffer.
//    BN: 192 where N % 192 == 0, 160 where N % 160 == 0, 128 where N % 128
//    == 0, else 64 (`gemm_width`), with 4 stages (128-160 KB, one block an
//    SM): at the train step's products the widest width was the fastest or
//    level with 64, and 2-3 stages at two blocks an SM slower
//    (probes/tf32_gemm_widths.py, PERF.md);
//  - `ln_kernel`: LayerNorm, one warp a row, one-pass fp32 statistics, the
//    output TF32-rounded (it is only ever a product operand);
//  - `attn_kernel`: o = softmax(q k^T / 8) v of (pixel, head) pairs on
//    mma.sync m16n8k8 TF32 (csrc/warp_mma.cuh): an F x F x 64 product is far
//    below `wgmma`'s 64-row tile, so a warp takes 16 query frames of one
//    pair, F rounded up to FP = 16..64 (`attn_frames`) with the keys past F
//    masked, a block 4 / (FP / 16) pairs; a pixel's F rows are found through
//    the stream's strides, so rows keep the stream's order (frames-major or
//    pixels-major) in every pass.
// Every product operand is rounded to TF32 (round to nearest, ties away)
// before it reaches shared memory or a fragment; statistics, softmax, bias,
// residuals and accumulators stay fp32.
//
// Each including form defines LVD_PAIR_TF32, the namespace its copy of these
// kernels lives in, so that a profile tells B's passes from F's.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "warp_mma.cuh"

#ifndef LVD_PAIR_TF32
#error "define LVD_PAIR_TF32 (the including form's namespace) before including pair_tf32.cuh"
#endif

namespace lvd {
namespace LVD_PAIR_TF32 {

constexpr int kHd = 64;          // head dim
constexpr int kGemmRows = 128;   // rows a GEMM tile: two consumer warpgroups of m64
constexpr int kGemmStages = 4;

template <int BN, int NS>
struct Tf32Gemm {
  static constexpr int kThreads = 2 * 128 + 32;  // consumer warpgroups, then the producer warp
  static constexpr int kA = kGemmRows * 128;      // 128 rows x 32 fp32
  static constexpr int kB = BN * 128;             // BN rows x 32 fp32
  static constexpr int kStage = kA + kB;
  static constexpr int kSmem = NS * kStage + 256 + 1024;  // + barriers, alignment
};

struct GemmEpilogue {
  const float* bias;  // (N,) added in fp32, or null
  const float* res;   // (M, N) added in fp32, or null; may be `out` itself
  float* out;         // (M, N)
};

// out (M, N) = A (M, K) B^T (+ bias) (+ res), with A and B = Bt (N, K) fp32
// row-major and already TF32-rounded; K % 32 == 0, N % BN == 0; a ring of NS
// stages. Tile t of the grid's walk is row tile t / (N / BN), column tile
// t % (N / BN).
template <int BN, int NS>
__global__ void __launch_bounds__(Tf32Gemm<BN, NS>::kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
            GemmEpilogue ep, int M, int N, int K) {
  using G = Tf32Gemm<BN, NS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * G::kStage);
  uint64_t* empty = full + NS;
  const int nt = N / BN, tiles = (M + kGemmRows - 1) / kGemmRows * nt;
  const int nk = K / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // every consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp: one lane issues every TMA load
    if (lane == 0) {
      int it = 0;  // the ring's step count across tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / nt * kGemmRows, n0 = t % nt * BN;
        for (int v = 0; v < nk; ++v, ++it) {
          const int s = it % NS;
          if (it >= NS) hop::mbar_wait(&empty[s], (it / NS - 1) & 1);
          unsigned char* st = ring + s * G::kStage;
          hop::mbar_expect_tx(&full[s], G::kStage);
          hop::tma_load_2d(st, &tm_a, &full[s], 32 * v, m0);
          hop::tma_load_2d(st + G::kA, &tm_b, &full[s], 32 * v, n0);
        }
      }
    }
    return;
  }
  const int wg = warp / 4, wq = warp % 4, r4 = lane / 4, cq = 2 * (lane % 4);
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / nt * kGemmRows, n0 = t % nt * BN;
    for (int v = 0; v < nk; ++v, ++it) {
      const int s = it % NS;
      hop::mbar_wait(&full[s], (it / NS) & 1);
      const float* A = reinterpret_cast<const float*>(ring + s * G::kStage) + wg * 64 * 32;
      const float* B = reinterpret_cast<const float*>(ring + s * G::kStage + G::kA);
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hop::wgmma_tf32<BN>(acc, hop::desc_sw128(A + kk * 8), hop::desc_sw128(B + kk * 8),
                            v > 0 || kk > 0);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // the previous stage's products are done: release it
      if (v > 0) {
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(&empty[(it - 1) % NS]);
      }
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[(it - 1) % NS]);  // the tile's last stage

    // Column n0 + 8 c + cq (+1) of row m0 + 64 wg + 16 wq + r4 is acc[4 c (+1)]
    // (+ 2 for row + 8). Every bias and residual load comes before the
    // first store: `res` may be `out`, so a load after a store would wait for
    // it. The sum is (acc + bias) + res either way.
    const int row0 = m0 + 64 * wg + 16 * wq + r4;
    if (ep.bias != nullptr) {
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const float2 b = *reinterpret_cast<const float2*>(ep.bias + n0 + 8 * c + cq);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          acc[4 * c + 2 * hf] += b.x;
          acc[4 * c + 2 * hf + 1] += b.y;
        }
      }
    }
    if (ep.res != nullptr) {
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = row0 + 8 * hf;
          if (row >= M) continue;
          const float2 r =
              *reinterpret_cast<const float2*>(ep.res + (size_t)row * N + n0 + 8 * c + cq);
          acc[4 * c + 2 * hf] += r.x;
          acc[4 * c + 2 * hf + 1] += r.y;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + 8 * hf;
        if (row >= M) continue;
        *reinterpret_cast<float2*>(ep.out + (size_t)row * N + n0 + 8 * c + cq) =
            make_float2(acc[4 * c + 2 * hf], acc[4 * c + 2 * hf + 1]);
      }
    }
  }
}

// LayerNorm of R rows of C (one warp a row, C % 32 == 0, C <= 640) with
// one-pass fp32 statistics (as lvd_tpu's): z = xhat * scale + bias,
// TF32-rounded; where stats is given, stats[2 r] = mean, stats[2 r + 1] =
// rstd.
__global__ void __launch_bounds__(256)
ln_kernel(const float* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ bias, float* __restrict__ z, float* __restrict__ stats,
          int R, int C, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= R) return;
  const float* xr = x + (size_t)row * C;
  const int n = C / 32;
  float v[20];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    if (i < n) {
      v[i] = xr[lane + 32 * i];
      s += v[i];
      s2 += v[i] * v[i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mean = s / C;
  const float rstd = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + eps);
  float* zr = z + (size_t)row * C;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    if (i < n) {
      const int c = lane + 32 * i;
      zr[c] = hop::tf32_rna((v[i] - mean) * rstd * scale[c] + bias[c]);
    }
  }
  if (lane == 0 && stats != nullptr) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = rstd;
  }
}

// The rows of a pixel: element (b, f, p, 0) of the stream is row b rB + f rF
// + p rP, its strides over C (which every layout's strides are multiples of).
struct PixelRows {
  long long rB, rF, rP;
  int F, P, C;
  static PixelRows of(long long sB, long long sF, long long sP, int F, int P, int C) {
    return {sB / C, sF / C, sP / C, F, P, C};
  }
};

// The attention passes' tiles at FP = F rounded up to 16 frames: a (pixel,
// head) pair's q, k, v (and dO) as FP x kLdt fp32 tiles, frames past F zero;
// a warp owns one 16-row tile of a pair (its queries, then in the VJP its
// keys), and a block holds kPairs pairs: 4 at F <= 16, 2 at F <= 32, 1
// past (three warps at F <= 48).
template <int FP>
struct AttnTiles {
  static constexpr int kLdt = kHd + wm::WarpMma<float>::kPadE;  // 68: conflict-free fragments
  static constexpr int kLdp = FP + 4;                           // a P^T / dL^T row
  static constexpr int kRowTiles = FP / 16;
  static constexpr int kPairs = kRowTiles >= 3 ? 1 : 4 / kRowTiles;
  static constexpr int kWarps = kPairs * kRowTiles;
  static constexpr int kHead = FP * kLdt;
  static constexpr int kFwd = 3 * kHead;                   // q, k, v
  static constexpr int kVjp = 4 * kHead + 2 * FP * kLdp;   // q, k, v, dO, P^T, dL^T
};

// The attention passes' padded frame count at F frames (F <= 64).
inline int attn_frames(int F) { return round_up(F, 16); }

// Runs fn(std::integral_constant<int, FP>) at the attention passes' FP for
// F frames (F <= 64).
template <typename Fn>
cudaError_t by_frames(int F, Fn fn) {
  switch (attn_frames(F)) {
    case 16: return fn(std::integral_constant<int, 16>{});
    case 32: return fn(std::integral_constant<int, 32>{});
    case 48: return fn(std::integral_constant<int, 48>{});
    default: return fn(std::integral_constant<int, 64>{});
  }
}

// The block's pairs' rows, computed once a block: rows[j FP + f] is the row
// of frame f of the block's pair j (pair = (pixel, head)), or -1 past F or
// past `pairs`; cols[j] its head's first column, h * 64. Ends in a barrier.
template <int FP>
__device__ inline void pair_rows(long long* rows, int* cols, const PixelRows& pr, int H,
                                 int pairs) {
  using T = AttnTiles<FP>;
  for (int e = threadIdx.x; e < T::kPairs * FP; e += blockDim.x) {
    const int j = e / FP, f = e % FP;
    const int pair = blockIdx.x * T::kPairs + j;
    const int px = pair < pairs ? pair / H : 0;
    rows[e] = pair < pairs && f < pr.F
                  ? px / pr.P * pr.rB + f * pr.rF + px % pr.P * pr.rP
                  : -1;
    if (f == 0) cols[j] = pair < pairs ? pair % H * kHd : 0;
  }
  __syncthreads();
}

// Starts the copy of the block's pairs' head tiles (cp.async, 16 bytes a
// thread a step, all in flight at once): matrix m of MATS at column m *
// mstride + the head's columns of the (R, ld) buffer src, the pair's rows
// (`pair_rows`); frames past F and pairs past the last zero-filled. The
// values stay as stored: the fragment loads round every operand to TF32.
template <int FP, int MATS>
__device__ inline void load_heads(float* tiles, int per_pair, const float* src, size_t ld,
                                  int mstride, const long long* rows, const int* cols) {
  using T = AttnTiles<FP>;
  constexpr int kV = kHd / 4;  // 16-byte pieces a head row
  constexpr int n = T::kPairs * MATS * FP * kV;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c4 = e % kV, f = e / kV % FP, m = e / (kV * FP) % MATS, j = e / (kV * FP * MATS);
    const long long row = rows[j * FP + f];
    const float* at = row < 0 ? src : src + row * ld + m * mstride + cols[j] + 4 * c4;
    wm::cp_async16(tiles + j * per_pair + m * T::kHead + f * T::kLdt + 4 * c4, at, row >= 0);
  }
  wm::cp_async_commit();
}

// A warp's 16 query rows of S = q k^T (keys in FP / 8 accumulator tiles), scaled,
// keys past F masked, softmax in fp32 in place: row g holds keys 8 n + 2 t
// (+1) in s[n][0..1], row g + 8 in s[n][2..3] (g = lane / 4, t = lane % 4).
template <int FP>
__device__ inline void softmax_tile(float (&s)[FP / 8][4], const float* q, const float* k, int F,
                                    float scale, int lane) {
  using T = AttnTiles<FP>;
#pragma unroll
  for (int n = 0; n < FP / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  wm::mma_rows_nk<float, FP / 8>(s, q, k, T::kLdt, kHd, lane);
  const int t = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < FP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = 8 * n + 2 * t + (e & 1) < F ? s[n][e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int n = 0; n < FP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = expf(s[n][e] - mx[e >> 1]);
      sum[e >> 1] += s[n][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    sum[r] = 1.f / sum[r];
  }
#pragma unroll
  for (int n = 0; n < FP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] *= sum[e >> 1];
  }
}

// Stores a warp's 16 x 64 accumulator (frames r0 + g (+8) of the pair whose
// rows `rows` lists, those below F) TF32-rounded at column col0 of the (R,
// ld) buffer dst.
__device__ inline void store_head(float* dst, size_t ld, int col0, const float (&c)[8][4],
                                  const long long* rows, int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long long at = rows[r0 + g + 8 * hf];
    if (at < 0) continue;
    float* row = dst + at * ld + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(hop::tf32_rna(c[n][2 * hf]), hop::tf32_rna(c[n][2 * hf + 1]));
    }
  }
}

// The forward attention of (pixel, head) pairs on mma.sync m16n8k8 TF32:
// o = softmax(q k^T / 8) v from q, k, v in qkv (R, 3C), written
// TF32-rounded into o (R, C) (the output projection's operand). `pairs` =
// B P H.
template <int FP>
__global__ void __launch_bounds__(AttnTiles<FP>::kWarps * 32)
attn_kernel(const float* __restrict__ qkv, float* __restrict__ o, PixelRows pr, int H, int pairs,
            float scale) {
  using T = AttnTiles<FP>;
  extern __shared__ float sm[];
  __shared__ long long rows[T::kPairs * FP];
  __shared__ int cols[T::kPairs];
  pair_rows<FP>(rows, cols, pr, H, pairs);
  load_heads<FP, 3>(sm, T::kFwd, qkv, 3 * (size_t)pr.C, pr.C, rows, cols);
  wm::cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = warp / T::kRowTiles, r0 = 16 * (warp % T::kRowTiles);
  const int pair = blockIdx.x * T::kPairs + j;
  if (pair >= pairs) return;
  const float* q = sm + j * T::kFwd;
  const float* k = q + T::kHead;
  const float* v = k + T::kHead;
  float s[FP / 8][4], acc[8][4] = {};
  softmax_tile<FP>(s, q + r0 * T::kLdt, k, pr.F, scale, lane);
  wm::mma_acc_kn<float, FP / 8, 8>(acc, s, v, T::kLdt, lane);  // P rounded to TF32 as the A operand
  store_head(o, pr.C, cols[j], acc, rows + j * FP, r0, lane);
}

// dst = src TF32-rounded, (rows, cols) as it is or transposed to (cols,
// rows): the per-call staging of the weights in the orientations the
// products read K-major.
__global__ void __launch_bounds__(256)
stage_kernel(const float* __restrict__ src, float* __restrict__ dst, int rows, int cols,
             int transpose) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int j = ty; j < 32; j += 8) {
    const int r = r0 + j, c = c0 + tx;
    if (r < rows && c < cols) tile[j][tx] = hop::tf32_rna(src[(size_t)r * cols + c]);
  }
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    if (transpose) {
      const int r = c0 + j, c = r0 + tx;  // dst (cols, rows)
      if (r < cols && c < rows) dst[(size_t)r * rows + c] = tile[tx][j];
    } else {
      const int r = r0 + j, c = c0 + tx;
      if (r < rows && c < cols) dst[(size_t)r * cols + c] = tile[j][tx];
    }
  }
}

__global__ void round_kernel(const float* src, float* dst, long long n) {
  hop::tf32_round_rows(src, dst, n);
}

// The forward attention pass at F frames (F <= 64): o from qkv.
inline cudaError_t attn_forward(const float* qkv, float* o, const PixelRows& pr, int B, int H,
                                cudaStream_t s) {
  const int pairs = B * pr.P * H;
  const float scale = 1.0f / sqrtf((float)kHd);
  return by_frames(pr.F, [&](auto fp) {
    constexpr int FP = decltype(fp)::value;
    using T = AttnTiles<FP>;
    const int smem = T::kPairs * T::kFwd * 4;
    const cudaError_t err = set_smem(attn_kernel<FP>, smem);
    if (err != cudaSuccess) return err;
    attn_kernel<FP><<<(pairs + T::kPairs - 1) / T::kPairs, T::kWarps * 32, smem, s>>>(
        qkv, o, pr, H, pairs, scale);
    return cudaGetLastError();
  });
}

template <int BN, int NS = kGemmStages>
cudaError_t gemm_bn(const float* a, const float* bt, int M, int N, int K, GemmEpilogue ep,
                    cudaStream_t s) {
  using G = Tf32Gemm<BN, NS>;
  if (M <= 0 || N % BN != 0 || K % 32 != 0) return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t err = make_map_2d_f32(&ta, a, M, K, kGemmRows);
  if (err == cudaSuccess) err = make_map_2d_f32(&tb, bt, N, K, BN);
  if (err == cudaSuccess) err = set_smem(gemm_kernel<BN, NS>, G::kSmem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_kernel<BN, NS>,
                                                        G::kThreads, G::kSmem);
  }
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((M + kGemmRows - 1) / kGemmRows) * (N / BN);
  const int grid = (int)std::min<long long>(tiles, (long long)sms * std::max(per_sm, 1));
  gemm_kernel<BN, NS><<<grid, G::kThreads, G::kSmem, s>>>(ta, tb, ep, M, N, K);
  return cudaGetLastError();
}

// The GEMM's tile width for N output columns (N % 64 == 0).
inline int gemm_width(int N) {
  return N % 192 == 0 ? 192 : N % 160 == 0 ? 160 : N % 128 == 0 ? 128 : 64;
}

inline cudaError_t gemm(const float* a, const float* bt, int M, int N, int K, GemmEpilogue ep,
                        cudaStream_t s) {
  switch (gemm_width(N)) {
    case 192: return gemm_bn<192>(a, bt, M, N, K, ep, s);
    case 160: return gemm_bn<160>(a, bt, M, N, K, ep, s);
    case 128: return gemm_bn<128>(a, bt, M, N, K, ep, s);
    default: return gemm_bn<64>(a, bt, M, N, K, ep, s);
  }
}

inline cudaError_t ln(const float* x, const float* scale, const float* bias, float* z,
                      float* stats, int R, int C, float eps, cudaStream_t s) {
  ln_kernel<<<(R + 7) / 8, 256, 0, s>>>(x, scale, bias, z, stats, R, C, eps);
  return cudaGetLastError();
}

inline cudaError_t stage(const void* src, float* dst, int rows, int cols, int transpose,
                         cudaStream_t s) {
  const dim3 grid((cols + 31) / 32, (rows + 31) / 32);
  stage_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(src), dst, rows, cols, transpose);
  return cudaGetLastError();
}

inline size_t align_floats(size_t n) { return (n + 63) / 64 * 64; }  // 256-byte aligned buffers

}  // namespace LVD_PAIR_TF32
}  // namespace lvd
