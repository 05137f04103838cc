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
// L0 instance in bf16). The structure is flash attention's forward: x is Q,
// a chunk of W1 is K, the gate is the softmax, a chunk of W2 is V, and the
// output is O. Every 64-row block streams all 3*C*4C weights (at most 9.8
// MB, L2-resident), 64 operations a weight byte.
//
// bf16 (the `wgmma` form; C = 64..640 step 64, inner % 64 == 0): one block
// per 64 rows, warp-specialised. A producer warp loads the x tile once
// (C/64 swizzled 64-column TMA boxes, rows past R read as zero) and streams
// the weights through a ring of 16 KB stages (up to 8). Per 64-wide inner
// chunk k: C/64 stages of W1, each 64 input rows x [h32 | g32 | h32' |
// g32'] (the two warpgroups' 32-column halves of the chunk, W1h's columns
// beside W1g's: the wrapper passes W1 with its columns interleaved in 32s,
// a copy made per call, ops/geglu_fused.py `interleave_w1`), then the
// stages of W2, each 64 inner rows x two 64-column output blocks, all
// MN-major (N-contiguous). Loading W1 as stored instead, as four 32-column
// boxes a stage under the 64-byte swizzle, measured 8-21% slower on an
// H100 than the kernel and its copy together (PERF.md). The two consumer
// warpgroups:
//  - GEMM1: warpgroup j computes [h | g] for its 32 inner columns of the
//    chunk as one m64n64 product over C (wgmma, A = the x tile K-major, two
//    K-tiles a group), so h and g of an inner column sit in the same
//    thread's registers;
//  - the gate: + b1, gelu (tanh form on tanh.approx, or the exact erf form,
//    LVD_GELU_FORM), h * gelu(g), rounded to bf16 (where lvd_tpu rounds it)
//    and written to a 64 x 64 gated tile in shared memory (8 KB, double
//    buffered), ordered before the products by a proxy fence and a named
//    barrier of both warpgroups;
//  - GEMM2: warpgroup j accumulates output blocks 2i + j from the gated
//    tile and W2's stage, and does not wait for them: the next chunk's
//    GEMM1 issues behind them, so the tensor cores drain once a chunk (for
//    the gate), not twice;
//  - the epilogue adds b2 in fp32, rounds once, and stores 16 bytes a lane
//    through the x tile (free after the last GEMM1).
// With 9 warps a block the SM's four register files cap a thread at 168
// registers, and ptxas does not raise its allocation after setmaxnreg. At
// C >= 448 (C/4 output and 32 [h | g] accumulators a thread would spill,
// and spilled accumulators serialize every wgmma), two blocks share each
// 64-row tile, each writing half of the output blocks and recomputing
// GEMM1, no spills. Both warpgroups issue ceil(NO / 2) GEMM2 blocks (NO:
// the block's output blocks), so an odd NO computes one block that is
// never stored: 16/15 of the needed products at C = 320, 5/3 at 512 and
// about 1.73x at 640. Without the producer warp (up to 255 registers,
// thread 0 issuing the loads) the kernel measured slower at every width.
// Timing variants that skip the weight loads or the products showed that
// the products with their per-stage handoffs and the drain at the gate,
// not the weights' L2 stream, set the pace (PERF.md); sharing each
// weight box between two blocks by TMA multicast measured slower too.
//
// The wrapper's launch plan (ops/geglu_fused.py `launch_plan`: rows a
// block, inner columns a chunk, blocks a row tile) is passed in, and a
// plan the form was not built for is refused.
//
// fp32 at C <= 384 (the `mma_sync` form): the same 64-row blocks and
// chunks on mma.sync m16n8k8 in TF32, operands through a four-stage
// cp.async ring of 32-row weight tiles (rows padded to 136 floats) with
// the x tile resident (rows padded to C + 4 floats): each half of the 8
// warps computes its [h32 | g32] for 16 rows a warp, the gate runs in
// registers in fp32 (not rounded) into a shared 64 x 64 fp32 gated tile,
// and each half accumulates its output blocks (2i + half) from it, A from
// the gated tile. One __syncthreads a stage orders the ring and the gated
// tile. 171 KB of shared memory at C = 320.
//
// fp32 at C >= 448 (the `wmma` form, kept; lvd_tpu's route reaches it only
// with an inner dimension well under 4C): one block per 32-row tile keeps its x rows
// in shared memory and walks the inner dimension in 64-wide chunks: h and g
// from WMMA TF32 products (fp32), the gate in fp32 (not rounded), and the
// chunk multiplied straight into W2, the (32, C) output in registers; the
// weights are read from device memory (L2-resident). 116 KB of shared
// memory at C = 640.
#include "common.cuh"
#include "hopper.cuh"
#include "warp_mma.cuh"

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
geglu_wmma_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
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
cudaError_t launch_wmma(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, int R, int I, int exact, cudaStream_t stream) {
  constexpr int smem = geglu_smem<T, NF>();
  cudaError_t err = set_smem(geglu_wmma_kernel<T, NF>, smem);
  if (err != cudaSuccess) return err;
  geglu_wmma_kernel<T, NF><<<(R + kBM - 1) / kBM, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), R, I, exact);
  return cudaGetLastError();
}

// ---- bf16: TMA weight ring + wgmma ----

template <int NF>
struct WgGeglu {
  static constexpr int BM = 64;                  // rows a block
  static constexpr int kThreads = 2 * 128 + 32;  // consumer warpgroups, then the producer warp
  // Output blocks a block writes: all C/64, or at C >= 448 one half (two
  // blocks on the same rows, each recomputing GEMM1), so that a thread's
  // accumulators fit the 168 registers 9 warps a block leave it.
  static constexpr int kSplit = NF >= 7 ? 2 : 1;
  static constexpr int NO = (NF + kSplit - 1) / kSplit;
  static constexpr int NA = (NO + 1) / 2;        // output blocks of warpgroup 0 (1 has NO / 2)
  static constexpr int kStage = 16384;           // two 64 x 64 bf16 blocks
  static constexpr int kX = NF * 8192;           // the x tile: NF blocks of 64 rows x 64 columns
  static constexpr int kGated = 2 * 8192;        // the gated chunk, double-buffered
  static constexpr int kFixed = kX + kGated + 256 + 1024;  // + barriers, alignment slack
  static constexpr int kFit = (kMaxSmem - kFixed) / kStage;
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static constexpr int kSmem = kStages * kStage + kFixed;
};

template <int NF>
__global__ void __launch_bounds__(WgGeglu<NF>::kThreads, 1)
geglu_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w1,
                   const __grid_constant__ CUtensorMap tm_w2, const bf16* __restrict__ b1,
                   const bf16* __restrict__ b2, bf16* __restrict__ out, int R, int I,
                   int exact) {
  using G = WgGeglu<NF>;
  constexpr int NS = G::kStages;
  constexpr int C = 64 * NF;
  constexpr int U = NF + G::NA;  // stages an inner chunk takes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem;
  bf16* xs = reinterpret_cast<bf16*>(smem + NS * G::kStage);
  bf16* gated = xs + NF * 4096;
  uint64_t* full = reinterpret_cast<uint64_t*>(gated + 2 * 4096);
  uint64_t* empty = full + NS;
  uint64_t* xfull = empty + NS;
  const int r0 = blockIdx.x * G::BM;
  const int o0 = blockIdx.y * G::NO;  // this block's first output block
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
      hop::mbar_expect_tx(xfull, NF * 8192);
      for (int kt = 0; kt < NF; ++kt) hop::tma_load_2d(xs + kt * 4096, &tm_x, xfull, 64 * kt, r0);
      // Stage v (chunk v / U) holds, in its half h, W1 rows 64 j .. of
      // warpgroup h's [h32 | g32] block (the interleaved W1's 64-column block
      // 2 k + h) for j = v % U < NF, else W2 rows of the chunk for output
      // block o0 + 2 (j - NF) + h. The map and coordinates are selected,
      // not branched on: with two load sites under a branch the kernel's
      // UNet launches measured 4-5% slower on an H100 (same registers).
      for (int v = 0; v < nk * U; ++v) {
        const int s = v % NS, k = v / U, j = v % U;
        if (v >= NS) hop::mbar_wait(&empty[s], (v / NS - 1) & 1);
        hop::mbar_expect_tx(&full[s], G::kStage);
        for (int h = 0; h < 2; ++h) {
          void* d = ring + s * G::kStage + h * 8192;
          const CUtensorMap* map = j < NF ? &tm_w1 : &tm_w2;
          const int c0 = j < NF ? 64 * (2 * k + h) : 64 * (o0 + 2 * (j - NF) + h);
          const int c1 = 64 * (j < NF ? j : k);
          hop::tma_load_2d(d, map, &full[s], c0, c1);
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

  // Warpgroup wg computes inner columns 64 k + 32 wg .. + 31 of each chunk
  // and output blocks 2 i + wg.
  const int wg = warp / 4, wq = warp % 4;
  const int r4 = lane / 4, cq = 2 * (lane % 4);
  float acc[G::NA][32];
#pragma unroll
  for (int i = 0; i < G::NA; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
  float hg[32];
  // Stages u.. are consumed in order; `done` is the first not yet released.
  // A stage is released once the wgmma group that read it has completed:
  // after each wait<1>, every stage before the newest group's.
  int u = 0, done = 0;
  auto release_to = [&](int end) {
    for (; done < end; ++done) release(done);
  };
  hop::mbar_wait(xfull, 0);
  for (int k = 0; k < nk; ++k) {
    // GEMM1: [h | g] = x [W1h | W1g] over C, 64 rows x (32 + 32) columns,
    // two K-tiles (stages) a wgmma group. The first group's wait also
    // retires the previous chunk's GEMM2 groups, which ran on the tensor
    // cores while this chunk's first products were issued.
#pragma unroll
    for (int kt = 0; kt < NF; kt += 2) {
      constexpr int kPair = 2;
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
    hop::wgmma_wait<0>();
    hop::fence_regs(hg);
    release_to(u);

    // The gate: column 8 c + cq (+1) of h is hg[4 c (+1)], of g hg[4 (c + 4) (+1)];
    // + 2 for row r4 + 8.
    bf16* gt = gated + (k & 1) * 4096;
    const int i0 = 64 * k + 32 * wg;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 8 * c + cq;
      const float2 bh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + i0 + col));
      const float2 bg =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + I + i0 + col));
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float h0 = hg[4 * c + 2 * hf] + bh.x, h1 = hg[4 * c + 2 * hf + 1] + bh.y;
        const float g0 = hg[4 * (c + 4) + 2 * hf] + bg.x;
        const float g1 = hg[4 * (c + 4) + 2 * hf + 1] + bg.y;
        const int row = 16 * wq + r4 + 8 * hf;
        *reinterpret_cast<uint32_t*>(gt + row * 64 + (((4 * wg + c) ^ r4) * 8) + cq) =
            pack_bf16(h0 * hop::gelu_gate(g0, exact), h1 * hop::gelu_gate(g1, exact));
      }
    }
    hop::fence_proxy_async();
    hop::bar_sync(1, 256);  // both halves of the gated chunk are in place

    // GEMM2: out[:, block o0 + 2 s2 + wg] += gated W2[chunk rows, that block],
    // one group a stage, not waited for here (the next chunk's GEMM1 issues
    // behind it). A block past this block's share (odd counts) reads zeros
    // or another block's weights and is never stored; no branch around the
    // wgmma: a warpgroup-dependent one would serialize them.
#pragma unroll
    for (int s2 = 0; s2 < G::NA; ++s2, ++u) {
      wait_full(u);
      const bf16* Bs = reinterpret_cast<const bf16*>(ring + (u % NS) * G::kStage) + wg * 4096;
      hop::fence_regs(acc[s2]);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_ss_n64_tn(acc[s2], hop::desc_sw128(gt + kk * 16),
                             hop::desc_sw128_mn(Bs + kk * 16 * 64, 8192), 1);
      hop::wgmma_commit();
    }
  }
  hop::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < G::NA; ++i) hop::fence_regs(acc[i]);
  release_to(u);

  // Epilogue through x tile block 2 s2 + wg (both warpgroups passed the
  // last chunk's barrier, so no GEMM1 reads the x tile any more).
  const int valid = NF - o0 < G::NO ? NF - o0 : G::NO;
#pragma unroll
  for (int s2 = 0; s2 < G::NA; ++s2) {
    const int blk = 2 * s2 + wg;
    if (blk < valid)
      hop::store_acc_bf16<1>(acc[s2], xs + blk * 4096, 4096, b2 + 64 * (o0 + blk),
                             out + (size_t)r0 * C + 64 * (o0 + blk), C, R - r0);
  }
}

template <int NF>
cudaError_t launch_wgmma(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, int R, int I, int exact,
                         cudaStream_t stream) {
  using G = WgGeglu<NF>;
  constexpr int C = 64 * NF;
  CUtensorMap tx, tw1, tw2;
  cudaError_t err = make_map_2d(&tx, x, R, C, 64);
  if (err == cudaSuccess) err = make_map_2d(&tw1, w1, C, 2 * I, 64);
  if (err == cudaSuccess) err = make_map_2d(&tw2, w2, I, C, 64);
  if (err == cudaSuccess) err = set_smem(geglu_wgmma_kernel<NF>, G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + G::BM - 1) / G::BM, G::kSplit);
  geglu_wgmma_kernel<NF><<<grid, G::kThreads, G::kSmem, stream>>>(
      tx, tw1, tw2, static_cast<const bf16*>(b1), static_cast<const bf16*>(b2),
      static_cast<bf16*>(out), R, I, exact);
  return cudaGetLastError();
}

// ---- fp32 at C <= 384: mma.sync TF32, cp.async ring ----

template <int NF>
struct F32Geglu {
  static constexpr int BM = 64, kThreads = 256, kStages = 4;
  static constexpr int C = 64 * NF;
  static constexpr int NA = (NF + 1) / 2;
  static constexpr int kLdX = C + 4;     // x tile rows (floats)
  static constexpr int kLdW = 128 + 8;   // weight tile rows (floats)
  static constexpr int kLdG = 64 + 4;    // gated tile rows (floats)
  static constexpr int kStage = 32 * kLdW;  // one 32-row weight tile (floats)
  static constexpr int U = C / 32 + 2 * NA;  // stages an inner chunk takes
  static constexpr int kSmem = (BM * kLdX + kStages * kStage + BM * kLdG) * 4;
};

template <int NF>
__global__ void __launch_bounds__(F32Geglu<NF>::kThreads, 1)
geglu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ out, int R, int I, int exact) {
  using G = F32Geglu<NF>;
  using M = wm::WarpMma<float>;
  constexpr int C = G::C, NS = G::kStages, U = G::U, KT = C / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ring = xs + G::BM * G::kLdX;
  float* gs = ring + NS * G::kStage;
  const int r0 = blockIdx.x * G::BM;
  const int total = (I / 64) * U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wr = warp % 4;  // inner half / output-block parity; rows 16 wr ..
  const int g = lane / 4, t = lane % 4;

  // Stage v (chunk v / U): for j = v % U < C/32 the interleaved W1 rows
  // 32 j .. x the chunk's 128 columns (both halves' [h32 | g32]); else W2
  // rows 64 k + 32 (j' % 2) .. x output blocks 2 (j' / 2) and + 1,
  // j' = j - C/32 (columns past C read as zero).
  auto load = [&](int v) {
    float* st = ring + (v % NS) * G::kStage;
    const int k = v / U, j = v % U;
    for (int e = threadIdx.x; e < 32 * 32; e += G::kThreads) {
      const int r = e / 32, cv = e % 32;
      const float* src;
      bool ok = true;
      if (j < KT) {
        src = w1 + (size_t)(32 * j + r) * (2 * I) + 128 * k + cv * 4;
      } else {
        const int jj = j - KT, col = 64 * 2 * (jj / 2) + cv * 4;
        ok = col < C;
        src = w2 + (size_t)(64 * k + 32 * (jj % 2) + r) * C + (ok ? col : 0);
      }
      wm::cp_async16(st + r * G::kLdW + cv * 4, src, ok);
    }
  };
  for (int e = threadIdx.x; e < G::BM * (C / 4); e += G::kThreads) {
    const int r = e / (C / 4), cv = e % (C / 4);
    const bool ok = r0 + r < R;
    wm::cp_async16(xs + r * G::kLdX + cv * 4, x + (ok ? (size_t)(r0 + r) * C + cv * 4 : 0), ok);
  }
#pragma unroll
  for (int v = 0; v < NS - 1; ++v) {
    if (v < total) load(v);
    wm::cp_async_commit();
  }

  float hg[8][4];
  float acc[G::NA][8][4] = {};
  const float* xw = xs + (16 * wr) * G::kLdX;
  const float* gw = gs + (16 * wr) * G::kLdG;
  for (int v = 0; v < total; ++v) {
    wm::cp_async_wait<NS - 2>();
    __syncthreads();  // stage v (and the gated tile's writes) visible; stage v - 1 free
    if (v + NS - 1 < total) load(v + NS - 1);
    wm::cp_async_commit();
    const float* st = ring + (v % NS) * G::kStage;
    const int k = v / U, j = v % U;
    if (j < KT) {  // GEMM1: [h | g] over input rows 32 j ..
      if (j == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) hg[nt][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < 32; kk += 8) {
        uint32_t a[4];
        M::load_a(a, xw + 32 * j + kk, G::kLdX, lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b0[2], b1[2];
          M::load_b_rows(b0, b1, st + kk * G::kLdW + 64 * wg + 16 * np, G::kLdW, lane);
          M::mma(hg[2 * np], a, b0);
          M::mma(hg[2 * np + 1], a, b1);
        }
      }
      if (j == KT - 1) {
        // The gate: column 8 nt + 2t (+1) of h is hg[nt][0 (1)], of g
        // hg[nt + 4][...]; [2], [3] for row g + 8.
        const int i0 = 64 * k + 32 * wg;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = 8 * nt + 2 * t;
          const float bh0 = b1[i0 + col], bh1 = b1[i0 + col + 1];
          const float bg0 = b1[I + i0 + col], bg1 = b1[I + i0 + col + 1];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float h0 = hg[nt][2 * hf] + bh0, h1 = hg[nt][2 * hf + 1] + bh1;
            const float g0 = hg[nt + 4][2 * hf] + bg0, g1 = hg[nt + 4][2 * hf + 1] + bg1;
            M::store2(gs + (16 * wr + g + 8 * hf) * G::kLdG + 32 * wg + col, h0 * gelu(g0, exact),
                      h1 * gelu(g1, exact));
          }
        }
      }
    } else {  // GEMM2: inner rows 32 (jj % 2) .. of output blocks 2 (jj / 2) + wg
      const int jj = j - KT, s2 = jj / 2, h = jj % 2;
#pragma unroll
      for (int i = 0; i < G::NA; ++i) {
        if (i == s2) {
#pragma unroll
          for (int kk = 0; kk < 32; kk += 8) {
            uint32_t a[4];
            M::load_a(a, gw + 32 * h + kk, G::kLdG, lane);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              uint32_t b0[2], b1[2];
              M::load_b_rows(b0, b1, st + kk * G::kLdW + 64 * wg + 16 * np, G::kLdW, lane);
              M::mma(acc[i][2 * np], a, b0);
              M::mma(acc[i][2 * np + 1], a, b1);
            }
          }
        }
      }
    }
  }
  wm::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < G::NA; ++i) {
    const int blk = 2 * i + wg;
    if (blk >= NF) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + 16 * wr + g + 8 * hf;
      if (row >= R) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = 64 * blk + 8 * nt + 2 * t;
        M::store2(out + (size_t)row * C + col, acc[i][nt][2 * hf] + b2[col],
                  acc[i][nt][2 * hf + 1] + b2[col + 1]);
      }
    }
  }
}

template <int NF>
cudaError_t launch_f32(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int R, int I, int exact, cudaStream_t stream) {
  using G = F32Geglu<NF>;
  cudaError_t err = set_smem(geglu_f32_kernel<NF>, G::kSmem);
  if (err != cudaSuccess) return err;
  geglu_f32_kernel<NF><<<(R + G::BM - 1) / G::BM, G::kThreads, G::kSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out), R,
      I, exact);
  return cudaGetLastError();
}

// Whether the launch plan (rows a block, inner columns a chunk, blocks on
// one row tile) is the one this width's form was built for.
template <int NF>
bool plan_fits(int form, int row_block, int inner_chunk, int split) {
  if (inner_chunk != kBI) return false;  // every form walks the inner dim in 64s
  if (form == 1) return row_block == WgGeglu<NF>::BM && split == WgGeglu<NF>::kSplit;
  if (form == 2) return NF <= 6 && row_block == F32Geglu<(NF <= 6 ? NF : 6)>::BM && split == 1;
  return row_block == kBM && split == 1;
}

// One width: the wgmma form (form 1, bf16), the mma_sync form (form 2,
// fp32, C <= 384) or the WMMA form (form 0, fp32).
template <int NF>
cudaError_t launch_width(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, int R, int I, int exact, int form,
                         int row_block, int inner_chunk, int split, cudaStream_t s) {
  if (!plan_fits<NF>(form, row_block, inner_chunk, split)) return cudaErrorInvalidValue;
  if (form == 0) return launch_wmma<float, NF>(x, w1, b1, w2, b2, out, R, I, exact, s);
  if (form == 2) {
    if constexpr (NF <= 6) {
      return launch_f32<NF>(x, w1, b1, w2, b2, out, R, I, exact, s);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return launch_wgmma<NF>(x, w1, b1, w2, b2, out, R, I, exact, s);
}

cudaError_t launch_c(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* out, int R, int C, int I, int exact, int form,
                     int row_block, int inner_chunk, int split, cudaStream_t s) {
#define LVD_WIDTH(nf) \
  launch_width<nf>(x, w1, b1, w2, b2, out, R, I, exact, form, row_block, inner_chunk, split, s)
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

template <int NF>
long long smem_width(int form) {
  if (form == 1) return WgGeglu<NF>::kSmem;
  if (form == 2) return NF <= 6 ? F32Geglu<(NF <= 6 ? NF : 6)>::kSmem : 0;
  return geglu_smem<float, NF>();
}

long long smem_c(int C, int form) {
  switch (C / 64) {
    case 1: return smem_width<1>(form);
    case 2: return smem_width<2>(form);
    case 3: return smem_width<3>(form);
    case 4: return smem_width<4>(form);
    case 5: return smem_width<5>(form);
    case 6: return smem_width<6>(form);
    case 7: return smem_width<7>(form);
    case 8: return smem_width<8>(form);
    case 9: return smem_width<9>(form);
    default: return smem_width<10>(form);
  }
}

}  // namespace
}  // namespace lvd

// x: (R, C), b1: (2I,), w2: (I, C), b2: (C,), out: (R, C); all of one type
// (dtype 0 bf16, 1 fp32). C in {64, 128, ..., 640}, I % 64 == 0. form 1 is
// the wgmma form (bf16) and form 2 the mma_sync form (fp32, C <= 384),
// whose w1 (C, 2I) holds W1h's and W1g's columns interleaved in 32s ([h
// 0..31 | g 0..31 | h 32..63 | ...]); form 0 the WMMA form (fp32), whose w1
// is [W1h | W1g]. row_block, inner_chunk and split are the wrapper's launch
// plan; one the form was not built for is refused.
LVD_EXPORT int lvd_geglu(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, int R, int C, int I, int exact, int form,
                         int row_block, int inner_chunk, int split, int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (C % 64 != 0 || C < 64 || C > 640 || I % kBI != 0 || I <= 0 || R <= 0 ||
      dtype != (form == 1 ? kBF16 : kF32) || form < 0 || form > 2 || (form == 2 && C > 384))
    return cudaErrorInvalidValue;
  return launch_c(x, w1, b1, w2, b2, out, R, C, I, exact, form, row_block, inner_chunk, split,
                  static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory one block of kernel C takes at width C:
// the wgmma form (form 1, bf16), the mma_sync form (form 2, fp32) or the
// WMMA form (form 0, fp32); 0 for arguments the kernel does not take.
LVD_EXPORT long long lvd_geglu_smem(int form, int C, int dtype) {
  using namespace lvd;
  if (C % 64 != 0 || C < 64 || C > 640 || form < 0 || form > 2 ||
      dtype != (form == 1 ? kBF16 : kF32))
    return 0;
  return smem_c(C, form);
}
