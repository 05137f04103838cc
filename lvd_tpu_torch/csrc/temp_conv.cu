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
// The output rows of a block are ordered (frame, pixel) over all F frames of
// its pixel tile, so with z stored for frames -1..F in the same order the
// three taps are the same z tile read at row offsets 0, BP and 2 BP (the
// observation behind lvd_tpu's `_kernel_rowshift`). The conv is rounded to
// the stream's type, then the bias is added, as the plain version does.
//
// Frame groups: the F output frames are split into ceil(F / 32) groups of
// G = ceil(F / groups) frames (G <= 32: at most four m64 tiles of
// accumulators in registers). A block computes one group; its window holds
// frames f0 - 1 .. f0 + G of the group starting at f0, so a group's prologue
// repeats only on the two halo frames its neighbours also hold. Frames
// outside [0, F) are zero in the window and never receive the prologue.
// Channels: any C % 8 == 0. The last input chunk reads zeros past C (TMA's
// fill, cp.async's zero-fill), the weight slices are zero past C on both
// axes, and the last 64-column output tile stores only its columns < C.
//
// bf16 (the `wgmma` form): warp-specialised, one block per (64 output
// channels, frame group, two 8-pixel tiles, batch); any P. One producer
// warp loads, per 64-channel chunk of the input, each pixel tile's window
// with one TMA box of a 4-D map over x (C, P, F, B): 64 channels x 8 pixels
// x G + 2 frames from frame f0 - 1, laid down as rows (frame, pixel) of 128
// bytes under the 128-byte swizzle, frames outside [0, F), pixels past P and
// channels past C read as zero; and the chunk's three (64 in, 64 out) tap
// slices of w through a 3-D map (C out, C in, 3 taps), MN-major, zero past
// C, into the same stage of a two-stage ring. With 8 pixels a frame
// is exactly one 8-row, 1024-byte swizzle atom, so tap k's A operand for
// m64 tile t is the canonical descriptor at window row 64 t + 8 k: wgmma
// reads the taps straight from the one window, no shifted copies. Each of
// the two consumer warpgroups owns one pixel tile (F * 8 rows, padded to
// m64 tiles whose extra rows are never stored) and keeps its m64 x 64
// accumulators in registers (G <= 32: at most four tiles). The prologue
// z = silu(x*a + b) runs in place on the rows of frames inside [0, F) (fp32, one
// tanh.approx a value, rounded to bf16), each thread on one 16-byte chunk
// column, so its channels and (a, b) are fixed for the chunk; it is
// ordered before the products by a proxy fence and the warpgroup's named
// barrier, and chunk c+1's prologue runs while chunk c's products are in
// flight. The epilogue stages the rounded accumulators through the
// warpgroup's own window and stores 16 bytes a lane; pixels past P and
// frames past F are not stored. Output-channel tiles are the fastest grid
// index, so the C/64 blocks that read one window run together and x comes
// from device memory once. At L3 (P = 45, C = 1280, B = 2, F = 24) the grid
// is 20 x 3 x 2 = 120 blocks, under one wave of 132 SMs (one block a SM:
// 156 KB of shared memory at G = 24).
//
// fp32 (the `mma_sync` form): the same blocks and windows, 16 input
// channels a chunk (rows padded to 80 bytes), loaded with the chunk's three
// (16, 64) weight slices through a two-stage cp.async ring (zero-filled for
// frames outside [0, F), pixels past P and channels past C); the prologue
// runs in place in fp32
// (not rounded), then eight warps (four a pixel tile, each 16 m_tiles rows
// x 64 channels) run mma.sync m16n8k8 in TF32, tap k's A fragments read
// from window rows r + 8 k. 94 KB of shared memory at G = 24.

#include "common.cuh"
#include "hopper.cuh"
#include "warp_mma.cuh"

namespace lvd {
namespace {

// ---- bf16: frame-window implicit GEMM on wgmma ----

struct WgTc {
  static constexpr int kTiles = 2;  // 8-pixel tiles a block: one consumer warpgroup each
  // Pixels of a window (a frame is then one 8-row, 1024-byte swizzle
  // atom) and the frame its first rows hold; the fp32 form shares both.
  static constexpr int kPixels = 8, kStartFrame = -1;
  static constexpr int kThreads = kTiles * 128 + 32;
  static constexpr int kWBytes = 3 * 64 * 64 * 2;  // a chunk's three tap slices
  __host__ __device__ static int m_tiles(int F) { return (kPixels * F + 63) / 64; }
  // A window's rows: the m64 tiles and the two frames the taps reach past
  // them (8 F + 16 of them come from TMA; the rest only feed rows never
  // stored).
  __host__ __device__ static int win_rows(int F) { return 64 * m_tiles(F) + 2 * kPixels; }
  __host__ __device__ static int win_bytes(int F) { return win_rows(F) * 128; }
  __host__ __device__ static int stage_bytes(int F) { return kTiles * win_bytes(F) + kWBytes; }
  // Two stages, four barriers, and slack to align the start to 1024.
  __host__ __device__ static int smem(int F) { return 2 * stage_bytes(F) + 64 + 1024; }
};

template <int N>
__device__ __forceinline__ void fence_tiles(float (&acc)[N][32]) {
#pragma unroll
  for (int t = 0; t < N; ++t) hop::fence_regs(acc[t]);
}

__global__ void __launch_bounds__(WgTc::kThreads, 1)
temp_conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ a,
                       const float* __restrict__ bsh, const bf16* __restrict__ bias,
                       bf16* __restrict__ out, int F, int P, int C, int G) {
  using W = WgTc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int Mt = W::m_tiles(G);
  const int win_bytes = W::win_bytes(G);
  const int stage_bytes = W::stage_bytes(G);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * stage_bytes);
  uint64_t* empty = full + 2;
  const int ct = (C + 63) / 64;  // output-channel tiles, the fastest grid index
  const int n0 = (blockIdx.x % ct) * 64, f0 = (blockIdx.x / ct) * G;
  const int tile0 = blockIdx.y * W::kTiles, b = blockIdx.z;
  const int nc = (C + 63) / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 4 * W::kTiles);  // one arrival per consumer warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * W::kTiles) {  // the producer: one lane issues every TMA load
    if (lane == 0) {
      const uint32_t bytes = W::kTiles * (G + 2) * 8 * 128 + W::kWBytes;
      for (int cc = 0; cc < nc; ++cc) {
        const int s = cc & 1;
        if (cc >= 2) hop::mbar_wait(&empty[s], ((cc >> 1) - 1) & 1);
        hop::mbar_expect_tx(&full[s], bytes);
        unsigned char* st = smem + s * stage_bytes;
        for (int t = 0; t < W::kTiles; ++t)
          hop::tma_load_4d(st + t * win_bytes, &tm_x, &full[s], cc * 64, (tile0 + t) * W::kPixels,
                           f0 + W::kStartFrame, b);
        for (int k = 0; k < 3; ++k)
          hop::tma_load_3d(st + W::kTiles * win_bytes + k * 8192, &tm_w, &full[s], n0, cc * 64,
                           k);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns pixel tile tile0 + wg. For the prologue,
  // thread tid takes the 16-byte chunk column pc of rows 8 + rr, 24 + rr,
  // ...: every such row is pixel rr % 8 and holds, under the swizzle,
  // channels 8 (pc ^ (rr % 8)) .. + 7 of the chunk.
  const int wg = warp / 4, wq = warp % 4, tid = threadIdx.x % 128;
  const int p0 = (tile0 + wg) * 8;
  const int pc = tid & 7, rr = tid >> 3, pix = rr & 7;
  const bool pix_ok = p0 + pix < P;
  // Window rows of frames inside [0, F): window frame j (row 8 j + pixel)
  // is frame f0 - 1 + j.
  const int row_lo = 8 * max(0, 1 - f0), row_hi = 8 * min(G + 2, F + 1 - f0);
  const float* ab = a + (size_t)b * C;
  const float* bb = bsh + (size_t)b * C;

  auto window = [&](int cc) { return smem + (cc & 1) * stage_bytes + wg * win_bytes; };
  auto prologue = [&](int cc) {
    const int ch = cc * 64 + ((pc ^ pix) * 8);
    if (pix_ok && ch < C) {  // channels past C stay zero
      float ah[8], bh[8];  // halved: silu(v) = h + h tanh(h), h = v / 2
#pragma unroll
      for (int j = 0; j < 8; j += 4) {
        const float4 av = *reinterpret_cast<const float4*>(ab + ch + j);
        const float4 bv = *reinterpret_cast<const float4*>(bb + ch + j);
        const float as[4] = {av.x, av.y, av.z, av.w}, bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[j + i] = 0.5f * as[i];
          bh[j + i] = 0.5f * bs[i];
        }
      }
      unsigned char* win = window(cc);
      for (int r = row_lo + rr; r < row_hi; r += 16) {
        uint4* slot = reinterpret_cast<uint4*>(win + r * 128 + pc * 16);
        uint4 v = *slot;
        uint32_t* pr = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pr[j]));
          const float h0 = fmaf(xv.x, ah[2 * j], bh[2 * j]);
          const float h1 = fmaf(xv.y, ah[2 * j + 1], bh[2 * j + 1]);
          pr[j] = pack_bf16(fmaf(h0, hop::tanh_approx(h0), h0), fmaf(h1, hop::tanh_approx(h1), h1));
        }
        *slot = v;
      }
    }
    hop::fence_proxy_async();  // the z writes, before the products read them
  };

  float acc[4][32];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[t][e] = 0.f;

  hop::mbar_wait(&full[0], 0);
  prologue(0);
  hop::bar_sync(1 + wg, 128);
  for (int cc = 0; cc < nc; ++cc) {
    const int s = cc & 1;
    const bf16* win = reinterpret_cast<const bf16*>(window(cc));
    const bf16* ws = reinterpret_cast<const bf16*>(smem + s * stage_bytes + W::kTiles * win_bytes);
    fence_tiles(acc);
    hop::wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t < Mt) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hop::wgmma_ss_n64_tn(acc[t], hop::desc_sw128(win + (64 * t + 8 * k) * 64 + kk * 16),
                                 hop::desc_sw128_mn(ws + k * 4096 + kk * 16 * 64, 8192), 1);
      }
    }
    hop::wgmma_commit();
    if (cc + 1 < nc) {  // the next chunk's prologue under this chunk's products
      hop::mbar_wait(&full[s ^ 1], ((cc + 1) >> 1) & 1);
      prologue(cc + 1);
    }
    hop::wgmma_wait<0>();
    fence_tiles(acc);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
    if (cc + 1 < nc) hop::bar_sync(1 + wg, 128);  // the next window is z
  }

  // Epilogue: the accumulators rounded to bf16, staged through this
  // warpgroup's window of the last stage (m64 tile t at 8 KB t, chunk c of
  // row r at c ^ (r % 8)); each warp stages and stores only its own 16 rows
  // of each tile. Output row r (over the tiles) is frame f0 + r / 8 of
  // pixel p0 + r % 8; columns past C are not stored.
  bf16* stage = reinterpret_cast<bf16*>(window(nc - 1));
  const int r4 = lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t < Mt) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        bf16* st = stage + t * 4096 + (wq * 16) * 64 + ((c ^ r4) * 8) + cq;
        *reinterpret_cast<uint32_t*>(st + r4 * 64) = pack_bf16(acc[t][4 * c], acc[t][4 * c + 1]);
        *reinterpret_cast<uint32_t*>(st + (r4 + 8) * 64) =
            pack_bf16(acc[t][4 * c + 2], acc[t][4 * c + 3]);
      }
    }
  }
  __syncwarp();
  for (int t = 0; t < Mt; ++t) {
    for (int i = lane; i < 16 * 8; i += 32) {
      const int ro = i / 8, c = i % 8;
      const int row = 64 * t + 16 * wq + ro;
      const int f = f0 + (row >> 3), p = row & 7;
      if ((row >> 3) >= G || f >= F || p0 + p >= P || n0 + c * 8 >= C) continue;
      uint4 v = *reinterpret_cast<const uint4*>(stage + t * 4096 + (16 * wq + ro) * 64 +
                                                ((c ^ (ro & 7)) * 8));
      const uint4 bv = *reinterpret_cast<const uint4*>(bias + n0 + c * 8);
      uint32_t* pr = reinterpret_cast<uint32_t*>(&v);
      const uint32_t* pb = reinterpret_cast<const uint32_t*>(&bv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 yv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pr[j]));
        const float2 bq = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pb[j]));
        pr[j] = pack_bf16(yv.x + bq.x, yv.y + bq.y);
      }
      *reinterpret_cast<uint4*>(out + (((size_t)b * F + f) * P + p0 + p) * C + n0 + c * 8) = v;
    }
  }
}

cudaError_t launch_wgmma(const void* x, const void* a, const void* b, const void* w,
                         const void* bias, void* out, int B, int F, int P, int C, int G,
                         const dim3& grid, cudaStream_t stream) {
  using W = WgTc;
  // x (B, F, P, C) as dims (C, P, F, B); one box: 64 channels x 8 pixels x
  // G + 2 frames x 1 batch. w (3, C, C) as dims (C out, C in, 3 taps), one
  // box a tap slice of 64 x 64. C % 8 == 0 makes every row stride a
  // multiple of 16 bytes, as TMA asks.
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)P, (cuuint64_t)F, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)P * C * 2,
                                 (cuuint64_t)F * P * C * 2};
  const cuuint32_t box[4] = {64, W::kPixels, (cuuint32_t)G + 2, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)C, (cuuint64_t)C, 3};
  const cuuint64_t wstrides[2] = {(cuuint64_t)C * 2, (cuuint64_t)C * C * 2};
  const cuuint32_t wbox[3] = {64, 64, 1};
  CUtensorMap tx, tw;
  cudaError_t err = make_map(&tx, x, 4, dims, strides, box);
  if (err == cudaSuccess) err = make_map(&tw, w, 3, wdims, wstrides, wbox);
  const int smem = W::smem(G);
  if (err == cudaSuccess) err = set_smem(temp_conv_wgmma_kernel, smem);
  if (err != cudaSuccess) return err;
  temp_conv_wgmma_kernel<<<grid, W::kThreads, smem, stream>>>(
      tx, tw, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), F, P, C, G);
  return cudaGetLastError();
}

// ---- fp32: the frame windows on mma.sync TF32, cp.async ring ----

struct F32Tc {
  static constexpr int kTiles = 2;       // 8-pixel tiles a block
  static constexpr int BK = 16;          // input channels a chunk
  static constexpr int kThreads = 256;   // 8 warps: four a pixel tile
  static constexpr int kLdWin = BK + 4;  // window rows (floats): 16 bytes of padding
  static constexpr int kLdB = 64 + 8;    // weight rows (floats)
  static constexpr int kBTile = 3 * BK * kLdB;
  __host__ __device__ static int stage(int F) {  // floats
    return kTiles * WgTc::win_rows(F) * kLdWin + kBTile;
  }
  __host__ __device__ static int smem(int F) { return 2 * stage(F) * 4; }
};

__global__ void __launch_bounds__(F32Tc::kThreads, 1)
temp_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ bsh, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out, int F, int P,
                     int C, int G) {
  using T = F32Tc;
  using M = wm::WarpMma<float>;
  constexpr int BK = T::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int Mt = WgTc::m_tiles(G), wrows = WgTc::win_rows(G), stage_f = T::stage(G);
  const int loaded = 8 * (G + 2);  // window rows of frames f0 - 1 .. f0 + G
  const int ct = (C + 63) / 64;
  const int n0 = (blockIdx.x % ct) * 64, f0 = (blockIdx.x / ct) * G;
  const int tile0 = blockIdx.y * T::kTiles, b = blockIdx.z;
  const int nc = (C + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tl = warp / 4, wq = warp % 4;  // pixel tile; rows 16 Mt wq .. of its 64 Mt
  const int g = lane / 4, t = lane % 4;
  const float* ab = a + (size_t)b * C;
  const float* bb = bsh + (size_t)b * C;

  // Window row r of tile q is frame f0 + r / 8 - 1, pixel (tile0 + q) * 8 +
  // r % 8. Four channels a copy: with C % 8 == 0 a copy lies wholly inside
  // or wholly past C.
  auto load = [&](int st, int cc) {
    float* win = ring + st * stage_f;
    float* Bs = win + T::kTiles * wrows * T::kLdWin;
    for (int e = threadIdx.x; e < T::kTiles * loaded * (BK / 4); e += T::kThreads) {
      const int rr = e / (BK / 4), cv = e % (BK / 4);
      const int q = rr / loaded, r = rr % loaded;
      const int f = f0 + r / 8 - 1, p = (tile0 + q) * 8 + r % 8, ch = cc * BK + cv * 4;
      const bool ok = f >= 0 && f < F && p < P && ch < C;
      wm::cp_async16(win + (q * wrows + r) * T::kLdWin + cv * 4,
                     x + (ok ? (((size_t)b * F + f) * P + p) * C + ch : 0), ok);
    }
    for (int e = threadIdx.x; e < 3 * BK * 16; e += T::kThreads) {
      const int row = e / 16, cv = e % 16;  // row = tap * BK + input channel
      const int ci = cc * BK + row % BK, co = n0 + cv * 4;
      const bool ok = ci < C && co < C;
      wm::cp_async16(Bs + row * T::kLdB + cv * 4,
                     w + (ok ? ((size_t)(row / BK) * C + ci) * C + co : 0), ok);
    }
  };

  load(0, 0);
  wm::cp_async_commit();
  float acc[4][8][4] = {};
  for (int cc = 0; cc < nc; ++cc) {
    if (cc + 1 < nc) load((cc + 1) & 1, cc + 1);
    wm::cp_async_commit();
    wm::cp_async_wait<1>();
    __syncthreads();  // chunk cc landed for every thread
    float* win = ring + (cc & 1) * stage_f;
    const float* Bs = win + T::kTiles * wrows * T::kLdWin;
    {
      // z = silu(x * a + b) in place on the rows of frames inside [0, F),
      // pixels inside P and channels inside C: thread e takes channels
      // 4 (e % 4) .. + 3 of rows e / 4, e / 4 + 64, ...
      const int ch = cc * BK + 4 * (threadIdx.x % 4);
      const bool ch_ok = ch < C;
      const float4 av = ch_ok ? *reinterpret_cast<const float4*>(ab + ch) : float4{};
      const float4 bv = ch_ok ? *reinterpret_cast<const float4*>(bb + ch) : float4{};
      for (int rr = threadIdx.x / 4; ch_ok && rr < T::kTiles * loaded; rr += T::kThreads / 4) {
        const int q = rr / loaded, r = rr % loaded;
        const int f = f0 + r / 8 - 1, p = (tile0 + q) * 8 + r % 8;
        if (f < 0 || f >= F || p >= P) continue;
        float4* slot = reinterpret_cast<float4*>(win + (q * wrows + r) * T::kLdWin +
                                                 4 * (threadIdx.x % 4));
        float4 v = *slot;
        v.x = v.x * av.x + bv.x;
        v.y = v.y * av.y + bv.y;
        v.z = v.z * av.z + bv.z;
        v.w = v.w * av.w + bv.w;
        v.x = __fdividef(v.x, 1.f + expf(-v.x));
        v.y = __fdividef(v.y, 1.f + expf(-v.y));
        v.z = __fdividef(v.z, 1.f + expf(-v.z));
        v.w = __fdividef(v.w, 1.f + expf(-v.w));
        *slot = v;
      }
    }
    __syncthreads();
    const float* tw = win + tl * wrows * T::kLdWin;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt < Mt) {
            const float* rp = tw + (16 * (Mt * wq + mt) + 8 * k + g) * T::kLdWin + kk + t;
            af[mt][0] = wm::tf32(rp[0]);
            af[mt][1] = wm::tf32(rp[8 * T::kLdWin]);
            af[mt][2] = wm::tf32(rp[4]);
            af[mt][3] = wm::tf32(rp[8 * T::kLdWin + 4]);
          }
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b0[2], b1[2];
          M::load_b_rows(b0, b1, Bs + (k * BK + kk) * T::kLdB + 16 * np, T::kLdB, lane);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            if (mt < Mt) {
              M::mma(acc[mt][2 * np], af[mt], b0);
              M::mma(acc[mt][2 * np + 1], af[mt], b1);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is reloaded
  }

  // Output row r of the tile (rows 16 (Mt wq + mt) + g, + 8) is frame
  // f0 + r / 8 of pixel p0 + r % 8; columns past C are not stored.
  const int p0 = (tile0 + tl) * 8;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (mt >= Mt) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = 16 * (Mt * wq + mt) + g + 8 * hf;
      const int f = f0 + row / 8, p = p0 + row % 8;
      if (row / 8 >= G || f >= F || p >= P) continue;
      float* orow = out + (((size_t)b * F + f) * P + p) * C + n0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = 8 * nt + 2 * t;
        if (n0 + col >= C) continue;
        M::store2(orow + col, acc[mt][nt][2 * hf] + bias[n0 + col],
                  acc[mt][nt][2 * hf + 1] + bias[n0 + col + 1]);
      }
    }
  }
}

cudaError_t launch_f32(const void* x, const void* a, const void* b, const void* w,
                       const void* bias, void* out, int B, int F, int P, int C, int G,
                       const dim3& grid, cudaStream_t stream) {
  using T = F32Tc;
  const int smem = T::smem(G);
  cudaError_t err = set_smem(temp_conv_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  temp_conv_f32_kernel<<<grid, T::kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<float*>(out), F,
      P, C, G);
  return cudaGetLastError();
}

// The plan's frame groups: ceil(F / 32) groups of G = ceil(F / groups)
// frames.
int plan_groups(int F) { return (F + 31) / 32; }
int plan_group(int F) { return (F + plan_groups(F) - 1) / plan_groups(F); }

}  // namespace
}  // namespace lvd

// x/out: (B, F, P, C) and w: (3, C, C) [tap][in][out], bias: (C,), all of one
// type (dtype 0 bf16: form 1, the wgmma form; 1 fp32: form 2, the mma_sync
// form); a, b: (B, C) fp32. C % 8 == 0, any F and P. pixel_tile,
// start_frame, frame_group, frame_groups, m_tiles and window_rows are the
// wrapper's launch plan (pixels a window, its first frame relative to its
// group's, the frames of a group and the groups, the m64 tiles of a
// group's output rows, a window's rows); one the kernel was not built for
// is refused.
LVD_EXPORT int lvd_temp_conv(const void* x, const void* a, const void* b, const void* w,
                             const void* bias, void* out, int B, int F, int P, int C, int form,
                             int pixel_tile, int start_frame, int frame_group, int groups,
                             int m_tiles, int window_rows, int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (C % 8 != 0 || C <= 0 || F <= 0 || P <= 0 || B <= 0 ||
      form != (dtype == kBF16 ? 1 : 2) || pixel_tile != WgTc::kPixels ||
      start_frame != WgTc::kStartFrame || frame_group != plan_group(F) ||
      groups != plan_groups(F) || m_tiles != WgTc::m_tiles(frame_group) ||
      window_rows != WgTc::win_rows(frame_group))
    return cudaErrorInvalidValue;
  const long long gx = (long long)((C + 63) / 64) * groups;
  const long long gy = ((P + 7) / 8 + WgTc::kTiles - 1) / WgTc::kTiles;
  if (gx >= (1LL << 31) || gy > 65535 || B > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy, B);
  auto s = static_cast<cudaStream_t>(stream);
  const int G = frame_group;
  if (dtype == kBF16) return launch_wgmma(x, a, b, w, bias, out, B, F, P, C, G, grid, s);
  if (dtype == kF32) return launch_f32(x, a, b, w, bias, out, B, F, P, C, G, grid, s);
  return cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one block of kernel D takes at G frames a
// group (dtype 0 bf16: the wgmma form; 1 fp32: the mma_sync form); 0 for
// arguments the kernel does not take.
LVD_EXPORT long long lvd_temp_conv_smem(int G, int dtype) {
  using namespace lvd;
  if (G <= 0 || G > 32) return 0;
  if (dtype == kBF16) return WgTc::smem(G);
  return dtype == kF32 ? F32Tc::smem(G) : 0;
}
