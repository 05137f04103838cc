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
// memory between the norm and the conv.
//
// Cin and Cout multiples of 64 (every UNet conv and every conv3x3() shape):
// the halo-window form. The M dimension is the N*H*W pixels flattened over
// the frames, so a tile of 128 pixels may span two frames and a 45- or
// 180-pixel plane pads nothing. For each 64-channel chunk of Cin a block
// holds one window of the input: the rows [p0 - W - 1, p0 + 128 + W + 1) of
// the flattened (N*H*W, Cin) tensor, which hold every pixel any of the 9
// taps of its 128 pixels reads, so each pixel is read once per chunk and
// per output-channel tile (lvd_tpu's halo row windows, flattened). With the
// prologue, z = silu(x*a + b) is computed once per window element in fp32
// with the (a, b) of that row's frame and rounded to the tensor's type, as
// lvd_tpu's z scratch holds it (one exp per element per chunk, where a
// per-tap gather would take 9). Tap (dy, dx) of pixel p reads window row
// p - p0 + (dy+1)*W + (dx+1); it is valid only when 0 <= y+dy < H and
// 0 <= x+dx < W, and an invalid tap (an H edge, a W edge that would wrap to
// the neighbouring row of the flattened plane, a frame boundary) reads a
// row of zeros: SAME padding zeroes z, never silu(b).
//  - bf16: warp-specialised wgmma, one block per (128-pixel, BN-channel)
//    output tile (not persistent). One producer warp loads each window with
//    TMA (a 2-D map over (N*H*W, Cin); rows outside the tensor, negative
//    included, read as zero; one box of up to 256 rows, or two) into a
//    double buffer, and each tap's (64 Cin, BN) weight slice, MN-major,
//    into a four-stage ring. Two consumer warpgroups own 64 pixels each.
//    The shifted window is not a canonical wgmma tile, so the A operand
//    goes through registers: each lane hands ldmatrix x4 the address of
//    its own (pixel, tap) row (the 16-byte chunk XORed with row % 8 under
//    the 128-byte swizzle), or of the zero row, and the fragment is the
//    register A of wgmma m64nBNk16 (BN = 128 where Cout % 128 == 0, else
//    64). The next tap's fragments load while the current tap's products
//    run. The epilogue adds the bias in fp32, rounds once and stores 16
//    bytes a lane through shared memory.
//  - fp32 (TF32): the same windows, 16 channels a chunk, with the chunk's
//    9 weight slices, through a two-stage cp.async ring; eight warps of
//    mma.sync m16n8k8 (each 32 pixels x 32 channels of a 128 x 64 tile),
//    A fragments read from the lane's (pixel, tap) rows.
//
// Other widths (Cin or Cout % 64 != 0, which reach kernel I only through
// row 12's %8 predicate and never on a UNet path; or a plane wider than 191
// pixels, whose window would not fit): the WMMA form, the tiled GEMM of
// tile_gemm.cuh over one frame's pixels, gathering each tap's pixels
// (prologue recomputed per tap) for 32-channel chunks; Cin and Cout need
// only be multiples of 8. The wrapper (ops/conv3x3.py `launch_plan`)
// chooses the form and the window's boxes.
#include "common.cuh"
#include "hopper.cuh"
#include "tile_gemm.cuh"
#include "warp_mma.cuh"


namespace lvd {
namespace {

// ---- the WMMA form ----


template <typename T, bool kPrologue>
__global__ void __launch_bounds__(TileGemm<T>::kThreads)
conv3x3_wmma_kernel(const T* __restrict__ x, const float* __restrict__ a,
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
cudaError_t launch_wmma(const void* x, const void* a, const void* b, const void* w, const void* bias,
                   void* y, int N, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  using G = TileGemm<T>;
  cudaError_t err = set_smem(conv3x3_wmma_kernel<T, kPrologue>, G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H * W + G::BM - 1) / G::BM, (Cout + G::BN - 1) / G::BN, N);
  conv3x3_wmma_kernel<T, kPrologue><<<grid, G::kThreads, G::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(y), H, W, Cin, Cout);
  return cudaGetLastError();
}


constexpr int kBM = 128;  // output pixels per block of the halo-window forms

// ---- bf16, Cin and Cout % 64 == 0: TMA windows + wgmma ----

template <int NB>
struct WgConv {
  static constexpr int BN = 64 * NB;  // output channels per block
  static constexpr int kStages = 4;   // weight slices in flight
  static constexpr int kThreads = 2 * 128 + 32;
  static constexpr int kBTile = 64 * BN * 2;         // one tap's (64, BN) weight slice
  static constexpr int kOutBytes = 2 * NB * 64 * 64 * 2;  // epilogue staging, both warpgroups
  static constexpr int kZero = 1024;                 // the zero row (128 bytes used)
  // The ring, two windows, the staging, the zero row, 12 barriers, and
  // slack to align the start to 1024.
  __host__ __device__ static constexpr int smem(int win_bytes) {
    return kStages * kBTile + 2 * win_bytes + kOutBytes + kZero + 128 + 1024;
  }
};

template <int NB, bool kPrologue>
__global__ void __launch_bounds__(WgConv<NB>::kThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ a,
                     const float* __restrict__ b, const bf16* __restrict__ bias,
                     bf16* __restrict__ y, int P, int H, int W, int Cin, int Cout,
                     int box_rows, int boxes) {
  using C = WgConv<NB>;
  constexpr int NS = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int win_bytes = box_rows * boxes * 128;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* windows = reinterpret_cast<bf16*>(smem + NS * C::kBTile);
  bf16* out_stage = reinterpret_cast<bf16*>(smem + NS * C::kBTile + 2 * win_bytes);
  bf16* zrow = reinterpret_cast<bf16*>(smem + NS * C::kBTile + 2 * win_bytes + C::kOutBytes);
  uint64_t* bfull = reinterpret_cast<uint64_t*>(zrow + C::kZero / 2);
  uint64_t* bempty = bfull + NS;
  uint64_t* wfull = bempty + NS;
  uint64_t* wempty = wfull + 2;

  const int HW = H * W;
  const int n0 = blockIdx.x * C::BN, p0 = blockIdx.y * kBM;
  const int wstart = p0 - W - 1;  // the flattened row of window row 0
  const int nc = Cin / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(&bfull[s], 1);
      hop::mbar_init(&bempty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      hop::mbar_init(&wfull[s], 1);
      hop::mbar_init(&wempty[s], 8);
    }
    hop::mbar_fence_init();
  }
  if (threadIdx.x < 32) reinterpret_cast<uint32_t*>(zrow)[threadIdx.x] = 0u;
  __syncthreads();

  if (warp == 8) {  // the producer: one lane issues every TMA load
    if (lane == 0) {
      auto load_window = [&](int cc) {
        const int ws = cc & 1;
        if (cc >= 2) hop::mbar_wait(&wempty[ws], ((cc >> 1) - 1) & 1);
        hop::mbar_expect_tx(&wfull[ws], win_bytes);
        bf16* dst = windows + ws * (win_bytes / 2);
        for (int bx = 0; bx < boxes; ++bx)
          hop::tma_load_2d(dst + bx * box_rows * 64, &tm_x, &wfull[ws], cc * 64,
                           wstart + bx * box_rows);
      };
      load_window(0);
      int u = 0;  // (chunk, tap) in order
      for (int cc = 0; cc < nc; ++cc) {
        for (int tap = 0; tap < 9; ++tap, ++u) {
          // The next window once chunk cc - 1 (its buffer's last user) has
          // released it, well before chunk cc + 1 starts.
          if (tap == 4 && cc + 1 < nc) load_window(cc + 1);
          const int s = u % NS;
          if (u >= NS) hop::mbar_wait(&bempty[s], (u / NS - 1) & 1);
          hop::mbar_expect_tx(&bfull[s], C::kBTile);
          bf16* dst = ring + s * (C::kBTile / 2);
#pragma unroll
          for (int h = 0; h < NB; ++h)
            hop::tma_load_2d(dst + h * 64 * 64, &tm_w, &bfull[s], n0 + 64 * h,
                             tap * Cin + cc * 64);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns pixels [64 wg, 64 wg + 64) of the tile.
  // This lane hands ldmatrix the row of pixel i, and the 8-column half kh
  // of each k16 step.
  const int wg = warp / 4, wq = warp % 4;
  const int i = 64 * wg + 16 * wq + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int kh = lane >> 4;
  uint32_t valid = 0;  // bit tap: pixel i's tap lies inside its frame
  {
    const int p = p0 + i;
    const int rem = p % HW, py = rem / W, px = rem - py * W;
    if (p < P) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int sy = py + tap / 3 - 1, sx = px + tap % 3 - 1;
        if (sy >= 0 && sy < H && sx >= 0 && sx < W) valid |= 1u << tap;
      }
    }
  }
  float acc[NB * 32];
#pragma unroll
  for (int e = 0; e < NB * 32; ++e) acc[e] = 0.f;
  uint32_t af[2][4][4];

  for (int cc = 0; cc < nc; ++cc) {
    const int ws = cc & 1;
    bf16* win = windows + ws * (win_bytes / 2);
    hop::mbar_wait(&wfull[ws], (cc >> 1) & 1);
    if constexpr (kPrologue) {
      // z = silu(x * a + b) in place, once per element of the window, for
      // the rows inside the tensor (the rest stay zero and no valid tap
      // reads them). Thread t takes the 16-byte chunk t % 8 of rows t / 8,
      // t / 8 + 32, ...: row % 8 is the same for all of them, and so are
      // the 8 channels (chunk (t % 8) ^ (row % 8) under the swizzle), so
      // (a, b) stay in registers until the frame changes.
      const int rows = win_bytes / 128;
      const int pc = threadIdx.x & 7;
      const int ch = cc * 64 + ((pc ^ ((threadIdx.x >> 3) & 7)) * 8);
      int fa = -1;
      float as[8], bs[8];
      for (int row = threadIdx.x >> 3; row < rows; row += 32) {
        const int q = wstart + row;
        if (q < 0 || q >= P) continue;
        const int f = q / HW;
        if (f != fa) {
          fa = f;
          const float4* av = reinterpret_cast<const float4*>(a + (size_t)f * Cin + ch);
          const float4* bv = reinterpret_cast<const float4*>(b + (size_t)f * Cin + ch);
          const float4 a0 = av[0], a1 = av[1], b0 = bv[0], b1 = bv[1];
          as[0] = a0.x; as[1] = a0.y; as[2] = a0.z; as[3] = a0.w;
          as[4] = a1.x; as[5] = a1.y; as[6] = a1.z; as[7] = a1.w;
          bs[0] = b0.x; bs[1] = b0.y; bs[2] = b0.z; bs[3] = b0.w;
          bs[4] = b1.x; bs[5] = b1.y; bs[6] = b1.z; bs[7] = b1.w;
        }
        uint4* slot = reinterpret_cast<uint4*>(win + row * 64 + pc * 8);
        uint4 v = *slot;
        uint32_t* pair = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair[j]));
          const float z0 = xv.x * as[2 * j] + bs[2 * j];
          const float z1 = xv.y * as[2 * j + 1] + bs[2 * j + 1];
          pair[j] = pack_bf16(__fdividef(z0, 1.f + __expf(-z0)), __fdividef(z1, 1.f + __expf(-z1)));
        }
        *slot = v;
      }
      hop::fence_proxy_async();  // before a later TMA load overwrites these bytes
      hop::bar_sync(1, 256);     // both warpgroups' z is in place
    }

    // The A fragments of tap `tap` (4 k16 steps) from this lane's row.
    auto load_frags = [&](uint32_t(&fr)[4][4], int tap) {
      const int wr = i + (tap / 3) * W + tap % 3;
      const bool ok = (valid >> tap) & 1u;
      const bf16* rp = ok ? win + wr * 64 : zrow;
      const int sw = ok ? (wr & 7) : 0;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wm::ldmatrix_x4(fr[kk], rp + (((2 * kk + kh) ^ sw) * 8));
    };
    auto release = [&](int u) {
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&bempty[u % NS]);
    };
    load_frags(af[0], 0);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int u = cc * 9 + tap;
      hop::mbar_wait(&bfull[u % NS], (u / NS) & 1);
      const bf16* Bs = ring + (u % NS) * (C::kBTile / 2);
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_rs_tn<NB>(acc, af[tap & 1][kk],
                             hop::desc_sw128_mn(Bs + kk * 16 * 64, 64 * 64 * 2));
      hop::wgmma_commit();
      if (tap < 8) {
        hop::wgmma_wait<1>();  // the previous tap's products are done
        hop::fence_regs(acc);
        if (tap > 0) release(u - 1);
        load_frags(af[(tap + 1) & 1], tap + 1);
      } else {
        hop::wgmma_wait<0>();
        hop::fence_regs(acc);
        release(u - 1);
        release(u);
      }
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&wempty[ws]);
  }

  hop::store_acc_bf16<NB>(acc, out_stage + wg * NB * 4096, 4096,
                          bias == nullptr ? nullptr : bias + n0,
                          y + (size_t)(p0 + 64 * wg) * Cout + n0, Cout, P - p0 - 64 * wg);
}

template <int NB, bool kPrologue>
cudaError_t launch_wgmma(const void* x, const void* a, const void* b, const void* w,
                         const void* bias, void* y, int P, int H, int W, int Cin, int Cout,
                         int box_rows, int boxes, cudaStream_t stream) {
  using C = WgConv<NB>;
  CUtensorMap tx, tw;
  cudaError_t err = make_map_2d(&tx, x, P, Cin, box_rows);
  if (err == cudaSuccess) err = make_map_2d(&tw, w, 9LL * Cin, Cout, 64);
  const int smem = C::smem(box_rows * boxes * 128);
  if (err == cudaSuccess) err = set_smem(conv3x3_wgmma_kernel<NB, kPrologue>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Cout / C::BN, (P + kBM - 1) / kBM);
  conv3x3_wgmma_kernel<NB, kPrologue><<<grid, C::kThreads, smem, stream>>>(
      tx, tw, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const bf16*>(bias), static_cast<bf16*>(y), P, H, W, Cin, Cout, box_rows, boxes);
  return cudaGetLastError();
}

// ---- fp32 (TF32), Cin and Cout % 64 == 0: cp.async windows + mma.sync ----

struct F32Conv {
  static constexpr int BN = 64, BK = 16, kThreads = 256;
  static constexpr int kLdWin = BK + 4;  // window rows (floats): 16 bytes of padding
  static constexpr int kLdB = BN + 8;    // weight rows
  static constexpr int kBTile = 9 * BK * kLdB;  // the chunk's 9 tap slices (floats)
  __host__ __device__ static constexpr int stage(int win_rows) { return win_rows * kLdWin + kBTile; }
  // Two stages and the zero row.
  __host__ __device__ static constexpr int smem(int win_rows) {
    return (2 * stage(win_rows) + 32) * 4;
  }
};

// One block a SM (its 107-164 KB of shared memory allow no second), so
// ptxas may use every register it needs.
template <bool kPrologue>
__global__ void __launch_bounds__(F32Conv::kThreads, 1)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y, int P, int H, int W,
                   int Cin, int Cout, int win_rows) {
  using C = F32Conv;
  using M = wm::WarpMma<float>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int stage_f = C::stage(win_rows);
  float* zrow = ring + 2 * stage_f;
  const int HW = H * W;
  const int n0 = blockIdx.x * C::BN, p0 = blockIdx.y * kBM;
  const int wstart = p0 - W - 1;
  const int nc = Cin / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm_ = warp % 4, wn = warp / 4;  // pixels 32 wm_, channels 32 wn
  const int g = lane / 4, t = lane % 4;
  if (threadIdx.x < 32) zrow[threadIdx.x] = 0.f;

  // This lane's four pixels (rows g and g + 8 of two m16 tiles) and their
  // valid taps.
  int pix[2][2];
  uint32_t valid[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int ii = 32 * wm_ + 16 * mt + g + 8 * hf;
      const int p = p0 + ii;
      const int rem = p % HW, py = rem / W, px = rem - py * W;
      uint32_t v = 0;
      if (p < P) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int sy = py + tap / 3 - 1, sx = px + tap % 3 - 1;
          if (sy >= 0 && sy < H && sx >= 0 && sx < W) v |= 1u << tap;
        }
      }
      pix[mt][hf] = ii;
      valid[mt][hf] = v;
    }

  auto load = [&](int st, int cc) {
    float* win = ring + st * stage_f;
    float* Bs = win + win_rows * C::kLdWin;
    for (int e = threadIdx.x; e < win_rows * (BK / 4); e += C::kThreads) {
      const int r = e / (BK / 4), cv = e % (BK / 4);
      const int q = wstart + r;
      const bool ok = q >= 0 && q < P;
      wm::cp_async16(win + r * C::kLdWin + cv * 4,
                     x + (ok ? (size_t)q * Cin + cc * BK + cv * 4 : 0), ok);
    }
    for (int e = threadIdx.x; e < 9 * BK * (C::BN / 4); e += C::kThreads) {
      const int row = e / (C::BN / 4), cv = e % (C::BN / 4);  // row = tap * BK + k
      const int tap = row / BK, k = row % BK;
      wm::cp_async16(Bs + row * C::kLdB + cv * 4,
                     w + ((size_t)tap * Cin + cc * BK + k) * Cout + n0 + cv * 4, true);
    }
  };

  load(0, 0);
  wm::cp_async_commit();
  float acc[2][4][4] = {};
  for (int cc = 0; cc < nc; ++cc) {
    if (cc + 1 < nc) load((cc + 1) & 1, cc + 1);
    wm::cp_async_commit();
    wm::cp_async_wait<1>();
    __syncthreads();  // chunk cc landed for every thread
    float* win = ring + (cc & 1) * stage_f;
    const float* Bs = win + win_rows * C::kLdWin;
    if constexpr (kPrologue) {
      // z = silu(x * a + b) in place, as in the bf16 form: thread t takes
      // the 4 channels 4 (t % 4) of rows t / 4, t / 4 + 64, ..., with (a,
      // b) in registers until the frame changes.
      const int ch = cc * BK + 4 * (threadIdx.x % 4);
      int fa = -1;
      float4 av, bv;
      for (int r = threadIdx.x / 4; r < win_rows; r += C::kThreads / 4) {
        const int q = wstart + r;
        if (q < 0 || q >= P) continue;
        const int f = q / HW;
        if (f != fa) {
          fa = f;
          av = *reinterpret_cast<const float4*>(a + (size_t)f * Cin + ch);
          bv = *reinterpret_cast<const float4*>(b + (size_t)f * Cin + ch);
        }
        float4* slot = reinterpret_cast<float4*>(win + r * C::kLdWin + 4 * (threadIdx.x % 4));
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
      __syncthreads();
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * W + tap % 3;
      const float* rp[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          rp[mt][hf] = ((valid[mt][hf] >> tap) & 1u) ? win + (pix[mt][hf] + off) * C::kLdWin
                                                     : zrow;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          af[mt][0] = wm::tf32(rp[mt][0][kk + t]);
          af[mt][1] = wm::tf32(rp[mt][1][kk + t]);
          af[mt][2] = wm::tf32(rp[mt][0][kk + t + 4]);
          af[mt][3] = wm::tf32(rp[mt][1][kk + t + 4]);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b0[2], b1[2];
          M::load_b_rows(b0, b1, Bs + (tap * BK + kk) * C::kLdB + 32 * wn + 16 * np, C::kLdB,
                         lane);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            M::mma(acc[mt][2 * np], af[mt], b0);
            M::mma(acc[mt][2 * np + 1], af[mt], b1);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is reloaded
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row = p0 + 32 * wm_ + 16 * mt + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + 32 * wn + 8 * nt + 2 * t;
      const float b0 = bias == nullptr ? 0.f : bias[col];
      const float b1 = bias == nullptr ? 0.f : bias[col + 1];
      if (row < P) M::store2(y + (size_t)row * Cout + col, acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      if (row + 8 < P)
        M::store2(y + (size_t)(row + 8) * Cout + col, acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
  }
}

template <bool kPrologue>
cudaError_t launch_f32(const void* x, const void* a, const void* b, const void* w,
                       const void* bias, void* y, int P, int H, int W, int Cin, int Cout,
                       int win_rows, cudaStream_t stream) {
  const int smem = F32Conv::smem(win_rows);
  cudaError_t err = set_smem(conv3x3_f32_kernel<kPrologue>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Cout / F32Conv::BN, (P + kBM - 1) / kBM);
  conv3x3_f32_kernel<kPrologue><<<grid, F32Conv::kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<float*>(y), P, H,
      W, Cin, Cout, win_rows);
  return cudaGetLastError();
}

// Dynamic shared memory of the halo-window form (0 if the arguments are
// not one it takes).
long long window_smem(int box_rows, int boxes, int block_cout, int dtype) {
  if (box_rows <= 0 || box_rows > 256 || box_rows % 8 || boxes < 1 || boxes > 2) return 0;
  if (dtype == kBF16) {
    if (block_cout == 64) return WgConv<1>::smem(box_rows * boxes * 128);
    if (block_cout == 128) return WgConv<2>::smem(box_rows * boxes * 128);
    return 0;
  }
  return dtype == kF32 && block_cout == 64 ? F32Conv::smem(box_rows * boxes) : 0;
}

}  // namespace
}  // namespace lvd

// x: (N, H, W, Cin); w: (9, Cin, Cout) [tap = 3*(dy+1) + (dx+1)]; bias:
// (Cout,) or null; y: (N, H, W, Cout); all of one type (dtype 0 bf16, 1
// fp32). With `prologue`, a and b are (N, Cin) fp32 and the conv reads
// silu(x * a + b); without it a and b are ignored. form 1 is the
// halo-window form (Cin % 64 == 0, Cout % block_cout == 0; block_cout 64 or
// 128 in bf16, 64 in fp32; the window of 128 + 2W + 2 rows loaded as
// `boxes` boxes of `box_rows` rows, box_rows % 8 == 0 and <= 256); form 0
// the WMMA form (Cin % 8 == 0, Cout % 8 == 0).
LVD_EXPORT int lvd_conv3x3(const void* x, const void* a, const void* b, const void* w,
                           const void* bias, void* y, int N, int H, int W, int Cin, int Cout,
                           int prologue, int form, int box_rows, int boxes, int block_cout,
                           int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (N <= 0 || H <= 0 || W <= 0 || Cin % 8 != 0 || Cout % 8 != 0 || Cin <= 0 || Cout <= 0 ||
      (prologue && (a == nullptr || b == nullptr)))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    return dispatch(dtype, [&](auto tag) {
      using T = decltype(tag);
      return prologue ? launch_wmma<T, true>(x, a, b, w, bias, y, N, H, W, Cin, Cout, s)
                      : launch_wmma<T, false>(x, a, b, w, bias, y, N, H, W, Cin, Cout, s);
    });
  }
  const long long P = (long long)N * H * W;
  const long long smem = window_smem(box_rows, boxes, block_cout, dtype);
  if (form != 1 || Cin % 64 != 0 || Cout % block_cout != 0 || smem == 0 || smem > kMaxSmem ||
      (long long)box_rows * boxes < kBM + 2LL * W + 2 || P > (1LL << 31) - kBM)
    return cudaErrorInvalidValue;
  const int p = (int)P;
  if (dtype == kF32) {
    return prologue ? launch_f32<true>(x, a, b, w, bias, y, p, H, W, Cin, Cout, box_rows * boxes, s)
                    : launch_f32<false>(x, a, b, w, bias, y, p, H, W, Cin, Cout, box_rows * boxes, s);
  }
  if (block_cout == 128) {
    return prologue
               ? launch_wgmma<2, true>(x, a, b, w, bias, y, p, H, W, Cin, Cout, box_rows, boxes, s)
               : launch_wgmma<2, false>(x, a, b, w, bias, y, p, H, W, Cin, Cout, box_rows, boxes, s);
  }
  return prologue
             ? launch_wgmma<1, true>(x, a, b, w, bias, y, p, H, W, Cin, Cout, box_rows, boxes, s)
             : launch_wgmma<1, false>(x, a, b, w, bias, y, p, H, W, Cin, Cout, box_rows, boxes, s);
}

// Bytes of dynamic shared memory one block of kernel I takes: the
// halo-window form (form 1) at these window boxes and output tile, or the
// WMMA form (form 0); 0 for arguments the kernel does not take.
LVD_EXPORT long long lvd_conv3x3_smem(int form, int box_rows, int boxes, int block_cout,
                                      int dtype) {
  using namespace lvd;
  if (form == 0) return dtype == kBF16 ? TileGemm<bf16>::kSmem : TileGemm<float>::kSmem;
  return window_smem(box_rows, boxes, block_cout, dtype);
}
