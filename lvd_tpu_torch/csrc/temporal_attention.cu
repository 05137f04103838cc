// Kernel B: the fused temporal double self-attention of a temporal
// BasicTransformerBlock, LN1 -> attn1 -> +res -> LN2 -> attn2 -> +res over
// the F frames of each pixel.
//
// Replaces lvd_tpu/ops/temporal_attention.py `_pallas_pair` (`_tattn_kernel`).
//
// Bound on this card: the (C, 3C) qkv and (C, C) output projections carry
// almost all of the operations (the per-pixel F x F attention is tiny), so at
// C = 320..640 the pair is tensor-core bound; unfused it would instead move
// the (B, F, P, C) stream through device memory ~10 times (LN, q, k, v,
// concat, out, twice). Both forms read the stream once and write it once
// (plus the intermediate residual, which stays in the block's own rows of
// the output). Rounding points follow the plain version: q/k/v,
// probabilities, per-head outputs and the projected output are in the
// stream's type, statistics and accumulations fp32. Strides make both take
// the frames-major (B, F, P, C) stream and the pixels-major (B, P, F, C)
// one.
//
// bf16 (the `wgmma` form; C = 64 H <= 640, F <= 64): one block per 64 rows,
// G = 64 / F whole pixels (row r: pixel r / F, frame r % F; 48 of 64 rows
// at F = 24; rows past the last pixel are zero and never stored),
// warp-specialised. A producer warp streams the weights through a ring of
// 16 KB stages (two 64 x 64 boxes, one per consumer warpgroup, TMA with
// the 128-byte swizzle, MN-major), in the order the consumers use them;
// each weight box feeds one m64 product, one wgmma group a stage with one
// group in flight. Per attention the two consumer warpgroups:
//  - LayerNorm: one warp per row, four rows' loads in flight, fp32
//    one-pass statistics, z rounded to bf16 into a swizzled 64 x C tile
//    (K-major), ordered before the products by a proxy fence and a named
//    barrier;
//  - heads in pairs, warpgroup j taking head 2 i + j: k, v and q of the
//    head as three m64n64 products over C (wgmma, A = the z tile), k and v
//    rounded into the warpgroup's own 64 x 64 tiles, q rounded into
//    registers as the A operand of S = q k^T (m64n64, B = k K-major); the
//    per-pixel softmax on the accumulator fragment (keys of other pixels
//    masked, exact max, quad shuffles, exp2 with scale * log2(e) folded
//    into one fma), P normalised and rounded to bf16 straight into the A
//    operand of O = P V (B = v MN-major), O rounded into its head's 64
//    columns of a 64 x C output tile; an odd H leaves warpgroup 1 a head
//    past H in the last pair, whose products run on other weights or
//    zeros and are never stored;
//  - the output projection over the output tile, output blocks 2 i + j,
//    + bias in fp32, rounded once, the residual added from the block's
//    input rows (attn1: x; attn2: the rows attn1 wrote into the output,
//    all of a thread's loads before its stores) and stored; the block's
//    output rows then hold y1, which LN2 reads.
// Timing variants on an H100 (PERF.md): without the weight loads the
// kernel took as long at L0 (the products and their handoffs, the
// LayerNorms and the attentions set the pace, not the L2 stream); one
// m64n192 [q | k | v] product a head spilled at 168 registers and was
// slower. Shared memory: z and output tiles (C/64 boxes of 8 KB each), k
// and v of both warpgroups (32 KB) and a ring of 16 KB stages: 224 KB at
// C = 320 (7 stages), 512 (4) and 640 (2).
//
// fp32 up to F = 64 (the `wgmma` form on TF32; csrc/pair_fwd_tf32.cu): a
// chain of passes per attention on the kernels it shares with kernel F's fp32
// form (csrc/pair_tf32.cuh): LayerNorm, [q | k | v] on a TF32 `wgmma` GEMM in
// 128-row tiles, the F x F attention per (pixel, head) on mma.sync TF32 with
// F padded to 16..64 frames, and the output projection with the bias and the
// residual in the GEMM's epilogue, through a device-memory workspace.
//
// F > 64 in either type, and fp32 when named (the `wmma` form, the first
// version): one block per (batch, group of G pixels) holds the G*F rows of
// its pixels in shared memory (residual, LN output and per-head outputs)
// and runs both attentions there. q/k/v for one head at a time come from WMMA products
// against the weights in device memory (L2-resident); the F x F attention
// runs as one (R, R) product masked to its per-pixel blocks, with an exact
// softmax (running max; the TPU kernel's clamped no-max exp2 is not
// carried over); fp32 runs its products in TF32. Tiles: the first of
// G = 4, 2, 1 pixels (R = G*F rows rounded up to 16) whose layout fits
// 227 KB with the residual rows in shared memory; if none fits, the
// residual rows live in the output tensor itself (each block owns its
// rows; they are read by the LayerNorm and updated by the residual add,
// never a WMMA operand) and the same G search runs again. At F = 24: bf16
// C = 320 and 512 take G = 2 (R = 48; 139 and 193 KB), C = 640 G = 1
// (R = 32; 152 KB); fp32 C = 320 takes G = 1 (R = 32; 166 KB), C = 512 and
// 640 G = 1 with the residual in the output (R = 32; 173 and 205 KB).
//
// The wrapper's launch plan (ops/temporal_attention.py `launch_plan`: the
// form, rows a block, pixels a block, the attention's frames, and the
// workspace's bytes) is passed in, and a plan the form was not built for is
// refused.
#include "common.cuh"
#include "hopper.cuh"

namespace lvd {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kD = 64;

struct PairLayout {
  int R, ldc, ldh;
  bool ys_smem;
  size_t ys, lns, os, qs, ks, vs, S, P, scratch, total;
};

template <typename T>
__host__ __device__ inline PairLayout pair_layout(int R, int C, bool ys_smem) {
  PairLayout L;
  L.R = R;
  L.ldc = C + kPad<T>;
  L.ldh = kD + kPad<T>;
  L.ys_smem = ys_smem;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    size_t at = off;
    off += (bytes + 127) / 128 * 128;
    return at;
  };
  const size_t row_bytes = (size_t)R * L.ldc * sizeof(T);
  L.ys = ys_smem ? take(row_bytes) : 0;
  L.lns = take(row_bytes);
  L.os = take(row_bytes);
  L.qs = take((size_t)R * L.ldh * sizeof(T));
  L.ks = take((size_t)R * L.ldh * sizeof(T));
  L.vs = take((size_t)R * L.ldh * sizeof(T));
  L.S = take((size_t)R * R * 4);
  L.P = take((size_t)R * R * sizeof(T));
  L.scratch = take((size_t)kWarps * 256 * 4);
  L.total = off;
  return L;
}

template <typename T>
struct AttnWeights {
  const float* ln_s;  // (C,) fp32
  const float* ln_b;  // (C,) fp32
  const T* wqkv;      // (C, 3C): [Wq | Wk | Wv]
  const T* wo;        // (C, C)
  const float* bo;    // (C,) fp32
};

// The residual rows of the block: in shared memory (stride ldc) or in the
// output tensor (row r = g*F + f at f*sF + (p0 + g)*sP).
template <typename T>
struct Rows {
  T* base;
  int ldc;
  bool smem;
  long long sF, sP;
  int F, p0;
  __device__ T* row(int r) const {
    return smem ? base + r * ldc : base + (r % F) * sF + (long long)(p0 + r / F) * sP;
  }
};

template <typename T>
__device__ void one_attention(const AttnWeights<T>& w, const Rows<T>& ys, T* lns, T* os, T* qs,
                              T* ks, T* vs, float* S, T* P, float* scratch, int R, int ldc,
                              int ldh, int C, int H, int F, int valid_rows, float eps,
                              float scale_log2e) {
  using M = Mma<T>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int RT = R / 16;

  // LayerNorm, one warp per row, fp32 statistics (m2 - mean^2).
  for (int r = warp; r < R; r += kWarps) {
    T* dst = lns + r * ldc;
    if (r >= valid_rows) {
      for (int c = lane; c < C; c += 32) dst[c] = from_f<T>(0.f);
      continue;
    }
    const T* src = ys.row(r);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float x = to_f(src[c]);
      s1 += x;
      s2 += x * x;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mean = s1 / C;
    const float var = fmaxf(s2 / C - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    for (int c = lane; c < C; c += 32) {
      const float x = to_f(src[c]);
      dst[c] = from_f<T>((x - mean) * rstd * w.ln_s[c] + w.ln_b[c]);
    }
  }
  __syncthreads();

  float* scr = scratch + warp * 256;
  for (int h = 0; h < H; ++h) {
    // q, k, v of head h: three (R, 64) products over C.
    for (int t = warp; t < 3 * RT * 4; t += kWarps) {
      const int mat = t / (RT * 4);
      const int rt = (t % (RT * 4)) / 4;
      const int ct = t % 4;
      const T* bcol = w.wqkv + mat * C + h * kD + ct * 16;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < C; kk += M::K) {
        typename M::A a;
        typename M::BRow bm;
        load_op(a, lns + rt * 16 * ldc + kk, ldc);
        load_op(bm, bcol + (size_t)kk * 3 * C, 3 * C);
        wmma::mma_sync(acc, a, bm, acc);
      }
      T* dst = (mat == 0 ? qs : mat == 1 ? ks : vs) + rt * 16 * ldh + ct * 16;
      drain_tile(acc, scr, lane,
                 [&](int r, int c, float val) { dst[r * ldh + c] = from_f<T>(val); });
    }
    __syncthreads();

    // Logits for all row pairs of the tile; the softmax keeps each pixel's block.
    for (int t = warp; t < RT * RT; t += kWarps) {
      const int i = t / RT, j = t % RT;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD; kk += M::K) {
        typename M::A a;
        typename M::BCol bm;
        load_op(a, qs + i * 16 * ldh + kk, ldh);
        load_op(bm, ks + j * 16 * ldh + kk, ldh);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(S + i * 16 * R + j * 16, acc, R, wmma::mem_row_major);
    }
    __syncthreads();

    for (int r = tid; r < R; r += kThreads) {
      T* prow = P + r * R;
      for (int c = 0; c < R; ++c) prow[c] = from_f<T>(0.f);
      if (r < valid_rows) {
        const float* srow = S + r * R;
        const int c0 = (r / F) * F;
        float mx = -INFINITY;
        for (int c = c0; c < c0 + F; ++c) mx = fmaxf(mx, srow[c] * scale_log2e);
        float sum = 0.f;
        for (int c = c0; c < c0 + F; ++c) sum += exp2f(srow[c] * scale_log2e - mx);
        const float inv = 1.f / sum;
        for (int c = c0; c < c0 + F; ++c)
          prow[c] = from_f<T>(exp2f(srow[c] * scale_log2e - mx) * inv);
      }
    }
    __syncthreads();

    // Head output P V, written into its 64 columns of the concatenated output.
    for (int t = warp; t < RT * 4; t += kWarps) {
      const int i = t / 4, j = t % 4;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < R; kk += M::K) {
        typename M::A a;
        typename M::BRow bm;
        load_op(a, P + i * 16 * R + kk, R);
        load_op(bm, vs + kk * ldh + j * 16, ldh);
        wmma::mma_sync(acc, a, bm, acc);
      }
      T* dst = os + i * 16 * ldc + h * kD + j * 16;
      drain_tile(acc, scr, lane,
                 [&](int r, int c, float val) { dst[r * ldc + c] = from_f<T>(val); });
    }
    __syncthreads();
  }

  // Output projection + bias, then the residual add on the valid rows.
  const int CT = C / 16;
  for (int t = warp; t < RT * CT; t += kWarps) {
    const int i = t / CT, j = t % CT;
    typename M::Acc acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < C; kk += M::K) {
      typename M::A a;
      typename M::BRow bm;
      load_op(a, os + i * 16 * ldc + kk, ldc);
      load_op(bm, w.wo + (size_t)kk * C + j * 16, C);
      wmma::mma_sync(acc, a, bm, acc);
    }
    const float* bias = w.bo + j * 16;
    drain_tile(acc, scr, lane, [&](int r, int c, float val) {
      const int row = i * 16 + r;
      if (row >= valid_rows) return;
      T* dst = ys.row(row) + j * 16 + c;
      const float attn = round_to<T>(val + bias[c]);
      *dst = from_f<T>(to_f(*dst) + attn);
    });
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
temporal_pair_kernel(const T* __restrict__ x, T* __restrict__ out, AttnWeights<T> w1,
                     AttnWeights<T> w2, int F, int P, int C, int H, long long sB, long long sF,
                     long long sP, int G, int R, bool ys_smem, float eps, float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PairLayout L = pair_layout<T>(R, C, ys_smem);
  T* lns = reinterpret_cast<T*>(smem + L.lns);
  T* os = reinterpret_cast<T*>(smem + L.os);
  T* qs = reinterpret_cast<T*>(smem + L.qs);
  T* ks = reinterpret_cast<T*>(smem + L.ks);
  T* vs = reinterpret_cast<T*>(smem + L.vs);
  float* S = reinterpret_cast<float*>(smem + L.S);
  T* Pm = reinterpret_cast<T*>(smem + L.P);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * G;
  const int g_here = min(G, P - p0);
  const int valid_rows = g_here * F;
  const int ldc = L.ldc;
  constexpr int V = kVecN<T>;
  const int cvn = C / V;
  const T* xb = x + b * sB;
  T* ob = out + b * sB;
  const Rows<T> ys{ys_smem ? reinterpret_cast<T*>(smem + L.ys) : ob, ldc, ys_smem, sF, sP, F, p0};

  // Row r = g*F + f holds frame f of pixel p0 + g (padded rows are zero).
  for (int e = threadIdx.x; e < R * cvn; e += kThreads) {
    const int r = e / cvn, cv = e % cvn;
    if (!ys_smem && r >= valid_rows) continue;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid_rows) {
      const int g = r / F, f = r % F;
      val = *reinterpret_cast<const uint4*>(xb + f * sF + (p0 + g) * sP + cv * V);
    }
    *reinterpret_cast<uint4*>(ys.row(r) + cv * V) = val;
  }
  __syncthreads();

  one_attention(w1, ys, lns, os, qs, ks, vs, S, Pm, scratch, R, ldc, L.ldh, C, H, F, valid_rows,
                eps, scale_log2e);
  one_attention(w2, ys, lns, os, qs, ks, vs, S, Pm, scratch, R, ldc, L.ldh, C, H, F, valid_rows,
                eps, scale_log2e);

  if (!ys_smem) return;  // the rows already live in the output
  for (int e = threadIdx.x; e < valid_rows * cvn; e += kThreads) {
    const int r = e / cvn, cv = e % cvn;
    const int g = r / F, f = r % F;
    *reinterpret_cast<uint4*>(ob + f * sF + (p0 + g) * sP + cv * V) =
        *reinterpret_cast<const uint4*>(ys.row(r) + cv * V);
  }
}

// The first version's tile at (F, C): G pixels, R rows, the residual in
// shared memory or not; false if no tile fits.
template <typename T>
bool wmma_tile(int F, int C, int& G, int& R, bool& ys_smem) {
  for (int in_smem = 1; in_smem >= 0; --in_smem) {
    const int candidates[3] = {4, 2, 1};
    for (int g : candidates) {
      const int r = round_up(g * F, 16);
      if (r <= 128 && pair_layout<T>(r, C, in_smem).total <= (size_t)kMaxSmem) {
        G = g;
        R = r;
        ys_smem = in_smem;
        return true;
      }
    }
  }
  return false;
}

template <typename T>
cudaError_t launch_wmma(const void* x, void* out, const void* const* wts, int B, int F, int P,
                        int C, int H, long long sB, long long sF, long long sP, float eps,
                        int row_block, int pixels, cudaStream_t stream) {
  int G = 0, R = 0;
  bool ys_smem = true;
  if (!wmma_tile<T>(F, C, G, R, ys_smem) || row_block != R || pixels != G)
    return cudaErrorInvalidValue;
  const int smem = (int)pair_layout<T>(R, C, ys_smem).total;
  cudaError_t err = set_smem(temporal_pair_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  auto weights = [&](int i) {
    return AttnWeights<T>{static_cast<const float*>(wts[5 * i]),
                          static_cast<const float*>(wts[5 * i + 1]),
                          static_cast<const T*>(wts[5 * i + 2]),
                          static_cast<const T*>(wts[5 * i + 3]),
                          static_cast<const float*>(wts[5 * i + 4])};
  };
  dim3 grid((P + G - 1) / G, B);
  const float scale_log2e = (1.0f / sqrtf((float)kD)) * 1.4426950408889634f;
  temporal_pair_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), weights(0), weights(1), F, P, C, H, sB, sF,
      sP, G, R, ys_smem, eps, scale_log2e);
  return cudaGetLastError();
}

// ---- bf16: TMA weight ring + wgmma ----

template <int NH>
struct WgPair {
  static constexpr int C = 64 * NH;
  static constexpr int kThreads = 2 * 128 + 32;  // consumer warpgroups, then the producer warp
  static constexpr int NP = (NH + 1) / 2;        // head pairs; output blocks of a warpgroup
  static constexpr int kBox = 8192;              // one 64 x 64 bf16 box
  static constexpr int kStage = 2 * kBox;        // one box of each warpgroup
  // z and output tiles, k and v of both warpgroups, barriers, alignment slack.
  static constexpr int kFixed = 2 * NH * kBox + 4 * kBox + 256 + 1024;
  static constexpr int kFit = (kMaxSmem - kFixed) / kStage;
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static constexpr int kSmem = kStages * kStage + kFixed;
};

struct PairArgs {
  const bf16* x;
  bf16* out;
  const float* ln_s[2];
  const float* ln_b[2];
  const float* bo[2];
  long long sB, sF, sP;
  int F, P, G;  // frames, pixels, pixels a block
  float eps, scale_log2e;
};

template <int NH>
__global__ void __launch_bounds__(WgPair<NH>::kThreads, 1)
temporal_pair_wgmma_kernel(const __grid_constant__ CUtensorMap tm_qkv1,
                           const __grid_constant__ CUtensorMap tm_o1,
                           const __grid_constant__ CUtensorMap tm_qkv2,
                           const __grid_constant__ CUtensorMap tm_o2, const PairArgs a) {
  using W = WgPair<NH>;
  constexpr int NS = W::kStages, C = W::C, NP = W::NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem;
  bf16* zs = reinterpret_cast<bf16*>(smem + NS * W::kStage);  // LayerNorm output, C/64 boxes
  bf16* os = zs + NH * 4096;                                   // head outputs, C/64 boxes
  bf16* kvs = os + NH * 4096;                                  // k, v of each warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(kvs + 4 * 4096);
  uint64_t* empty = full + NS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int F = a.F;
  const int p0 = blockIdx.x * a.G;
  const int valid = min(a.G, a.P - p0) * F;  // row r < valid: pixel p0 + r / F, frame r % F
  const long long base = blockIdx.y * a.sB;
  auto row_at = [&](int r) { return base + (r % F) * a.sF + (long long)(p0 + r / F) * a.sP; };

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
      int v = 0;
      // Stage v: the box of warpgroup h at column col0 + 64 h, rows 64 kt.
      auto load = [&](const CUtensorMap* map, int col0, int kt) {
        const int s = v % NS;
        if (v >= NS) hop::mbar_wait(&empty[s], (v / NS - 1) & 1);
        hop::mbar_expect_tx(&full[s], W::kStage);
        for (int h = 0; h < 2; ++h)
          hop::tma_load_2d(ring + s * W::kStage + h * W::kBox, map, &full[s], col0 + 64 * h,
                           64 * kt);
        ++v;
      };
      for (int at = 0; at < 2; ++at) {
        const CUtensorMap* mq = at ? &tm_qkv2 : &tm_qkv1;
        const CUtensorMap* mo = at ? &tm_o2 : &tm_o1;
        // Head pair j: the k, v and q columns of heads 2 j and 2 j + 1.
        for (int j = 0; j < NP; ++j)
          for (int t = 0; t < 3; ++t)
            for (int kt = 0; kt < NH; ++kt) load(mq, (t == 2 ? 0 : t + 1) * C + 128 * j, kt);
        // Output blocks 2 i and 2 i + 1.
        for (int i = 0; i < NP; ++i)
          for (int kt = 0; kt < NH; ++kt) load(mo, 128 * i, kt);
      }
    }
    return;
  }

  const int wg = warp / 4, wq = warp % 4;
  const int r4 = lane / 4, cq = 2 * (lane % 4);
  const int ra = 16 * wq + r4, rb = ra + 8;  // this thread's two accumulator rows
  bf16* ks = kvs + wg * 2 * 4096;
  bf16* vs = ks + 4096;
  int u = 0, done = 0;  // stages are consumed in order; `done`: the first not yet released
  auto release_to = [&](int end) {
    for (; done < end; ++done) {
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[done % NS]);
    }
  };
  // acc = A (64 x C, C/64 swizzled boxes) times this warpgroup's boxes of
  // the next C/64 stages (a 64-column block of one matrix), one group a
  // stage, one group in flight; drained at the end.
  auto gemm = [&](const bf16* A, float (&acc)[32]) {
#pragma unroll
    for (int kt = 0; kt < NH; ++kt) {
      hop::mbar_wait(&full[u % NS], (u / NS) & 1);
      const bf16* Bs = reinterpret_cast<const bf16*>(ring + (u % NS) * W::kStage) + wg * 4096;
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_ss_n64_tn(acc, hop::desc_sw128(A + kt * 4096 + kk * 16),
                             hop::desc_sw128_mn(Bs + kk * 16 * 64, 8192), kt > 0 || kk > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      release_to(u);
      ++u;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    release_to(u);
  };
  // A 64 x 64 accumulator block rounded to bf16 into a swizzled tile.
  auto store_tile = [&](bf16* t, const float* acc) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      *reinterpret_cast<uint32_t*>(t + ra * 64 + ((c ^ r4) * 8) + cq) =
          pack_bf16(acc[4 * c], acc[4 * c + 1]);
      *reinterpret_cast<uint32_t*>(t + rb * 64 + ((c ^ r4) * 8) + cq) =
          pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
    }
  };
  // q rounded into the A operand of q k^T.
  auto pack_a = [&](uint32_t (&qa)[4][4], const float* acc) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      qa[c / 2][(c % 2) * 2] = pack_bf16(acc[4 * c], acc[4 * c + 1]);
      qa[c / 2][(c % 2) * 2 + 1] = pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
    }
  };
  // This thread's keys of its rows' pixels: [lo, lo + F).
  const int lo_a = ra / F * F, lo_b = rb / F * F;

  for (int at = 0; at < 2; ++at) {
    const bf16* src = at ? a.out : a.x;  // the residual rows
    const float* ln_s = a.ln_s[at];
    const float* ln_b = a.ln_b[at];

    // LayerNorm of the block's rows into the z tile; rows past the block's
    // pixels are zero. Each consumer warp takes rows warp + 8 i, four at a
    // time, so four rows' loads are in flight together; a lane's columns
    // are the same in every row, so their scale and bias stay in registers
    // (loaded per row, behind stores that might alias them, they were the
    // largest single cost of the first design).
    {
      constexpr int VN = C / 8, VI = (VN + 31) / 32;  // 16-byte vectors a row, a lane
      constexpr int RI = 4;                           // rows in flight a warp
      float4 gs[VI][2], gb[VI][2];
#pragma unroll
      for (int i = 0; i < VI; ++i) {
        const int vv = (lane + 32 * i) % VN;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          gs[i][h] = *reinterpret_cast<const float4*>(ln_s + 8 * vv + 4 * h);
          gb[i][h] = *reinterpret_cast<const float4*>(ln_b + 8 * vv + 4 * h);
        }
      }
#pragma unroll 1
      for (int r0 = warp; r0 < 64; r0 += 8 * RI) {
        Vec<bf16> pk[RI][VI];
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int r = r0 + 8 * j;
          const bf16* row = src + (r < valid ? row_at(r) : 0);
#pragma unroll
          for (int i = 0; i < VI; ++i) {
            const int vv = lane + 32 * i;
            pk[j][i].u = make_uint4(0, 0, 0, 0);
            if (r < valid && vv < VN) pk[j][i].u = *reinterpret_cast<const uint4*>(row + 8 * vv);
          }
        }
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int r = r0 + 8 * j;
          float s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int i = 0; i < VI; ++i)
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float v = __bfloat162float(pk[j][i].h[e]);
              s1 += v;
              s2 += v * v;
            }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
          }
          const float mean = s1 / C;
          const float rstd = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + a.eps);
#pragma unroll
          for (int i = 0; i < VI; ++i) {
            const int vv = lane + 32 * i;
            if (vv >= VN) continue;
            Vec<bf16> z;
            const float sc[8] = {gs[i][0].x, gs[i][0].y, gs[i][0].z, gs[i][0].w,
                                 gs[i][1].x, gs[i][1].y, gs[i][1].z, gs[i][1].w};
            const float bi[8] = {gb[i][0].x, gb[i][0].y, gb[i][0].z, gb[i][0].w,
                                 gb[i][1].x, gb[i][1].y, gb[i][1].z, gb[i][1].w};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float v = __bfloat162float(pk[j][i].h[e]);
              z.h[e] = __float2bfloat16(r < valid ? (v - mean) * rstd * sc[e] + bi[e] : 0.f);
            }
            *reinterpret_cast<uint4*>(zs + (vv / 8) * 4096 + r * 64 + (((vv % 8) ^ (r % 8)) * 8)) =
                z.u;
          }
        }
      }
    }
    hop::fence_proxy_async();
    hop::bar_sync(1, 256);  // the z tile is in place

#pragma unroll 1
    for (int j = 0; j < NP; ++j) {
      const int head = 2 * j + wg;
      uint32_t qa[4][4];
      float acc[32];
      gemm(zs, acc);  // k
      store_tile(ks, acc);
      gemm(zs, acc);  // v
      store_tile(vs, acc);
      gemm(zs, acc);  // q
      pack_a(qa, acc);
      hop::fence_proxy_async();
      hop::bar_sync(2 + wg, 128);  // k and v of the head are in place

      float sacc[32];
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_rs_n64(sacc, qa[kk], hop::desc_sw128(ks + kk * 16), kk > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(sacc);

      // Softmax over each row's keys of its own pixel.
      float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * c + cq + e;
          if (key >= lo_a && key < lo_a + F) mxa = fmaxf(mxa, sacc[4 * c + e]);
          if (key >= lo_b && key < lo_b + F) mxb = fmaxf(mxb, sacc[4 * c + 2 + e]);
        }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
        mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
      }
      const float ma = mxa * a.scale_log2e, mb = mxb * a.scale_log2e;
      float suma = 0.f, sumb = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * c + cq + e;
          float& pa_ = sacc[4 * c + e];
          float& pb_ = sacc[4 * c + 2 + e];
          pa_ = (key >= lo_a && key < lo_a + F) ? exp2f(fmaf(pa_, a.scale_log2e, -ma)) : 0.f;
          pb_ = (key >= lo_b && key < lo_b + F) ? exp2f(fmaf(pb_, a.scale_log2e, -mb)) : 0.f;
          suma += pa_;
          sumb += pb_;
        }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        suma += __shfl_xor_sync(0xffffffffu, suma, off);
        sumb += __shfl_xor_sync(0xffffffffu, sumb, off);
      }
      const float ia = 1.f / suma, ib = 1.f / sumb;
      uint32_t pa[4][4];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        pa[c / 2][(c % 2) * 2] = pack_bf16(sacc[4 * c] * ia, sacc[4 * c + 1] * ia);
        pa[c / 2][(c % 2) * 2 + 1] = pack_bf16(sacc[4 * c + 2] * ib, sacc[4 * c + 3] * ib);
      }

      float oacc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[e] = 0.f;
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_rs_n64_tn(oacc, pa[kk], hop::desc_sw128(vs + kk * 16 * 64));
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(oacc);
      if (head < NH) store_tile(os + head * 4096, oacc);
    }
    hop::fence_proxy_async();
    hop::bar_sync(1, 256);  // every head's output is in place

    // The output projection, + bias, rounded, + the residual.
    const float* bo = a.bo[at];
#pragma unroll 1
    for (int i = 0; i < NP; ++i) {
      const int blk = 2 * i + wg;
      float acc[32];
      gemm(os, acc);
      if (blk >= NH) continue;
      // The residual's 16 pairs of this thread are loaded before any store
      // (src may be the output itself, so a load could not pass a store).
      const long long at_a = ra < valid ? row_at(ra) : -1, at_b = rb < valid ? row_at(rb) : -1;
      __nv_bfloat162 res[8][2];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 64 * blk + 8 * c + cq;
        if (at_a >= 0) res[c][0] = *reinterpret_cast<const __nv_bfloat162*>(src + at_a + col);
        if (at_b >= 0) res[c][1] = *reinterpret_cast<const __nv_bfloat162*>(src + at_b + col);
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 64 * blk + 8 * c + cq;
        const float b0 = bo[col], b1 = bo[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const long long at_r = hf ? at_b : at_a;
          if (at_r < 0) continue;
          const float2 y = __bfloat1622float2(res[c][hf]);
          const float o0 = round_to<bf16>(acc[4 * c + 2 * hf] + b0);
          const float o1 = round_to<bf16>(acc[4 * c + 2 * hf + 1] + b1);
          *reinterpret_cast<uint32_t*>(a.out + at_r + col) = pack_bf16(y.x + o0, y.y + o1);
        }
      }
    }
    hop::bar_sync(1, 256);  // the block's rows of y1 are written before LN2 reads them
  }
}

template <int NH>
cudaError_t launch_wgmma_h(const void* x, void* out, const void* const* wts, int B, int F, int P,
                           int G, long long sB, long long sF, long long sP, float eps,
                           cudaStream_t stream) {
  using W = WgPair<NH>;
  constexpr int C = W::C;
  CUtensorMap tq1, to1, tq2, to2;
  cudaError_t err = make_map_2d(&tq1, wts[2], C, 3 * C, 64);
  if (err == cudaSuccess) err = make_map_2d(&to1, wts[3], C, C, 64);
  if (err == cudaSuccess) err = make_map_2d(&tq2, wts[7], C, 3 * C, 64);
  if (err == cudaSuccess) err = make_map_2d(&to2, wts[8], C, C, 64);
  if (err == cudaSuccess) err = set_smem(temporal_pair_wgmma_kernel<NH>, W::kSmem);
  if (err != cudaSuccess) return err;
  PairArgs a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  for (int i = 0; i < 2; ++i) {
    a.ln_s[i] = static_cast<const float*>(wts[5 * i]);
    a.ln_b[i] = static_cast<const float*>(wts[5 * i + 1]);
    a.bo[i] = static_cast<const float*>(wts[5 * i + 4]);
  }
  a.sB = sB;
  a.sF = sF;
  a.sP = sP;
  a.F = F;
  a.P = P;
  a.G = G;
  a.eps = eps;
  a.scale_log2e = (1.0f / sqrtf((float)kD)) * 1.4426950408889634f;
  const dim3 grid((P + G - 1) / G, B);
  temporal_pair_wgmma_kernel<NH><<<grid, W::kThreads, W::kSmem, stream>>>(tq1, to1, tq2, to2, a);
  return cudaGetLastError();
}

// The wgmma form at H heads, or its shared memory (smem_only).
long long wgmma_heads(const void* x, void* out, const void* const* wts, int B, int F, int P,
                      int H, int G, long long sB, long long sF, long long sP, float eps,
                      cudaStream_t s, bool smem_only) {
#define LVD_HEADS(nh)                                                                   \
  (smem_only ? (long long)WgPair<nh>::kSmem                                             \
             : (long long)launch_wgmma_h<nh>(x, out, wts, B, F, P, G, sB, sF, sP, eps, s))
  switch (H) {
    case 1: return LVD_HEADS(1);
    case 2: return LVD_HEADS(2);
    case 3: return LVD_HEADS(3);
    case 4: return LVD_HEADS(4);
    case 5: return LVD_HEADS(5);
    case 6: return LVD_HEADS(6);
    case 7: return LVD_HEADS(7);
    case 8: return LVD_HEADS(8);
    case 9: return LVD_HEADS(9);
    default: return LVD_HEADS(10);
  }
#undef LVD_HEADS
}

}  // namespace
}  // namespace lvd

namespace lvd {
// The fp32 form on TF32 wgmma (csrc/pair_fwd_tf32.cu).
long long pair_fwd_tf32_workspace(int B, int F, int P, int C);
cudaError_t pair_fwd_tf32(const void* x, void* out, const void* const* wts, void* ws, int B,
                          int F, int P, int C, long long sB, long long sF, long long sP,
                          float eps, cudaStream_t s);
constexpr int kTf32RowBlock = 128;  // its projections' output tiles: 128 rows a block
}  // namespace lvd

// x/out: (dtype 0 bf16, 1 fp32) with element (b, f, p, c) at b*sB + f*sF +
// p*sP + c (strides in elements; c contiguous). Per attention i: ln
// scale/bias (C,) fp32, wqkv (C, 3C) = [Wq | Wk | Wv] and wo (C, C) in x's
// type, bo (C,) fp32. C = H*64. ws: lvd_temporal_pair_workspace bytes of
// device workspace. form 1 is the wgmma form (H <= 10, F <= 64): in bf16
// row_block 64, pixels 64 / F and frames F; in fp32 (csrc/pair_fwd_tf32.cu)
// row_block 128 (its projections' tiles), pixels 1 and frames F rounded up
// to 16 (its attention pass). form 0 is the first version (row_block and
// pixels its tile search's R and G, frames F). A plan the form was not
// built for is refused.
LVD_EXPORT int lvd_temporal_pair(const void* x, void* out, const void* ln1_s, const void* ln1_b,
                                 const void* wqkv1, const void* wo1, const void* bo1,
                                 const void* ln2_s, const void* ln2_b, const void* wqkv2,
                                 const void* wo2, const void* bo2, void* ws, int B, int F, int P,
                                 int C, int H, long long sB, long long sF, long long sP,
                                 float eps, int form, int row_block, int pixels, int frames,
                                 int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (C != H * kD || F <= 0 || P <= 0 || B <= 0) return cudaErrorInvalidValue;
  const void* wts[10] = {ln1_s, ln1_b, wqkv1, wo1, bo1, ln2_s, ln2_b, wqkv2, wo2, bo2};
  auto s = static_cast<cudaStream_t>(stream);
  if (form == 1 && dtype == kF32) {
    if (H < 1 || H > 10 || F > 64 || row_block != kTf32RowBlock || pixels != 1 ||
        frames != round_up(F, 16) || ws == nullptr)
      return cudaErrorInvalidValue;
    return (int)pair_fwd_tf32(x, out, wts, ws, B, F, P, C, sB, sF, sP, eps, s);
  }
  if (frames != F) return cudaErrorInvalidValue;
  if (form == 1) {
    if (dtype != kBF16 || H < 1 || H > 10 || F > 64 || row_block != 64 || pixels != 64 / F)
      return cudaErrorInvalidValue;
    return (int)wgmma_heads(x, out, wts, B, F, P, H, pixels, sB, sF, sP, eps, s, false);
  }
  if (form != 0) return cudaErrorInvalidValue;
  return dispatch(dtype, [&](auto tag) {
    return launch_wmma<decltype(tag)>(x, out, wts, B, F, P, C, H, sB, sF, sP, eps, row_block,
                                      pixels, s);
  });
}

// Bytes of device-memory workspace lvd_temporal_pair needs for this shape,
// form and type (-1 if the shape or type is not supported): the fp32 wgmma
// form's (pair_fwd_tf32_workspace), none in any other form (the entry
// refuses a form it does not know).
LVD_EXPORT long long lvd_temporal_pair_workspace(int B, int F, int P, int C, int form,
                                                 int dtype) {
  using namespace lvd;
  if (B <= 0 || F <= 0 || P <= 0 || C % kD != 0 || (dtype != kBF16 && dtype != kF32)) return -1;
  if (form != 1 || dtype != kF32) return 0;
  return C > 10 * kD || F > 64 ? -1 : pair_fwd_tf32_workspace(B, F, P, C);
}

// Bytes of dynamic shared memory one block of kernel B's wgmma form takes
// at H heads (1..10); 0 for any other count.
LVD_EXPORT long long lvd_temporal_pair_smem(int H) {
  using namespace lvd;
  if (H < 1 || H > 10) return 0;
  return wgmma_heads(nullptr, nullptr, nullptr, 0, 1, 1, H, 1, 0, 0, 0, 0.f, nullptr, true);
}
