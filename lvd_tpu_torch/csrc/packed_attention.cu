// Kernel A: exact-softmax attention on head-packed (B, S, H*D) tensors,
// any head dim D % 64 == 0, bf16 or fp32, with an optional base-2
// log-sum-exp output for the backward (kernel E).
//
// Replaces lvd_tpu/ops/pallas_attention.py `_pallas_attention_heads`
// (`_attn_kernel_heads`, long keys), `_pallas_attention_shortkey`
// (`_cross_kernel`, S_k <= 256) and `_pallas_attention` (`_attn_kernel`, the
// (B*H, S, D) layout of the public sdpa(), which is the packed layout with
// one head). The TPU kernels differ only in how they fit VMEM; on Hopper one
// flash-style kernel covers every key length.
//
// Bound on this card: at the spatial self-attention shapes (S = 2880 and
// 720) the QK^T and PV products dominate (4 * S_q * S_k * D operations per
// head, 0.515 ms at L0 in bf16), so the kernel is tensor-core bound, with
// one exp2 per logit close behind (2 G exps at L0, about 0.5 ms of the
// SMs' special-function units); at the 77-key cross-attention it reads q
// and writes o once and is bound by memory.
//
// bf16, D = 64 and 128 (every UNet attention is D = 64): a warp-specialised
// wgmma kernel. One block per (128-query tile, batch*head): two consumer
// warpgroups of 64 query rows each and one producer warp.
//  - Loads: the producer's one lane keeps a ring of three K/V stages in
//    flight with TMA (cp.async.bulk.tensor) and mbarriers (full: bytes
//    landed; empty: all eight consumer warps are done with the stage), and
//    loads the block's Q tile once. A 3-D tensor map over (B, S, C) with a
//    box of (64 columns, rows, 1) reads head h at column h*D with no
//    relayout (D = 128 is two boxes); rows past S read as zero, so a tile
//    never takes the next batch's keys. Tiles land 128-byte swizzled.
//  - Products: S = Q K^T with wgmma m64nNk16 (Q and K from shared memory,
//    both K-major as stored; N = 128 keys at D = 64, 64 at D = 128), then
//    O += P V with P from registers and V from shared memory as a
//    transposed (MN-major) operand, 64 output columns per instruction.
//  - Softmax in registers: the row max and sum on the accumulator fragment
//    with quad shuffles, scale*log2(e) folded into one fma before exp2, O
//    rescaled in registers, P packed to bf16 straight into the A operand.
//    Keys past S_k are masked to -inf before the max. Nothing of S, P or O
//    touches shared memory until the epilogue, which normalises by l and
//    stages each warp's 16 rows in its own (now free) Q rows, swizzled, for
//    16-byte stores; query rows past S_q are not stored.
//  - Registers: BK/2 S accumulators (64 at D = 64, 32 at D = 128), D/2 O
//    accumulators and BK/4 packed P registers a thread, within the 224
//    that 288 threads leave each (ptxas: 154 and 145, no spills).
// fp32, D = 64 and 128: TF32 wgmma takes only K-major operands, so the
// same register-resident design runs on mma.sync m16n8k8 (TF32, fp32
// accumulators): eight warps of 16 query rows, 64-key K/V tiles in a
// two-stage cp.async ring, the same softmax on the m16n8 accumulator
// fragments, P fed from the accumulators to the PV product (csrc/
// warp_mma.cuh). Shared memory: 102 KB at D = 64, 198 KB at D = 128.
//
// Other head dims (lvd_tpu's row-1 and packed predicates take any D % 64 ==
// 0, e.g. 192 or 256 through the public sdpa()) take a D-sliced form: block
// z of a (head, query tile) owns output columns [64z, 64z + 64). Its logits
// are summed over D in 64-wide chunks (the Q and K chunks staged in shared
// memory, the warp's four (16, 16) logit accumulators in registers) before
// the same online softmax and O += P V[:, slice], on WMMA with the logits,
// P and O in shared memory. Each of the D/64 blocks of a query tile
// recomputes the logits, so QK^T costs D/64 times its share.
//
// Log-sum-exp: with a non-null `lse` (B*H, S_q) fp32, every form writes
// m + log2(l) of each query row in base-2 units of the scaled logits
// (log2(e) * scale * q.k), which kernel E reads to recompute P.
#include "common.cuh"
#include "hopper.cuh"
#include "warp_mma.cuh"

namespace lvd {
namespace {

constexpr int kBQ = 64;     // queries per block
constexpr int kBK = 64;     // keys per tile
constexpr int kWarps = 4;
constexpr int kLdS = 72;    // fp32 S row stride (288 B)

template <typename T, int D>
struct AttnCfg {
  static constexpr int kLdD = D + kPad<T>;    // Q/K/V rows
  static constexpr int kLdP = kBK + kPad<T>;  // P rows
  static constexpr int kLdO = D + 8;          // fp32 O rows
  static constexpr int kSmem = 3 * kBQ * kLdD * (int)sizeof(T)     // Q, K, V tiles
                               + kWarps * 16 * (kLdS + kLdO) * 4    // per-warp S and O
                               + kWarps * 16 * kLdP * (int)sizeof(T);  // per-warp P
};

// Copies rows [r0, r0 + 64) x D columns from `src` (row stride C) into a
// (64, kLdD) shared tile of AttnCfg<T, D>; rows past `rows` are zero.
template <typename T, int D>
__device__ inline void load_rows(T* dst, const T* src, int r0, int rows, int C) {
  constexpr int V = kVecN<T>, DV = D / V, ld = AttnCfg<T, D>::kLdD;
  for (int i = threadIdx.x; i < kBK * DV; i += kWarps * 32) {
    const int r = i / DV, cv = i % DV;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * C + cv * V);
    *reinterpret_cast<uint4*>(dst + r * ld + cv * V) = val;
  }
}

// One online-softmax step over a warp's (16, 64) tile of raw logits S (base
// 2 after scaling, keys past kvalid masked): P = exp2(S - m_new) in T, the
// running max and sum updated and the warp's (16, D) fp32 O rescaled. Each
// row is owned by two lanes: 32 of the 64 logits and D/2 of the D columns.
template <typename T, int D>
__device__ inline void softmax_step(float* S, T* P, float* O, int kvalid, float scale_log2e,
                                    int lane, float& m_i, float& l_i) {
  constexpr int kLdP = AttnCfg<T, D>::kLdP, kLdO = AttnCfg<T, D>::kLdO;
  const int row = lane >> 1, half = lane & 1;
  float* srow = S + row * kLdS + half * 32;
  float mx = -INFINITY;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const float s = (half * 32 + j < kvalid) ? srow[j] * scale_log2e : -INFINITY;
    srow[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(m_i, mx);
  const float alpha = exp2f(m_i - m_new);
  float sum = 0.f;
  T* prow = P + row * kLdP + half * 32;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const float p = exp2f(srow[j] - m_new);
    sum += p;
    prow[j] = from_f<T>(p);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  l_i = l_i * alpha + sum;
  m_i = m_new;
  float* orow = O + row * kLdO + half * (D / 2);
#pragma unroll 8
  for (int j = 0; j < D / 2; ++j) orow[j] *= alpha;
  __syncwarp();
}

// O (16, D, fp32) += P (16, 64) V, V a (64, kLdD) shared tile.
template <typename T, int D>
__device__ inline void pv_product(float* O, const T* P, const T* Vs) {
  using M = Mma<T>;
  constexpr int kLdD = AttnCfg<T, D>::kLdD, kLdP = AttnCfg<T, D>::kLdP;
  constexpr int kLdO = AttnCfg<T, D>::kLdO;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    typename M::Acc acc;
    wmma::load_matrix_sync(acc, O + n * 16, kLdO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBK / M::K; ++kk) {
      typename M::A pf;
      typename M::BRow vf;
      load_op(pf, P + kk * M::K, kLdP);
      load_op(vf, Vs + kk * M::K * kLdD + n * 16, kLdD);
      wmma::mma_sync(acc, pf, vf, acc);
    }
    wmma::store_matrix_sync(O + n * 16, acc, kLdO, wmma::mem_row_major);
  }
  __syncwarp();
}

// Writes the warp's row of O / l (D columns, half of them per lane) to dst.
template <typename T, int D>
__device__ inline void store_o(const float* O, float l_i, T* dst, int lane) {
  constexpr int V = kVecN<T>, kLdO = AttnCfg<T, D>::kLdO;
  const int row = lane >> 1, half = lane & 1;
  const float inv = 1.f / l_i;
  const float* orow = O + row * kLdO + half * (D / 2);
  dst += half * (D / 2);
#pragma unroll
  for (int j = 0; j < D / 2; j += V) {
    Vec<T> pack;
#pragma unroll
    for (int e = 0; e < V; ++e) pack.h[e] = from_f<T>(orow[j + e] * inv);
    *reinterpret_cast<uint4*>(dst + j) = pack.u;
  }
}

// The D-sliced form (head dims other than 64 and 128): grid (B*H, query
// tiles, D/64), block z writes output columns [64z, 64z + 64) of its head
// with the tiles of D = 64.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attn_sliced_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk, int C, int D,
                   float scale_log2e) {
  using M = Mma<T>;
  using Cfg = AttnCfg<T, 64>;
  constexpr int kLdD = Cfg::kLdD, kLdP = Cfg::kLdP, kLdO = Cfg::kLdO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // chunks at d0
  T* Ks = Qs + kBQ * kLdD;
  T* Vs = Ks + kBK * kLdD;  // the block's slice of V
  float* Sw = reinterpret_cast<float*>(Vs + kBK * kLdD);
  float* Ow = Sw + kWarps * 16 * kLdS;
  T* Pw = reinterpret_cast<T*>(Ow + kWarps * 16 * kLdO);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBQ;
  const int slice = blockIdx.z * 64;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qb = q + (size_t)b * Sq * C + h * D;
  const T* kb = k + (size_t)b * Sk * C + h * D;
  const T* vb = v + (size_t)b * Sk * C + h * D + slice;

  float* S = Sw + warp * 16 * kLdS;
  float* O = Ow + warp * 16 * kLdO;
  T* P = Pw + warp * 16 * kLdP;
  for (int i = lane; i < 16 * 64; i += 32) O[(i / 64) * kLdO + i % 64] = 0.f;
  float m_i = -INFINITY;
  float l_i = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    // S = Q K^T for this warp's 16 rows, summed over D in 64-wide chunks.
    typename M::Acc acc[kBK / 16];
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
    for (int d0 = 0; d0 < D; d0 += 64) {
      __syncthreads();  // every warp is done with the previous chunks and V tile
      load_rows<T, 64>(Qs, qb + d0, q0, Sq, C);
      load_rows<T, 64>(Ks, kb + d0, k0, Sk, C);
      if (d0 == 0) load_rows<T, 64>(Vs, vb, k0, Sk, C);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 64; kk += M::K) {
        typename M::A qf;
        load_op(qf, Qs + warp * 16 * kLdD + kk, kLdD);
#pragma unroll
        for (int n = 0; n < kBK / 16; ++n) {
          typename M::BCol kf;
          load_op(kf, Ks + n * 16 * kLdD + kk, kLdD);
          wmma::mma_sync(acc[n], qf, kf, acc[n]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n)
      wmma::store_matrix_sync(S + n * 16, acc[n], kLdS, wmma::mem_row_major);
    __syncwarp();
    softmax_step<T, 64>(S, P, O, min(kBK, Sk - k0), scale_log2e, lane, m_i, l_i);
    pv_product<T, 64>(O, P, Vs);  // O += P V[:, slice]
  }

  const int qr = q0 + warp * 16 + (lane >> 1);
  if (qr < Sq) store_o<T, 64>(O, l_i, o + ((size_t)b * Sq + qr) * C + h * D + slice, lane);
  if (lse != nullptr && blockIdx.z == 0 && (lane & 1) == 0 && qr < Sq)
    lse[(size_t)blockIdx.x * Sq + qr] = m_i + log2f(l_i);
}

template <typename T>
cudaError_t launch_sliced(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                          int H, int Sq, int Sk, int C, int D, float scale, cudaStream_t stream) {
  constexpr int smem = AttnCfg<T, 64>::kSmem;
  cudaError_t err = set_smem(attn_sliced_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ, D / 64);
  attn_sliced_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Sq, Sk, C, D, scale * 1.4426950408889634f);
  return cudaGetLastError();
}


// ---- bf16, D = 64 and 128: warp-specialised wgmma with a TMA ring ----

template <int D>
struct WgCfg {
  static constexpr int kBQ = 128;                 // queries per block: two warpgroups of 64
  static constexpr int kBK = D == 64 ? 128 : 64;  // keys per tile
  static constexpr int kStages = 3;               // K/V tiles in flight
  static constexpr int kHalves = D / 64;          // 128-byte boxes per row
  static constexpr int kThreads = 2 * 128 + 32;   // consumer warpgroups, then the producer warp
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;  // one K or V tile
  static constexpr int kBarOff = kQBytes + 2 * kStages * kTileBytes;
  // Q, the K/V ring, the barriers, and slack to align the start to 1024.
  static constexpr int kSmem = kBarOff + (2 * kStages + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(WgCfg<D>::kThreads, 1)
attn_packed_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                         float* __restrict__ lse, int H, int Sq, int Sk, int C,
                         float scale_log2e) {
  using Cfg = WgCfg<D>;
  constexpr int BK = Cfg::kBK, NS = Cfg::kStages, NH = Cfg::kHalves, NC = BK / 8;
  constexpr int kTileE = Cfg::kTileBytes / 2;  // elements of one K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(smem);                  // half hh at hh * 128 rows
  bf16* KVs = reinterpret_cast<bf16*>(smem + Cfg::kQBytes);  // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::kBarOff);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int q0 = blockIdx.x * Cfg::kBQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = (Sk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hop::mbar_init(qbar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer: one lane issues every TMA load
    if (lane == 0) {
      hop::mbar_expect_tx(qbar, Cfg::kQBytes);
      for (int hh = 0; hh < NH; ++hh)
        hop::tma_load_3d(Qs + hh * Cfg::kBQ * 64, &tm_q, qbar, h * D + hh * 64, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % NS;
        if (j >= NS) hop::mbar_wait(&empty[s], (j / NS - 1) & 1);
        hop::mbar_expect_tx(&full[s], 2 * Cfg::kTileBytes);
        bf16* Kt = KVs + 2 * s * kTileE;
        for (int hh = 0; hh < NH; ++hh) {
          hop::tma_load_3d(Kt + hh * BK * 64, &tm_k, &full[s], h * D + hh * 64, j * BK, b);
          hop::tma_load_3d(Kt + kTileE + hh * BK * 64, &tm_v, &full[s], h * D + hh * 64, j * BK,
                           b);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the
  // tile; lane l of warp wq owns rows r = 16 wq + l/4 and r + 8.
  const int wg = warp / 4, wq = warp % 4;
  const int cq = 2 * (lane % 4);
  const bf16* Qw = Qs + wg * 64 * 64;
  float oacc[NH][32];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[hh][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  hop::mbar_wait(qbar, 0);

  for (int j = 0; j < nk; ++j) {
    const int s = j % NS;
    hop::mbar_wait(&full[s], (j / NS) & 1);
    const bf16* Kt = KVs + 2 * s * kTileE;
    const bf16* Vt = Kt + kTileE;

    // S = Q K^T (64 rows x BK keys of this warpgroup).
    float sacc[BK / 2];
    hop::wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = hop::desc_sw128(Qw + hh * Cfg::kBQ * 64 + kk * 16);
        const uint64_t db = hop::desc_sw128(Kt + hh * BK * 64 + kk * 16);
        if constexpr (BK == 128) {
          hop::wgmma_ss_n128(sacc, da, db, hh + kk);
        } else {
          hop::wgmma_ss_n64(sacc, da, db, hh + kk);
        }
      }
    }
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(sacc);

    if ((j + 1) * BK > Sk) {  // keys past S_k
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int key = j * BK + 8 * c + cq;
        if (key >= Sk) sacc[4 * c] = sacc[4 * c + 2] = -INFINITY;
        if (key + 1 >= Sk) sacc[4 * c + 1] = sacc[4 * c + 3] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * c], sacc[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * c + 2], sacc[4 * c + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * scale_log2e), mn1 = fmaxf(m1, mx1 * scale_log2e);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P = exp2(S * scale * log2e - m), packed to bf16 as the A operand.
    uint32_t pa[BK / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float p0 = exp2f(fmaf(sacc[4 * c], scale_log2e, -mn0));
      const float p1 = exp2f(fmaf(sacc[4 * c + 1], scale_log2e, -mn0));
      const float p2 = exp2f(fmaf(sacc[4 * c + 2], scale_log2e, -mn1));
      const float p3 = exp2f(fmaf(sacc[4 * c + 3], scale_log2e, -mn1));
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pa[c / 2][(c % 2) * 2] = pack_bf16(p0, p1);
      pa[c / 2][(c % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        oacc[hh][4 * c] *= al0;
        oacc[hh][4 * c + 1] *= al0;
        oacc[hh][4 * c + 2] *= al1;
        oacc[hh][4 * c + 3] *= al1;
      }
    }

    // O += P V, 64 output columns per instruction.
    hop::wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hop::wgmma_rs_n64_tn(oacc[hh], pa[kk], hop::desc_sw128(Vt + hh * BK * 64 + kk * 16 * 64));
    }
    hop::wgmma_commit();
    hop::wgmma_wait_all();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) hop::fence_regs(oacc[hh]);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int r = lane / 4;
  const int wrow = q0 + wg * 64 + wq * 16;  // the warp's first query row
  if (lse != nullptr && lane % 4 == 0) {
    if (wrow + r < Sq) lse[(size_t)bh * Sq + wrow + r] = m0 + log2f(l0);
    if (wrow + r + 8 < Sq) lse[(size_t)bh * Sq + wrow + r + 8] = m1 + log2f(l1);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  // Stage O / l in the warp's own 16 rows of Q (every product that read
  // them has completed), 16-byte chunk c of row r at chunk c ^ (r % 8).
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    bf16* st = Qs + hh * Cfg::kBQ * 64 + (wg * 64 + wq * 16) * 64;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = ((c ^ r) * 8) + cq;
      *reinterpret_cast<uint32_t*>(st + r * 64 + col) =
          pack_bf16(oacc[hh][4 * c] * inv0, oacc[hh][4 * c + 1] * inv0);
      *reinterpret_cast<uint32_t*>(st + (r + 8) * 64 + col) =
          pack_bf16(oacc[hh][4 * c + 2] * inv1, oacc[hh][4 * c + 3] * inv1);
    }
  }
  __syncwarp();
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    const bf16* st = Qs + hh * Cfg::kBQ * 64 + (wg * 64 + wq * 16) * 64;
#pragma unroll
    for (int i = lane; i < 16 * 8; i += 32) {
      const int rr = i / 8, cc = i % 8;
      if (wrow + rr < Sq)
        *reinterpret_cast<uint4*>(o + ((size_t)b * Sq + wrow + rr) * C + h * D + hh * 64 +
                                  cc * 8) =
            *reinterpret_cast<const uint4*>(st + rr * 64 + ((cc ^ (rr % 8)) * 8));
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                         int H, int Sq, int Sk, int C, float scale, cudaStream_t stream) {
  using Cfg = WgCfg<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map_bsc(&tq, q, B, Sq, C, Cfg::kBQ);
  if (err == cudaSuccess) err = make_map_bsc(&tk, k, B, Sk, C, Cfg::kBK);
  if (err == cudaSuccess) err = make_map_bsc(&tv, v, B, Sk, C, Cfg::kBK);
  if (err == cudaSuccess) err = set_smem(attn_packed_kernel_wgmma<D>, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + Cfg::kBQ - 1) / Cfg::kBQ, B * H);
  attn_packed_kernel_wgmma<D><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, H, Sq, Sk, C, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---- fp32, D = 64 and 128: mma.sync TF32 with a cp.async ring ----

template <int D>
struct F32Cfg {
  static constexpr int kWarps = 8;
  static constexpr int kBQ = 16 * kWarps;  // queries per block
  static constexpr int kBK = 64;           // keys per tile
  static constexpr int kLd = D + 4;        // row stride (floats): 16 bytes of padding
  static constexpr int kTile = kBK * kLd;  // floats of one K or V tile
  static constexpr int kSmem = (kBQ * kLd + 4 * kTile) * 4;  // Q, two stages of K and V
};

template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::kWarps * 32)
attn_packed_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int H, int Sq, int Sk, int C,
                       float scale_log2e) {
  using Cfg = F32Cfg<D>;
  using W = wm::WarpMma<float>;
  constexpr int ld = Cfg::kLd, BK = Cfg::kBK, NC = BK / 8, ND = D / 8;
  constexpr int kThreads = Cfg::kWarps * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* KVs = Qs + Cfg::kBQ * ld;  // stage s: K at 2s, V at 2s + 1
  const int q0 = blockIdx.x * Cfg::kBQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* kb = k + (size_t)b * Sk * C + h * D;
  const float* vb = v + (size_t)b * Sk * C + h * D;
  const int nk = (Sk + BK - 1) / BK;

  wm::cp_rows<float, D>(Qs, ld, q + (size_t)b * Sq * C + h * D, q0, Cfg::kBQ, Sq, C, kThreads);
  wm::cp_rows<float, D>(KVs, ld, kb, 0, BK, Sk, C, kThreads);
  wm::cp_rows<float, D>(KVs + Cfg::kTile, ld, vb, 0, BK, Sk, C, kThreads);
  wm::cp_async_commit();

  float oacc[ND][4] = {};
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int cq = 2 * (lane % 4);
  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {  // the next tile into the other stage (free since the last barrier)
      float* nxt = KVs + 2 * ((j + 1) & 1) * Cfg::kTile;
      wm::cp_rows<float, D>(nxt, ld, kb, (j + 1) * BK, BK, Sk, C, kThreads);
      wm::cp_rows<float, D>(nxt + Cfg::kTile, ld, vb, (j + 1) * BK, BK, Sk, C, kThreads);
    }
    wm::cp_async_commit();
    wm::cp_async_wait<1>();
    __syncthreads();
    const float* Kt = KVs + 2 * (j & 1) * Cfg::kTile;
    const float* Vt = Kt + Cfg::kTile;

    float sacc[NC][4] = {};
    wm::mma_rows_nk<float, NC>(sacc, Qs + warp * 16 * ld, Kt, ld, D, lane);
    if ((j + 1) * BK > Sk) {  // keys past S_k
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int key = j * BK + 8 * c + cq;
        if (key >= Sk) sacc[c][0] = sacc[c][2] = -INFINITY;
        if (key + 1 >= Sk) sacc[c][1] = sacc[c][3] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      mx0 = fmaxf(mx0, fmaxf(sacc[c][0], sacc[c][1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[c][2], sacc[c][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * scale_log2e), mn1 = fmaxf(m1, mx1 * scale_log2e);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {  // P in place of S
      sacc[c][0] = exp2f(fmaf(sacc[c][0], scale_log2e, -mn0));
      sacc[c][1] = exp2f(fmaf(sacc[c][1], scale_log2e, -mn0));
      sacc[c][2] = exp2f(fmaf(sacc[c][2], scale_log2e, -mn1));
      sacc[c][3] = exp2f(fmaf(sacc[c][3], scale_log2e, -mn1));
      ps0 += sacc[c][0] + sacc[c][1];
      ps1 += sacc[c][2] + sacc[c][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= al0;
      oacc[n][1] *= al0;
      oacc[n][2] *= al1;
      oacc[n][3] *= al1;
    }
    wm::mma_acc_kn<float, NC, ND>(oacc, sacc, Vt, ld, lane);
    __syncthreads();  // every warp is done with this stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int row0 = q0 + warp * 16 + lane / 4;
  if (lse != nullptr && lane % 4 == 0) {
    if (row0 < Sq) lse[(size_t)bh * Sq + row0] = m0 + log2f(l0);
    if (row0 + 8 < Sq) lse[(size_t)bh * Sq + row0 + 8] = m1 + log2f(l1);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  float* ob = o + (size_t)b * Sq * C + h * D + cq;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (row0 < Sq) W::store2(ob + (size_t)row0 * C + 8 * n, oacc[n][0] * inv0, oacc[n][1] * inv0);
    if (row0 + 8 < Sq)
      W::store2(ob + (size_t)(row0 + 8) * C + 8 * n, oacc[n][2] * inv1, oacc[n][3] * inv1);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int H, int Sq, int Sk, int C, float scale, cudaStream_t stream) {
  using Cfg = F32Cfg<D>;
  cudaError_t err = set_smem(attn_packed_kernel_f32<D>, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + Cfg::kBQ - 1) / Cfg::kBQ, B * H);
  attn_packed_kernel_f32<D><<<grid, Cfg::kWarps * 32, Cfg::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, Sq, Sk, C, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lvd

// q: (B, Sq, C), k/v: (B, Sk, C), o: (B, Sq, C), all of one type (dtype 0
// bf16, 1 fp32); C = H*D with head dim D % 64 == 0 (64 and 128 run their
// own kernels, every other D the D-sliced form). lse: null, or (B*H, Sq)
// fp32 to receive each query row's base-2 log-sum-exp.
LVD_EXPORT int lvd_attention_packed(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int H, int Sq, int Sk, int C, float scale,
                                    int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();  // clear any stale error so the return value is this launch's
  if (H <= 0 || C % H != 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  const int D = C / H;
  if (D % 64 != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  return dispatch(dtype, [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    if (D == 64 || D == 128) {
      if constexpr (sizeof(T) == 2) {
        return D == 64 ? launch_wgmma<64>(q, k, v, o, l, B, H, Sq, Sk, C, scale, s)
                       : launch_wgmma<128>(q, k, v, o, l, B, H, Sq, Sk, C, scale, s);
      } else {
        return D == 64 ? launch_f32<64>(q, k, v, o, l, B, H, Sq, Sk, C, scale, s)
                       : launch_f32<128>(q, k, v, o, l, B, H, Sq, Sk, C, scale, s);
      }
    }
    return launch_sliced<T>(q, k, v, o, l, B, H, Sq, Sk, C, D, scale, s);
  });
}

// Bytes of dynamic shared memory one block of kernel A takes at head dim D
// (dtype 0 bf16, 1 fp32): the D = 64 / 128 kernels, else the D-sliced form.
LVD_EXPORT long long lvd_attention_packed_smem(int D, int dtype) {
  using namespace lvd;
  const bool b16 = dtype == kBF16;
  if (D == 64) return b16 ? WgCfg<64>::kSmem : F32Cfg<64>::kSmem;
  if (D == 128) return b16 ? WgCfg<128>::kSmem : F32Cfg<128>::kSmem;
  return b16 ? AttnCfg<bf16, 64>::kSmem : AttnCfg<float, 64>::kSmem;
}
