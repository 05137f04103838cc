// Kernel A: exact-softmax attention on head-packed (B, S, H*D) tensors,
// any head dim D % 64 == 0, bf16 or fp32.
//
// Replaces lvd_tpu/ops/pallas_attention.py `_pallas_attention_heads`
// (`_attn_kernel_heads`, long keys), `_pallas_attention_shortkey`
// (`_cross_kernel`, S_k <= 256) and `_pallas_attention` (`_attn_kernel`, the
// (B*H, S, D) layout of the public sdpa(), which is the packed layout with
// one head). The TPU kernels differ only in how they fit VMEM; on Hopper one
// flash-style kernel covers every key length.
//
// Bound on this card: at the spatial self-attention shapes (S = 2880 and 720)
// the QK^T and PV products dominate and the kernel is tensor-core bound; at
// the 77-key cross-attention it reads q and writes o once and is bound by
// memory. Design: one block per (batch*head, 64-query tile), four warps of
// 16 query rows each. Head h is read at column offset h*64 of the packed
// rows, so q/k/v/o need no relayout. K/V stream through shared memory in
// 64-key tiles; logits and O accumulate in fp32 with a running row max
// (online softmax), so no (S_q, S_k) tensor ever reaches device memory.
// Ragged query and key tails are masked (77, 45 and 180 are not multiples of
// 64). The TPU kernel's clamped no-max exp2 shortcut is not carried over.
//
// Shared memory (Q, K, V tiles in T; per-warp fp32 S and O; per-warp P in
// T): bf16 D=64 76 KB, bf16 D=128 116 KB, fp32 D=64 108 KB, fp32 D=128
// 172 KB. fp32 runs its products in TF32 (m16n16k8) and keeps P in fp32.
//
// Other head dims (lvd_tpu's row-1 and packed predicates take any D % 64 ==
// 0, e.g. 192 or 256 through the public sdpa()) take a D-sliced form: block
// z of a (head, query tile) owns output columns [64z, 64z + 64). Its logits
// are summed over D in 64-wide chunks (the Q and K chunks staged in shared
// memory, the warp's four (16, 16) logit accumulators in registers) before
// the same online softmax and O += P V[:, slice]. Shared memory and
// registers are those of D = 64 whatever D is; each of the D/64 blocks of a
// query tile recomputes the logits, so QK^T costs D/64 times its share.
#include "common.cuh"

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

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_packed_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, int H, int Sq, int Sk, int C, float scale_log2e) {
  using M = Mma<T>;
  using Cfg = AttnCfg<T, D>;
  constexpr int kLdD = Cfg::kLdD, kLdP = Cfg::kLdP, kLdO = Cfg::kLdO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBQ * kLdD;
  T* Vs = Ks + kBK * kLdD;
  float* Sw = reinterpret_cast<float*>(Vs + kBK * kLdD);
  float* Ow = Sw + kWarps * 16 * kLdS;
  T* Pw = reinterpret_cast<T*>(Ow + kWarps * 16 * kLdO);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* kb = k + (size_t)b * Sk * C + h * D;
  const T* vb = v + (size_t)b * Sk * C + h * D;

  load_rows<T, D>(Qs, q + (size_t)b * Sq * C + h * D, q0, Sq, C);
  float* S = Sw + warp * 16 * kLdS;
  float* O = Ow + warp * 16 * kLdO;
  T* P = Pw + warp * 16 * kLdP;
  for (int i = lane; i < 16 * D; i += 32) O[(i / D) * kLdO + i % D] = 0.f;
  __syncthreads();

  typename M::A qf[D / M::K];
#pragma unroll
  for (int kk = 0; kk < D / M::K; ++kk)
    load_op(qf[kk], Qs + warp * 16 * kLdD + kk * M::K, kLdD);
  float m_i = -INFINITY;
  float l_i = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, D>(Ks, kb, k0, Sk, C);
    load_rows<T, D>(Vs, vb, k0, Sk, C);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows.
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / M::K; ++kk) {
        typename M::BCol kf;
        load_op(kf, Ks + n * 16 * kLdD + kk * M::K, kLdD);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(S + n * 16, acc, kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    softmax_step<T, D>(S, P, O, min(kBK, Sk - k0), scale_log2e, lane, m_i, l_i);
    pv_product<T, D>(O, P, Vs);
  }

  const int qr = q0 + warp * 16 + (lane >> 1);
  if (qr < Sq) store_o<T, D>(O, l_i, o + ((size_t)b * Sq + qr) * C + h * D, lane);
}

// The D-sliced form (head dims other than 64 and 128): grid (B*H, query
// tiles, D/64), block z writes output columns [64z, 64z + 64) of its head
// with the tiles of D = 64.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attn_sliced_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, int H, int Sq, int Sk, int C, int D, float scale_log2e) {
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
}

template <typename T>
cudaError_t launch_sliced(const void* q, const void* k, const void* v, void* o, int B, int H,
                          int Sq, int Sk, int C, int D, float scale, cudaStream_t stream) {
  constexpr int smem = AttnCfg<T, 64>::kSmem;
  cudaError_t err = set_smem(attn_sliced_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ, D / 64);
  attn_sliced_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Sq, Sk, C, D, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                   int Sk, int C, float scale, cudaStream_t stream) {
  constexpr int smem = AttnCfg<T, D>::kSmem;
  cudaError_t err = set_smem(attn_packed_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  attn_packed_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Sq, Sk, C, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lvd

// q: (B, Sq, C), k/v: (B, Sk, C), o: (B, Sq, C), all of one type (dtype 0
// bf16, 1 fp32); C = H*D with head dim D % 64 == 0 (64 and 128 run their
// own instantiations, every other D the D-sliced form).
LVD_EXPORT int lvd_attention_packed(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int Sq, int Sk, int C, float scale, int dtype,
                                    void* stream) {
  using namespace lvd;
  cudaGetLastError();  // clear any stale error so the return value is this launch's
  if (H <= 0 || C % H != 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  const int D = C / H;
  if (D % 64 != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    if (D == 64) return launch<T, 64>(q, k, v, o, B, H, Sq, Sk, C, scale, s);
    if (D == 128) return launch<T, 128>(q, k, v, o, B, H, Sq, Sk, C, scale, s);
    return launch_sliced<T>(q, k, v, o, B, H, Sq, Sk, C, D, scale, s);
  });
}
