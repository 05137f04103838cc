// Kernel A: exact-softmax attention on head-packed (B, S, H*D) tensors,
// D in {64, 128}, bf16 or fp32.
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

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_packed_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, int H, int Sq, int Sk, int C, float scale_log2e) {
  using M = Mma<T>;
  using Cfg = AttnCfg<T, D>;
  constexpr int kLdD = Cfg::kLdD, kLdP = Cfg::kLdP, kLdO = Cfg::kLdO;
  constexpr int V = kVecN<T>;
  constexpr int DV = D / V;  // vectors per row
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
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* qb = q + (size_t)b * Sq * C + h * D;
  const T* kb = k + (size_t)b * Sk * C + h * D;
  const T* vb = v + (size_t)b * Sk * C + h * D;

  for (int i = tid; i < kBQ * DV; i += kWarps * 32) {
    const int r = i / DV, cv = i % DV;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * C + cv * V);
    *reinterpret_cast<uint4*>(Qs + r * kLdD + cv * V) = val;
  }
  float* S = Sw + warp * 16 * kLdS;
  float* O = Ow + warp * 16 * kLdO;
  T* P = Pw + warp * 16 * kLdP;
  for (int i = lane; i < 16 * D; i += 32) O[(i / D) * kLdO + i % D] = 0.f;
  __syncthreads();

  typename M::A qf[D / M::K];
#pragma unroll
  for (int kk = 0; kk < D / M::K; ++kk)
    load_op(qf[kk], Qs + warp * 16 * kLdD + kk * M::K, kLdD);

  // Each row of the warp's 16 is owned by two lanes: 32 of the 64 logits and
  // D/2 of the D output columns each.
  const int row = lane >> 1;
  const int half = lane & 1;
  float m_i = -INFINITY;
  float l_i = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kBK * DV; i += kWarps * 32) {
      const int r = i / DV, cv = i % DV;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * C + cv * V);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * C + cv * V);
      }
      *reinterpret_cast<uint4*>(Ks + r * kLdD + cv * V) = kv;
      *reinterpret_cast<uint4*>(Vs + r * kLdD + cv * V) = vv;
    }
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

    // Online softmax over this tile (base-2 logits, masked key tail).
    const int kvalid = min(kBK, Sk - k0);
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

    // O += P V
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

  const int qr = q0 + warp * 16 + row;
  if (qr < Sq) {
    const float inv = 1.f / l_i;
    const float* orow = O + row * kLdO + half * (D / 2);
    T* dst = o + ((size_t)b * Sq + qr) * C + h * D + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; j += V) {
      Vec<T> pack;
#pragma unroll
      for (int e = 0; e < V; ++e) pack.h[e] = from_f<T>(orow[j + e] * inv);
      *reinterpret_cast<uint4*>(dst + j) = pack.u;
    }
  }
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
// bf16, 1 fp32); C = H*D with head dim D in {64, 128}.
LVD_EXPORT int lvd_attention_packed(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int Sq, int Sk, int C, float scale, int dtype,
                                    void* stream) {
  using namespace lvd;
  cudaGetLastError();  // clear any stale error so the return value is this launch's
  if (H <= 0 || C % H != 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  const int D = C / H;
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    return D == 64 ? launch<T, 64>(q, k, v, o, B, H, Sq, Sk, C, scale, s)
                   : launch<T, 128>(q, k, v, o, B, H, Sq, Sk, C, scale, s);
  });
}
