// Kernel A: exact-softmax attention on head-packed (B, S, H*64) tensors.
//
// Replaces lvd_tpu/ops/pallas_attention.py `_pallas_attention_heads`
// (`_attn_kernel_heads`, long keys) and `_pallas_attention_shortkey`
// (`_cross_kernel`, S_k <= 256). The two TPU kernels differ only in how they
// fit VMEM; on Hopper one flash-style kernel covers every key length.
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
#include "common.cuh"

namespace lvd {
namespace {

constexpr int kD = 64;      // head dim
constexpr int kBQ = 64;     // queries per block
constexpr int kBK = 64;     // keys per tile
constexpr int kWarps = 4;
constexpr int kLdb = 80;    // bf16 smem row stride (160 B)
constexpr int kLdf = 72;    // fp32 smem row stride (288 B)

constexpr int kSmemBytes =
    3 * kBQ * kLdb * 2                 // Q, K, V tiles
    + 2 * kWarps * 16 * kLdf * 4       // per-warp S and O
    + kWarps * 16 * kLdb * 2;          // per-warp P

__global__ void __launch_bounds__(kWarps * 32)
attn_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   int H, int Sq, int Sk, int C, float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * kLdb;
  bf16* Vs = Ks + kBK * kLdb;
  float* Sw = reinterpret_cast<float*>(Vs + kBK * kLdb);
  float* Ow = Sw + kWarps * 16 * kLdf;
  bf16* Pw = reinterpret_cast<bf16*>(Ow + kWarps * 16 * kLdf);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const bf16* qb = q + (size_t)b * Sq * C + h * kD;
  const bf16* kb = k + (size_t)b * Sk * C + h * kD;
  const bf16* vb = v + (size_t)b * Sk * C + h * kD;

  for (int i = tid; i < kBQ * 8; i += kWarps * 32) {
    const int r = i / 8, c8 = i % 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * C + c8 * 8);
    *reinterpret_cast<uint4*>(Qs + r * kLdb + c8 * 8) = val;
  }
  float* S = Sw + warp * 16 * kLdf;
  float* O = Ow + warp * 16 * kLdf;
  bf16* P = Pw + warp * 16 * kLdb;
  for (int i = lane; i < 16 * kD; i += 32) O[(i / kD) * kLdf + i % kD] = 0.f;
  __syncthreads();

  FragA qf[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * kLdb + kk * 16, kLdb);

  // Each row of the warp's 16 is owned by two lanes, 32 columns each.
  const int row = lane >> 1;
  const int half = lane & 1;
  float m_i = -INFINITY;
  float l_i = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kBK * 8; i += kWarps * 32) {
      const int r = i / 8, c8 = i % 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * C + c8 * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * C + c8 * 8);
      }
      *reinterpret_cast<uint4*>(Ks + r * kLdb + c8 * 8) = kv;
      *reinterpret_cast<uint4*>(Vs + r * kLdb + c8 * 8) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows.
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        FragBCol kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * kLdb + kk * 16, kLdb);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(S + n * 16, acc, kLdf, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this tile (base-2 logits, masked key tail).
    const int kvalid = min(kBK, Sk - k0);
    float* srow = S + row * kLdf + half * 32;
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
    bf16* prow = P + row * kLdb + half * 32;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const float p = exp2f(srow[j] - m_new);
      sum += p;
      prow[j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    float* orow = O + row * kLdf + half * 32;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) orow[j] *= alpha;
    __syncwarp();

    // O += P V
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      FragAcc acc;
      wmma::load_matrix_sync(acc, O + n * 16, kLdf, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        FragA pf;
        FragBRow vf;
        wmma::load_matrix_sync(pf, P + kk * 16, kLdb);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * kLdb + n * 16, kLdb);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(O + n * 16, acc, kLdf, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int qr = q0 + warp * 16 + row;
  if (qr < Sq) {
    const float inv = 1.f / l_i;
    const float* orow = O + row * kLdf + half * 32;
    bf16* dst = o + ((size_t)b * Sq + qr) * C + h * kD + half * 32;
#pragma unroll
    for (int j = 0; j < 32; j += 8) {
      Vec8 pack;
#pragma unroll
      for (int e = 0; e < 8; ++e) pack.h[e] = __float2bfloat16(orow[j + e] * inv);
      *reinterpret_cast<uint4*>(dst + j) = pack.u;
    }
  }
}

}  // namespace
}  // namespace lvd

// q: (B, Sq, C), k/v: (B, Sk, C), o: (B, Sq, C), all bf16, C = H*64.
LVD_EXPORT int lvd_attention_packed(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int Sq, int Sk, int C, float scale,
                                    void* stream) {
  using namespace lvd;
  cudaGetLastError();  // clear any stale error so the return value is this launch's
  if (C != H * kD || C % 8 != 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(attn_packed_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  attn_packed_kernel<<<grid, kWarps * 32, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, Sq, Sk, C, scale * 1.4426950408889634f);
  return cudaGetLastError();
}
