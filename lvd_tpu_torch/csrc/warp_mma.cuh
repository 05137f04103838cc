// Warp-level tensor-core products on mma.sync for the register-resident
// attention kernels (A in fp32; E in bf16 and fp32): each warp keeps its
// product accumulators in registers, reads its operands from shared memory
// (ldmatrix for bf16), and turns an accumulator straight into the A operand
// of the next product, so nothing of S, P or dS goes through shared memory.
//
// Fragments (g = lane / 4, t = lane % 4), m16n8 accumulators c[4]: (row g,
// columns 2t, 2t + 1) and (row g + 8, the same columns).
//  - bf16, m16n8k16: A (16 x 16) a[4], B (16 x 8) b[2]; two neighbouring
//    accumulator tiles packed to bf16 pairs are one A operand.
//  - fp32 in TF32, m16n8k8: A (16 x 8) a[4] = (g, t), (g + 8, t), (g, t + 4),
//    (g + 8, t + 4); B (8 x 8) b[2] = (t, g), (t + 4, g). An accumulator tile
//    holds columns 2t and 2t + 1 where the A operand wants t and t + 4, so
//    acc_to_a reads columns 2t, 2t + 1 as the A operand's k = t, t + 4, and
//    load_b_kn reads B's rows 2t, 2t + 1 to match: the product sums over the
//    same eight keys in another order. Every B operand read from k-rows
//    (load_b_kn) follows an accumulator A operand in these kernels.
// Shared-memory rows are padded by 16 bytes (kPadE elements), which makes
// ldmatrix and the fp32 fragment reads free of bank conflicts.
#pragma once

#include "common.cuh"

namespace lvd {
namespace wm {

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `count` threads:
// bar_sync waits for the others, bar_arrive only counts in (a warp that
// hands a shared tile on and need not wait). Both order the thread's prior
// shared-memory writes before the barrier completes.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies rows [r0, r0 + rows) x D columns of one head (row stride C) into a
// shared tile of row stride ld; rows at or past `lim` are zero. All
// `threads` threads of the block take part.
template <typename T, int D>
__device__ __forceinline__ void cp_rows(T* dst, int ld, const T* src, int r0, int rows, int lim,
                                        int C, int threads) {
  constexpr int V = kVecN<T>, DV = D / V;
  for (int i = threadIdx.x; i < rows * DV; i += threads) {
    const int r = i / DV, cv = i % DV;
    const bool ok = r0 + r < lim;
    cp_async16(dst + r * ld + cv * V, src + (ok ? (size_t)(r0 + r) * C + cv * V : 0), ok);
  }
}

template <typename T>
struct WarpMma;

template <>
struct WarpMma<bf16> {
  static constexpr int K = 16;     // depth of one product
  static constexpr int kPadE = 8;  // row padding, elements

  // A (16 x 16) from a row-major tile (k contiguous).
  __device__ static void load_a(uint32_t (&a)[4], const bf16* s, int ld, int lane) {
    ldmatrix_x4(a, s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4));
  }
  // B of two n-tiles (n 0-7, 8-15) from a tile whose rows are n (k contiguous).
  __device__ static void load_b_nk(uint32_t (&b0)[2], uint32_t (&b1)[2], const bf16* s, int ld,
                                   int lane) {
    uint32_t r[4];
    ldmatrix_x4(r, s + ((lane & 7) + 8 * (lane >> 4)) * ld + 8 * ((lane >> 3) & 1));
    b0[0] = r[0]; b0[1] = r[1]; b1[0] = r[2]; b1[1] = r[3];
  }
  // B of two n-tiles from a tile whose rows are k (n contiguous).
  __device__ static void load_b_kn(uint32_t (&b0)[2], uint32_t (&b1)[2], const bf16* s, int ld,
                                   int lane) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4));
    b0[0] = r[0]; b0[1] = r[1]; b1[0] = r[2]; b1[1] = r[3];
  }
  // The A operand of k-step kk from accumulator tiles 2kk and 2kk + 1.
  template <int NT>
  __device__ static void acc_to_a(uint32_t (&a)[4], const float (&c)[NT][4], int kk) {
    a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
  __device__ static void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // Stores a row pair (columns 2t, 2t + 1) rounded to bf16.
  __device__ static void store2(bf16* p, float x, float y) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
  }
};

template <>
struct WarpMma<float> {
  static constexpr int K = 8;
  static constexpr int kPadE = 4;

  __device__ static void load_a(uint32_t (&a)[4], const float* s, int ld, int lane) {
    const int g = lane >> 2, t = lane & 3;
    a[0] = tf32(s[g * ld + t]);
    a[1] = tf32(s[(g + 8) * ld + t]);
    a[2] = tf32(s[g * ld + t + 4]);
    a[3] = tf32(s[(g + 8) * ld + t + 4]);
  }
  __device__ static void load_b_nk(uint32_t (&b0)[2], uint32_t (&b1)[2], const float* s, int ld,
                                   int lane) {
    const int g = lane >> 2, t = lane & 3;
    b0[0] = tf32(s[g * ld + t]);
    b0[1] = tf32(s[g * ld + t + 4]);
    b1[0] = tf32(s[(g + 8) * ld + t]);
    b1[1] = tf32(s[(g + 8) * ld + t + 4]);
  }
  // Rows 2t and 2t + 1 (see the note at the top: paired with acc_to_a).
  __device__ static void load_b_kn(uint32_t (&b0)[2], uint32_t (&b1)[2], const float* s, int ld,
                                   int lane) {
    const int g = lane >> 2, t = lane & 3;
    b0[0] = tf32(s[2 * t * ld + g]);
    b0[1] = tf32(s[(2 * t + 1) * ld + g]);
    b1[0] = tf32(s[2 * t * ld + 8 + g]);
    b1[1] = tf32(s[(2 * t + 1) * ld + 8 + g]);
  }
  // B of two n-tiles from a tile whose rows are k (n contiguous), for an A
  // operand read with load_a: rows t and t + 4, as m16n8k8 takes them.
  __device__ static void load_b_rows(uint32_t (&b0)[2], uint32_t (&b1)[2], const float* s,
                                     int ld, int lane) {
    const int g = lane >> 2, t = lane & 3;
    b0[0] = tf32(s[t * ld + g]);
    b0[1] = tf32(s[(t + 4) * ld + g]);
    b1[0] = tf32(s[t * ld + 8 + g]);
    b1[1] = tf32(s[(t + 4) * ld + 8 + g]);
  }
  template <int NT>
  __device__ static void acc_to_a(uint32_t (&a)[4], const float (&c)[NT][4], int kk) {
    a[0] = tf32(c[kk][0]);
    a[1] = tf32(c[kk][2]);
    a[2] = tf32(c[kk][1]);
    a[3] = tf32(c[kk][3]);
  }
  __device__ static void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ static void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// c[n] += A B over a depth of `depth` (a multiple of 16): A rows from a
// row-major tile at `a` (k contiguous), B of NT n-tiles from a tile whose
// rows are n (k contiguous), e.g. S = Q K^T with K's rows.
template <typename T, int NT>
__device__ __forceinline__ void mma_rows_nk(float (&c)[NT][4], const T* a, const T* b, int ld,
                                            int depth, int lane) {
  using W = WarpMma<T>;
  static_assert(NT % 2 == 0, "n-tiles come in pairs");
#pragma unroll
  for (int kk = 0; kk < depth; kk += W::K) {
    uint32_t af[4];
    W::load_a(af, a + kk, ld, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b0[2], b1[2];
      W::load_b_nk(b0, b1, b + np * 16 * ld + kk, ld, lane);
      W::mma(c[2 * np], af, b0);
      W::mma(c[2 * np + 1], af, b1);
    }
  }
}

// c[n] += P B: P the accumulator tiles p (16 rows x 8 * NP columns, the
// product's depth), B of NT n-tiles from a tile whose rows are k (n
// contiguous), e.g. O += P V with V's rows.
template <typename T, int NP, int NT>
__device__ __forceinline__ void mma_acc_kn(float (&c)[NT][4], const float (&p)[NP][4],
                                           const T* b, int ld, int lane) {
  using W = WarpMma<T>;
  static_assert(NT % 2 == 0, "n-tiles come in pairs");
#pragma unroll
  for (int kk = 0; kk < NP * 8 / W::K; ++kk) {
    uint32_t af[4];
    W::acc_to_a(af, p, kk);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b0[2], b1[2];
      W::load_b_kn(b0, b1, b + kk * W::K * ld + np * 16, ld, lane);
      W::mma(c[2 * np], af, b0);
      W::mma(c[2 * np + 1], af, b1);
    }
  }
}

}  // namespace wm
}  // namespace lvd
