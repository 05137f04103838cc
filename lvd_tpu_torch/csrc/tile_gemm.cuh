// A 64 x 64 output tile of a matrix product for one block of four warps:
// the WMMA form of kernel I (conv3x3.cu), for widths % 64 != 0.
//
// The block stages a (64, 32) A chunk and a (32, 64) B chunk in shared
// memory per step of the K loop; warp w owns output rows [16w, 16w + 16) and
// all 64 columns (four WMMA accumulators, fp32). The caller fills the
// chunks (its own gather and prologue), calls `mma_chunk`, and at the end
// `store_tile` hands each output element to its epilogue functor. Element
// type T is bf16 (16x16x16 products) or fp32 (TF32 16x16x8 products).
#pragma once

#include "common.cuh"

namespace lvd {

template <typename T>
struct TileGemm {
  static constexpr int BM = 64, BN = 64, BK = 32;
  static constexpr int kWarps = 4, kThreads = kWarps * 32;
  static constexpr int kLdA = BK + kPad<T>;  // A chunk row stride
  static constexpr int kLdB = BN + kPad<T>;  // B chunk row stride
  static constexpr int kLdO = BN + 8;        // fp32 epilogue staging row stride
  static constexpr int kABytes = BM * kLdA * (int)sizeof(T);
  static constexpr int kBBytes = BK * kLdB * (int)sizeof(T);
  // A chunk, B chunk and the per-warp (16, 64) staging tile: 29 KB for
  // bf16, 37 KB for fp32.
  static constexpr int kSmem = kABytes + kBBytes + kWarps * 16 * kLdO * 4;
  using Acc = typename Mma<T>::Acc;

  __device__ static T* a_chunk(unsigned char* smem) { return reinterpret_cast<T*>(smem); }
  __device__ static T* b_chunk(unsigned char* smem) {
    return reinterpret_cast<T*>(smem + kABytes);
  }
  __device__ static float* stage(unsigned char* smem, int warp) {
    return reinterpret_cast<float*>(smem + kABytes + kBBytes) + warp * 16 * kLdO;
  }

  __device__ static void zero(Acc (&acc)[BN / 16]) {
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  }

  // acc += A[warp rows] B over one staged chunk.
  __device__ static void mma_chunk(Acc (&acc)[BN / 16], const T* As, const T* Bs, int warp) {
    using M = Mma<T>;
#pragma unroll
    for (int kk = 0; kk < BK; kk += M::K) {
      typename M::A a;
      load_op(a, As + warp * 16 * kLdA + kk, kLdA);
#pragma unroll
      for (int n = 0; n < BN / 16; ++n) {
        typename M::BRow b;
        load_op(b, Bs + kk * kLdB + n * 16, kLdB);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
  }

  // fn(row, col, value) for the warp's 16 x 64 outputs, row and col within
  // the block's tile; two lanes per row, 32 columns each.
  template <typename Fn>
  __device__ static void store_tile(const Acc (&acc)[BN / 16], float* stage, int warp, int lane,
                                    Fn fn) {
#pragma unroll
    for (int n = 0; n < BN / 16; ++n)
      wmma::store_matrix_sync(stage + n * 16, acc[n], kLdO, wmma::mem_row_major);
    __syncwarp();
    const int row = lane >> 1, half = lane & 1;
    for (int j = 0; j < 32; ++j) fn(warp * 16 + row, half * 32 + j, stage[row * kLdO + half * 32 + j]);
    __syncwarp();
  }
};

}  // namespace lvd
