// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel here is built by one plain `nvcc` call into a shared library
// with a C interface (lvd_tpu_torch/ops/_build.py) and called through ctypes;
// nothing includes PyTorch's headers. Each exported entry point launches on
// the caller's stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// The matrix products use the tensor cores through WMMA (bf16 in, fp32
// accumulate, 16x16x16 tiles). Shared-memory row strides are multiples of
// 32 bytes so that every fragment pointer meets WMMA's 256-bit alignment.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#define LVD_EXPORT extern "C" __attribute__((visibility("default")))

namespace lvd {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Largest dynamic shared memory one block may use on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 8 bf16 values <-> one 16-byte vector.
union Vec8 {
  uint4 u;
  bf16 h[8];
};

// Opts a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t set_smem(Kernel* kernel, int bytes) {
  if (bytes > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  return cudaSuccess;
}

// Stores one accumulator tile to the warp's scratch (256 floats) and hands
// each lane its share of the values: fn(r, c, value) with r, c in [0, 16).
template <typename Fn>
__device__ inline void drain_tile(const FragAcc& acc, float* scratch, int lane, Fn fn) {
  wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) fn(e / 16, e % 16, scratch[e]);
  __syncwarp();
}

}  // namespace lvd

LVD_EXPORT const char* lvd_error_string(int err);
