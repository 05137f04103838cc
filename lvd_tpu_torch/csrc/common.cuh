// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel here is built by one plain `nvcc` call into a shared library
// with a C interface (lvd_tpu_torch/ops/_build.py) and called through ctypes;
// nothing includes PyTorch's headers. Each exported entry point launches on
// the caller's stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// Every kernel takes bf16 or fp32 tensors (a template on the element type,
// chosen at run time by the entry point's `dtype`). The matrix products use
// the tensor cores through WMMA: bf16 16x16x16 tiles, or TF32 16x16x8 tiles
// for fp32 tensors (the fp32 values are never rounded to bf16), both with
// fp32 accumulation. Shared-memory row strides are multiples of 32 bytes so
// that every fragment pointer meets WMMA's 256-bit alignment.
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

// Element types of the kernels' tensors: 0 = bf16, 1 = fp32 (the `dtype`
// argument of every entry point).
enum DType { kBF16 = 0, kF32 = 1 };

// WMMA fragments for element type T. bf16 runs m16n16k16 (bf16 in, fp32
// accumulate); fp32 runs m16n16k8 in TF32 (load_op rounds each loaded fp32
// value to TF32 as the tensor cores take it), also with fp32 accumulation.
// K is the depth of one product step.
template <typename T>
struct Mma;

template <>
struct Mma<bf16> {
  static constexpr int K = 16;
  using A = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using ACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
  using BRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
  using BCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
};

template <>
struct Mma<float> {
  static constexpr int K = 8;
  using A = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  using ACol = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::col_major>;
  using BRow = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  using BCol = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::col_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
};

// Loads an operand fragment from bf16 or fp32 memory (fp32 rounded to TF32).
template <typename Frag, typename T>
__device__ inline void load_op(Frag& f, const T* p, unsigned ld) {
  wmma::load_matrix_sync(f, p, ld);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < f.num_elements; ++i) f.x[i] = wmma::__float_to_tf32(f.x[i]);
  }
}

// The shared-memory (32-bit) address of a generic pointer into shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats rounded to a bf16 pair, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Largest dynamic shared memory one block may use on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ inline float to_f(float v) { return v; }
__device__ inline float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ inline T from_f(float v);
template <>
__device__ inline float from_f<float>(float v) { return v; }
template <>
__device__ inline bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// v rounded to T's precision (identity for fp32).
template <typename T>
__device__ inline float round_to(float v) { return to_f(from_f<T>(v)); }

// Elements of T in one 16-byte vector, and 32 bytes of row padding in
// elements (shared-memory row strides are the tile width plus kPad<T>, so
// every fragment pointer stays 32-byte aligned).
template <typename T>
constexpr int kVecN = 16 / sizeof(T);
template <typename T>
constexpr int kPad = 32 / sizeof(T);

// kVecN<T> values <-> one 16-byte vector.
template <typename T>
union Vec {
  uint4 u;
  T h[kVecN<T>];
};

// Opts a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t set_smem(Kernel* kernel, int bytes) {
  if (bytes > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  return cudaSuccess;
}

// Runs fn(T{}) with T the element type `dtype` names.
template <typename Fn>
inline cudaError_t dispatch(int dtype, Fn fn) {
  if (dtype == kBF16) return fn(bf16{});
  if (dtype == kF32) return fn(float{});
  return cudaErrorInvalidValue;
}

// The GEGLU gate's GELU in fp32, in the form LVD_GELU_FORM names: the erf
// form (exact != 0) or the tanh form (kernels C and J).
__device__ inline float gelu(float g, int exact) {
  if (exact) return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
  const float z = 0.7978845608028654f * (g + 0.044715f * g * g * g);
  return 0.5f * g * (1.f + tanhf(z));
}

// Stores one accumulator tile to the warp's scratch (256 floats) and hands
// each lane its share of the values: fn(r, c, value) with r, c in [0, 16).
template <typename Acc, typename Fn>
__device__ inline void drain_tile(const Acc& acc, float* scratch, int lane, Fn fn) {
  wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) fn(e / 16, e % 16, scratch[e]);
  __syncwarp();
}

}  // namespace lvd

LVD_EXPORT const char* lvd_error_string(int err);
