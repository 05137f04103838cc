// Helpers shared by kernels K-M (norms.cu) and their backwards N and O
// (norms_bwd.cu): the element types, their rounding, K's and L's plan over
// channels-last (N, R, C) tensors, and 16-byte vector loads.
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"

namespace lvd {
namespace {

constexpr int kNormThreads = 256;   // K, L and N: threads a block
constexpr int kChunkBytes = 65536;  // K, L and N: bytes of one slab a chunk reads
constexpr int kLnRows = 8;          // M and O: rows (warps) a block
constexpr int kF16 = 2;             // the norms' third element type (0 bf16, 1 fp32)

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float ld(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T st(float v);
template <>
__device__ __forceinline__ float st<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 st<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half st<__half>(float v) { return __float2half_rn(v); }

// v rounded to T's precision, as a float.
template <typename T>
__device__ __forceinline__ float rnd(float v) { return ld(st<T>(v)); }

// K's and L's geometry for C channels of `itemsize` bytes: `vec` values a
// 16-byte vector, `slabs` slabs of `slab_vecs` vectors (at most 256),
// `row_lanes` threads down the rows, `chunk_rows` rows a chunk (a multiple
// of row_lanes, 64 KB of a slab rounded up). ops/norms.py `launch_plan`
// computes the same; the entry points refuse any other.
struct NormPlan {
  int vec, slabs, slab_vecs, row_lanes, chunk_rows;
};

inline NormPlan make_plan(int C, int itemsize) {
  NormPlan p;
  p.vec = 16 / itemsize;
  const int cv = C / p.vec;
  p.slabs = (cv + kNormThreads - 1) / kNormThreads;
  p.slab_vecs = (cv + p.slabs - 1) / p.slabs;
  p.row_lanes = kNormThreads / p.slab_vecs;
  const int want = (kChunkBytes + p.slab_vecs * 16 - 1) / (p.slab_vecs * 16);
  p.chunk_rows = (want + p.row_lanes - 1) / p.row_lanes * p.row_lanes;
  return p;
}

inline int itemsize_of(int dtype) { return dtype == kF32 ? 4 : 2; }

// Loads one 16-byte vector of T as floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[16 / sizeof(T)]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) out[i] = ld(e[i]);
}

// Stores one 16-byte vector of T from floats (each rounded once).
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[16 / sizeof(T)]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) e[i] = st<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

// A scale or bias value of the type `pdtype` names.
__device__ __forceinline__ float load_param(const void* p, int pdtype, int i) {
  if (pdtype == kF32) return static_cast<const float*>(p)[i];
  if (pdtype == kF16) return __half2float(static_cast<const __half*>(p)[i]);
  return __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// Writes v, rounded to the type `pdtype` names, as element i of p.
__device__ __forceinline__ void store_param(void* p, int pdtype, int i, float v) {
  if (pdtype == kF32)
    static_cast<float*>(p)[i] = v;
  else if (pdtype == kF16)
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  else
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
}

// Runs fn(T{}) with T the element type `dtype` names (0 bf16, 1 fp32, 2 fp16).
template <typename Fn>
inline cudaError_t dispatch3(int dtype, Fn fn) {
  if (dtype == kBF16) return fn(bf16{});
  if (dtype == kF32) return fn(float{});
  if (dtype == kF16) return fn(__half{});
  return cudaErrorInvalidValue;
}

inline bool plan_ok(int C, int dtype, int vec, int slabs, int slab_vecs, int row_lanes,
                    int chunk_rows) {
  if (dtype != kBF16 && dtype != kF32 && dtype != kF16) return false;
  const NormPlan p = make_plan(C, itemsize_of(dtype));
  return vec == p.vec && slabs == p.slabs && slab_vecs == p.slab_vecs &&
         row_lanes == p.row_lanes && chunk_rows == p.chunk_rows;
}

}  // namespace
}  // namespace lvd
