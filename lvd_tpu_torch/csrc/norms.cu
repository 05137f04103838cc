// Kernels K, L and M: GroupNorm statistics, GroupNorm apply (+ SiLU) and
// LayerNorm over rows, on channels-last tensors in bf16, fp16 or fp32.
//
// They replace no Pallas kernel. lvd_tpu hands the same functions
// (lvd_tpu/ops/basic.py:59 `group_norm_coeffs`, :113 `group_norm`, :144
// `layer_norm`) to XLA, which fuses each elementwise chain into one or two
// passes over the activation; run as stock torch ops they were 10-15
// launches over fp32 copies of it. These kernels are the port's counterpart
// of those fusions, with lvd_tpu's functions and rounding points.
//
// Bound on this card: bytes. There are no products, a few operations per
// element against 2-4 bytes of traffic, so each kernel is one read of x
// (and one write of y) at the memory rate; every load is a 16-byte vector.
//
// K (`lvd_gn_stats`), x viewed as (N, R, C): a sample's R rows are cut into
// chunks of `chunk_rows` rows, and its C channels into `slabs` slabs of at
// most 256 16-byte vectors. One block per (chunk, slab, sample) reads whole
// rows of its slab with 16-byte loads (a group is only C / G contiguous
// values of a row, 20-80 bytes at the UNet's widths, so a block per group
// would read a fraction of every row it touches), thread (row lane, vector)
// summing x and x*x in fp32 per channel over every row_lanes-th row, four
// loads in flight; the row lanes are then summed in order through shared
// memory and the per-channel sums of the chunk written to a workspace
// (N, chunks, C) x 2. A second kernel, one block per (group, sample), sums
// the group's channels over the sample's chunks in a fixed order (each
// thread over a fixed set of (channel, chunk), then a fixed tree), and in
// the `coeffs` form finishes as lvd_tpu does: mean = s1 / count, var =
// max(s2 / count - mean^2, 0) (one pass, not Welford), inv = rsqrt(var +
// eps), a = inv * scale, b = bias - mean * a, both (N, C) fp32. In the
// `sums` form (frame-sharded statistics) it writes the (N, G) sums, which
// the caller psums. The plan (vector width, slabs, row lanes, chunk rows)
// depends on C and the type alone and the chunks on R alone: a sample's
// sums take the same order whatever N is, with no atomics, so a sample's
// statistics are the same bits alone or in a batch and from run to run.
// The chunks (64 KB of a slab) fill the card at the temporal GroupNorms'
// N = 2 with 691200 values a group as at the spatial ones' N = 48.
//
// L (`lvd_gn_apply`): the same blocks over (N, R, C); each thread holds its
// 16-byte vector's (a, b), rounded to x's type, and writes y = x * a + b
// with lvd_tpu's rounding points (the product rounds to x's type, then the
// sum does: lvd_tpu/ops/basic.py:140), and in the `affine_silu` form SiLU
// on that value in fp32 (x / (1 + exp(-x)), as F.silu computes it), rounded
// once more. No fused multiply-add: in fp32 each step rounds as the plain
// version's does.
//
// M (`lvd_layer_norm`): one warp per row, eight rows a block. Each lane sums
// x and x*x in fp32 over its 16-byte vectors, the warp reduces by butterfly
// shuffles (every lane ends with the same bits), then reads its vectors
// again (from L1, the row was just read) and writes ((x - mean) * rsqrt(var
// + eps)) * scale + bias in fp32, rounded once to x's type (lvd_tpu's
// `layer_norm`, `p is None` in the `normalize` form). scale and bias may be
// bf16, fp16 or fp32, read as they are.
#include <cuda_fp16.h>

#include "common.cuh"

namespace lvd {
namespace {

constexpr int kNormThreads = 256;   // K and L: threads a block
constexpr int kChunkBytes = 65536;  // K and L: bytes of one slab a chunk reads
constexpr int kLnRows = 8;          // M: rows (warps) a block
constexpr int kF16 = 2;             // this file's third element type (0 bf16, 1 fp32)

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

// A scale or bias value of the type `pdtype` names.
__device__ __forceinline__ float load_param(const void* p, int pdtype, int i) {
  if (pdtype == kF32) return static_cast<const float*>(p)[i];
  if (pdtype == kF16) return __half2float(static_cast<const __half*>(p)[i]);
  return __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// ---- K, pass 1: per-channel sums of one chunk of one slab ----

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
gn_partial_kernel(const T* __restrict__ x, float* __restrict__ part1,
                  float* __restrict__ part2, int R, int C, NormPlan p, int chunks) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float red[];  // [2][row_lanes][slab_vecs * V]
  const int n = blockIdx.y, j = blockIdx.x / p.slabs, slab = blockIdx.x % p.slabs;
  const int sv = threadIdx.x % p.slab_vecs, rl = threadIdx.x / p.slab_vecs;
  const int cvec = slab * p.slab_vecs + sv;
  const int width = p.slab_vecs * V;
  const bool active = rl < p.row_lanes && cvec < C / V;
  float s1[V], s2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.f;
  if (active) {
    const T* xs = x + (size_t)n * R * C + (size_t)cvec * V;
    const int step = p.row_lanes;
    const int r1 = min(R, (j + 1) * p.chunk_rows);
    int r = j * p.chunk_rows + rl;
    for (; r + 3 * step < r1; r += 4 * step) {
      float v[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) load_vec(xs + (size_t)(r + u * step) * C, v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s1[e] += v[u][e];
          s2[e] += v[u][e] * v[u][e];
        }
      }
    }
    for (; r < r1; r += step) {
      float v[V];
      load_vec(xs + (size_t)r * C, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s1[e] += v[e];
        s2[e] += v[e] * v[e];
      }
    }
  }
  if (rl < p.row_lanes) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      red[rl * width + sv * V + e] = s1[e];
      red[(p.row_lanes + rl) * width + sv * V + e] = s2[e];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < width; e += kNormThreads) {
    const int c = slab * width + e;
    if (c >= C) continue;
    float a = 0.f, b = 0.f;
    for (int l = 0; l < p.row_lanes; ++l) {
      a += red[l * width + e];
      b += red[(p.row_lanes + l) * width + e];
    }
    const size_t o = ((size_t)n * chunks + j) * C + c;
    part1[o] = a;
    part2[o] = b;
  }
}

// ---- K, pass 2: a group's sums over the sample's chunks; the coefficients ----

__global__ void __launch_bounds__(kNormThreads)
gn_finish_kernel(const float* __restrict__ part1, const float* __restrict__ part2, int chunks,
                 int C, int G, int form, const void* scale, const void* bias, int pdtype,
                 float count, float eps, float* __restrict__ out1, float* __restrict__ out2) {
  __shared__ float r1[kNormThreads], r2[kNormThreads];
  const int g = blockIdx.x, n = blockIdx.y, cpg = C / G, t = threadIdx.x;
  const int lanes_c = min(cpg, kNormThreads);
  const int lanes_j = kNormThreads / lanes_c;
  const int cl = t % lanes_c, jl = t / lanes_c;
  float a1 = 0.f, a2 = 0.f;
  if (jl < lanes_j) {
    for (int c = cl; c < cpg; c += lanes_c) {
      const size_t base = (size_t)n * chunks * C + (size_t)g * cpg + c;
#pragma unroll 4
      for (int j = jl; j < chunks; j += lanes_j) {
        a1 += part1[base + (size_t)j * C];
        a2 += part2[base + (size_t)j * C];
      }
    }
  }
  r1[t] = a1;
  r2[t] = a2;
  for (int s = kNormThreads / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (t < s) {
      r1[t] += r1[t + s];
      r2[t] += r2[t + s];
    }
  }
  __syncthreads();
  const float s1 = r1[0], s2 = r2[0];
  if (form == 2) {  // sums: (N, G)
    if (t == 0) {
      out1[(size_t)n * G + g] = s1;
      out2[(size_t)n * G + g] = s2;
    }
    return;
  }
  const float mean = __fdiv_rn(s1, count);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, count), __fmul_rn(mean, mean)), 0.f);
  const float inv = rsqrtf(__fadd_rn(var, eps));
  for (int c = t; c < cpg; c += kNormThreads) {
    const int cc = g * cpg + c;
    const float a = __fmul_rn(inv, load_param(scale, pdtype, cc));
    out1[(size_t)n * C + cc] = a;
    out2[(size_t)n * C + cc] = __fsub_rn(load_param(bias, pdtype, cc), __fmul_rn(mean, a));
  }
}

// ---- L: y = x * a + b (+ SiLU) ----

template <typename T, bool kSilu>
__device__ __forceinline__ void apply_vec(const float (&v)[16 / sizeof(T)],
                                          const float (&a)[16 / sizeof(T)],
                                          const float (&b)[16 / sizeof(T)], T* out) {
  constexpr int V = 16 / sizeof(T);
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float y = __fadd_rn(rnd<T>(__fmul_rn(v[i], a[i])), b[i]);
    if constexpr (kSilu) {
      y = rnd<T>(y);
      y = __fdiv_rn(y, __fadd_rn(1.f, expf(-y)));
    }
    e[i] = st<T>(y);
  }
  *reinterpret_cast<uint4*>(out) = u;
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kNormThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, T* __restrict__ y, int R, int C, NormPlan p) {
  constexpr int V = 16 / sizeof(T);
  const int n = blockIdx.y, j = blockIdx.x / p.slabs, slab = blockIdx.x % p.slabs;
  const int sv = threadIdx.x % p.slab_vecs, rl = threadIdx.x / p.slab_vecs;
  const int cvec = slab * p.slab_vecs + sv;
  if (rl >= p.row_lanes || cvec >= C / V) return;
  float at[V], bt[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {  // the coefficients in x's type (lvd_tpu's .astype)
    at[e] = rnd<T>(a[(size_t)n * C + cvec * V + e]);
    bt[e] = rnd<T>(b[(size_t)n * C + cvec * V + e]);
  }
  const size_t base = (size_t)n * R * C + (size_t)cvec * V;
  const int step = p.row_lanes;
  const int r1 = min(R, (j + 1) * p.chunk_rows);
  int r = j * p.chunk_rows + rl;
  for (; r + 3 * step < r1; r += 4 * step) {
    float v[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) load_vec(x + base + (size_t)(r + u * step) * C, v[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) apply_vec<T, kSilu>(v[u], at, bt, y + base + (size_t)(r + u * step) * C);
  }
  for (; r < r1; r += step) {
    float v[V];
    load_vec(x + base + (size_t)r * C, v);
    apply_vec<T, kSilu>(v, at, bt, y + base + (size_t)r * C);
  }
}

// ---- M: LayerNorm, one warp a row ----

// V values of P from p (16 or 32 bytes for bf16 / fp16 / fp32 against a
// 16-byte vector of x; 8 bytes for 2-byte params beside fp32 x).
template <typename P, int V>
__device__ __forceinline__ void load_params(const P* p, float (&out)[V]) {
  constexpr int kBytes = V * (int)sizeof(P);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + k);
      const P* e = reinterpret_cast<const P*>(&u);
#pragma unroll
      for (int i = 0; i < 16 / (int)sizeof(P); ++i) out[k * (16 / (int)sizeof(P)) + i] = ld(e[i]);
    }
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const P* e = reinterpret_cast<const P*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = ld(e[i]);
  }
}

template <typename T, typename P, bool kAffine>
__global__ void __launch_bounds__(kLnRows * 32)
ln_rows_kernel(const T* __restrict__ x, const P* __restrict__ scale,
               const P* __restrict__ bias, T* __restrict__ y, int rows, int C, float eps) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRows + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * C;
  T* yr = y + (size_t)row * C;
  const int cv = C / V;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int i = lane; i < cv; i += 32) {
    float v[V];
    load_vec(xr + i * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s1 += v[e];
      s2 += v[e] * v[e];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mean = __fdiv_rn(s1, (float)C);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, (float)C), __fmul_rn(mean, mean)), 0.f);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  for (int i = lane; i < cv; i += 32) {
    float v[V];
    load_vec(xr + i * V, v);
    float sc[V], bi[V];
    if constexpr (kAffine) {
      load_params<P, V>(scale + i * V, sc);
      load_params<P, V>(bias + i * V, bi);
    }
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float z = __fmul_rn(__fsub_rn(v[k], mean), rstd);
      if constexpr (kAffine) z = __fadd_rn(__fmul_rn(z, sc[k]), bi[k]);
      e[k] = st<T>(z);
    }
    *reinterpret_cast<uint4*>(yr + i * V) = u;
  }
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

// Kernel K. x: (N, R, C) of `dtype` (0 bf16, 1 fp32, 2 fp16), C % 8 == 0;
// part1, part2: (N, chunks, C) fp32 workspaces; form 1 (`coeffs`): scale,
// bias (C,) of `pdtype`, out1 = a and out2 = b, each (N, C) fp32, from
// `count` values a group and `eps`; form 2 (`sums`): out1, out2 = the (N, G)
// sums of x and x*x (scale, bias unread). The plan must be launch_plan's.
LVD_EXPORT int lvd_gn_stats(const void* x, void* part1, void* part2, const void* scale,
                            const void* bias, void* out1, void* out2, int N, int R, int C,
                            int G, int form, int vec, int slabs, int slab_vecs, int row_lanes,
                            int chunk_rows, int chunks, float count, float eps, int pdtype,
                            int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (N <= 0 || R <= 0 || C <= 0 || C % 8 != 0 || G <= 0 || C % G != 0 || N > 65535 ||
      G > 65535 || (form != 1 && form != 2) ||
      !plan_ok(C, dtype, vec, slabs, slab_vecs, row_lanes, chunk_rows) ||
      chunks != (R + chunk_rows - 1) / chunk_rows || (long long)chunks * slabs >= (1LL << 31) ||
      (form == 1 && (pdtype < 0 || pdtype > 2 || scale == nullptr || bias == nullptr)))
    return cudaErrorInvalidValue;
  const NormPlan p{vec, slabs, slab_vecs, row_lanes, chunk_rows};
  auto s = static_cast<cudaStream_t>(stream);
  const int smem = 2 * row_lanes * slab_vecs * vec * (int)sizeof(float);
  cudaError_t err = dispatch3(dtype, [&](auto tag) {
    using T = decltype(tag);
    gn_partial_kernel<T><<<dim3(chunks * slabs, N), kNormThreads, smem, s>>>(
        static_cast<const T*>(x), static_cast<float*>(part1), static_cast<float*>(part2), R, C,
        p, chunks);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  gn_finish_kernel<<<dim3(G, N), kNormThreads, 0, s>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2), chunks, C, G, form,
      scale, bias, pdtype, count, eps, static_cast<float*>(out1), static_cast<float*>(out2));
  return cudaGetLastError();
}

// Kernel L. x, y: (N, R, C) of `dtype`; a, b: (N, C) fp32; form 1
// (`affine`) y = x * a + b, form 2 (`affine_silu`) silu of it; the plan
// must be launch_plan's.
LVD_EXPORT int lvd_gn_apply(const void* x, const void* a, const void* b, void* y, int N, int R,
                            int C, int form, int vec, int slabs, int slab_vecs, int row_lanes,
                            int chunk_rows, int chunks, int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (N <= 0 || R <= 0 || C <= 0 || C % 8 != 0 || N > 65535 || (form != 1 && form != 2) ||
      !plan_ok(C, dtype, vec, slabs, slab_vecs, row_lanes, chunk_rows) ||
      chunks != (R + chunk_rows - 1) / chunk_rows || (long long)chunks * slabs >= (1LL << 31))
    return cudaErrorInvalidValue;
  const NormPlan p{vec, slabs, slab_vecs, row_lanes, chunk_rows};
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(chunks * slabs, N);
  auto as = static_cast<const float*>(a);
  auto bs = static_cast<const float*>(b);
  return dispatch3(dtype, [&](auto tag) {
    using T = decltype(tag);
    auto xs = static_cast<const T*>(x);
    auto ys = static_cast<T*>(y);
    if (form == 2)
      gn_apply_kernel<T, true><<<grid, kNormThreads, 0, s>>>(xs, as, bs, ys, R, C, p);
    else
      gn_apply_kernel<T, false><<<grid, kNormThreads, 0, s>>>(xs, as, bs, ys, R, C, p);
    return cudaGetLastError();
  });
}

// Kernel M. x, y: (rows, C) of `dtype`, C % 8 == 0; form 1 (`affine`):
// scale, bias (C,) of `pdtype`; form 2 (`normalize`): neither (null).
LVD_EXPORT int lvd_layer_norm(const void* x, const void* scale, const void* bias, void* y,
                              int rows, int C, int form, float eps,
                              int pdtype, int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (rows <= 0 || C <= 0 || C % 8 != 0 ||
      (form == 1 && (scale == nullptr || bias == nullptr || pdtype < 0 || pdtype > 2)) ||
      (form == 2 && (scale != nullptr || bias != nullptr)) || (form != 1 && form != 2))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + kLnRows - 1) / kLnRows);
  return dispatch3(dtype, [&](auto tag) {
    using T = decltype(tag);
    auto xs = static_cast<const T*>(x);
    auto ys = static_cast<T*>(y);
    if (form == 2) {
      ln_rows_kernel<T, T, false><<<grid, kLnRows * 32, 0, s>>>(xs, nullptr, nullptr, ys, rows,
                                                                C, eps);
      return cudaGetLastError();
    }
    return dispatch3(pdtype, [&](auto ptag) {
      using P = decltype(ptag);
      ln_rows_kernel<T, P, true><<<grid, kLnRows * 32, 0, s>>>(
          xs, static_cast<const P*>(scale), static_cast<const P*>(bias), ys, rows, C, eps);
      return cudaGetLastError();
    });
  });
}
