// Kernels N and O: the backwards of GroupNorm (K then L) and LayerNorm (M),
// on channels-last tensors in bf16, fp16 or fp32.
//
// They replace no Pallas kernel. Under jax.grad lvd_tpu's norms
// (lvd_tpu/ops/basic.py:59 `group_norm_coeffs`, :113 `group_norm`, :144
// `layer_norm`) run their VJPs as XLA fusions; as stock torch ops the same
// closed forms were 11-25 launches a site, several over fp32 copies of the
// activation. N and O are the port's counterpart of those fusions, with the
// plain versions' arithmetic and rounding points (ops/norms.py
// `group_norm_bwd_plain`, `group_norm_coeffs_bwd_plain`,
// `group_sums_bwd_plain`, `layer_norm_bwd_plain`).
//
// Bound on this card: bytes. A few fp32 operations an element against 2-4
// bytes of each of x, dy and dx; every load is a 16-byte vector.
//
// N (`lvd_gn_bwd`), on K's and L's plan over x (N, R, C) (launch_plan: a
// block per (chunk, slab, sample), thread (row lane, vector)):
// - `affine` / `affine_silu` (GroupNorm through K and L): pass 1 reads x and
//   dy, recomputes L's z = x * a + b at its rounding points and, with SiLU,
//   dz = silu'(z) * dy rounded to x's type (torch's silu_backward), and
//   writes per-(sample, chunk, channel) fp32 sums of dz * x (each product
//   rounded to x's type, as the plain version's `(dz * x).sum(1)` rounds it)
//   and of dz. A finish kernel, a block per (group, sample), sums each
//   channel over its chunks in a fixed order (strided lanes, then the lanes
//   in order), rounds the two (N, C) cotangents of L's (a, b) to x's type,
//   and reduces the group's dmean and dvar from K's saved mean, inv and
//   clamp mask, sequentially over its channels. Pass 2 reads x and dy again
//   and writes dx = dz * a (rounded) + [dmean / count + 2 x dvar / count]
//   (each term rounded, then their sum: `group_sums_bwd_plain`), the two added
//   in x's type as autograd adds them. Where scale and bias need gradients,
//   the finish also writes the (N, C) terms that a last kernel sums over N
//   in a fixed order.
// - `coeffs` (K's coefficients alone, before kernels D and I): one pass over
//   x; each block first reduces, from the (N, C) cotangents of (a, b), the
//   dmean and dvar of the groups its slab touches (the same sequential
//   reduction as the finish), then writes dx. `sums` (the frame-sharded
//   statistics): the same pass with the (N, G) cotangents of the sums given.
// - `apply` / `apply_silu` (L alone, after the frame-sharded statistics):
//   pass 1 and the finish's chunk sums as above, which the finish writes as
//   the (N, C) cotangents of (a, b); pass 2 writes dx = dz * a.
// Every order depends on C, the type and R alone, never on N, with no
// atomics: a sample's dx is the same bits alone or in a batch.
//
// O (`lvd_layer_norm_bwd`), on M's plan (a warp a row, eight rows a block):
// reads the row's mean, rstd and clamp mask that M saved, sums g = dy * scale and
// g * (x - mean) over the row (per lane, then butterfly shuffles), and
// writes dx = g rstd + dmean / C + dvar (2 / C) x in fp32, rounded once.
// Form `dx_params` (the trainer) also sums dscale = sum(dy * xhat) and
// dbias = sum(dy) over rows: per (chunk, slab) blocks on K's plan, then the
// same fixed-order finish over the chunks.
#include "norms.cuh"

namespace lvd {
namespace {

// dz of L's output at x (one element): dy, or with SiLU torch's
// silu_backward at z = (x * a rounded + b) rounded, rounded to T.
template <typename T, bool kSilu>
__device__ __forceinline__ float dz_of(float x, float dy, float a, float b) {
  if constexpr (!kSilu) {
    return dy;
  } else {
    const float z = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, a)), b));
    const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-z)));
    const float d = __fmul_rn(__fmul_rn(dy, s), __fadd_rn(1.f, __fmul_rn(z, __fsub_rn(1.f, s))));
    return rnd<T>(d);
  }
}

// dmean / count and dvar / count of one group from the cotangents da, db of
// its channels' (a, b) (a = inv * scale, b = bias - mean * a), summed over
// the group's channels in order.
__device__ __forceinline__ void group_grads(const float* da, const float* db, const void* scale,
                                            int pdtype, int c0, int cpg, float mean, float inv,
                                            float keep, float count, float& ds1, float& ds2) {
  float u = 0.f, v = 0.f;
  for (int c = 0; c < cpg; ++c) {
    const float sc = load_param(scale, pdtype, c0 + c);
    const float dap = __fsub_rn(da[c], __fmul_rn(db[c], mean));
    u = __fadd_rn(u, __fmul_rn(dap, sc));
    v = __fadd_rn(v, __fmul_rn(db[c], __fmul_rn(inv, sc)));
  }
  const float dvar =
      __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(u, -0.5f), inv), inv), inv), keep);
  const float dmean = __fsub_rn(-v, __fmul_rn(__fmul_rn(2.f, mean), dvar));
  ds1 = __fdiv_rn(dmean, count);
  ds2 = __fdiv_rn(dvar, count);
}

// The (N, C) terms dscale and dbias sum over N: (da - db * mean) * inv, db.
__device__ __forceinline__ void param_terms(float da, float db, float mean, float inv,
                                            float* t1, float* t2) {
  *t1 = __fmul_rn(__fsub_rn(da, __fmul_rn(db, mean)), inv);
  *t2 = db;
}

// ---- N, pass 1: per-channel sums of dz * x and dz over one chunk of one slab ----

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kNormThreads)
gn_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ part1, float* __restrict__ part2, int R, int C,
                      NormPlan p, int chunks) {
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
    float at[V], bt[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {  // the coefficients in x's type (L's)
      at[e] = rnd<T>(a[(size_t)n * C + cvec * V + e]);
      bt[e] = rnd<T>(b[(size_t)n * C + cvec * V + e]);
    }
    const size_t base = (size_t)n * R * C + (size_t)cvec * V;
    const int step = p.row_lanes;
    const int r1 = min(R, (j + 1) * p.chunk_rows);
    int r = j * p.chunk_rows + rl;
    for (; r + step < r1; r += 2 * step) {
      float v[2][V], g[2][V];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        load_vec(x + base + (size_t)(r + u * step) * C, v[u]);
        load_vec(dy + base + (size_t)(r + u * step) * C, g[u]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float dz = dz_of<T, kSilu>(v[u][e], g[u][e], at[e], bt[e]);
          s1[e] = __fadd_rn(s1[e], rnd<T>(__fmul_rn(dz, v[u][e])));
          s2[e] = __fadd_rn(s2[e], dz);
        }
      }
    }
    for (; r < r1; r += step) {
      float v[V], g[V];
      load_vec(x + base + (size_t)r * C, v);
      load_vec(dy + base + (size_t)r * C, g);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float dz = dz_of<T, kSilu>(v[e], g[e], at[e], bt[e]);
        s1[e] = __fadd_rn(s1[e], rnd<T>(__fmul_rn(dz, v[e])));
        s2[e] = __fadd_rn(s2[e], dz);
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
    float u = 0.f, w = 0.f;
    for (int l = 0; l < p.row_lanes; ++l) {
      u = __fadd_rn(u, red[l * width + e]);
      w = __fadd_rn(w, red[(p.row_lanes + l) * width + e]);
    }
    const size_t o = ((size_t)n * chunks + j) * C + c;
    part1[o] = u;
    part2[o] = w;
  }
}

// ---- N, finish: a group's cotangents over the sample's chunks; dmean, dvar ----

// With `apply_only`, terms receives the group's da and db (L alone) and the
// statistics are not read.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
gn_bwd_finish_kernel(const float* __restrict__ part1, const float* __restrict__ part2,
                     int chunks, int C, int G, const void* scale, int pdtype,
                     const float* __restrict__ stats, float count, float* __restrict__ ds,
                     float* __restrict__ terms, int apply_only) {
  __shared__ float r1[kNormThreads], r2[kNormThreads];
  extern __shared__ float dab[];  // [2][cpg]: da and db of the group's channels
  const int g = blockIdx.x, n = blockIdx.y, N = gridDim.y, cpg = C / G, t = threadIdx.x;
  const int lanes_c = min(cpg, kNormThreads);
  const int lanes_j = kNormThreads / lanes_c;
  const int cl = t % lanes_c, jl = t / lanes_c;
  for (int c0 = 0; c0 < cpg; c0 += lanes_c) {
    const int c = c0 + cl;
    float u = 0.f, w = 0.f;
    if (jl < lanes_j && c < cpg) {
      const size_t base = (size_t)n * chunks * C + (size_t)g * cpg + c;
      for (int j = jl; j < chunks; j += lanes_j) {
        u = __fadd_rn(u, part1[base + (size_t)j * C]);
        w = __fadd_rn(w, part2[base + (size_t)j * C]);
      }
    }
    r1[t] = u;
    r2[t] = w;
    __syncthreads();
    if (jl == 0 && c < cpg) {
      u = w = 0.f;
      for (int l = 0; l < lanes_j; ++l) {
        u = __fadd_rn(u, r1[l * lanes_c + cl]);
        w = __fadd_rn(w, r2[l * lanes_c + cl]);
      }
      dab[c] = rnd<T>(u);  // the plain version's `.sum(1)` in x's type
      dab[cpg + c] = rnd<T>(w);
    }
    __syncthreads();
  }
  if (apply_only) {
    for (int c = t; c < cpg; c += kNormThreads) {
      const size_t oc = (size_t)n * C + g * cpg + c;
      terms[oc] = dab[c];
      terms[(size_t)N * C + oc] = dab[cpg + c];
    }
    return;
  }
  const size_t o = (size_t)n * G + g;
  const float mean = stats[o], inv = stats[(size_t)N * G + o];
  const float keep = stats[2 * (size_t)N * G + o];
  if (t == 0) {
    float s1, s2;
    group_grads(dab, dab + cpg, scale, pdtype, g * cpg, cpg, mean, inv, keep, count, s1, s2);
    ds[o] = s1;
    ds[(size_t)N * G + o] = s2;
  }
  if (terms != nullptr) {
    for (int c = t; c < cpg; c += kNormThreads) {
      const size_t oc = (size_t)n * C + g * cpg + c;
      param_terms(dab[c], dab[cpg + c], mean, inv, terms + oc, terms + (size_t)N * C + oc);
    }
  }
}

// ---- N, pass 2: dx ----

enum GnBwdMode { kAffine = 1, kAffineSilu = 2, kCoeffs = 3, kSums = 4, kApply = 5,
                 kApplySilu = 6 };

// dx of the statistics' sums (`group_sums_bwd_plain`): ds1 + 2 x ds2, each
// term rounded, then their sum.
template <typename T>
__device__ __forceinline__ float dx_of_sums(float x, float ds1, float ds2) {
  return rnd<T>(__fadd_rn(rnd<T>(ds1), rnd<T>(__fmul_rn(__fmul_rn(2.f, x), ds2))));
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kNormThreads)
gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ a,
                 const float* __restrict__ b, const float* __restrict__ da,
                 const float* __restrict__ db, const void* scale, int pdtype,
                 const float* __restrict__ stats, const float* __restrict__ ds, float count,
                 float* __restrict__ terms, T* __restrict__ dx, int R, int C, int G, NormPlan p) {
  constexpr int V = 16 / sizeof(T);
  // dz from dy through L (+ SiLU); the statistics' term dx_of_sums.
  constexpr bool kDz = kMode != kCoeffs && kMode != kSums;
  constexpr bool kSiluDz = kMode == kAffineSilu || kMode == kApplySilu;
  constexpr bool kStats = kMode != kApply && kMode != kApplySilu;
  extern __shared__ float dsc[];  // [2][slab_vecs * V]: ds1, ds2 of each channel of the slab
  const int n = blockIdx.y, N = gridDim.y, j = blockIdx.x / p.slabs, slab = blockIdx.x % p.slabs;
  const int width = p.slab_vecs * V, cpg = C / G, t = threadIdx.x;
  const int c_lo = slab * width, c_hi = min(C, c_lo + width);
  if constexpr (kMode == kCoeffs) {
    const int g0 = c_lo / cpg, g1 = (c_hi - 1) / cpg;
    for (int g = g0 + t; g <= g1; g += kNormThreads) {
      const size_t o = (size_t)n * G + g;
      float s1, s2;
      const size_t og = (size_t)N * G + o;
      group_grads(da + (size_t)n * C + g * cpg, db + (size_t)n * C + g * cpg, scale, pdtype,
                  g * cpg, cpg, stats[o], stats[og], stats[(size_t)N * G + og], count, s1, s2);
      for (int c = max(g * cpg, c_lo); c < min((g + 1) * cpg, c_hi); ++c) {
        dsc[c - c_lo] = s1;
        dsc[width + c - c_lo] = s2;
      }
    }
    if (terms != nullptr && j == 0) {  // the first chunk's blocks write the slab's terms
      for (int c = c_lo + t; c < c_hi; c += kNormThreads) {
        const size_t o = (size_t)n * G + c / cpg, oc = (size_t)n * C + c;
        param_terms(da[oc], db[oc], stats[o], stats[(size_t)N * G + o], terms + oc,
                    terms + (size_t)N * C + oc);
      }
    }
  } else if constexpr (kStats) {
    for (int c = c_lo + t; c < c_hi; c += kNormThreads) {
      const size_t o = (size_t)n * G + c / cpg;
      dsc[c - c_lo] = ds[o];
      dsc[width + c - c_lo] = ds[(size_t)N * G + o];
    }
  }
  __syncthreads();
  const int sv = t % p.slab_vecs, rl = t / p.slab_vecs;
  const int cvec = slab * p.slab_vecs + sv;
  if (rl >= p.row_lanes || cvec >= C / V) return;
  float s1[V], s2[V], at[V], bt[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if constexpr (kStats) {
      s1[e] = dsc[sv * V + e];
      s2[e] = dsc[width + sv * V + e];
    }
    if constexpr (kDz) {
      at[e] = rnd<T>(a[(size_t)n * C + cvec * V + e]);
      bt[e] = rnd<T>(b[(size_t)n * C + cvec * V + e]);
    }
  }
  const size_t base = (size_t)n * R * C + (size_t)cvec * V;
  const int step = p.row_lanes;
  const int r1 = min(R, (j + 1) * p.chunk_rows);
  for (int r = j * p.chunk_rows + rl; r < r1; r += step) {
    const size_t off = base + (size_t)r * C;
    float v[V], out[V];
    load_vec(x + off, v);
    if constexpr (kDz) {
      float g[V];
      load_vec(dy + off, g);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float dz = dz_of<T, kSiluDz>(v[e], g[e], at[e], bt[e]);
        out[e] = rnd<T>(__fmul_rn(dz, at[e]));
        if constexpr (kStats) out[e] = __fadd_rn(out[e], dx_of_sums<T>(v[e], s1[e], s2[e]));
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) out[e] = dx_of_sums<T>(v[e], s1[e], s2[e]);
    }
    store_vec(dx + off, out);
  }
}

// ---- N and O: column sums of two (rows, C) fp32 arrays in a fixed order ----

// dscale and dbias (C,) of `pdtype`: 32 channels a block, 8 lanes each down
// the rows (lane l sums rows l, l + 8, ...), then the lanes in order.
constexpr int kColLanes = 8;

__global__ void __launch_bounds__(32 * kColLanes)
colsum_kernel(const float* __restrict__ t1, const float* __restrict__ t2, int rows, int C,
              void* out1, void* out2, int pdtype) {
  __shared__ float r1[kColLanes][32], r2[kColLanes][32];
  const int cl = threadIdx.x % 32, l = threadIdx.x / 32, c = blockIdx.x * 32 + cl;
  float u = 0.f, w = 0.f;
  if (c < C) {
    for (int r = l; r < rows; r += kColLanes) {
      u = __fadd_rn(u, t1[(size_t)r * C + c]);
      w = __fadd_rn(w, t2[(size_t)r * C + c]);
    }
  }
  r1[l][cl] = u;
  r2[l][cl] = w;
  __syncthreads();
  if (l == 0 && c < C) {
    u = w = 0.f;
    for (int k = 0; k < kColLanes; ++k) {
      u = __fadd_rn(u, r1[k][cl]);
      w = __fadd_rn(w, r2[k][cl]);
    }
    store_param(out1, pdtype, c, u);
    store_param(out2, pdtype, c, w);
  }
}

// ---- O: LayerNorm dx, a warp a row ----

template <typename T, typename P, bool kScaled>
__global__ void __launch_bounds__(kLnRows * 32)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const P* __restrict__ scale,
              const float* __restrict__ stats, T* __restrict__ dx, int rows, int C) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRows + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * C;
  const T* gr = dy + (size_t)row * C;
  const int cv = C / V;
  const float mean = stats[row], rstd = stats[(size_t)rows + row];
  const float keep = stats[2 * (size_t)rows + row];
  float sg = 0.f, sgx = 0.f;  // sum of g and of g * (x - mean) over the row
  for (int i = lane; i < cv; i += 32) {
    float v[V], g[V], sc[V];
    load_vec(xr + i * V, v);
    load_vec(gr + i * V, g);
    if constexpr (kScaled) {
#pragma unroll
      for (int e = 0; e < V; ++e) sc[e] = ld(scale[i * V + e]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float ge = g[e];
      if constexpr (kScaled) ge = __fmul_rn(ge, sc[e]);
      sg = __fadd_rn(sg, ge);
      sgx = __fadd_rn(sgx, __fmul_rn(ge, __fsub_rn(v[e], mean)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sg = __fadd_rn(sg, __shfl_xor_sync(0xffffffffu, sg, o));
    sgx = __fadd_rn(sgx, __shfl_xor_sync(0xffffffffu, sgx, o));
  }
  const float dvar =
      __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(sgx, -0.5f), rstd), rstd), rstd), keep);
  const float dmean = __fsub_rn(-__fmul_rn(sg, rstd), __fmul_rn(__fmul_rn(2.f, mean), dvar));
  const float dm_c = __fdiv_rn(dmean, (float)C);
  const float dv_c = __fmul_rn(dvar, __fdiv_rn(2.f, (float)C));
  for (int i = lane; i < cv; i += 32) {
    float v[V], g[V], out[V];
    load_vec(xr + i * V, v);
    load_vec(gr + i * V, g);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float ge = g[e];
      if constexpr (kScaled) ge = __fmul_rn(ge, ld(scale[i * V + e]));
      out[e] = __fadd_rn(__fadd_rn(__fmul_rn(ge, rstd), dm_c), __fmul_rn(dv_c, v[e]));
    }
    store_vec(dx + (size_t)row * C + i * V, out);
  }
}

// ---- O, `dx_params`: per-(chunk, slab) sums of dy * xhat and dy over the rows ----

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
ln_bwd_params_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ stats, float* __restrict__ part1,
                     float* __restrict__ part2, int rows, int C, NormPlan p) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float red[];  // [2][row_lanes][slab_vecs * V]
  const int j = blockIdx.x / p.slabs, slab = blockIdx.x % p.slabs;
  const int sv = threadIdx.x % p.slab_vecs, rl = threadIdx.x / p.slab_vecs;
  const int cvec = slab * p.slab_vecs + sv;
  const int width = p.slab_vecs * V;
  float s1[V], s2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.f;
  if (rl < p.row_lanes && cvec < C / V) {
    const int r1 = min(rows, (j + 1) * p.chunk_rows);
    for (int r = j * p.chunk_rows + rl; r < r1; r += p.row_lanes) {
      float v[V], g[V];
      load_vec(x + (size_t)r * C + cvec * V, v);
      load_vec(dy + (size_t)r * C + cvec * V, g);
      const float mean = stats[r], rstd = stats[(size_t)rows + r];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s1[e] = __fadd_rn(s1[e], __fmul_rn(g[e], __fmul_rn(__fsub_rn(v[e], mean), rstd)));
        s2[e] = __fadd_rn(s2[e], g[e]);
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
    float u = 0.f, w = 0.f;
    for (int l = 0; l < p.row_lanes; ++l) {
      u = __fadd_rn(u, red[l * width + e]);
      w = __fadd_rn(w, red[(p.row_lanes + l) * width + e]);
    }
    part1[(size_t)j * C + c] = u;
    part2[(size_t)j * C + c] = w;
  }
}

}  // namespace
}  // namespace lvd

// Kernel N. x, dy, dx: (N, R, C) of `dtype` (0 bf16, 1 fp32, 2 fp16), C % 8
// == 0, G groups; the plan must be launch_plan's and `chunks` its chunk
// count. Forms (ops/norms.py GN_BWD_FORMS): 1 `affine` and 2 `affine_silu`
// (dy the cotangent of L's y; a, b (N, C) fp32 K's coefficients; stats (3,
// N, G) K's mean, inv and clamp mask; part1, part2 (N, chunks, C) and ds (2,
// N, G) fp32 workspaces), 3 `coeffs` (da, db (N, C) fp32 the cotangents of
// K's (a, b); stats as above), 4 `sums` (ds (2, N, G) the cotangents of K's
// sums), 5 `apply` and 6 `apply_silu` (dy, a, b, part1, part2 as in forms 1
// and 2; `terms` (2, N, C) fp32 receives the cotangents of (a, b)). scale
// (C,) of `pdtype` in forms 1-3. With `terms` ((2, N, C) fp32 workspace)
// non-null, forms 1-3 also write dscale and dbias (C,) of `pdtype`.
LVD_EXPORT int lvd_gn_bwd(const void* x, const void* dy, const void* a, const void* b,
                          const void* da, const void* db, const void* scale, const void* stats,
                          void* ds, void* part1, void* part2, void* terms, void* dx,
                          void* dscale, void* dbias, int N, int R, int C, int G, int form,
                          int vec, int slabs, int slab_vecs, int row_lanes, int chunk_rows,
                          int chunks, float count, int pdtype, int dtype, void* stream) {
  using namespace lvd;
  cudaGetLastError();
  const bool dz = form != kCoeffs && form != kSums;       // forms 1, 2, 5, 6
  const bool apply_only = form == kApply || form == kApplySilu;
  const bool stats_in = form == kAffine || form == kAffineSilu || form == kCoeffs;
  if (N <= 0 || R <= 0 || C <= 0 || C % 8 != 0 || G <= 0 || C % G != 0 || N > 65535 ||
      G > 65535 || form < kAffine || form > kApplySilu ||
      !plan_ok(C, dtype, vec, slabs, slab_vecs, row_lanes, chunk_rows) ||
      chunks != (R + chunk_rows - 1) / chunk_rows || (long long)chunks * slabs >= (1LL << 31) ||
      x == nullptr || dx == nullptr ||
      ((form == kAffine || form == kAffineSilu || form == kSums) && ds == nullptr) ||
      (dz && (dy == nullptr || a == nullptr || b == nullptr || part1 == nullptr ||
              part2 == nullptr)) ||
      (form == kCoeffs && (da == nullptr || db == nullptr)) ||
      (stats_in && (scale == nullptr || stats == nullptr || pdtype < 0 || pdtype > 2)) ||
      (form == kSums && terms != nullptr) || (apply_only && terms == nullptr) ||
      (stats_in && terms != nullptr && (dscale == nullptr || dbias == nullptr)))
    return cudaErrorInvalidValue;
  const NormPlan p{vec, slabs, slab_vecs, row_lanes, chunk_rows};
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(chunks * slabs, N);
  const int width = slab_vecs * vec;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto fw = static_cast<float*>(ds);
  auto tw = static_cast<float*>(terms);
  cudaError_t err = dispatch3(dtype, [&](auto tag) {
    using T = decltype(tag);
    auto xs = static_cast<const T*>(x);
    auto dys = static_cast<const T*>(dy);
    auto dxs = static_cast<T*>(dx);
    if (dz) {
      const int smem1 = 2 * row_lanes * width * (int)sizeof(float);
      if (form == kAffineSilu || form == kApplySilu)
        gn_bwd_partial_kernel<T, true><<<grid, kNormThreads, smem1, s>>>(
            xs, dys, f(a), f(b), static_cast<float*>(part1), static_cast<float*>(part2), R, C,
            p, chunks);
      else
        gn_bwd_partial_kernel<T, false><<<grid, kNormThreads, smem1, s>>>(
            xs, dys, f(a), f(b), static_cast<float*>(part1), static_cast<float*>(part2), R, C,
            p, chunks);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      const int smem2 = 2 * (C / G) * (int)sizeof(float);
      if (smem2 > kMaxSmem) return cudaErrorInvalidValue;
      e = set_smem(gn_bwd_finish_kernel<T>, smem2);
      if (e != cudaSuccess) return e;
      gn_bwd_finish_kernel<T><<<dim3(G, N), kNormThreads, smem2, s>>>(
          f(part1), f(part2), chunks, C, G, scale, pdtype, f(stats), count, fw, tw,
          apply_only);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    const int smem3 = 2 * width * (int)sizeof(float);
    const auto args = [&](auto kernel) {
      kernel<<<grid, kNormThreads, smem3, s>>>(xs, dys, f(a), f(b), f(da), f(db), scale, pdtype,
                                               f(stats), f(ds), count, tw, dxs, R, C, G, p);
    };
    if (form == kAffine) args(gn_bwd_dx_kernel<T, kAffine>);
    if (form == kAffineSilu) args(gn_bwd_dx_kernel<T, kAffineSilu>);
    if (form == kCoeffs) args(gn_bwd_dx_kernel<T, kCoeffs>);
    if (form == kSums) args(gn_bwd_dx_kernel<T, kSums>);
    if (form == kApply) args(gn_bwd_dx_kernel<T, kApply>);
    if (form == kApplySilu) args(gn_bwd_dx_kernel<T, kApplySilu>);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || terms == nullptr || apply_only) return err;
  colsum_kernel<<<(C + 31) / 32, 32 * kColLanes, 0, s>>>(tw, tw + (size_t)N * C, N, C, dscale,
                                                         dbias, pdtype);
  return cudaGetLastError();
}

// Kernel O. x, dy, dx: (rows, C) of `dtype`, C % 8 == 0; scale (C,) of
// `pdtype` or null (M's `normalize` form); stats (3, rows) fp32 M's mean,
// rstd and clamp mask. Forms
// (ops/norms.py LN_BWD_FORMS): 1 `dx`; 2 `dx_params`, which also writes
// dscale and dbias (C,) of `pdtype` through part1, part2 ((chunks, C) fp32
// workspaces) on K's plan over the rows (launch_plan's, checked in both
// forms).
LVD_EXPORT int lvd_layer_norm_bwd(const void* x, const void* dy, const void* scale,
                                  const void* stats, void* dx, void* part1, void* part2,
                                  void* dscale, void* dbias, int rows, int C, int form,
                                  int vec, int slabs, int slab_vecs, int row_lanes,
                                  int chunk_rows, int chunks, int pdtype, int dtype,
                                  void* stream) {
  using namespace lvd;
  cudaGetLastError();
  if (rows <= 0 || C <= 0 || C % 8 != 0 || (form != 1 && form != 2) ||
      !plan_ok(C, dtype, vec, slabs, slab_vecs, row_lanes, chunk_rows) ||
      chunks != (rows + chunk_rows - 1) / chunk_rows ||
      (long long)chunks * slabs >= (1LL << 31) || x == nullptr || dy == nullptr ||
      stats == nullptr || dx == nullptr || (scale != nullptr && (pdtype < 0 || pdtype > 2)) ||
      (form == 2 && (scale == nullptr || part1 == nullptr || part2 == nullptr ||
                     dscale == nullptr || dbias == nullptr)))
    return cudaErrorInvalidValue;
  const NormPlan p{vec, slabs, slab_vecs, row_lanes, chunk_rows};
  auto s = static_cast<cudaStream_t>(stream);
  auto stat = static_cast<const float*>(stats);
  cudaError_t err = dispatch3(dtype, [&](auto tag) {
    using T = decltype(tag);
    auto xs = static_cast<const T*>(x);
    auto dys = static_cast<const T*>(dy);
    auto dxs = static_cast<T*>(dx);
    const dim3 grid((rows + kLnRows - 1) / kLnRows);
    if (scale == nullptr) {
      ln_bwd_kernel<T, T, false><<<grid, kLnRows * 32, 0, s>>>(xs, dys, nullptr, stat, dxs, rows,
                                                               C);
    } else {
      cudaError_t e = dispatch3(pdtype, [&](auto ptag) {
        using P = decltype(ptag);
        ln_bwd_kernel<T, P, true><<<grid, kLnRows * 32, 0, s>>>(
            xs, dys, static_cast<const P*>(scale), stat, dxs, rows, C);
        return cudaGetLastError();
      });
      if (e != cudaSuccess) return e;
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || form == 1) return e;
    const int smem = 2 * row_lanes * slab_vecs * vec * (int)sizeof(float);
    ln_bwd_params_kernel<T><<<chunks * slabs, kNormThreads, smem, s>>>(
        xs, dys, stat, static_cast<float*>(part1), static_cast<float*>(part2), rows, C, p);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || form == 1) return err;
  colsum_kernel<<<(C + 31) / 32, 32 * kColLanes, 0, s>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2), chunks, C, dscale,
      dbias, pdtype);
  return cudaGetLastError();
}
