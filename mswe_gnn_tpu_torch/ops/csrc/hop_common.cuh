// Device code shared by the SWE-GNN hop kernels for Hopper (sm_90a):
// hop.cu instantiates it with ELL addressing, band_hop.cu with band-plan
// addressing. An addressing policy answers one question, "which source row
// does slot d of destination row n read?", and everything else is common.
//
// Forward (one hop):
//   agg[n] = sum_d act(n,d) * (dst[n] - src[a(n,d)]) * s[n,d]          gradient
//   agg[n] = sum_d act(n,d) * max(dst[n] - src[a(n,d)], 0) * s[n,d]    upwind
//   agg[n] = sum_d act(n,d) * s[n,d] * src[a(n,d)]                     no gradient
//   act(n,d) = rowsum(src[a(n,d)]) != 0  OR  rowsum(dst[n]) != 0
//
// Backward, for the upstream gradient g [Nd, F] (the wet-front mask act is
// piecewise constant and gets no gradient):
//   gs[n,d]       = act * diff * g[n]   (upwind: act * max(diff, 0) * g[n];
//                                        no gradient: act * src[a(n,d)] * g[n])
//   c(n,d)        = act * s[n,d] * g[n] (upwind: only where diff > 0)
//   g_dst[n]      = + sum_d c(n,d)                        (gradient modes)
//   g_src[r]      = - sum_{(n,d) : a(n,d) = r} c(n,d)     (gradient modes)
//   g_src[r]      = + sum_{(n,d) : a(n,d) = r} act * s[n,d] * g[n]  (no gradient)
// A same-block hop (src is dst) has one state gradient, g_dst + g_src.
//
// Arithmetic: float32 throughout, with explicitly rounded operations (no FMA
// contraction), terms added in a fixed order (slots in slot order, then the
// reading slots in the order of the out-slot table), one rounding to the
// storage type at each store. The plain PyTorch versions in ops/hop.py and
// ops/band_hop.py do the same operations in the same order, so the kernels
// match them to the bit. A source index outside [0, n_src) reads a row of
// NaN, as jnp.take's default fill mode does, instead of memory outside the
// state.
//
// Layout: a group of G lanes owns one row (G = F / V rounded up to a power
// of two, at most 32; V = 16 bytes of elements when F and every pointer
// allow it, else 1), so a warp reads whole rows with 16-byte loads. Row sums
// for the wet-front test are reduced by warp shuffles inside the group,
// under a mask of the group's own lanes: groups of one warp may take
// different branches and loop counts (the backward's reading-slot lists
// differ in length from row to row), and a whole group leaves together.
//
// The scatter of the backward: the TPU kernel carries an [N, F] accumulator
// across its sequential grid; Hopper's blocks run in no order. So the
// scatter is turned into a gather over a transposed table (CSR of the slots
// that read each source row, built once per graph by ops/hop.py's
// out_slot_table): the group that owns source row r adds its own slots'
// diagonal terms, then subtracts the contributions of the slots that read
// r, and stores the row once. No atomics: the result is deterministic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mswe {

constexpr int kThreads = 256;
constexpr int kTile = 128;         // band plan: destination rows a window serves
constexpr int kMaxDegree = 16;     // band plan: slot widths passed by value

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t f32_to_bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// ---- loads of V consecutive elements into float32 registers
__device__ __forceinline__ void load(const float* p, float (&x)[1]) { x[0] = __ldg(p); }

__device__ __forceinline__ void load(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[1]) {
  x[0] = bf16_bits_to_f32(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {        // little endian: element 2i is the low half
    x[2 * i] = bf16_bits_to_f32(w[i] & 0xffffu);
    x[2 * i + 1] = bf16_bits_to_f32(w[i] >> 16);
  }
}

// ---- stores, with one rounding to the storage type
__device__ __forceinline__ void store(float* p, const float (&x)[1]) { p[0] = x[0]; }

__device__ __forceinline__ void store(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&x)[1]) {
  p[0] = __float2bfloat16_rn(x[0]);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&x)[8]) {
  uint4 v;
  v.x = f32_to_bf16_bits(x[0]) | (f32_to_bf16_bits(x[1]) << 16);
  v.y = f32_to_bf16_bits(x[2]) | (f32_to_bf16_bits(x[3]) << 16);
  v.z = f32_to_bf16_bits(x[4]) | (f32_to_bf16_bits(x[5]) << 16);
  v.w = f32_to_bf16_bits(x[6]) | (f32_to_bf16_bits(x[7]) << 16);
  *reinterpret_cast<uint4*>(p) = v;
}

// The lanes of this thread's group (G a power of two dividing 32; groups
// never straddle a warp because the block size is a multiple of 32).
__device__ __forceinline__ unsigned group_mask(int group) {
  if (group >= 32) return 0xffffffffu;
  const int base = static_cast<int>(threadIdx.x & 31u) & ~(group - 1);
  return ((1u << group) - 1u) << base;
}

// Sum over the G lanes of a group; every lane of the group calls it.
__device__ __forceinline__ float group_sum(float v, int group, unsigned mask) {
  for (int off = group >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off, group);
  return v;
}

// Loads chunk j of a row (zeros past the row's last chunk) and adds its
// elements to `part`.
template <typename T, int V>
__device__ __forceinline__ void load_chunk(const T* row_ptr, int c, int nchunk,
                                           float (&x)[V], float& part) {
  if (c < nchunk) {
    load(row_ptr + c * V, x);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) part += x[i];
}

// Loads the source row a slot reads: NaN where the index is outside the
// source, zeros past the row's last chunk.
template <typename T, int V, int CPL>
__device__ __forceinline__ float load_source(const T* src_state, int64_t s, int n_src,
                                             int feat, int group, int lane, int nchunk,
                                             float (&nb)[CPL][V]) {
  const bool in_range = s >= 0 && s < n_src;
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = j * group + lane;
    if (c < nchunk && in_range) {
      load(src_state + s * feat + c * V, nb[j]);
    } else {
      const float fill = c < nchunk ? __int_as_float(0x7fc00000) : 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) nb[j][i] = fill;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) part += nb[j][i];
  }
  return part;
}

// ---- addressing policies

// ELL: slot sources are an [Nd, D] int32 table of source rows.
struct EllAddr {
  const int32_t* src_tab;
  int degree;
  __device__ __forceinline__ int64_t operator()(int64_t row, int d) const {
    return __ldg(src_tab + row * degree + d);
  }
};

// Band plan (mswe_gnn_tpu/ops/band_hop.py::BandPlan): slot d of row n reads
// win[n / 128, d] + rel when rel = idx_rel[n, d] < ws[d], else the ghost tail
// row n_rows - we + (rel - ws[d]).
struct BandAddr {
  const int32_t* idx_rel;
  const int32_t* win;
  int degree;
  int n_rows;
  int we;
  int ws[kMaxDegree];
  __device__ __forceinline__ int64_t operator()(int64_t row, int d) const {
    const int rel = __ldg(idx_rel + row * degree + d);
    const int w = ws[d];
    if (rel < w) return static_cast<int64_t>(__ldg(win + (row / kTile) * degree + d)) + rel;
    return static_cast<int64_t>(n_rows) - we + (rel - w);
  }
};

// ---- forward: CPL chunks of V elements a lane (F <= 32 * CPL * V)
template <typename T, int V, int CPL, typename Addr>
__global__ void __launch_bounds__(kThreads)
hop_fwd_kernel(const T* __restrict__ dst_state, const T* __restrict__ src_state, Addr addr,
               const T* __restrict__ s_tab, T* __restrict__ agg, int n_dst, int n_src,
               int feat, int degree, int group, int with_gradient, int upwind) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = tid / group;
  if (row >= n_dst) return;                     // the whole group leaves
  const int lane = static_cast<int>(tid % group);
  const unsigned gmask = group_mask(group);
  const int nchunk = feat / V;

  float o[CPL][V];
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) load_chunk<T, V>(dst_state + row * feat, j * group + lane, nchunk, o[j], part);
  const bool dst_act = group_sum(part, group, gmask) != 0.f;

  float acc[CPL][V];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;

  for (int d = 0; d < degree; ++d) {
    const int64_t slot = row * degree + d;
    float nb[CPL][V];
    part = load_source<T, V, CPL>(src_state, addr(row, d), n_src, feat, group, lane, nchunk, nb);
    const float act = (dst_act || group_sum(part, group, gmask) != 0.f) ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = j * group + lane;
      if (c >= nchunk) continue;
      float sv[V];
      load(s_tab + slot * feat + c * V, sv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float term;
        if (with_gradient) {
          float diff = __fsub_rn(o[j][i], nb[j][i]);
          if (upwind) diff = diff < 0.f ? 0.f : diff;   // keeps NaN, as clamp_min does
          term = __fmul_rn(diff, sv[i]);
        } else {
          term = __fmul_rn(sv[i], nb[j][i]);
        }
        acc[j][i] = __fadd_rn(acc[j][i], __fmul_rn(term, act));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = j * group + lane;
    if (c < nchunk) store(agg + row * feat + c * V, acc[j]);
  }
}

// ---- backward. Rows 0..max(Nd, Ns): a row below Nd does its own slots
// (gs, and the diagonal of g_dst); a row below Ns gathers the slots that
// read it through the out-slot table (out_ptr [Ns+1], out_slots: flat slot
// ids n * D + d). A same-block hop adds both into one accumulator and
// stores g_src only (the state gradient); otherwise g_dst (may be null: no
// gradient mode) and g_src are stored separately.
template <typename T, int V, int CPL, typename Addr>
__global__ void __launch_bounds__(kThreads)
hop_bwd_kernel(const T* __restrict__ dst_state, const T* __restrict__ src_state, Addr addr,
               const T* __restrict__ s_tab, const T* __restrict__ g,
               const int32_t* __restrict__ out_ptr, const int32_t* __restrict__ out_slots,
               T* __restrict__ gs, T* __restrict__ g_dst, T* __restrict__ g_src,
               int n_dst, int n_src, int feat, int degree, int group,
               int with_gradient, int upwind, int same_block) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = tid / group;
  const int64_t rows = same_block ? n_dst : (n_dst > n_src ? n_dst : n_src);
  if (row >= rows) return;                      // the whole group leaves
  const int lane = static_cast<int>(tid % group);
  const unsigned gmask = group_mask(group);
  const int nchunk = feat / V;

  float acc[CPL][V];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;

  if (row < n_dst) {
    float o[CPL][V], gr[CPL][V];
    float part = 0.f, unused = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = j * group + lane;
      load_chunk<T, V>(dst_state + row * feat, c, nchunk, o[j], part);
      load_chunk<T, V>(g + row * feat, c, nchunk, gr[j], unused);
    }
    const bool dst_act = group_sum(part, group, gmask) != 0.f;
    for (int d = 0; d < degree; ++d) {
      const int64_t slot = row * degree + d;
      float nb[CPL][V];
      part = load_source<T, V, CPL>(src_state, addr(row, d), n_src, feat, group, lane, nchunk, nb);
      const bool act = dst_act || group_sum(part, group, gmask) != 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = j * group + lane;
        if (c >= nchunk) continue;
        float sv[V], gsv[V];
        load(s_tab + slot * feat + c * V, sv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (with_gradient) {
            const float diff = __fsub_rn(o[j][i], nb[j][i]);
            const float kept = upwind ? (diff < 0.f ? 0.f : diff) : diff;
            gsv[i] = act ? __fmul_rn(kept, gr[j][i]) : 0.f;
            const bool pass = act && (!upwind || diff > 0.f);
            acc[j][i] = __fadd_rn(acc[j][i], pass ? __fmul_rn(sv[i], gr[j][i]) : 0.f);
          } else {
            gsv[i] = act ? __fmul_rn(nb[j][i], gr[j][i]) : 0.f;
          }
        }
        store(gs + slot * feat + c * V, gsv);
      }
    }
    if (!same_block) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = j * group + lane;
        if (g_dst != nullptr && c < nchunk) store(g_dst + row * feat + c * V, acc[j]);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
      }
    }
  }

  if (row < n_src) {
    float own[CPL][V];
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) load_chunk<T, V>(src_state + row * feat, j * group + lane, nchunk, own[j], part);
    const bool own_act = group_sum(part, group, gmask) != 0.f;
    const int begin = __ldg(out_ptr + row), end = __ldg(out_ptr + row + 1);
    for (int e = begin; e < end; ++e) {
      const int64_t slot = __ldg(out_slots + e);
      const int64_t n = slot / degree;
      float on[CPL][V];
      part = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) load_chunk<T, V>(dst_state + n * feat, j * group + lane, nchunk, on[j], part);
      const bool act = own_act || group_sum(part, group, gmask) != 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = j * group + lane;
        if (c >= nchunk) continue;
        float sv[V], gv[V];
        load(s_tab + slot * feat + c * V, sv);
        load(g + n * feat + c * V, gv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (with_gradient) {
            const bool pass = act && (!upwind || __fsub_rn(on[j][i], own[j][i]) > 0.f);
            acc[j][i] = __fsub_rn(acc[j][i], pass ? __fmul_rn(sv[i], gv[i]) : 0.f);
          } else {
            acc[j][i] = __fadd_rn(acc[j][i], act ? __fmul_rn(sv[i], gv[i]) : 0.f);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = j * group + lane;
      if (c < nchunk) store(g_src + row * feat + c * V, acc[j]);
    }
  }
}

// ---- launchers

struct Shape {
  int group, cpl;
};

inline Shape shape_for(int feat, int v) {
  const int nchunk = feat / v;
  int group = 1;
  while (group < nchunk && group < 32) group <<= 1;
  return {group, (nchunk + group - 1) / group};
}

inline dim3 grid_for(int64_t rows, int group) {
  const int64_t threads = rows * group;
  return dim3(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
}

template <typename T, int V, typename Addr>
int launch_fwd(const void* dst_state, const void* src_state, const Addr& addr,
               const void* s_tab, void* agg, int n_dst, int n_src, int feat, int degree,
               int with_gradient, int upwind, cudaStream_t stream) {
  const Shape sh = shape_for(feat, V);
  const dim3 grid = grid_for(n_dst, sh.group);
  const auto* d = static_cast<const T*>(dst_state);
  const auto* s = static_cast<const T*>(src_state);
  const auto* f = static_cast<const T*>(s_tab);
  auto* a = static_cast<T*>(agg);
#define MSWE_FWD(CPL)                                                              \
  hop_fwd_kernel<T, V, CPL, Addr><<<grid, kThreads, 0, stream>>>(                  \
      d, s, addr, f, a, n_dst, n_src, feat, degree, sh.group, with_gradient, upwind)
  switch (sh.cpl) {
    case 1: MSWE_FWD(1); break;
    case 2: MSWE_FWD(2); break;
    case 3:
    case 4: MSWE_FWD(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MSWE_FWD
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, typename Addr>
int launch_bwd(const void* dst_state, const void* src_state, const Addr& addr,
               const void* s_tab, const void* g, const void* out_ptr, const void* out_slots,
               void* gs, void* g_dst, void* g_src, int n_dst, int n_src, int feat,
               int degree, int with_gradient, int upwind, int same_block,
               cudaStream_t stream) {
  const Shape sh = shape_for(feat, V);
  const int64_t rows = same_block ? n_dst : (n_dst > n_src ? n_dst : n_src);
  const dim3 grid = grid_for(rows, sh.group);
  const auto* d = static_cast<const T*>(dst_state);
  const auto* s = static_cast<const T*>(src_state);
  const auto* f = static_cast<const T*>(s_tab);
  const auto* gg = static_cast<const T*>(g);
  const auto* op = static_cast<const int32_t*>(out_ptr);
  const auto* os = static_cast<const int32_t*>(out_slots);
  auto* o_gs = static_cast<T*>(gs);
  auto* o_gd = static_cast<T*>(g_dst);
  auto* o_gsrc = static_cast<T*>(g_src);
#define MSWE_BWD(CPL)                                                              \
  hop_bwd_kernel<T, V, CPL, Addr><<<grid, kThreads, 0, stream>>>(                  \
      d, s, addr, f, gg, op, os, o_gs, o_gd, o_gsrc, n_dst, n_src, feat, degree,   \
      sh.group, with_gradient, upwind, same_block)
  switch (sh.cpl) {
    case 1: MSWE_BWD(1); break;
    case 2: MSWE_BWD(2); break;
    case 3:
    case 4: MSWE_BWD(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MSWE_BWD
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16. vectorized: 16-byte loads (the caller
// checks that F is a multiple of 16 bytes and every pointer 16-byte aligned).
template <typename Addr>
int fwd_any(int dtype, int vectorized, const void* dst_state, const void* src_state,
            const Addr& addr, const void* s_tab, void* agg, int n_dst, int n_src,
            int feat, int degree, int with_gradient, int upwind, cudaStream_t st) {
  if (n_dst <= 0) return 0;
  if (dtype == 0) {
    return vectorized
        ? launch_fwd<float, 4>(dst_state, src_state, addr, s_tab, agg, n_dst, n_src, feat,
                               degree, with_gradient, upwind, st)
        : launch_fwd<float, 1>(dst_state, src_state, addr, s_tab, agg, n_dst, n_src, feat,
                               degree, with_gradient, upwind, st);
  }
  if (dtype == 1) {
    return vectorized
        ? launch_fwd<__nv_bfloat16, 8>(dst_state, src_state, addr, s_tab, agg, n_dst, n_src,
                                       feat, degree, with_gradient, upwind, st)
        : launch_fwd<__nv_bfloat16, 1>(dst_state, src_state, addr, s_tab, agg, n_dst, n_src,
                                       feat, degree, with_gradient, upwind, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Addr>
int bwd_any(int dtype, int vectorized, const void* dst_state, const void* src_state,
            const Addr& addr, const void* s_tab, const void* g, const void* out_ptr,
            const void* out_slots, void* gs, void* g_dst, void* g_src, int n_dst, int n_src,
            int feat, int degree, int with_gradient, int upwind, int same_block,
            cudaStream_t st) {
  if (n_dst <= 0 && n_src <= 0) return 0;
  if (dtype == 0) {
    return vectorized
        ? launch_bwd<float, 4>(dst_state, src_state, addr, s_tab, g, out_ptr, out_slots, gs,
                               g_dst, g_src, n_dst, n_src, feat, degree, with_gradient,
                               upwind, same_block, st)
        : launch_bwd<float, 1>(dst_state, src_state, addr, s_tab, g, out_ptr, out_slots, gs,
                               g_dst, g_src, n_dst, n_src, feat, degree, with_gradient,
                               upwind, same_block, st);
  }
  if (dtype == 1) {
    return vectorized
        ? launch_bwd<__nv_bfloat16, 8>(dst_state, src_state, addr, s_tab, g, out_ptr,
                                       out_slots, gs, g_dst, g_src, n_dst, n_src, feat,
                                       degree, with_gradient, upwind, same_block, st)
        : launch_bwd<__nv_bfloat16, 1>(dst_state, src_state, addr, s_tab, g, out_ptr,
                                       out_slots, gs, g_dst, g_src, n_dst, n_src, feat,
                                       degree, with_gradient, upwind, same_block, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace mswe
