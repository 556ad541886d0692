// ELL hop of the SWE-GNN layer, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mswe_gnn_tpu/ops/pallas_hop.py::_hop_kernel
// (wrapper fused_hop), and with it the XLA slot loop that the JAX package
// runs on the TPU instead (mswe_gnn_tpu/models/swegnn.py:420-471).
//
//   agg[n] = sum_d act(n,d) * (dst[n] - src[tab[n,d]]) * s[n,d]          gradient
//   agg[n] = sum_d act(n,d) * max(dst[n] - src[tab[n,d]], 0) * s[n,d]    upwind
//   agg[n] = sum_d act(n,d) * s[n,d] * src[tab[n,d]]                     no gradient
//   act(n,d) = rowsum(src[tab[n,d]]) != 0  OR  rowsum(dst[n]) != 0
//
// State and flux are float32 or bfloat16, indices int32. Every product and
// sum is taken in float32 and the aggregate is rounded to the state type
// once, at the store. The D terms are added in slot order with explicitly
// rounded operations (no contraction into FMA), so the kernel repeats
// hop_reference in ops/hop.py operation for operation. A source index
// outside [0, n_src) reads a row of NaN, as jnp.take's default fill mode
// does, instead of reading outside the state.
//
// What bounds it on an H100: bytes. At the finest bench scale in bf16
// (Nd = 23168, D = 4, F = 64) one hop reads 11.9 MB of flux, 3.0 MB of state
// and 0.37 MB of indices and writes 3.0 MB: about 18 MB, 5.4 us at 3.35 TB/s,
// against some 0.03 GFLOP of float32 arithmetic. Neighbour rows mostly hit
// the 50 MB L2 (the state is 3 MB). The two coarse scales move 4x and 15x
// less and are bound by the launch instead.
//
// Design: a group of G lanes owns one destination row (G = F / V rounded up
// to a power of two, at most 32; V = 16 bytes of elements when F and the
// pointers allow, else 1), so a warp reads whole rows with 16-byte loads.
// The row sums of the wet-front test are reduced with warp shuffles inside
// the group, and the D slots are a loop inside the thread. Lanes past the
// last row repeat the last row and skip the store, so every lane of a warp
// reaches the shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// ---- stores, with one rounding to the state type
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

// Sum over the G lanes of a group (G a power of two dividing 32). Every lane
// of the warp must call it.
__device__ __forceinline__ float group_sum(float v, int group) {
  for (int off = group >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, group);
  return v;
}

// CPL: chunks of V elements held by each lane (F <= 32 * CPL * V).
template <typename T, int V, int CPL>
__global__ void __launch_bounds__(kThreads)
hop_kernel(const T* __restrict__ dst_state, const T* __restrict__ src_state,
           const int32_t* __restrict__ src_tab, const T* __restrict__ s_tab,
           T* __restrict__ agg, int n_dst, int n_src, int feat, int degree,
           int group, int with_gradient, int upwind) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row_raw = tid / group;
  const int lane = static_cast<int>(tid % group);
  const bool valid = row_raw < n_dst;
  const int64_t row = valid ? row_raw : n_dst - 1;
  const int nchunk = feat / V;

  // own row, and its wet test
  float o[CPL][V];
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = j * group + lane;
    if (c < nchunk) {
      load(dst_state + row * feat + c * V, o[j]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) o[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) part += o[j][i];
  }
  const bool dst_act = group_sum(part, group) != 0.f;

  float acc[CPL][V];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;

  for (int d = 0; d < degree; ++d) {
    const int64_t slot = row * degree + d;
    const int s = __ldg(src_tab + slot);
    const bool in_range = s >= 0 && s < n_src;
    float nb[CPL][V];
    part = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = j * group + lane;
      if (c < nchunk && in_range) {
        load(src_state + static_cast<int64_t>(s) * feat + c * V, nb[j]);
      } else {
        const float fill = c < nchunk ? __int_as_float(0x7fc00000) : 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) nb[j][i] = fill;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) part += nb[j][i];
    }
    const float act = (dst_act || group_sum(part, group) != 0.f) ? 1.f : 0.f;
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

  if (!valid) return;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = j * group + lane;
    if (c < nchunk) store(agg + row * feat + c * V, acc[j]);
  }
}

template <typename T, int V>
int launch(const void* dst_state, const void* src_state, const void* src_tab,
           const void* s_tab, void* agg, int n_dst, int n_src, int feat,
           int degree, int with_gradient, int upwind, cudaStream_t stream) {
  const int nchunk = feat / V;
  int group = 1;
  while (group < nchunk && group < 32) group <<= 1;
  const int cpl = (nchunk + group - 1) / group;
  const int64_t threads = static_cast<int64_t>(n_dst) * group;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  const auto* d = static_cast<const T*>(dst_state);
  const auto* s = static_cast<const T*>(src_state);
  const auto* t = static_cast<const int32_t*>(src_tab);
  const auto* f = static_cast<const T*>(s_tab);
  auto* a = static_cast<T*>(agg);
  switch (cpl) {
    case 1:
      hop_kernel<T, V, 1><<<grid, kThreads, 0, stream>>>(
          d, s, t, f, a, n_dst, n_src, feat, degree, group, with_gradient, upwind);
      break;
    case 2:
      hop_kernel<T, V, 2><<<grid, kThreads, 0, stream>>>(
          d, s, t, f, a, n_dst, n_src, feat, degree, group, with_gradient, upwind);
      break;
    case 3:
    case 4:
      hop_kernel<T, V, 4><<<grid, kThreads, 0, stream>>>(
          d, s, t, f, a, n_dst, n_src, feat, degree, group, with_gradient, upwind);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vectorized: 16-byte loads (the caller
// checks that F is a multiple of 16 bytes and every pointer 16-byte aligned).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int mswe_hop_launch(const void* dst_state, const void* src_state,
                               const void* src_tab, const void* s_tab, void* agg,
                               int n_dst, int n_src, int feat, int degree,
                               int dtype, int vectorized, int with_gradient,
                               int upwind, void* stream) {
  if (n_dst <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vectorized
        ? launch<float, 4>(dst_state, src_state, src_tab, s_tab, agg, n_dst, n_src,
                           feat, degree, with_gradient, upwind, st)
        : launch<float, 1>(dst_state, src_state, src_tab, s_tab, agg, n_dst, n_src,
                           feat, degree, with_gradient, upwind, st);
  }
  if (dtype == 1) {
    return vectorized
        ? launch<__nv_bfloat16, 8>(dst_state, src_state, src_tab, s_tab, agg, n_dst,
                                   n_src, feat, degree, with_gradient, upwind, st)
        : launch<__nv_bfloat16, 1>(dst_state, src_state, src_tab, s_tab, agg, n_dst,
                                   n_src, feat, degree, with_gradient, upwind, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
