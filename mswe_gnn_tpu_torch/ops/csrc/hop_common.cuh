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
// What bounds the forward on an H100. Its least time is set by bytes (18 MB
// at the finest bench scale in bf16: 5.4 us at 3.35 TB/s), but a slot loop
// that walks the slots one by one (index, then source row, then its row
// sum, then the flux) makes each group wait on about nine dependent round
// trips, and at the coarse scales, whose grids are resident at once, the
// kernel lasts that chain. So the forward works in batches of B slots (4 at
// one chunk a lane, fewer for wider rows): it issues the batch's table
// entries, the flux rows (which depend on no entry) and, once the entries
// are in, all of the batch's source rows, before it uses any of them; the
// destination row is issued first of all and reduced while the source rows
// are in flight. The chain is two round trips a batch.
//
// Loads in flight must be held somewhere, and at the finest scale, where
// the grid takes several waves, what they hold caps the warps an SM keeps
// and with them the rate at which rows go through. Held in registers, a
// batch took 106 of them and left 16 warps an SM, slower there than the
// slot loop at 40. So 16-byte chunks are copied into shared memory with
// cp.async (SmemStage): 36 KB a 256-thread block, 63 registers, 32 warps an
// SM. Narrower chunks, which cp.async cannot copy one to an element, stay
// in registers (RegStage). Each lane reads back only its own copies.
//
// The band plan's slots are walked with compile-time slot numbers
// (kMaxDegree bounds them), so its widths are read from the kernel
// parameters at constant offsets (no stack frame), and its window start is
// loaded beside idx_rel instead of after it. The block size is chosen from
// the row count (pick_block), so that a coarse scale's few rows spread over
// every SM.
//
// The scatter of the backward: the TPU kernel carries an [N, F] accumulator
// across its sequential grid; Hopper's blocks run in no order. So the
// scatter is turned into a gather over a transposed table (CSR of the slots
// that read each source row, built once per graph by ops/hop.py's
// out_slot_table): the group that owns source row r adds its own slots'
// diagonal terms, then subtracts the contributions of the slots that read
// r, and stores the row once. No atomics: the result is deterministic.
//
// The backward has two chains of loads a row: its own slots (table entry,
// then source row; flux, destination and gradient rows) and its reading
// slots (out_ptr, then the out-slot entry, then the reader's destination,
// flux and gradient rows). Walked one slot at a time that is about twenty
// dependent round trips a row at D = 4, and the whole grid of a bench
// scale is resident at once, so the kernel lasts the chain. So it loads
// as the forward does: its first group of copies holds the destination
// and gradient rows (and, for a separate source, the source row itself),
// then each own batch of B slots issues its table entries and flux rows,
// then its source rows; out_ptr is loaded with the first loads and the
// first reading batch's out-slot entries while the own batch is in
// flight; a reading batch of R slots issues the readers' rows together and
// the next batch's entries behind them. Row sums of a batch are reduced
// together, and the terms are added in slot order, then in out-slot-table
// order, as before. Where the row itself is wet and the mode is not
// upwind, every reading slot is active and the readers' destination rows
// are not needed, so they are not loaded. The flux is not loaded by the
// own slots in the no-gradient mode, which does not use it there. Loads
// are staged as in the forward (SmemStage / RegStage): at one chunk a lane
// 224 bytes a lane for the band backward (readers in fours), so its blocks
// take 128 threads to stay within the 48 KB a kernel gets without opting
// in (bwd_block), and 160 for the ELL one (readers in pairs; 16 more for a
// separate source). The register budget and reader batch differ by
// addressing (BwdTuning). The chain is three round trips a row where it
// was about twenty; the arithmetic per row, and at the finest scale the
// warps an SM keeps, now set the time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mswe {

constexpr int kThreads = 256;
constexpr int kTile = 128;         // band plan: destination rows a window serves
constexpr int kMaxDegree = 16;     // band plan: slot widths passed by value
constexpr int kFwdSlots = 4;       // forward: slots a batch loads at one chunk a lane
// forward: blocks of 256 threads an SM must hold at one chunk a lane
// (__launch_bounds__, which caps the registers: 4 gives 63-64 and 32 warps
// an SM; 5 and 6 spill)
constexpr int kFwdMinBlocks = 4;
constexpr int kMinThreads = 64;    // the smallest block pick_block chooses
constexpr int kMaxSmem = 48 * 1024;  // dynamic shared memory a block takes without opting in

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t f32_to_bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// ---- a chunk of V consecutive elements as it lies in memory (fetch), and
// widened to float32 registers (widen).
template <typename T, int V> struct Chunk;
template <> struct Chunk<float, 1> { using type = float; };
template <> struct Chunk<float, 4> { using type = float4; };
template <> struct Chunk<__nv_bfloat16, 1> { using type = unsigned short; };
template <> struct Chunk<__nv_bfloat16, 8> { using type = uint4; };

__device__ __forceinline__ void fetch(const float* p, float& r) { r = __ldg(p); }
__device__ __forceinline__ void fetch(const float* p, float4& r) {
  r = __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void fetch(const __nv_bfloat16* p, unsigned short& r) {
  r = __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ void fetch(const __nv_bfloat16* p, uint4& r) {
  r = __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void widen(float r, float (&x)[1]) { x[0] = r; }
__device__ __forceinline__ void widen(const float4& r, float (&x)[4]) {
  x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
}
__device__ __forceinline__ void widen(unsigned short r, float (&x)[1]) {
  x[0] = bf16_bits_to_f32(r);
}
__device__ __forceinline__ void widen(const uint4& r, float (&x)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
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

// x, opaque to the compiler from here on (no instruction is emitted).
__device__ __forceinline__ int settle(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// A fetched chunk of a source row, widened: NaN where the slot's index was
// outside the source, zeros past the row's last chunk.
template <typename Raw, int V>
__device__ __forceinline__ void source_chunk(const Raw& raw, bool real, bool in_range,
                                             float (&x)[V]) {
  if (real && in_range) {
    widen(raw, x);
  } else {
    const float fill = real ? __int_as_float(0x7fc00000) : 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = fill;
  }
}

// ---- addressing policies: fetch loads a slot's table entries as they lie,
// resolve gives the source row from them, so that the loads of a batch are
// issued before any of them is waited for.

// ELL: slot sources are an [Nd, D] int32 table of source rows. Slot numbers
// may be runtime values: nothing is indexed by them.
struct EllAddr {
  static constexpr bool kStaticSlots = false;
  const int32_t* src_tab;
  int degree;
  struct Raw { int32_t src; };
  __device__ __forceinline__ Raw fetch(int64_t row, int d) const {
    return {__ldg(src_tab + row * degree + d)};
  }
  __device__ __forceinline__ int64_t resolve(const Raw& r, int) const { return r.src; }
};

// Band plan (mswe_gnn_tpu/ops/band_hop.py::BandPlan): slot d of row n reads
// win[n / 128, d] + rel when rel = idx_rel[n, d] < ws[d], else the ghost tail
// row n_rows - we + (rel - ws[d]). Both kernels take slot numbers known at
// compile time (kStaticSlots), so that ws[d] is a parameter at a constant
// offset and not a copy of ws in local memory.
struct BandAddr {
  static constexpr bool kStaticSlots = true;
  const int32_t* idx_rel;
  const int32_t* win;
  int degree;
  int n_rows;
  int we;
  int ws[kMaxDegree];
  struct Raw { int32_t rel, start; };
  __device__ __forceinline__ Raw fetch(int64_t row, int d) const {
    return {__ldg(idx_rel + row * degree + d), __ldg(win + (row / kTile) * degree + d)};
  }
  __device__ __forceinline__ int64_t resolve(const Raw& r, int d) const {
    const int w = ws[d];
    if (r.rel < w) return static_cast<int64_t>(r.start) + r.rel;
    return static_cast<int64_t>(n_rows) - we + (r.rel - w);
  }
};

// A slot number known at compile time, usable as an int.
template <int N>
struct Slot {
  __host__ __device__ constexpr operator int() const { return N; }
};

// Calls f(Slot<d0>) for d0 = First, First + Step, ... while d0 < min(Limit,
// degree).
template <int First, int Step, int Limit, typename F>
__device__ __forceinline__ void static_steps(int degree, F&& f) {
  if constexpr (First < Limit) {
    if (First < degree) {
      f(Slot<First>{});
      static_steps<First + Step, Step, Limit>(degree, f);
    }
  }
}

// Slots a forward batch loads together: kFwdSlots at one chunk a lane,
// fewer for wider rows, so that a lane holds the same bytes in flight.
__host__ __device__ constexpr int fwd_batch(int cpl) {
  return kFwdSlots / cpl > 1 ? kFwdSlots / cpl : 1;
}
__host__ __device__ constexpr int fwd_min_blocks(int cpl) {
  return cpl == 1 ? kFwdMinBlocks : 1;
}
// Chunks a lane stages: its destination row, then B slots' flux and source
// rows.
__host__ __device__ constexpr int fwd_stage_chunks(int cpl) {
  return cpl + 2 * fwd_batch(cpl) * cpl;
}
// Backward, by addressing (measured on an H100, PERF.md): kReaders, the
// reading slots a batch loads at one chunk a lane; kMinBlocks, blocks of
// 256 threads an SM must hold at one chunk a lane with 16-byte chunks
// (__launch_bounds__: 4 caps the registers at 64, 3 at 80); kFresh, the
// own slots read the destination and gradient chunks anew from shared
// memory at every slot instead of keeping them widened in registers. The
// band plan's entries are two words a slot: its backward spills at 64
// registers whatever else is cut, so it takes 80 and readers in fours. The
// ELL one fits 64 with readers in pairs and fresh reads, and then holds 32
// warps an SM instead of 24: its un-pool hop 23168 <- 5888, whose grid
// takes two waves, needs them.
template <typename Addr> struct BwdTuning;
template <> struct BwdTuning<EllAddr> {
  static constexpr int kReaders = 2, kMinBlocks = 4;
  static constexpr bool kFresh = true;
};
template <> struct BwdTuning<BandAddr> {
  static constexpr int kReaders = 4, kMinBlocks = 3;
  static constexpr bool kFresh = false;
};

// Backward: reading slots a batch loads together (fewer for wider rows, as
// fwd_batch), blocks an SM must hold (registers staging narrow chunks
// spill at 64: they take 80), the chunks of the batch region (an own
// batch's flux and source rows or a reading batch's destination, flux and
// gradient rows, whichever is larger), and the chunks a lane stages: its
// destination and gradient rows, the batch region and, for a separate
// source, its own source row.
template <typename Addr>
__host__ __device__ constexpr int bwd_readers(int cpl) {
  return BwdTuning<Addr>::kReaders / cpl > 1 ? BwdTuning<Addr>::kReaders / cpl : 1;
}
template <typename Addr>
__host__ __device__ constexpr int bwd_min_blocks(int cpl, bool staged) {
  return cpl == 1 ? (staged ? BwdTuning<Addr>::kMinBlocks : 3) : 1;
}
template <typename Addr>
__host__ __device__ constexpr int bwd_batch_chunks(int cpl) {
  return (2 * fwd_batch(cpl) > 3 * bwd_readers<Addr>(cpl) ? 2 * fwd_batch(cpl)
                                                          : 3 * bwd_readers<Addr>(cpl)) * cpl;
}
template <typename Addr>
__host__ __device__ constexpr int bwd_stage_chunks(int cpl, bool same_block) {
  return 2 * cpl + bwd_batch_chunks<Addr>(cpl) + (same_block ? 0 : cpl);
}

// Four 32-bit words as a 16-byte chunk.
__device__ __forceinline__ uint4 from_words(const uint32_t (&w)[4], uint4) {
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ float4 from_words(const uint32_t (&w)[4], float4) {
  return make_float4(__uint_as_float(w[0]), __uint_as_float(w[1]), __uint_as_float(w[2]),
                     __uint_as_float(w[3]));
}

// ---- where the loads land. Chunk k of a lane, forward: k < CPL its
// destination row, then the batch's flux rows, then its source rows
// (backward: see hop_bwd_kernel).
//
// SmemStage (16-byte chunks): cp.async copies into the block's dynamic
// shared memory, one column a thread (chunk k of thread t at k * blockDim + t,
// so a warp's accesses fall on consecutive 16-byte words). Loads in flight
// hold no registers. Each lane waits for its own copies only
// (cp.async.wait_group makes them visible to the thread that issued them),
// so no barrier is needed; a later batch overwrites a chunk only after the
// lane has used it. Flux rows, read once, are cached in L2 only (.cg); state
// rows, which the neighbouring rows of a block read again, in L1 as well
// (.ca).
template <typename Raw>
struct SmemStage {
  Raw* col;
  int stride;
  template <bool kStream, typename T>
  __device__ __forceinline__ void put(int k, const T* p) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(col + k * stride));
    if constexpr (kStream)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(p) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(p) : "memory");
  }
  __device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
  // all but the newest group have landed / everything has landed
  __device__ __forceinline__ void wait_older() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
  __device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
  __device__ __forceinline__ Raw get(int k) const { return col[k * stride]; }
  // get, read anew at every call: the compiler cannot keep the value in
  // registers from one use to the next
  __device__ __forceinline__ Raw fresh(int k) const {
    const unsigned src = static_cast<unsigned>(__cvta_generic_to_shared(col + k * stride));
    uint32_t w[4];
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "r"(src));
    return from_words(w, Raw{});
  }
};

// RegStage (narrower chunks, which cp.async cannot copy one to an element):
// loads into registers; a load is waited for where its value is used.
template <typename Raw, int N>
struct RegStage {
  Raw r[N];
  template <bool kStream, typename T>
  __device__ __forceinline__ void put(int k, const T* p) { fetch(p, r[k]); }
  __device__ __forceinline__ void commit() {}
  __device__ __forceinline__ void wait_older() {}
  __device__ __forceinline__ void wait_all() {}
  __device__ __forceinline__ const Raw& get(int k) const { return r[k]; }
  __device__ __forceinline__ const Raw& fresh(int k) const { return r[k]; }
};

template <typename T, int V>
constexpr bool kStaged = sizeof(typename Chunk<T, V>::type) == 16;

// ---- forward: CPL chunks of V elements a lane (F <= 32 * CPL * V), slots in
// batches of B (see the header comment). The arithmetic is the slot loop's:
// terms added to a float32 accumulator in slot order.
template <typename T, int V, int CPL, typename Addr>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks(CPL))
hop_fwd_kernel(const T* __restrict__ dst_state, const T* __restrict__ src_state, Addr addr,
               const T* __restrict__ s_tab, T* __restrict__ agg, int n_dst, int n_src,
               int feat, int degree, int group, int with_gradient, int upwind) {
  using Raw = typename Chunk<T, V>::type;
  constexpr int B = fwd_batch(CPL);
  constexpr int kFlux = CPL, kSrc = CPL + B * CPL;     // first flux / source chunk
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = tid / group;
  if (row >= n_dst) return;                     // the whole group leaves
  const int lane = static_cast<int>(tid % group);
  const unsigned gmask = group_mask(group);
  const int nchunk = feat / V;

  extern __shared__ uint4 stage_smem[];
  using Stage = std::conditional_t<kStaged<T, V>, SmemStage<Raw>,
                                   RegStage<Raw, fwd_stage_chunks(CPL)>>;
  Stage st;
  if constexpr (kStaged<T, V>) {
    st.col = reinterpret_cast<Raw*>(stage_smem) + threadIdx.x;
    st.stride = blockDim.x;
  }

#pragma unroll
  for (int j = 0; j < CPL; ++j) {               // the destination row, issued first
    const int c = j * group + lane;
    if (c < nchunk) st.template put<false>(j, dst_state + row * feat + c * V);
  }

  float o[CPL][V], acc[CPL][V];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
  bool dst_act = false;

  // Slots d0 .. d0 + B - 1 (the ones below degree). Called from one place
  // on each path, so that it is inlined and its arrays stay in registers.
  auto batch = [&](auto d0) {
    // 1. every load of the batch: the table entries, the flux rows (one
    // group of copies with the destination row), then, once the entries are
    // in, the source rows (a second group)
    typename Addr::Raw entry[B];
    bool in_range[B];
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (d0 + b < degree) entry[b] = addr.fetch(row, d0 + b);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (d0 + b >= degree) continue;
      const T* flux = s_tab + (row * degree + d0 + b) * feat;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = j * group + lane;
        if (c < nchunk) st.template put<true>(kFlux + b * CPL + j, flux + c * V);
      }
    }
    st.commit();
#pragma unroll
    for (int b = 0; b < B; ++b) {
      in_range[b] = false;
      if (d0 + b >= degree) continue;
      const int64_t s = addr.resolve(entry[b], d0 + b);
      in_range[b] = s >= 0 && s < n_src;
      if (!in_range[b]) continue;               // the row reads NaN
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = j * group + lane;
        if (c < nchunk) st.template put<false>(kSrc + b * CPL + j, src_state + s * feat + c * V);
      }
    }
    st.commit();

    // 2. the first batch: the destination row's sum, while the source rows
    // are in flight
    if (d0 == 0) {
      st.wait_older();
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (j * group + lane < nchunk) {
          widen(st.get(j), o[j]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) o[j][i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < V; ++i) part += o[j][i];
      }
      dst_act = group_sum(part, group, gmask) != 0.f;
    }
    st.wait_all();

    // 3. the B row sums, reduced together (one shuffle of each a step), then
    // the terms in slot order. A source chunk is widened where it is used
    // (twice), so that only its storage-type copy stays live.
    float sum[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      sum[b] = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        float x[V];
        source_chunk(st.get(kSrc + b * CPL + j), j * group + lane < nchunk, in_range[b], x);
#pragma unroll
        for (int i = 0; i < V; ++i) sum[b] += x[i];
      }
    }
    for (int off = group >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int b = 0; b < B; ++b) sum[b] += __shfl_xor_sync(gmask, sum[b], off, group);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (d0 + b >= degree) continue;
      const float act = (dst_act || sum[b] != 0.f) ? 1.f : 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (j * group + lane >= nchunk) continue;
        float nb[V], sv[V];
        source_chunk(st.get(kSrc + b * CPL + j), true, in_range[b], nb);
        widen(st.get(kFlux + b * CPL + j), sv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float term;
          if (with_gradient) {
            float diff = __fsub_rn(o[j][i], nb[i]);
            if (upwind) diff = diff < 0.f ? 0.f : diff;   // keeps NaN, as clamp_min does
            term = __fmul_rn(diff, sv[i]);
          } else {
            term = __fmul_rn(sv[i], nb[i]);
          }
          // acc + term * act with act 0 or 1: the product is exact, so one
          // fused rounding gives the bits of a product and a sum
          acc[j][i] = __fmaf_rn(term, act, acc[j][i]);
        }
      }
    }
  };

  if constexpr (Addr::kStaticSlots) {
    static_steps<0, B, kMaxDegree>(degree, batch);
  } else {
    for (int d0 = 0; d0 < degree; d0 += B) batch(d0);
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
//
// Chunk k of a lane: [0, CPL) its destination row, [CPL, 2 CPL) its
// gradient row, then the batch region: an own batch's B flux rows and B
// source rows, or a reading batch's R destination rows, R flux rows and R
// gradient rows; last, for a separate source, its own source row (a
// same-block hop's is its destination row). The arithmetic is the slot
// loop's: float32 terms added in slot order, then in out-slot-table order.
template <typename T, int V, int CPL, typename Addr>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks<Addr>(CPL, kStaged<T, V>))
hop_bwd_kernel(const T* __restrict__ dst_state, const T* __restrict__ src_state, Addr addr,
               const T* __restrict__ s_tab, const T* __restrict__ g,
               const int32_t* __restrict__ out_ptr, const int32_t* __restrict__ out_slots,
               T* __restrict__ gs, T* __restrict__ g_dst, T* __restrict__ g_src,
               int n_dst, int n_src, int feat, int degree, int group,
               int with_gradient, int upwind, int same_block) {
  using Raw = typename Chunk<T, V>::type;
  constexpr int B = fwd_batch(CPL), R = bwd_readers<Addr>(CPL);
  constexpr int kGrad = CPL, kBatch = 2 * CPL, kOwn = kBatch + bwd_batch_chunks<Addr>(CPL);
  constexpr bool kFresh = BwdTuning<Addr>::kFresh;
  constexpr int kSrc = kBatch + B * CPL;                        // own batch: flux at kBatch
  constexpr int kFlux2 = kBatch + R * CPL, kGrad2 = kBatch + 2 * R * CPL;  // reading batch
  // 32-bit rows and slot ids (out_slots holds them as int32), 64-bit
  // offsets: a 64-bit division is a long routine, and 64-bit indices take
  // two registers each
  const int row = static_cast<int>(
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / group);
  const int rows = same_block ? n_dst : (n_dst > n_src ? n_dst : n_src);
  if (row >= rows) return;                      // the whole group leaves
  const int lane = static_cast<int>(threadIdx.x % group);
  const unsigned gmask = group_mask(group);
  const int nchunk = feat / V;
  const bool owns = row < n_dst, reads = row < n_src;
  auto at = [feat](auto* base, int r, int c) {
    return base + static_cast<int64_t>(r) * feat + c * V;
  };

  extern __shared__ uint4 stage_smem[];
  using Stage = std::conditional_t<kStaged<T, V>, SmemStage<Raw>,
                                   RegStage<Raw, bwd_stage_chunks<Addr>(CPL, false)>>;
  Stage st;
  if constexpr (kStaged<T, V>) {
    st.col = reinterpret_cast<Raw*>(stage_smem) + threadIdx.x;
    st.stride = blockDim.x;
  }

  // the first group of copies: the destination and gradient rows, and a
  // separate source's own row; then the row's range of the out-slot table
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = j * group + lane;
    if (c >= nchunk) continue;
    if (owns) {
      st.template put<false>(j, at(dst_state, row, c));
      st.template put<false>(kGrad + j, at(g, row, c));
    }
    if (reads && !same_block) st.template put<false>(kOwn + j, at(src_state, row, c));
  }
  st.commit();
  int begin = 0, end = 0;
  if (reads) {
    begin = __ldg(out_ptr + row);
    end = __ldg(out_ptr + row + 1);
  }
  // the out-slot entries of the coming reading batch
  int32_t next[R];
  auto prefetch = [&](int e0) {
#pragma unroll
    for (int r = 0; r < R; ++r) next[r] = e0 + r < end ? __ldg(out_slots + e0 + r) : 0;
  };

  float acc[CPL][V];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
  bool dst_act = false;

  // Own slots d0 .. d0 + B - 1 (the ones below degree): gs, and the
  // diagonal terms into acc. Called from one place on each path, so that it
  // is inlined and its arrays stay in registers.
  auto own_batch = [&](auto d0) {
    // the row as the compiler must take it: known only here, so that the
    // batch's table loads are not hoisted above the batch before, where
    // they would hold registers across it
    const int r0 = settle(row);
    typename Addr::Raw entry[B];
    bool in_range[B];
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (d0 + b < degree) entry[b] = addr.fetch(r0, d0 + b);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (!with_gradient || d0 + b >= degree) continue;   // no gradient: no flux here
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = j * group + lane;
        if (c < nchunk)
          st.template put<true>(kBatch + b * CPL + j, at(s_tab, r0 * degree + d0 + b, c));
      }
    }
    st.commit();
#pragma unroll
    for (int b = 0; b < B; ++b) {
      in_range[b] = false;
      if (d0 + b >= degree) continue;
      const int64_t s = addr.resolve(entry[b], d0 + b);
      in_range[b] = s >= 0 && s < n_src;
      if (!in_range[b]) continue;               // the row reads NaN
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = j * group + lane;
        if (c < nchunk)
          st.template put<false>(kSrc + b * CPL + j, at(src_state, static_cast<int>(s), c));
      }
    }
    st.commit();

    // the first batch: the reading slots' first entries, and the
    // destination row's sum while the source rows are in flight
    if (d0 == 0) {
      if (reads) prefetch(begin);
      st.wait_older();
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (j * group + lane >= nchunk) continue;
        float o[V];
        widen(st.get(j), o);
#pragma unroll
        for (int i = 0; i < V; ++i) part += o[i];
      }
      dst_act = group_sum(part, group, gmask) != 0.f;
    }
    st.wait_all();

    float sum[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      sum[b] = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        float x[V];
        source_chunk(st.get(kSrc + b * CPL + j), j * group + lane < nchunk, in_range[b], x);
#pragma unroll
        for (int i = 0; i < V; ++i) sum[b] += x[i];
      }
    }
    for (int off = group >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int b = 0; b < B; ++b) sum[b] += __shfl_xor_sync(gmask, sum[b], off, group);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (d0 + b >= degree) continue;
      const bool act = dst_act || sum[b] != 0.f;
      const int slot = row * degree + d0 + b;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = j * group + lane;
        if (c >= nchunk) continue;
        float o[V], gr[V], nb[V], gsv[V];
        widen(kFresh ? st.fresh(j) : st.get(j), o);
        widen(kFresh ? st.fresh(kGrad + j) : st.get(kGrad + j), gr);
        source_chunk(st.get(kSrc + b * CPL + j), true, in_range[b], nb);
        if (with_gradient) {
          float sv[V];
          widen(st.get(kBatch + b * CPL + j), sv);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float diff = __fsub_rn(o[i], nb[i]);
            const float kept = upwind ? (diff < 0.f ? 0.f : diff) : diff;
            gsv[i] = act ? __fmul_rn(kept, gr[i]) : 0.f;
            const bool pass = act && (!upwind || diff > 0.f);
            acc[j][i] = __fadd_rn(acc[j][i], pass ? __fmul_rn(sv[i], gr[i]) : 0.f);
          }
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) gsv[i] = act ? __fmul_rn(nb[i], gr[i]) : 0.f;
        }
        store(at(gs, slot, c), gsv);
      }
    }
  };

  if (owns) {
    if constexpr (Addr::kStaticSlots) {
      static_steps<0, B, kMaxDegree>(degree, own_batch);
    } else {
      for (int d0 = 0; d0 < degree; d0 += B) own_batch(d0);
    }
    if (!same_block) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = j * group + lane;
        if (g_dst != nullptr && c < nchunk) store(at(g_dst, row, c), acc[j]);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
      }
    }
  }
  if (!reads) {
    st.wait_all();
    return;
  }

  // the reading slots, R at a time, in out-slot-table order
  bool own_act = dst_act;                       // a same-block row is its own source
  if (!same_block) {
    st.wait_all();
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (j * group + lane >= nchunk) continue;
      float x[V];
      widen(st.get(kOwn + j), x);
#pragma unroll
      for (int i = 0; i < V; ++i) part += x[i];
    }
    own_act = group_sum(part, group, gmask) != 0.f;
  }
  if (!owns || degree <= 0) prefetch(begin);
  // a wet row makes every reading slot active: outside upwind, the readers'
  // destination rows are then not needed
  const bool need_dst = upwind || !own_act;
  for (int e0 = begin; e0 < end; e0 += R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (e0 + r >= end) continue;
      const int slot = next[r];
      const int n = static_cast<int>(static_cast<unsigned>(slot) / static_cast<unsigned>(degree));
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = j * group + lane;
        if (c >= nchunk) continue;
        if (need_dst) st.template put<false>(kBatch + r * CPL + j, at(dst_state, n, c));
        st.template put<true>(kFlux2 + r * CPL + j, at(s_tab, slot, c));
        st.template put<false>(kGrad2 + r * CPL + j, at(g, n, c));
      }
    }
    st.commit();
    prefetch(e0 + R);
    st.wait_all();

    float sum[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sum[r] = 0.f;
      if (!need_dst || e0 + r >= end) continue;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (j * group + lane >= nchunk) continue;
        float x[V];
        widen(st.get(kBatch + r * CPL + j), x);
#pragma unroll
        for (int i = 0; i < V; ++i) sum[r] += x[i];
      }
    }
    if (need_dst) {
      for (int off = group >> 1; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r) sum[r] += __shfl_xor_sync(gmask, sum[r], off, group);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (e0 + r >= end) continue;
      const bool act = own_act || sum[r] != 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (j * group + lane >= nchunk) continue;
        float sv[V], gv[V];
        widen(st.get(kFlux2 + r * CPL + j), sv);
        widen(st.get(kGrad2 + r * CPL + j), gv);
        if (with_gradient && upwind) {
          float on[V], own[V];
          widen(st.get(kBatch + r * CPL + j), on);
          widen(same_block ? st.get(j) : st.get(kOwn + j), own);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const bool pass = act && __fsub_rn(on[i], own[i]) > 0.f;
            acc[j][i] = __fsub_rn(acc[j][i], pass ? __fmul_rn(sv[i], gv[i]) : 0.f);
          }
        } else if (with_gradient) {
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[j][i] = __fsub_rn(acc[j][i], act ? __fmul_rn(sv[i], gv[i]) : 0.f);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[j][i] = __fadd_rn(acc[j][i], act ? __fmul_rn(sv[i], gv[i]) : 0.f);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = j * group + lane;
    if (c < nchunk) store(at(g_src, row, c), acc[j]);
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

inline dim3 grid_for(int64_t rows, int group, int block = kThreads) {
  const int64_t threads = rows * group;
  return dim3(static_cast<unsigned>((threads + block - 1) / block));
}

// Multiprocessors of the device current at the first call (0 if unknown).
inline int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return n;
  }();
  return count;
}

// Threads a block: 256, halved down to kMinThreads while the grid would
// give fewer than two blocks an SM. At the bench's 8 lanes a row that is
// 256 threads at 23,168 rows, 128 at 5,888 and 64 at 1,536 (192 blocks
// where 256 threads gave 48).
inline int pick_block(int64_t threads) {
  const int64_t want = 2 * static_cast<int64_t>(sm_count());
  int block = kThreads;
  while (block > kMinThreads && (threads + block - 1) / block < want) block >>= 1;
  return block;
}

// What a launch of `kernel` uses: info[0] threads a block, [1] blocks, [2]
// registers a thread, [3] local memory (stack frame and spills) bytes a
// thread, [4] blocks one SM holds at once, [5] lanes a row, [6] dynamic
// shared memory bytes a block. Returns a cudaError_t.
template <typename K>
int kernel_info(K kernel, int block, int64_t rows, int group, size_t smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  int resident = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, block, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int out[7] = {block, static_cast<int>(grid_for(rows, group, block).x), attr.numRegs,
                      static_cast<int>(attr.localSizeBytes), resident, group,
                      static_cast<int>(smem)};
  for (int i = 0; i < 7; ++i) info[i] = out[i];
  return 0;
}

template <typename T, typename Addr>
using FwdKernel = void (*)(const T*, const T*, Addr, const T*, T*, int, int, int, int, int,
                           int, int);

template <typename T, int V, typename Addr>
FwdKernel<T, Addr> fwd_kernel(int cpl) {
  switch (cpl) {
    case 1: return hop_fwd_kernel<T, V, 1, Addr>;
    case 2: return hop_fwd_kernel<T, V, 2, Addr>;
    case 3:
    case 4: return hop_fwd_kernel<T, V, 4, Addr>;
    default: return nullptr;
  }
}

// Dynamic shared memory of a forward block: the staged chunks of its lanes
// (none where the chunks are staged in registers); at most 48 KB.
template <typename T, int V>
size_t fwd_smem(int cpl, int block) {
  if (!kStaged<T, V>) return 0;
  return static_cast<size_t>(fwd_stage_chunks(cpl == 3 ? 4 : cpl)) * block * 16;
}

template <typename T, int V, typename Addr>
int launch_fwd(const void* dst_state, const void* src_state, const Addr& addr,
               const void* s_tab, void* agg, int n_dst, int n_src, int feat, int degree,
               int with_gradient, int upwind, cudaStream_t stream) {
  const Shape sh = shape_for(feat, V);
  const auto kernel = fwd_kernel<T, V, Addr>(sh.cpl);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int block = pick_block(static_cast<int64_t>(n_dst) * sh.group);
  kernel<<<grid_for(n_dst, sh.group, block), block, fwd_smem<T, V>(sh.cpl, block), stream>>>(
      static_cast<const T*>(dst_state), static_cast<const T*>(src_state), addr,
      static_cast<const T*>(s_tab), static_cast<T*>(agg), n_dst, n_src, feat, degree,
      sh.group, with_gradient, upwind);
  return static_cast<int>(cudaGetLastError());
}

// A forward launch over n_rows rows of width feat (see kernel_info).
template <typename T, int V, typename Addr>
int info_fwd(int feat, int n_rows, int* info) {
  const Shape sh = shape_for(feat, V);
  const auto kernel = fwd_kernel<T, V, Addr>(sh.cpl);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int block = pick_block(static_cast<int64_t>(n_rows) * sh.group);
  return kernel_info(kernel, block, n_rows, sh.group, fwd_smem<T, V>(sh.cpl, block), info);
}

template <typename T, typename Addr>
using BwdKernel = void (*)(const T*, const T*, Addr, const T*, const T*, const int32_t*,
                           const int32_t*, T*, T*, T*, int, int, int, int, int, int, int, int);

// Dynamic shared memory of a backward block (none where the chunks are
// staged in registers).
template <typename T, int V, typename Addr>
size_t bwd_smem(int cpl, int block, bool same_block) {
  if (!kStaged<T, V>) return 0;
  return static_cast<size_t>(bwd_stage_chunks<Addr>(cpl == 3 ? 4 : cpl, same_block)) * block *
         16;
}

// Threads a backward block: pick_block's, halved while its shared memory
// would pass kMaxSmem (the band backward at one chunk a lane: 128, where
// 256 would take 56 KB).
template <typename T, int V, typename Addr>
int bwd_block(int64_t threads, int cpl, bool same_block) {
  int block = pick_block(threads);
  while (block > 32 && bwd_smem<T, V, Addr>(cpl, block, same_block) > kMaxSmem) block >>= 1;
  return block;
}

template <typename T, int V, typename Addr>
BwdKernel<T, Addr> bwd_kernel(int cpl) {
  switch (cpl) {
    case 1: return hop_bwd_kernel<T, V, 1, Addr>;
    case 2: return hop_bwd_kernel<T, V, 2, Addr>;
    case 3:
    case 4: return hop_bwd_kernel<T, V, 4, Addr>;
    default: return nullptr;
  }
}

inline int64_t bwd_rows(int n_dst, int n_src, int same_block) {
  return same_block ? n_dst : (n_dst > n_src ? n_dst : n_src);
}

template <typename T, int V, typename Addr>
int launch_bwd(const void* dst_state, const void* src_state, const Addr& addr,
               const void* s_tab, const void* g, const void* out_ptr, const void* out_slots,
               void* gs, void* g_dst, void* g_src, int n_dst, int n_src, int feat,
               int degree, int with_gradient, int upwind, int same_block,
               cudaStream_t stream) {
  const Shape sh = shape_for(feat, V);
  const auto kernel = bwd_kernel<T, V, Addr>(sh.cpl);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = bwd_rows(n_dst, n_src, same_block);
  const int block = bwd_block<T, V, Addr>(rows * sh.group, sh.cpl, same_block);
  kernel<<<grid_for(rows, sh.group, block), block,
           bwd_smem<T, V, Addr>(sh.cpl, block, same_block), stream>>>(
      static_cast<const T*>(dst_state), static_cast<const T*>(src_state), addr,
      static_cast<const T*>(s_tab), static_cast<const T*>(g),
      static_cast<const int32_t*>(out_ptr), static_cast<const int32_t*>(out_slots),
      static_cast<T*>(gs), static_cast<T*>(g_dst), static_cast<T*>(g_src), n_dst, n_src, feat,
      degree, sh.group, with_gradient, upwind, same_block);
  return static_cast<int>(cudaGetLastError());
}

// A backward launch (see kernel_info).
template <typename T, int V, typename Addr>
int info_bwd(int feat, int n_dst, int n_src, int same_block, int* info) {
  const Shape sh = shape_for(feat, V);
  const auto kernel = bwd_kernel<T, V, Addr>(sh.cpl);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = bwd_rows(n_dst, n_src, same_block);
  const int block = bwd_block<T, V, Addr>(rows * sh.group, sh.cpl, same_block);
  return kernel_info(kernel, block, rows, sh.group,
                     bwd_smem<T, V, Addr>(sh.cpl, block, same_block), info);
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
int fwd_info_any(int dtype, int vectorized, int feat, int n_rows, int* info) {
  if (dtype == 0)
    return vectorized ? info_fwd<float, 4, Addr>(feat, n_rows, info)
                      : info_fwd<float, 1, Addr>(feat, n_rows, info);
  if (dtype == 1)
    return vectorized ? info_fwd<__nv_bfloat16, 8, Addr>(feat, n_rows, info)
                      : info_fwd<__nv_bfloat16, 1, Addr>(feat, n_rows, info);
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

template <typename Addr>
int bwd_info_any(int dtype, int vectorized, int feat, int n_dst, int n_src, int same_block,
                 int* info) {
  if (dtype == 0)
    return vectorized ? info_bwd<float, 4, Addr>(feat, n_dst, n_src, same_block, info)
                      : info_bwd<float, 1, Addr>(feat, n_dst, n_src, same_block, info);
  if (dtype == 1)
    return vectorized
        ? info_bwd<__nv_bfloat16, 8, Addr>(feat, n_dst, n_src, same_block, info)
        : info_bwd<__nv_bfloat16, 1, Addr>(feat, n_dst, n_src, same_block, info);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace mswe
