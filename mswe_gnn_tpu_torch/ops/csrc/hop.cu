// ELL hop of the SWE-GNN layer and its backward, hand-written for Hopper
// (sm_90a). The device code is in hop_common.cuh (what is computed, in what
// order, and how a row is laid out over the lanes); this file gives it ELL
// addressing: slot d of destination row n reads source row src_tab[n, d].
//
// Forward: replaces the TPU kernel mswe_gnn_tpu/ops/pallas_hop.py::_hop_kernel
// (wrapper fused_hop), and with it the XLA slot loop that the JAX package
// runs on the TPU instead (mswe_gnn_tpu/models/swegnn.py:420-471).
//
// Backward: a kernel of the port with no TPU counterpart. The JAX package
// gets this gradient from XLA autodiff of the slot loop; the port needs it
// for the hops the band plan does not take (the coarsest scale and the
// un-pool hops, which read a separate source block).
//
// The least time on an H100 is set by bytes. At the finest bench scale in
// bf16 (Nd = 23168, D = 4, F = 64) the forward reads 11.9 MB of flux, 3.0 MB
// of state and 0.37 MB of indices and writes 3.0 MB: about 18 MB, 5.4 us at
// 3.35 TB/s, against some 0.03 GFLOP of float32 arithmetic. What its time is
// set by is the chain of dependent loads of a row at the coarse scales (the
// whole grid resident at once) and, at the finest, how many rows an SM keeps
// in flight. The forward (hop_common.cuh) loads a row's slots together,
// which cuts the chain from about nine round trips to two, stages those
// loads in shared memory so that they do not cost the registers that set
// the warps an SM keeps, and picks smaller blocks at the coarse scales so
// that their rows spread over all 132 SMs.
//
// The backward reads state, flux, the upstream gradient and the two index
// tables and writes the flux gradient and the state gradient: about 33 MB,
// 10 us. Its design reads the flux twice (once by the row that owns the
// slot, once by the row the slot reads) and the state and gradient rows of
// the reading slots once more, mostly from the 50 MB L2; that is the price
// of a gather without atomics, and what keeps the result deterministic.
// Walking its slots and then its reading slots one at a time made a chain
// of about twenty dependent round trips a row; it now loads them in
// batches, as the forward does (hop_common.cuh), which cuts the chain to
// three, and it picks its block size from the row count too.

#include "hop_common.cuh"

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int mswe_hop_launch(const void* dst_state, const void* src_state,
                               const void* src_tab, const void* s_tab, void* agg,
                               int n_dst, int n_src, int feat, int degree,
                               int dtype, int vectorized, int with_gradient,
                               int upwind, void* stream) {
  const mswe::EllAddr addr{static_cast<const int32_t*>(src_tab), degree};
  return mswe::fwd_any(dtype, vectorized, dst_state, src_state, addr, s_tab, agg, n_dst,
                       n_src, feat, degree, with_gradient, upwind,
                       static_cast<cudaStream_t>(stream));
}

// The forward's launch over n_rows rows (info[7]: see mswe::kernel_info).
extern "C" int mswe_hop_fwd_info(int dtype, int vectorized, int feat, int n_rows, int* info) {
  return mswe::fwd_info_any<mswe::EllAddr>(dtype, vectorized, feat, n_rows, info);
}

// g_dst may be null (no gradient mode, or a same-block hop, whose state
// gradient is g_src).
extern "C" int mswe_hop_bwd_launch(const void* dst_state, const void* src_state,
                                   const void* src_tab, const void* s_tab, const void* g,
                                   const void* out_ptr, const void* out_slots, void* gs,
                                   void* g_dst, void* g_src, int n_dst, int n_src, int feat,
                                   int degree, int dtype, int vectorized, int with_gradient,
                                   int upwind, int same_block, void* stream) {
  const mswe::EllAddr addr{static_cast<const int32_t*>(src_tab), degree};
  return mswe::bwd_any(dtype, vectorized, dst_state, src_state, addr, s_tab, g, out_ptr,
                       out_slots, gs, g_dst, g_src, n_dst, n_src, feat, degree,
                       with_gradient, upwind, same_block, static_cast<cudaStream_t>(stream));
}

// The backward's launch (info[7]: see mswe::kernel_info).
extern "C" int mswe_hop_bwd_info(int dtype, int vectorized, int feat, int n_dst, int n_src,
                                 int same_block, int* info) {
  return mswe::bwd_info_any<mswe::EllAddr>(dtype, vectorized, feat, n_dst, n_src, same_block,
                                           info);
}
