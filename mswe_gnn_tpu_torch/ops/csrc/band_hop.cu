// Banded SWE-GNN hop and its backward, hand-written for Hopper (sm_90a).
// The device code is in hop_common.cuh; this file gives it band-plan
// addressing (mswe_gnn_tpu/ops/band_hop.py::BandPlan): slot d of row n reads
// win[n / 128, d] + idx_rel[n, d] when idx_rel[n, d] < ws[d], else the ghost
// tail row N - we + (idx_rel[n, d] - ws[d]). The kernel decodes the plan
// itself, per slot, from the plan's own tables.
//
// Replaces the TPU kernels mswe_gnn_tpu/ops/band_hop.py::_hop_kernel
// (forward; wrappers _band_hop_impl and band_hop) and ::_bwd_kernel
// (backward; wrapper _band_hop_bwd_impl, custom VJP band_hop). On the TPU the
// plan exists so that a one-hot matrix product on the MXU can stand in for
// the row gather the TPU lacks, and the backward's transposed one-hot
// product lands in a VMEM accumulator carried across a sequential grid.
// Neither carries over: Hopper gathers rows directly, and its blocks run in
// no order, so the backward's scatter is a gather over the out-slot table
// (the slots that read each row), as in hop.cu. Only the addressing is
// kept.
//
// The least time on an H100 is set by bytes, as for hop.cu. At the finest
// bench scale in bf16 (N = 23168, D = 4, F = 64) the forward moves about
// 18 MB (5.4 us at 3.35 TB/s) and the backward about 33 MB (10 us); the
// plan's tables (idx_rel 0.37 MB, win 3 KB) replace the ELL source table
// byte for byte. The forward's time is set as in hop.cu, and the decode
// used to add to its chain: the window start was loaded only after idx_rel
// had arrived, and the slot widths, indexed by a runtime slot, were read
// from a copy of the parameters in local memory. The forward
// (hop_common.cuh) loads idx_rel and win together and walks the slots with
// compile-time numbers, so that ws[d] is a parameter at a constant offset
// (no stack frame); the rest is the ELL forward's design. The backward is
// the ELL backward's design under the same addressing, its own slots walked
// with compile-time numbers too; its register budget and reading batch are
// its own (hop_common.cuh, BwdTuning).

#include "hop_common.cuh"

namespace {

// ws: the plan's D slot widths, copied into the kernel's parameters.
int band_addr(const void* idx_rel, const void* win, const int* ws, int we, int n,
              int degree, mswe::BandAddr* addr) {
  if (degree <= 0 || degree > mswe::kMaxDegree) return static_cast<int>(cudaErrorInvalidValue);
  addr->idx_rel = static_cast<const int32_t*>(idx_rel);
  addr->win = static_cast<const int32_t*>(win);
  addr->degree = degree;
  addr->n_rows = n;
  addr->we = we;
  for (int d = 0; d < mswe::kMaxDegree; ++d) addr->ws[d] = d < degree ? ws[d] : 0;
  return 0;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int mswe_band_hop_launch(const void* state, const void* idx_rel, const void* win,
                                    const int* ws, int we, const void* s_tab, void* agg,
                                    int n, int feat, int degree, int dtype, int vectorized,
                                    int with_gradient, int upwind, void* stream) {
  mswe::BandAddr addr;
  const int rc = band_addr(idx_rel, win, ws, we, n, degree, &addr);
  if (rc != 0) return rc;
  return mswe::fwd_any(dtype, vectorized, state, state, addr, s_tab, agg, n, n, feat, degree,
                       with_gradient, upwind, static_cast<cudaStream_t>(stream));
}

// The forward's launch over n rows (info[7]: see mswe::kernel_info).
extern "C" int mswe_band_hop_fwd_info(int dtype, int vectorized, int feat, int n, int* info) {
  return mswe::fwd_info_any<mswe::BandAddr>(dtype, vectorized, feat, n, info);
}

// gstate: the state gradient (diagonal terms plus the gathered scatter).
extern "C" int mswe_band_hop_bwd_launch(const void* state, const void* idx_rel,
                                        const void* win, const int* ws, int we,
                                        const void* s_tab, const void* g, const void* out_ptr,
                                        const void* out_slots, void* gs, void* gstate, int n,
                                        int feat, int degree, int dtype, int vectorized,
                                        int with_gradient, int upwind, void* stream) {
  mswe::BandAddr addr;
  const int rc = band_addr(idx_rel, win, ws, we, n, degree, &addr);
  if (rc != 0) return rc;
  return mswe::bwd_any(dtype, vectorized, state, state, addr, s_tab, g, out_ptr, out_slots,
                       gs, nullptr, gstate, n, n, feat, degree, with_gradient, upwind,
                       /*same_block=*/1, static_cast<cudaStream_t>(stream));
}

// The backward's launch over n rows (info[7]: see mswe::kernel_info).
extern "C" int mswe_band_hop_bwd_info(int dtype, int vectorized, int feat, int n, int* info) {
  return mswe::bwd_info_any<mswe::BandAddr>(dtype, vectorized, feat, n, n, 1, info);
}
