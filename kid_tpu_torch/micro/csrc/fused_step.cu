// Thompson09 microphysics, phases 2-20 of one time step, as one CUDA kernel
// for Hopper (sm_90a).
//
// Replaces kid_tpu/micro/pallas_step.py::fused_step (the Pallas TPU kernel
// whose body is kid_tpu/micro/solver.py::core_from_tables).  Its plain
// PyTorch version is kid_tpu_torch/micro/solver.py::core_from_tables
// (fused_step.fused_step_ref); the stages of thompson.cuh transcribe that
// code expression by expression, in the same association order, so the two
// differ only by the card's rounding of exp/log/pow.
//
// Boundary (as the TPU design): the prologue is re-derived in-kernel from
// the raw state, so only 14 + ntv channels go in (12 state + pres + dzq +
// 18 table-stage channels for mixed phase, 1 warm) and 12 (+36 rate
// profiles) channels plus 4 per-column precip values come out.
//
// Mapping: one thread block per column, one thread per level (nz rounded
// up to whole warps); the stages and the warp-level vertical helpers are
// those of thompson.cuh (one barrier per exchange, 18 per mixed-phase
// column plus one per sedimentation substep), shared with the two kernels
// of the aerosol split (fused_rates.cu, fused_post.cu).  The kernel is
// instantiated for blocks of up to 128 threads (nz <= 128) and of up to
// 256 (nz <= MAX_NZ), with __launch_bounds__(BLOCK, min_blocks(MIN_BLOCKS,
// BLOCK)): the register budget that fits MIN_BLOCKS blocks of 128 threads
// on an SM.  Nothing is staged in shared memory beyond the exchange slots.
//
// Bound at (ncol, nz) = (8192, 120) f32 without rates: 32 input + 12 output
// channels of 3.93 MB (+ precip) is ~173 MB, i.e. >= ~52 us at 3.35 TB/s;
// with the 36 rate channels ~80 channels, ~315 MB, >= ~94 us.  The
// arithmetic is some 2.4 k elementwise operations per cell (chip_smoke.py
// counts 2.41 G for the plain version at this shape; this file has some
// 90 call sites of exp, log, pow, sqrt and the chains built on them),
// >= ~36 us at the 67 TFLOP/s f32 rate, so bytes bound it.  It runs ~10x
// above: without fast math (-fmad=false keeps the plain version's
// rounding) every cell is a long chain of IEEE exp/log/pow/div, and the
// register file holds few warps to hide its latency.  On an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md, kernel_budget.py and chip_smoke.py): the
// compiler alone takes 128 registers in f32 mixed, 4 blocks/SM,
// 0.62 ms/launch; 5 blocks (96 registers, 48 spill bytes) gives
// 0.54 ms, while 6 and 8 (80 and 64 registers) spill 104 and 176 bytes
// and are slower.  f64 mixed is fastest at 3 blocks (168 registers).
// The warp-level helpers alone left the time unchanged.

#include "thompson.cuh"

namespace {

template <typename T, bool WARM, bool RATES, int BLOCK>
__global__ void __launch_bounds__(BLOCK,
                                  min_blocks(kMinBlocks<T, WARM>, BLOCK))
    fused_step_kernel(const T* __restrict__ x, T* __restrict__ y,
                      T* __restrict__ ppt, int ncol, int nz, int l_sediment,
                      double nt_c, double dt, double ifdry) {
  __shared__ Shared<T> sh;
  Vert<T> vx{sh, 0};
  const int col = blockIdx.x;
  const bool valid = (int)threadIdx.x < nz;
  const int kl = valid ? threadIdx.x : nz - 1;  // padding mirrors the top
  const size_t plane = (size_t)ncol * nz;
  const size_t off = (size_t)col * nz + kl;
  const Params<T> P = make_params<T>(dt, nt_c, ifdry, l_sediment, 0, 0);

  // input channels: ColumnState, pres, dzq, tv_keys(cfg)
  const Cell<T> s = load_cell(x, plane, off);
  const T dzq = x[(I_pres + 1) * plane + off];
  Pro<T> p;
  prologue<T, WARM, false>(s, P, valid, vx, p);
  Late<T> l;
  set_late(l, s, p, dzq);
  P8<T> q;
  T* d = RATES ? y + N_STATE * plane + off : nullptr;
  rates<T, WARM, RATES, false>(p, x + (I_pres + 2) * plane + off, plane, P,
                               valid, q, d);
  if (RATES && valid) d[D_prr_gml * plane] = q.prr_gml;
  Out<T> o;
  post<T, WARM, false>(l, p, q, (T)0, (T)0, P, valid, nz, vx, o);
  store_out(o, y, ppt, plane, off, ncol, col, valid);
  if (RATES && valid) {
    d[D_prv_rev * plane] = o.prv_rev;
    d[D_pnr_rev * plane] = o.pnr_rev;
  }
}

// f(the instantiation that a launch of these arguments takes): blocks of
// up to 128 threads for nz <= 128, of up to 256 above
template <typename T, int BLOCK, typename F>
int with_block(int iiwarm, int want_rates, F f) {
  if (iiwarm)
    return want_rates ? f(fused_step_kernel<T, true, true, BLOCK>)
                      : f(fused_step_kernel<T, true, false, BLOCK>);
  return want_rates ? f(fused_step_kernel<T, false, true, BLOCK>)
                    : f(fused_step_kernel<T, false, false, BLOCK>);
}
template <typename T, typename F>
int with_kernel(int nz, int iiwarm, int want_rates, F f) {
  return nz <= 128 ? with_block<T, 128>(iiwarm, want_rates, f)
                   : with_block<T, kMaxThreads>(iiwarm, want_rates, f);
}

template <typename T>
int launch(const T* x, T* y, T* ppt, int ncol, int nz, int iiwarm,
           int want_rates, int l_sediment, double nt_c, double dt,
           double ifdry, void* stream) {
  return with_kernel<T>(nz, iiwarm, want_rates, [&](auto kernel) {
    return launch_columns(kernel, ncol, nz, stream, x, y, ppt, ncol, nz,
                          l_sediment, nt_c, dt, ifdry);
  });
}

}  // namespace

// the resources of the instantiation launched for (nz, dtype, iiwarm,
// want_rates): see kernel_resources in thompson.cuh
extern "C" int kid_fused_step_resources(int nz, int f64, int iiwarm,
                                        int want_rates, int* row) {
  auto f = [&](auto kernel) { return kernel_resources(kernel, nz, row); };
  return f64 ? with_kernel<double>(nz, iiwarm, want_rates, f)
             : with_kernel<float>(nz, iiwarm, want_rates, f);
}

// C interface, loaded with ctypes by kid_tpu_torch/micro/fused_step.py.
// x: (14 + ntv, ncol, nz), y: (12 [+36], ncol, nz), ppt: (4, ncol), all
// contiguous on the card.  Returns the cudaError_t of the launch.
extern "C" int kid_fused_step_f32(const float* x, float* y, float* ppt,
                                  int ncol, int nz, int iiwarm,
                                  int want_rates, int l_sediment,
                                  double nt_c, double dt, double ifdry,
                                  void* stream) {
  return launch<float>(x, y, ppt, ncol, nz, iiwarm, want_rates, l_sediment,
                       nt_c, dt, ifdry, stream);
}

extern "C" int kid_fused_step_f64(const double* x, double* y, double* ppt,
                                  int ncol, int nz, int iiwarm,
                                  int want_rates, int l_sediment,
                                  double nt_c, double dt, double ifdry,
                                  void* stream) {
  return launch<double>(x, y, ppt, ncol, nz, iiwarm, want_rates, l_sediment,
                        nt_c, dt, ifdry, stream);
}
