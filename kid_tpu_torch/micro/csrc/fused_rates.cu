// Phases 2-11 of the aerosol-aware microphysics step (the first kernel of
// the aerosol split) as one CUDA kernel for Hopper (sm_90a).
//
// Replaces kid_tpu/micro/pallas_step.py::fused_rates (the Pallas TPU kernel
// whose body is kid_tpu/micro/solver.py::rates_from_tables).  Its plain
// PyTorch version is kid_tpu_torch/micro/solver.py::rates_from_tables
// (split_step.fused_rates_ref); the stages of thompson.cuh transcribe it.
//
// Boundary: the prologue is re-derived from the raw state, so 13 + ntv
// channels go in (12 state + pres + 18 table-stage channels for mixed
// phase, 1 warm) and the 15 p8 tendency channels (+33 rate profiles) come
// out; torch's aerosol lookup stage and fused_post.cu read them.
//
// Mapping: one thread block per column, one thread per level.  The only
// vertical coupling is the prologue's graupel-N0 suffix minimum.
//
// Bound at (ncol, nz) = (8192, 120) f32 without rates: 31 input + 15 output
// channels of 3.93 MB is ~181 MB, >= ~54 us at 3.35 TB/s; the arithmetic
// (chip_smoke.py counts the plain version's operations) is below that at
// the 67 TFLOP/s f32 rate, so bytes bound it.  No fast math (-fmad=false
// keeps the rounding of the plain version).
//
// What the design does about the instruction stream, which sets the time
// (the TPU body computes every chain at every cell, then selects):
//   * guards: a warp whose 32 levels hold no lane of a mask branches
//     around the chain the mask discards: the six eff_aero, DeMott, Koop
//     and the droplet clamp (on aerosol1d they run in 3/4 of the warps or
//     fewer, Koop and the graupel pair in none);
//   * POWC: powc's branches on its constant exponent are taken at compile
//     time (KID_FOLD_POWC), which took the f32 mixed SASS from 19460 to
//     6535 instructions and 593 to 194 MUFU;
//   * eff_aero's slip correction is a constant of the generated header;
//   * a register budget of RATES_MIN_BLOCKS_* (f32 mixed 5 blocks of 128
//     threads per SM, 96 registers).
// The results are bit for bit those before.  On an NVIDIA H100 80GB HBM3
// at 700 W, aerosol1d's own inputs at (8192, 120) f32: 0.467 -> 0.238 ms
// (PERF.md).

#define KID_FOLD_POWC  // POWC plans powc at compile time (thompson.cuh)
#include "thompson.cuh"

namespace {

template <typename T, bool WARM, bool RATES, int BLOCK>
__global__ void __launch_bounds__(BLOCK,
                                  min_blocks(kRatesMinBlocks<T, WARM>, BLOCK))
    fused_rates_kernel(const T* __restrict__ x, T* __restrict__ y, int ncol,
                       int nz, double nt_c, double dt, double ifdry,
                       int dusty, int homog) {
  __shared__ Shared<T> sh;
  Vert<T> vx{sh, 0};
  const int col = blockIdx.x;
  const bool valid = (int)threadIdx.x < nz;
  const int kl = valid ? threadIdx.x : nz - 1;  // padding mirrors the top
  const size_t plane = (size_t)ncol * nz;
  const size_t off = (size_t)col * nz + kl;
  const Params<T> P = make_params<T>(dt, nt_c, ifdry, 1, dusty, homog);

  // input channels: ColumnState, pres, tv_keys(cfg)
  const Cell<T> s = load_cell(x, plane, off);
  Pro<T> p;
  prologue<T, WARM, true>(s, P, valid, vx, p);
  P8<T> q;
  T* d = RATES ? y + N_P8 * plane + off : nullptr;
  rates<T, WARM, RATES, true>(p, x + (I_pres + 1) * plane + off, plane, P,
                              valid, q, d);
  if (valid) {
    T* o = y + off;
    o[P_tten * plane] = q.tten; o[P_qvten * plane] = q.qvten;
    o[P_qcten * plane] = q.qcten; o[P_ncten * plane] = q.ncten;
    o[P_qiten * plane] = q.qiten; o[P_niten * plane] = q.niten;
    o[P_qrten * plane] = q.qrten; o[P_nrten * plane] = q.nrten;
    o[P_qsten * plane] = q.qsten; o[P_qgten * plane] = q.qgten;
    o[P_nwfaten * plane] = q.nwfaten; o[P_nifaten * plane] = q.nifaten;
    o[P_vts_boost * plane] = q.vts_boost; o[P_mvd_r * plane] = q.mvd_r;
    o[P_prr_gml * plane] = q.prr_gml;
  }
}

// f(the instantiation that a launch of these arguments takes): blocks of
// up to 128 threads for nz <= 128, of up to 256 above
template <typename T, int BLOCK, typename F>
int with_block(int iiwarm, int want_rates, F f) {
  if (iiwarm)
    return want_rates ? f(fused_rates_kernel<T, true, true, BLOCK>)
                      : f(fused_rates_kernel<T, true, false, BLOCK>);
  return want_rates ? f(fused_rates_kernel<T, false, true, BLOCK>)
                    : f(fused_rates_kernel<T, false, false, BLOCK>);
}
template <typename T, typename F>
int with_kernel(int nz, int iiwarm, int want_rates, F f) {
  return nz <= 128 ? with_block<T, 128>(iiwarm, want_rates, f)
                   : with_block<T, kMaxThreads>(iiwarm, want_rates, f);
}

template <typename T>
int launch(const T* x, T* y, int ncol, int nz, int iiwarm, int want_rates,
           double nt_c, double dt, double ifdry, int dusty, int homog,
           void* stream) {
  return with_kernel<T>(nz, iiwarm, want_rates, [&](auto kernel) {
    return launch_columns(kernel, ncol, nz, stream, x, y, ncol, nz, nt_c, dt,
                          ifdry, dusty, homog);
  });
}

}  // namespace

// the resources of the instantiation launched for (nz, dtype, iiwarm,
// want_rates): see kernel_resources in thompson.cuh
extern "C" int kid_fused_rates_resources(int nz, int f64, int iiwarm,
                                         int want_rates, int* row) {
  auto f = [&](auto kernel) { return kernel_resources(kernel, nz, row); };
  return f64 ? with_kernel<double>(nz, iiwarm, want_rates, f)
             : with_kernel<float>(nz, iiwarm, want_rates, f);
}

// C interface, loaded with ctypes by kid_tpu_torch/micro/split_step.py.
// x: (13 + ntv, ncol, nz), y: (15 [+33], ncol, nz), both contiguous on the
// card.  Returns the cudaError_t of the launch.
extern "C" int kid_fused_rates_f32(const float* x, float* y, int ncol, int nz,
                                   int iiwarm, int want_rates, double nt_c,
                                   double dt, double ifdry, int dusty,
                                   int homog, void* stream) {
  return launch<float>(x, y, ncol, nz, iiwarm, want_rates, nt_c, dt, ifdry,
                       dusty, homog, stream);
}

extern "C" int kid_fused_rates_f64(const double* x, double* y, int ncol,
                                   int nz, int iiwarm, int want_rates,
                                   double nt_c, double dt, double ifdry,
                                   int dusty, int homog, void* stream) {
  return launch<double>(x, y, ncol, nz, iiwarm, want_rates, nt_c, dt, ifdry,
                        dusty, homog, stream);
}
