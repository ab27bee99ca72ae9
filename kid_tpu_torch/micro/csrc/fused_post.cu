// Phases 12-20 of the aerosol-aware microphysics step (the second kernel
// of the aerosol split) as one CUDA kernel for Hopper (sm_90a).
//
// Replaces kid_tpu/micro/pallas_step.py::fused_post (the Pallas TPU kernel
// whose body is kid_tpu/micro/solver.py::post_from_p8).  Its plain PyTorch
// version is kid_tpu_torch/micro/solver.py::post_from_p8
// (split_step.fused_post_ref); the stages of thompson.cuh transcribe it.
//
// Boundary: 31 channels go in (12 state + pres + dzq + the 15 p8
// tendencies of fused_rates.cu + xnc_act and wev, the phase-14 lookups of
// lookup_stage.cu) and 12 state channels (+ prr_gml, prv_rev,
// pnr_rev) plus 4 per-column precip values come out.  The prologue is
// re-derived from the raw state for the phase-2 zeroed state and the
// stale snow moments only; the compiler drops the rest of it.
//
// Mapping: one thread block per column, one thread per level, as
// fused_step.cu: the post stage needs the sedimentation sweeps, the
// fill-downs and the block reductions.
//
// Bound at (ncol, nz) = (8192, 120) f32 without rates: 31 input + 12
// output channels of 3.93 MB (+ precip) is ~169 MB, >= ~50 us at
// 3.35 TB/s; bytes bound it.  No fast math (-fmad=false).
//
// What the design does about the instruction stream, which sets the time:
// guards around the rain-evaporation chain and the four fall-speed chains
// (fill_down never reads an unflagged level), so a warp with no lane in
// their masks skips them; powc planned at compile time (POWC: f32 mixed
// SASS 13638 -> 5807 instructions, 350 -> 107 MUFU); a register budget of
// POST_MIN_BLOCKS_* (f32 mixed 8 blocks of 128 threads per SM, 64
// registers).  The results are bit for bit those before.  On an NVIDIA
// H100 80GB HBM3 at 700 W, aerosol1d's own inputs at (8192, 120) f32:
// 0.244 -> 0.177 ms (PERF.md).

#define KID_FOLD_POWC  // POWC plans powc at compile time (thompson.cuh)
#include "thompson.cuh"

namespace {

template <typename T, bool WARM, bool RATES, int BLOCK>
__global__ void __launch_bounds__(BLOCK,
                                  min_blocks(kPostMinBlocks<T, WARM>, BLOCK))
    fused_post_kernel(const T* __restrict__ x, T* __restrict__ y,
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

  // input channels: ColumnState, pres, dzq, P8_OUT, xnc_act, wev
  const Cell<T> s = load_cell(x, plane, off);
  const T dzq = x[(I_pres + 1) * plane + off];
  const T* pin = x + (I_pres + 2) * plane + off;
  P8<T> q;
  q.tten = pin[P_tten * plane]; q.qvten = pin[P_qvten * plane];
  q.qcten = pin[P_qcten * plane]; q.ncten = pin[P_ncten * plane];
  q.qiten = pin[P_qiten * plane]; q.niten = pin[P_niten * plane];
  q.qrten = pin[P_qrten * plane]; q.nrten = pin[P_nrten * plane];
  q.qsten = pin[P_qsten * plane]; q.qgten = pin[P_qgten * plane];
  q.nwfaten = pin[P_nwfaten * plane]; q.nifaten = pin[P_nifaten * plane];
  q.vts_boost = pin[P_vts_boost * plane]; q.mvd_r = pin[P_mvd_r * plane];
  q.prr_gml = pin[P_prr_gml * plane];
  const T xnc_act = pin[N_P8 * plane];
  const T wev = pin[(N_P8 + 1) * plane];

  Pro<T> p;
  prologue_cell<T, WARM, true>(s, P, p);
  Late<T> l;
  set_late(l, s, p, dzq);
  Out<T> o;
  post<T, WARM, true>(l, p, q, xnc_act, wev, P, valid, nz, vx, o);
  store_out(o, y, ppt, plane, off, ncol, col, valid);
  if (RATES && valid) {
    T* d = y + N_STATE * plane + off;
    d[0 * plane] = q.prr_gml;
    d[1 * plane] = o.prv_rev;
    d[2 * plane] = o.pnr_rev;
  }
}

// f(the instantiation that a launch of these arguments takes): blocks of
// up to 128 threads for nz <= 128, of up to 256 above
template <typename T, int BLOCK, typename F>
int with_block(int iiwarm, int want_rates, F f) {
  if (iiwarm)
    return want_rates ? f(fused_post_kernel<T, true, true, BLOCK>)
                      : f(fused_post_kernel<T, true, false, BLOCK>);
  return want_rates ? f(fused_post_kernel<T, false, true, BLOCK>)
                    : f(fused_post_kernel<T, false, false, BLOCK>);
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
extern "C" int kid_fused_post_resources(int nz, int f64, int iiwarm,
                                        int want_rates, int* row) {
  auto f = [&](auto kernel) { return kernel_resources(kernel, nz, row); };
  return f64 ? with_kernel<double>(nz, iiwarm, want_rates, f)
             : with_kernel<float>(nz, iiwarm, want_rates, f);
}

// C interface, loaded with ctypes by kid_tpu_torch/micro/split_step.py.
// x: (31, ncol, nz), y: (12 [+3], ncol, nz), ppt: (4, ncol), all
// contiguous on the card.  Returns the cudaError_t of the launch.
extern "C" int kid_fused_post_f32(const float* x, float* y, float* ppt,
                                  int ncol, int nz, int iiwarm,
                                  int want_rates, int l_sediment,
                                  double nt_c, double dt, double ifdry,
                                  void* stream) {
  return launch<float>(x, y, ppt, ncol, nz, iiwarm, want_rates, l_sediment,
                       nt_c, dt, ifdry, stream);
}

extern "C" int kid_fused_post_f64(const double* x, double* y, double* ppt,
                                  int ncol, int nz, int iiwarm,
                                  int want_rates, int l_sediment,
                                  double nt_c, double dt, double ifdry,
                                  void* stream) {
  return launch<double>(x, y, ppt, ncol, nz, iiwarm, want_rates, l_sediment,
                        nt_c, dt, ifdry, stream);
}
