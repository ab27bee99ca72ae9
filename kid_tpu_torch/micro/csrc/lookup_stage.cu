// The phase-14 lookups of the aerosol-aware step as one CUDA kernel for
// Hopper (sm_90a): ``aerosol_lookup_stage`` of
// kid_tpu_torch/micro/solver.py, the hand-off between fused_rates.cu and
// fused_post.cu.
//
// Replaces no TPU kernel: the reference computes this stage
// (kid_tpu/micro/solver.py::aerosol_lookup_stage) as XLA between its two
// Pallas calls, which ``jax.jit`` fuses.  The port's plain version
// (split_step.lookup_stage_ref) runs it as some 230 torch kernels a step;
// this file is the port's counterpart of that fusion.
//
// What it computes, per cell, in the association order of the torch code
// (as thompson.cuh transcribes it):
//   * the provisional (phase-12) thermodynamics from the raw state and
//     fused_rates' tendencies: the raw qc and nc, not the prologue's zeroed
//     ones, as the reference reads them (ROADMAP.md, Queue 3);
//   * xnc_act = max(activ_ncloud(temp, w, nwfa), 2): the na and w bins as
//     torch.searchsorted(right=True) finds them, in double, the
//     temperature bin by rint, and the bilinear log-interpolation between
//     the four corners of its row of tnccn_corners;
//   * wev = tnc_wev[idx_d, idx_ce, idx_n] at every cell: the evaporation
//     diameter Dc_star's bin, rc's decade (thompson.cuh's decade_index)
//     and the drop number's bin.  The table (NBC x NTB_C x NBC, 1.5 MB in
//     float32) stays in L2; the reference's band of levels around the cells
//     that consume it has no counterpart here.
// The outputs go straight into rows of the caller's buffer: in the step,
// the last two rows of fused_post.cu's packed input.
//
// Mapping: one thread a cell over the flattened (column, level) index,
// blocks of 256 threads, no shared memory, the register budget
// LOOKUP_MIN_BLOCKS_* of thompson.cuh.  Each of the 12 input channels is
// read in place through a pointer and two element strides (columns,
// levels): the state rows of fused_rates.cu's packed input, pres, w and the
// tendency rows of fused_rates.cu's output, so a broadcast row costs no
// copy and a warp's loads of a contiguous row are coalesced.
//
// Bound: bytes.  At (65536, 120) f32 it reads 12 rows and writes 2: 14 x
// 31.5 MB = 440 MB, at least 0.131 ms at 3.35 TB/s, plus the table's
// sectors from L2.  No fast math (-fmad=false).

#define KID_FOLD_POWC  // POWC plans powc at compile time (thompson.cuh)
#include "thompson.cuh"

namespace {

// the input channels, in the order of split_step.LOOKUP_CHANNELS
enum LookupCh {
  L_t, L_qv, L_qc, L_nc, L_nwfa, L_pres, L_w, L_tten, L_qvten, L_qcten,
  L_ncten, L_nwfaten, kNIn
};

// where the kernel reads its input channels: a pointer and the element
// strides between columns and between levels of each
template <typename T> struct Inputs {
  const T* p[kNIn];
  long long sc[kNIn], sk[kNIn];
};

constexpr int kBlock = 256;
constexpr int kNbc = (int)NBC, kNtbC = (int)NTB_C;
// the activation table's axes (constants.TA_NA, TA_WW, TA_TK) and the logs
// of the first two, as aerosol.activ_ncloud holds them
constexpr int kNa = 7, kNw = 9, kNt = 7;
__device__ const double kTaNa[kNa] = {TA_NA_0, TA_NA_1, TA_NA_2, TA_NA_3,
                                      TA_NA_4, TA_NA_5, TA_NA_6};
__device__ const double kTaWw[kNw] = {TA_WW_0, TA_WW_1, TA_WW_2,
                                      TA_WW_3, TA_WW_4, TA_WW_5,
                                      TA_WW_6, TA_WW_7, TA_WW_8};
__device__ const double kLogNa[kNa] = {LOG_TA_NA_0, LOG_TA_NA_1, LOG_TA_NA_2,
                                       LOG_TA_NA_3, LOG_TA_NA_4, LOG_TA_NA_5,
                                       LOG_TA_NA_6};
__device__ const double kLogWw[kNw] = {LOG_TA_WW_0, LOG_TA_WW_1, LOG_TA_WW_2,
                                       LOG_TA_WW_3, LOG_TA_WW_4, LOG_TA_WW_5,
                                       LOG_TA_WW_6, LOG_TA_WW_7, LOG_TA_WW_8};

// torch.searchsorted(axis, v, right=True) clipped to [1, N - 1]: the
// number of axis values not above v (all of them for a NaN)
template <int N>
__device__ __forceinline__ int upper_bin(const double* axis, double v) {
  int i = 0;
#pragma unroll
  for (int q = 0; q < N; ++q) i += !(axis[q] > v);
  return i < 1 ? 1 : (i > N - 1 ? N - 1 : i);
}

// aerosol.activ_ncloud: CCN activation by bilinear log-interpolation into
// the (l=2, m=1) plane of the activation table, whose four corners of each
// bin are a row of ``corners`` (solver._tnccn_corners)
template <typename T>
__device__ __forceinline__ T activ_ncloud(T tt, T ww, T nccn,
                                          const T* __restrict__ corners) {
  const T n_local = clampT(nccn * (T)1.0e-6, (T)(TA_NA_0 + 1.0),
                           (T)(TA_NA_6 - 1.0));
  const T w_local = clampT(ww, (T)(TA_WW_0 + 0.001), (T)(TA_WW_8 - 1.0));
  const int i = upper_bin<kNa>(kTaNa, (double)n_local);
  const int j = upper_bin<kNw>(kTaWw, (double)w_local);
  // torch.round, then int64 (a NaN, and anything out of the axis, clips)
  const T kr = clampT(rint((tt - (T)TA_TK_0) * (T)0.1), (T)-kBig, (T)kBig);
  const int k = clip(kr == kr ? (long long)kr + 1 : 1, 1, kNt) - 1;
  const T* row = corners + ((i * kNw + j) * kNt + k) * 4;
  const T a = row[0], b = row[1], cc = row[2], dd = row[3];
  const T x1 = (T)kLogNa[i - 1], x2 = (T)kLogNa[i];
  const T y1 = (T)kLogWw[j - 1], y2 = (T)kLogWw[j];
  const T t = (log(n_local) - x1) / (x2 - x1);
  const T u = (log(w_local) - y1) / (y2 - y1);
  const T frac = ((T)1 - t) * ((T)1 - u) * a + t * ((T)1 - u) * b +
                 t * u * cc + ((T)1 - t) * u * dd;
  return nccn * frac;
}

template <typename T, bool WARM>
__global__ void __launch_bounds__(kBlock,
                                  min_blocks(kLookupMinBlocks<T, WARM>,
                                             kBlock))
    lookup_stage_kernel(const Inputs<T> in, const T* __restrict__ wev_tab,
                        const T* __restrict__ corners, T* __restrict__ out,
                        int cells, int nz, double dt_d) {
  const int g = blockIdx.x * kBlock + threadIdx.x;
  if (g >= cells) return;
  const int col = g / nz, kl = g - col * nz;
  T v[kNIn];
#pragma unroll
  for (int c = 0; c < kNIn; ++c)
    v[c] = in.p[c][col * in.sc[c] + kl * in.sk[c]];
  const T dt = (T)dt_d;

  // phase 12's provisional thermodynamics, from the raw qc and nc
  const T temp = v[L_t] + dt * v[L_tten];
  const T tempc = temp - (T)273.15;
  const T qv = mx(v[L_qv] + dt * v[L_qvten], (T)1.0e-10);
  const T pres = v[L_pres];
  const T rho = (T)0.622 * pres / ((T)R_GAS * temp * (qv + (T)0.622));
  const T qvs = rslf(pres, temp);
  T ssatw = qv / qvs - (T)1;
  ssatw = fabs(ssatw) < (T)EPS ? (T)0 : ssatw;
  const T diffu =
      (T)2.11e-5 * POWC(temp / (T)273.15, 1.94) * ((T)101325.0 / pres);
  const T lvap = (T)LVAP0 + (T)(2106.0 - 4218.0) * tempc;
  const T tcond = ((T)5.69 + (T)0.0168 * tempc) * (T)1.0e-5 * (T)418.936;
  const T nwfa = mx((v[L_nwfa] + v[L_nwfaten] * dt) * rho, (T)11.1e6);
  const T qc = v[L_qc] + v[L_qcten] * dt;
  const bool l_qc = qc > (T)R1;
  const T rc = l_qc ? qc * rho : (T)R1;
  const T nc = l_qc ? mx((v[L_nc] + v[L_ncten] * dt) * rho, (T)2.0) : (T)2.0;

  // CCN activation (f90:2795-2801)
  const T xnc_act = mx(activ_ncloud(temp, v[L_w], nwfa, corners), (T)2.0);

  // the drop-evaporation number (f90:2804-2851)
  T t1_evd, rvs_wd;
  subl_prefactor(temp, qvs, rho, diffu, tcond, ssatw, lvap, (T)-2.0 * lvap,
                 2.0 * PI, t1_evd, rvs_wd);
  const T dc_star = sqrt(mx((T)(-2.0 * dt_d) * t1_evd / (T)(2.0 * PI) *
                                (T)4.0 * diffu * ssatw * rvs_wd / (T)RHO_W,
                            (T)0));
  const int idx_d =
      clip(trunc_int((T)1.0e6 * dc_star, (T)-1.0, (T)(NBC + 1.0)), 1, kNbc) -
      1;
  const T n_bin = fnint((T)1.0 + (T)NBC * log(nc / (T)TNC1) / (T)NIC1);
  const int idx_n =
      clip(trunc_int(n_bin, (T)-2.0, (T)(NBC + 2.0)), 1, kNbc) - 1;
  const int idx_ce = rc > (T)RC1 ? decade_index(rc, NIC2, kNtbC) : 0;
  const T wev = wev_tab[(idx_d * kNtbC + idx_ce) * kNbc + idx_n];

  out[g] = xnc_act;
  out[cells + g] = wev;
}

// f(the instantiation that a launch for these arguments takes)
template <typename T, typename F>
int with_kernel(int iiwarm, F f) {
  return iiwarm ? f(lookup_stage_kernel<T, true>)
                : f(lookup_stage_kernel<T, false>);
}

template <typename T>
int launch(const void* const* chans, const long long* strides,
           const T* wev_tab, const T* corners, T* out, int ncol, int nz,
           int iiwarm, double dt, void* stream) {
  const long long cells = (long long)ncol * nz;
  if (ncol < 1 || nz < 1 || cells > 0x7fffffffLL - kBlock)
    return (int)cudaErrorInvalidValue;
  Inputs<T> in;
  for (int c = 0; c < kNIn; ++c) {
    in.p[c] = (const T*)chans[c];
    in.sc[c] = strides[2 * c];
    in.sk[c] = strides[2 * c + 1];
  }
  const int blocks = (int)((cells + kBlock - 1) / kBlock);
  return with_kernel<T>(iiwarm, [&](auto kernel) {
    kernel<<<dim3(blocks), dim3(kBlock), 0, (cudaStream_t)stream>>>(
        in, wev_tab, corners, out, (int)cells, nz, dt);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// the resources of the instantiation launched for (dtype, iiwarm), as
// kernel_resources in thompson.cuh gives them, at blocks of 256 threads
// whatever nz; ``aero`` is unused (every launch is aerosol-aware)
extern "C" int kid_lookup_stage_resources(int nz, int f64, int iiwarm,
                                          int aero, int* row) {
  (void)aero;
  if (nz < 1) return (int)cudaErrorInvalidValue;
  auto f = [&](auto kernel) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, (const void*)kernel);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kBlock,
                                                      0);
    row[0] = a.numRegs;
    row[1] = (int)a.localSizeBytes;
    row[2] = (int)a.sharedSizeBytes;
    row[3] = blocks;
    return (int)e;
  };
  return f64 ? with_kernel<double>(iiwarm, f) : with_kernel<float>(iiwarm, f);
}

// C interface, loaded with ctypes by kid_tpu_torch/micro/split_step.py.
// chans: 12 pointers (t, qv, qc, nc, nwfa, pres, w, tten, qvten, qcten,
// ncten, nwfaten), strides: their (column, level) element strides, 24
// values; wev_tab: tnc_wev, (NBC, NTB_C, NBC) contiguous; corners:
// tnccn_corners, (7 * 9 * 7, 4) contiguous; out: (2, ncol, nz) contiguous,
// xnc_act then wev; every array on the card but chans and strides, which
// the host reads.  Returns the cudaError_t of the launch.
extern "C" int kid_lookup_stage_f32(const void* const* chans,
                                    const long long* strides,
                                    const float* wev_tab,
                                    const float* corners, float* out,
                                    int ncol, int nz, int iiwarm, double dt,
                                    void* stream) {
  return launch<float>(chans, strides, wev_tab, corners, out, ncol, nz,
                       iiwarm, dt, stream);
}

extern "C" int kid_lookup_stage_f64(const void* const* chans,
                                    const long long* strides,
                                    const double* wev_tab,
                                    const double* corners, double* out,
                                    int ncol, int nz, int iiwarm, double dt,
                                    void* stream) {
  return launch<double>(chans, strides, wev_tab, corners, out, ncol, nz,
                        iiwarm, dt, stream);
}
