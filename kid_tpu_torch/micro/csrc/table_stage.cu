// The table stage of the Thompson09 step as one CUDA kernel for Hopper
// (sm_90a): ``_table_stage(*_prologue(state, pres, cfg), tables, cfg, dt)``
// of kid_tpu_torch/micro/solver.py, the tv channels that fused_step.cu,
// fused_rates.cu and fused_kid_step.cu read.
//
// Replaces kid_tpu/micro/solver.py:1132 (``_prologue``) and :1350
// (``_table_stage``).  The reference has no Pallas kernel there: it runs
// the two stages as plain XLA, which ``jax.jit`` fuses into a handful of
// fusions with banded gathers.  The port's plain version
// (table_stage.table_stage_ref) runs them as some 1,100 torch kernels a
// call; this file is the port's counterpart of that fusion.
//
// What it computes, per cell, in the association order of the torch code
// (as thompson.cuh transcribes it): phases 2-7 (``prologue``, with its
// warp-level graupel N0 suffix minimum and, for aerosol-aware configs,
// the droplet clamp that sets nc and so mvd_c, the cw index and
// pni_wfz); the lookup indices of ``_prologue`` through ``decade_index``,
// ``log_bin_index``, ``trunc_int`` and ``fnint`` of
// kid_tpu_torch/tables/index.py (torch.log10 and torch.pow(10, n) with the
// mantissa repair, not thompson.cuh's log10_); the table gathers; and the
// rates that consume them.  The tv channels go straight into rows of the
// caller's buffer, which the caller makes the next kernel's packed input.
//
// Mapping: as fused_step.cu, one block per column and one thread per
// level, 128 threads for nz <= 128 and 256 above, with the register budget
// TABLE_MIN_BLOCKS_* of thompson.cuh.  Each of the 13 input channels is
// read in place through a pointer and two element strides (columns,
// levels), so a broadcast pres row and rows of another tensor cost no
// copy.  The tables stay in DeviceTables' layout and are read with plain
// read-only loads.
//
// Bound: at (8192, 120) f32 the kernel reads 13 channels and writes 18:
// 31 x 983,040 x 4 B = 121.9 MB, at least 36 us at 3.35 TB/s, plus at
// most 20 table values a cell.  The f32 tables are some 25 MB and stay in
// the 50 MB L2; a cell's rows are scattered, so each gather is a
// 32-byte sector for 4-20 useful bytes.  The design keeps every gather
// off device memory it does not need: a gather is skipped where its
// consumer's mask is off (rs_on for racs, rg_on for racg, frz_tab for
// qrfz, wfz_tab for qcfz, ice_on for iaus rows 1-2; every consumer is
// where(mask, ..., 0), so skipping is exact, and it is the counterpart
// of the reference's banding, which guards the same blocks per cell).
// ef_rw, ef_sw and tide are read at every cell.  The prologue's IEEE
// exp/log/pow chains (no fast math, -fmad=false) are the arithmetic:
// chip_smoke.py phase 2e counts 0.97 G operations for the plain version
// at this shape, >= 14 us at 67 TFLOP/s, so bytes bound it.  On an
// NVIDIA H100 80GB HBM3 at 700 W it takes 0.090 ms a launch with 47
// registers and no spill, 10 blocks of 128 threads a SM (the budget does
// not bind), bit for bit its plain version (PERF.md).

#define KID_FOLD_POWC
#include "thompson.cuh"

namespace {

constexpr int kNIn = N_STATE + 1;  // ColumnState's 12 channels, then pres

// where the kernel reads its input channels: a pointer and the element
// strides between columns and between levels of each
template <typename T> struct Inputs {
  const T* p[kNIn];
  long long sc[kNIn], sk[kNIn];
};

// the device tables (solver.DeviceTables), contiguous, in their layout
template <typename T> struct Tabs {
  const T *racs, *racg, *qrfz, *qcfz, *iaus, *efrw, *efsw;
};

constexpr int kNtbC = (int)NTB_C, kNtbI = (int)NTB_I, kNtbI1 = (int)NTB_I1;
constexpr int kNtbR = (int)NTB_R, kNtbR1 = (int)NTB_R1, kNtbS = (int)NTB_S;
constexpr int kNtbT = (int)NTB_T, kNtbG = (int)NTB_G, kNtbG1 = (int)NTB_G1;
constexpr int kNbr = (int)NBR, kNbc = (int)NBC, kNbs = (int)NBS;

// index.py::log_bin_index: ``scale`` is nbins / log(bin_last / bin0),
// folded in double as Python folds it
template <typename T>
__device__ __forceinline__ int log_bin_index(T x, double bin0, double scale,
                                             int nbins) {
  const T v = (T)scale * log(x / (T)bin0);
  return clip(1 + (long long)trunc_int(v, (T)-2.0, (T)(nbins + 2.0)), 1,
              nbins) - 1;
}

// one cell's tv channels from its prologue products (solver._prologue's
// indices, then solver._table_stage), written to tv[c * plane]
template <typename T, bool WARM>
__device__ __forceinline__ void table_cell(const Pro<T>& p,
                                           const Params<T>& P, double nt_c,
                                           const Tabs<T>& tb,
                                           T* __restrict__ tv, size_t plane,
                                           bool store) {
  const T odts = P.odts;
  const int rw = log_bin_index(mx(p.mvd_r, (T)DR1), DR1, RW_SCALE, kNbr);
  const int cw =
      clip(trunc_int(p.mvd_c * (T)1.0e6, (T)-1.0, (T)(NBC + 1.0)), 1, kNbc) -
      1;
  const T ef_rw = tb.efrw[rw * kNbc + cw];
  if (WARM) {
    if (store) tv[TV_ef_rw * plane] = ef_rw;
    return;
  }

  // temperature / species table indices (solver._prologue)
  const T temp = p.temp0, tempc = temp - (T)273.15;
  const T rc = p.rc0, nc = p.nc0, ri = p.ri0, ni = p.ni0;
  const T rr = p.rr0, nr = p.nr0, rs = p.rs0, rg = p.rg0;
  const int idx_tc =
      clip(trunc_int(fnint(-tempc), (T)-1.0, (T)46.0), 1, 45) - 1;
  const long long idx_t0 =
      (long long)trunc_int((tempc - (T)2.5) / (T)5.0, (T)-kBig, (T)kBig) - 1;
  const int idx_t = clip(-idx_t0 > 1 ? -idx_t0 : 1, 1, kNtbT) - 1;
  const bool has_r = rr > (T)RR1, has_g = rg > (T)RG1;
  const T lam_exp_r = ((T)1 / p.ilamr0) * (T)LAM_EXP_R_FAC;
  const T n0_exp_r = (T)ORG1 * rr / (T)AM_R * POWC(lam_exp_r, CRE_1);
  const T lam_exp_g = ((T)1 / p.ilamg) * (T)LAM_EXP_G_FAC;
  const T n0_exp_g = (T)OGG1 * rg / (T)AM_G * POWC(lam_exp_g, CGE_1);
  const int idx_c = rc > (T)RC1 ? decade_index(rc, NIC2, kNtbC) : 0;
  const int idx_i = ri > (T)RI1 ? decade_index(ri, NII2, kNtbI) : 0;
  const int idx_i1 = ni > (T)NTI1 ? decade_index(ni, NII3, kNtbI1) : 0;
  const int idx_r = has_r ? decade_index(rr, NIR2, kNtbR) : 0;
  const int idx_r1 =
      has_r ? decade_index(n0_exp_r, NIR3, kNtbR1) : kNtbR1 - 1;
  const int idx_s = rs > (T)RS1 ? decade_index(rs, NIS2, kNtbS) : 0;
  const int idx_g = has_g ? decade_index(rg, NIG2, kNtbG) : 0;
  const int idx_g1 =
      has_g ? decade_index(n0_exp_g, NIG3, kNtbG1) : kNtbG1 - 1;
  const int sw = log_bin_index(mx(p.xds, (T)DS1), DS1, SW_SCALE, kNbs);

  // the gathers, each skipped where its consumer's mask is off
  const T ef_sw = tb.efsw[sw * kNbc + cw];
  const bool t_lt_0 = temp < (T)T_0;
  const bool rs_on = (rr >= (T)RR1) && (rs >= (T)RS1);
  const bool rg_on = (rr >= (T)RR1) && (rg >= (T)RG1);
  const bool frz_tab = t_lt_0 && (rr > (T)RR1);
  const bool wfz_tab = t_lt_0 && (rc > (T)RC1);
  const bool ice_on = t_lt_0 && (p.qi1d > (T)R1);
  T ma = 0, mb = 0, mc = 0, n_cold = 0, n_warm = 0;
  if (rs_on) {
    const T* row =
        tb.racs +
        (size_t)(((idx_s * kNtbT + idx_t) * kNtbR1 + idx_r1) * kNtbR + idx_r) *
            5;
    ma = row[0]; mb = row[1]; mc = row[2]; n_cold = row[3]; n_warm = row[4];
  }
  T g0 = 0, g1 = 0, g2 = 0, g3 = 0;
  if (rg_on) {
    const T* row = tb.racg + (size_t)(((idx_g1 * kNtbG + idx_g) * kNtbR1 +
                                       idx_r1) * kNtbR + idx_r) * 4;
    g0 = row[0]; g1 = row[1]; g2 = row[2]; g3 = row[3];
  }
  T f0 = 0, f1 = 0, f2 = 0, f3 = 0;
  if (frz_tab) {
    const T* row =
        tb.qrfz + (size_t)((idx_r * kNtbR1 + idx_r1) * 45 + idx_tc) * 4;
    f0 = row[0]; f1 = row[1]; f2 = row[2]; f3 = row[3];
  }
  T c0 = 0, c1 = 0;
  if (wfz_tab) {
    const int at = idx_c * 45 + idx_tc;
    c0 = tb.qcfz[at];
    c1 = tb.qcfz[kNtbC * 45 + at];
  }
  const int at_i = idx_i * kNtbI1 + idx_i1;
  const T tide = tb.iaus[at_i];
  T i1 = 0, i2 = 0;
  if (ice_on) {
    i1 = tb.iaus[kNtbI * kNtbI1 + at_i];
    i2 = tb.iaus[2 * kNtbI * kNtbI1 + at_i];
  }

  // rain<->snow collection via the 5 pre-summed combinations
  // (f90:1961-1997)
  const T prr_rcs_c = mx(-rr * odts, -(mb + ma));
  const T prs_rcs_c = mx(-rs * odts, mb - mc);
  const T prg_rcs_c = mn((rr + rs) * odts, ma + mc);
  const T prs_rcs_w = mx(-rs * odts, mb - mc);
  const T prr_rcs_w = -prs_rcs_w;
  const T prr_rcs = rs_on ? (t_lt_0 ? prr_rcs_c : prr_rcs_w) : (T)0;
  const T prs_rcs = rs_on ? (t_lt_0 ? prs_rcs_c : prs_rcs_w) : (T)0;
  const T prg_rcs = (rs_on && t_lt_0) ? prg_rcs_c : (T)0;
  const T pnr_rcs = rs_on ? mn(nr * odts, t_lt_0 ? n_cold : n_warm) : (T)0;

  // rain<->graupel collection via the 4 pre-summed combinations
  // (f90:1999-2018)
  const T prg_rcg_c = mn(rr * odts, g0);
  const T pnr_rcg_c = mn(nr * odts, g1);
  const T prr_rcg_w = mn(rg * odts, g3);
  const T pnr_rcg_w = (T)-5.0 * g2;  // explicit break-up f90:2016
  const T prg_rcg = rg_on ? (t_lt_0 ? prg_rcg_c : -prr_rcg_w) : (T)0;
  const T prr_rcg = rg_on ? (t_lt_0 ? -prg_rcg_c : prr_rcg_w) : (T)0;
  const T pnr_rcg = rg_on ? (t_lt_0 ? pnr_rcg_c : pnr_rcg_w) : (T)0;

  // rain freezing, Bigg 1953 (f90:2065-2076)
  const bool frz_hom = t_lt_0 && !(rr > (T)RR1) && (rr > (T)R1) &&
                       (temp < (T)HGFR);
  const T prg_rfz = frz_tab ? f0 * odts : (T)0;
  const T pri_rfz = frz_tab ? f1 * odts : (frz_hom ? rr * odts : (T)0);
  const T pni_rfz = frz_tab ? f2 * odts : (frz_hom ? nr * odts : (T)0);
  const T pnr_rfz = frz_tab ? mn(nr * odts, f3 * odts)
                            : (frz_hom ? nr * odts : (T)0);

  // cloud water freezing (f90:2077-2086)
  const bool wfz_hom = t_lt_0 && !(rc > (T)RC1) && (rc > (T)R1) &&
                       (temp < (T)HGFR);
  const T pri_wfz = wfz_tab ? mn(rc * odts, c0 * odts)
                            : (wfz_hom ? rc * odts : (T)0);
  const T pni_wfz =
      wfz_tab ? mn(mn(pri_wfz / (T)(2.0 * XM0I), (T)(nt_c * (double)odts)),
                   c1 * odts)
              : (wfz_hom ? nc * odts : (T)0);

  // ice -> snow autoconversion (f90:2135-2148)
  const T xdi = p.xdi;
  const bool iau_big = (idx_i == kNtbI - 1) || (xdi > (T)(5.0 * D0S));
  const bool iau_small = xdi < (T)(0.1 * D0S);
  const T prs_iau_t = mn(ri * (T)0.99 * odts, i1 * odts);
  const T pni_iau_t = mn(ni * (T)0.95 * odts, i2 * odts);
  const T prs_iau =
      ice_on ? (iau_big ? ri * (T)0.99 * odts
                        : (iau_small ? (T)0 : prs_iau_t))
             : (T)0;
  const T pni_iau =
      ice_on ? (iau_big ? ni * (T)0.95 * odts
                        : (iau_small ? (T)0 : pni_iau_t))
             : (T)0;

  if (!store) return;
  tv[TV_ef_rw * plane] = ef_rw;
  tv[TV_ef_sw * plane] = ef_sw;
  tv[TV_tide * plane] = tide;
  tv[TV_prr_rcs * plane] = prr_rcs;
  tv[TV_prs_rcs * plane] = prs_rcs;
  tv[TV_prg_rcs * plane] = prg_rcs;
  tv[TV_pnr_rcs * plane] = pnr_rcs;
  tv[TV_prg_rcg * plane] = prg_rcg;
  tv[TV_prr_rcg * plane] = prr_rcg;
  tv[TV_pnr_rcg * plane] = pnr_rcg;
  tv[TV_prg_rfz * plane] = prg_rfz;
  tv[TV_pri_rfz * plane] = pri_rfz;
  tv[TV_pni_rfz * plane] = pni_rfz;
  tv[TV_pnr_rfz * plane] = pnr_rfz;
  tv[TV_pri_wfz * plane] = pri_wfz;
  tv[TV_pni_wfz * plane] = pni_wfz;
  tv[TV_prs_iau * plane] = prs_iau;
  tv[TV_pni_iau * plane] = pni_iau;
}

template <typename T, bool WARM, bool AERO, int BLOCK>
__global__ void __launch_bounds__(BLOCK,
                                  min_blocks(kTableMinBlocks<T, WARM>, BLOCK))
    table_stage_kernel(const Inputs<T> in, const Tabs<T> tb,
                       T* __restrict__ tv, int ncol, int nz, double nt_c,
                       double dt) {
  __shared__ Shared<T> sh;
  Vert<T> vx{sh, 0};
  const int col = blockIdx.x;
  const bool valid = (int)threadIdx.x < nz;
  const int kl = valid ? threadIdx.x : nz - 1;  // padding mirrors the top
  const Params<T> P = make_params<T>(dt, nt_c, 0.0, 0, 0, 0);
  T v[kNIn];
#pragma unroll
  for (int c = 0; c < kNIn; ++c)
    v[c] = in.p[c][col * in.sc[c] + kl * in.sk[c]];
  const Cell<T> s{v[I_t],  v[I_qv], v[I_qc], v[I_qi],   v[I_qr],
                  v[I_qs], v[I_qg], v[I_ni], v[I_nr],   v[I_nc],
                  v[I_nwfa], v[I_nifa], v[I_pres]};
  Pro<T> p;
  prologue<T, WARM, AERO>(s, P, valid, vx, p);
  table_cell<T, WARM>(p, P, nt_c, tb, tv + (size_t)col * nz + kl,
                      (size_t)ncol * nz, valid);
}

// f(the instantiation that a launch of these arguments takes): blocks of
// up to 128 threads for nz <= 128, of up to 256 above
template <typename T, int BLOCK, typename F>
int with_block(int iiwarm, int aero, F f) {
  if (iiwarm)
    return aero ? f(table_stage_kernel<T, true, true, BLOCK>)
                : f(table_stage_kernel<T, true, false, BLOCK>);
  return aero ? f(table_stage_kernel<T, false, true, BLOCK>)
              : f(table_stage_kernel<T, false, false, BLOCK>);
}
template <typename T, typename F>
int with_kernel(int nz, int iiwarm, int aero, F f) {
  return nz <= 128 ? with_block<T, 128>(iiwarm, aero, f)
                   : with_block<T, kMaxThreads>(iiwarm, aero, f);
}

template <typename T>
int launch(const void* const* chans, const long long* strides,
           const void* const* tabs, T* tv, int ncol, int nz, int iiwarm,
           int aero, double nt_c, double dt, void* stream) {
  Inputs<T> in;
  for (int c = 0; c < kNIn; ++c) {
    in.p[c] = (const T*)chans[c];
    in.sc[c] = strides[2 * c];
    in.sk[c] = strides[2 * c + 1];
  }
  const Tabs<T> tb{(const T*)tabs[0], (const T*)tabs[1], (const T*)tabs[2],
                   (const T*)tabs[3], (const T*)tabs[4], (const T*)tabs[5],
                   (const T*)tabs[6]};
  return with_kernel<T>(nz, iiwarm, aero, [&](auto kernel) {
    return launch_columns(kernel, ncol, nz, stream, in, tb, tv, ncol, nz,
                          nt_c, dt);
  });
}

}  // namespace

// the resources of the instantiation launched for (nz, dtype, iiwarm,
// aero): see kernel_resources in thompson.cuh
extern "C" int kid_table_stage_resources(int nz, int f64, int iiwarm,
                                         int aero, int* row) {
  auto f = [&](auto kernel) { return kernel_resources(kernel, nz, row); };
  return f64 ? with_kernel<double>(nz, iiwarm, aero, f)
             : with_kernel<float>(nz, iiwarm, aero, f);
}

// C interface, loaded with ctypes by kid_tpu_torch/micro/table_stage.py.
// chans: 13 pointers (ColumnState's channels, then pres), strides: their
// (column, level) element strides, 26 values; tabs: racs, racg, qrfz,
// qcfz, iaus, t_efrw, t_efsw, contiguous; tv: (ntv, ncol, nz) contiguous;
// every array on the card but chans, strides and tabs, which the host
// reads.  Returns the cudaError_t of the launch.
extern "C" int kid_table_stage_f32(const void* const* chans,
                                   const long long* strides,
                                   const void* const* tabs, float* tv,
                                   int ncol, int nz, int iiwarm, int aero,
                                   double nt_c, double dt, void* stream) {
  return launch<float>(chans, strides, tabs, tv, ncol, nz, iiwarm, aero,
                       nt_c, dt, stream);
}

extern "C" int kid_table_stage_f64(const void* const* chans,
                                   const long long* strides,
                                   const void* const* tabs, double* tv,
                                   int ncol, int nz, int iiwarm, int aero,
                                   double nt_c, double dt, void* stream) {
  return launch<double>(chans, strides, tabs, tv, ncol, nz, iiwarm, aero,
                        nt_c, dt, stream);
}
