// Thompson09 microphysics, phases 2-20 of one time step, as one CUDA kernel
// for Hopper (sm_90a).
//
// Replaces kid_tpu/micro/pallas_step.py::fused_step (the Pallas TPU kernel
// whose body is kid_tpu/micro/solver.py::core_from_tables).  Its plain
// PyTorch version is kid_tpu_torch/micro/solver.py::core_from_tables
// (fused_step.fused_step_ref); this file transcribes that code expression by
// expression, in the same association order, so the two differ only by the
// card's rounding of exp/log/pow.
//
// Boundary (as the TPU design): the prologue is re-derived in-kernel from
// the raw state, so only 14 + ntv channels go in (12 state + pres + dzq +
// 18 table-stage channels for mixed phase, 1 warm) and 12 (+36 rate
// profiles) channels plus 4 per-column precip values come out.
//
// Mapping: one thread block per column, one thread per level (blockDim = nz
// rounded up to 32).  Elementwise phases run per thread in registers; the
// vertical structures go through shared memory: the graupel-N0 suffix
// minimum and the fall-speed fill-down are log-doubling scans, k0/ksed/nstep
// are block max-reductions, and each sedimentation substep exchanges the
// flux of the level above.  Each column runs its own substep count.
//
// Bound at (ncol, nz) = (8192, 120) f32 without rates: 32 input + 12 output
// channels of 3.93 MB (+ precip) is ~173 MB, i.e. >= ~52 us at 3.35 TB/s;
// with the 36 rate channels ~80 channels, ~315 MB, >= ~94 us.  The
// arithmetic is some 2.4 k elementwise operations per cell (chip_smoke.py
// counts 2.41 G for the plain version at this shape; this file has some
// 90 call sites of exp, log, pow, sqrt and the chains built on them),
// >= ~36 us at the 67 TFLOP/s f32 rate, so bytes bound it.
// This first version aims at being right, with float32 and float64
// instantiations and no fast math (-fmad=false keeps the rounding of the
// plain version); it is register-heavy and runs well above its bound.
//
// Every literal and constant is cast to scalar_t (T) where it meets a
// tensor value; leading products of constants are folded in double first,
// as Python folds them before they meet a tensor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_step_constants.h"

namespace {

constexpr int kMaxThreads = MAX_NZ;  // from the generated header

// NaN-propagating max/min (torch.maximum / torch.minimum / torch.clamp)
template <typename T> __device__ __forceinline__ T mx(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T> __device__ __forceinline__ T mn(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T> __device__ __forceinline__ T clampT(T x, T lo, T hi) {
  return mn(mx(x, lo), hi);
}
template <typename T> __device__ __forceinline__ T relu(T x) {
  return mx(x, (T)0);
}
template <typename T> __device__ __forceinline__ T sgn(T x) {
  return x > (T)0 ? (T)1 : (x < (T)0 ? (T)-1 : x);
}
template <typename T> __device__ __forceinline__ T fnint(T x) {
  return sgn(x) * floor(fabs(x) + (T)0.5);
}
// C truncation of x clamped to [lo, hi] (NaN -> lo)
template <typename T> __device__ __forceinline__ int trunc_int(T x, T lo,
                                                               T hi) {
  if (!(x >= lo)) return (int)lo;
  if (x > hi) return (int)hi;
  return (int)x;
}

template <typename T> __device__ __forceinline__ T exp10_(T x) {
  return exp(x * (T)LN10_PY);
}
template <typename T> __device__ __forceinline__ T log10_(T x) {
  return log(x) * (T)INV_LN10_PY;
}
template <typename T> __device__ __forceinline__ T cbrt_(T x) {
  return exp(log(x) * (T)(1.0 / 3.0));
}
// x**k by binary squaring (JAX's integer_pow order)
template <typename T> __host__ __device__ __forceinline__ T ipow(T x,
                                                                 int k) {
  if (k == 0) return (T)1;
  T acc = x;
  bool has = false;
  T base = x;
  while (k) {
    if (k & 1) {
      acc = has ? acc * base : base;
      has = true;
    }
    k >>= 1;
    if (k) base = base * base;
  }
  return acc;
}
// x**p for a constant p: multiply/sqrt/cbrt chains as fastmath.powc
template <typename T> __device__ __forceinline__ T powc(T x, double p) {
  if (p == 0.0) return (T)1;
  const double a = fabs(p);
  const int k = (int)a;
  const double f = a - k;
  T extra = (T)0;
  bool has_extra = true;
  if (fabs(f) < 1e-12) {
    has_extra = false;
  } else if (fabs(f - 0.5) < 1e-12) {
    extra = sqrt(x);
  } else if (fabs(f - 1.0 / 3.0) < 1e-12) {
    extra = cbrt_(x);
  } else if (fabs(f - 2.0 / 3.0) < 1e-12) {
    T cr = cbrt_(x);
    extra = cr * cr;
  } else if (fabs(f - 0.25) < 1e-12) {
    extra = sqrt(sqrt(x));
  } else if (fabs(f - 0.75) < 1e-12) {
    T s = sqrt(x);
    extra = s * sqrt(s);
  } else if (fabs(f - 1.0 / 6.0) < 1e-12) {
    extra = sqrt(cbrt_(x));
  } else {
    return pow(x, (T)p);
  }
  T out;
  if (!has_extra) out = ipow(x, k);
  else if (k == 0) out = extra;
  else out = ipow(x, k) * extra;
  if (p < 0) out = (T)1 / out;
  return out;
}

// Flatau saturation polynomials, Horner order of special._poly8
template <typename T> __device__ __forceinline__ T sat_(T p, T t,
                                                        const double* cf) {
  T x = mx(t - (T)273.16, (T)-80.0);
  T acc = (T)cf[8];
  for (int k = 7; k >= 0; --k) acc = (T)cf[k] + x * acc;
  T es = mn(acc, p * (T)0.15);
  return (T)0.622 * es / (p - es);
}
__device__ const double kRSLF[9] = {RSLF_C_0, RSLF_C_1, RSLF_C_2, RSLF_C_3,
                                    RSLF_C_4, RSLF_C_5, RSLF_C_6, RSLF_C_7,
                                    RSLF_C_8};
__device__ const double kRSIF[9] = {RSIF_C_0, RSIF_C_1, RSIF_C_2, RSIF_C_3,
                                    RSIF_C_4, RSIF_C_5, RSIF_C_6, RSIF_C_7,
                                    RSIF_C_8};
template <typename T> __device__ __forceinline__ T rslf(T p, T t) {
  return sat_(p, t, kRSLF);
}
template <typename T> __device__ __forceinline__ T rsif(T p, T t) {
  return sat_(p, t, kRSIF);
}

// Field et al. (2005) snow moment of order m (solver._field_moment);
// m3 = m**3 as Python computes it
template <typename T>
__device__ __forceinline__ T field_moment(T log10_smo2, T tc0, double m,
                                          double m3) {
  T loga = (T)SA_0 + (T)SA_1 * tc0 + (T)(SA_2 * m) + (T)SA_3 * tc0 * (T)m +
           (T)SA_4 * tc0 * tc0 + (T)(SA_5 * m * m) +
           (T)SA_6 * tc0 * tc0 * (T)m + (T)SA_7 * tc0 * (T)m * (T)m +
           (T)SA_8 * ipow(tc0, 3) + (T)(SA_9 * m3);
  T b = (T)SB_0 + (T)SB_1 * tc0 + (T)(SB_2 * m) + (T)SB_3 * tc0 * (T)m +
        (T)SB_4 * tc0 * tc0 + (T)(SB_5 * m * m) +
        (T)SB_6 * tc0 * tc0 * (T)m + (T)SB_7 * tc0 * (T)m * (T)m +
        (T)SB_8 * ipow(tc0, 3) + (T)(SB_9 * m3);
  return exp10_(loga + b * log10_smo2);
}

// solver._nr_from_mvd with a constant diameter
template <typename T> __device__ __forceinline__ T nr_from_mvd(T rr_,
                                                               double mvd) {
  const double lam = (3.0 + MU_R + 0.672) / mvd;
  return (T)(CRG_2 * ORG3) * rr_ * (T)ipow(lam, 3) / (T)AM_R;
}

// Srivastava & Coen prefactor (solver._subl_prefactor); m2lheat is the
// value of ``-2.0 * lheat`` as the caller's Python evaluates it
template <typename T>
__device__ __forceinline__ void subl_prefactor(T temp, T qvsi, T rho,
                                               T diffu, T tcond, T ssati,
                                               T lheat, T m2lheat,
                                               double two_pi, T& t1,
                                               T& rvs) {
  T otemp = (T)1 / temp;
  rvs = rho * qvsi;
  T base = lheat * otemp * (T)ORV - (T)1;
  T rvs_p = rvs * otemp * base;
  T rvs_pp = rvs * (otemp * base * otemp * base +
                    (m2lheat * ipow(otemp, 3) * (T)ORV) + otemp * otemp);
  T gamsc = lheat * diffu / tcond * rvs_p;
  T alphsc = mx((T)0.5 * ipow(gamsc / ((T)1 + gamsc), 2) * rvs_pp / rvs_p *
                    rvs / rvs_p,
                (T)1e-9);
  T xsat = fabs(ssati) < (T)1e-9 ? (T)0 : ssati;
  t1 = (T)two_pi *
       ((T)1 - alphsc * xsat + (T)2 * alphsc * alphsc * xsat * xsat -
        (T)5 * ipow(alphsc, 3) * ipow(xsat, 3)) /
       ((T)1 + gamsc);
}

// ---------------------------------------------------------------------------
// block-wide vertical helpers (every thread of the block must call them)

template <typename T> struct Shared {
  T a[kMaxThreads];
  T b[kMaxThreads];
  int f[kMaxThreads];
  int red;
};

// max over the block of a non-negative int
template <typename T>
__device__ __forceinline__ int block_max(int v, Shared<T>& sh) {
  if (threadIdx.x == 0) sh.red = 0;
  __syncthreads();
  if (v > 0) atomicMax(&sh.red, v);
  __syncthreads();
  int r = sh.red;
  __syncthreads();
  return r;
}

// suffix (top-down running) minimum over the valid levels
template <typename T>
__device__ __forceinline__ T suffix_min(T v, bool valid, Shared<T>& sh) {
  const int k = threadIdx.x;
  const int n = blockDim.x;
  const T inf = (T)INFINITY;
  T cur = valid ? v : inf;
  sh.a[k] = cur;
  __syncthreads();
  for (int off = 1; off < n; off <<= 1) {
    T o = (k + off < n) ? sh.a[k + off] : inf;
    __syncthreads();
    cur = mn(cur, o);
    sh.a[k] = cur;
    __syncthreads();
  }
  return cur;
}

// first valid value at or above each level, 0 where none (_fill_down)
template <typename T>
__device__ __forceinline__ T fill_down(T v, bool flag, Shared<T>& sh) {
  const int k = threadIdx.x;
  const int n = blockDim.x;
  T cv = v;
  int cf = flag ? 1 : 0;
  sh.a[k] = cv;
  sh.f[k] = cf;
  __syncthreads();
  for (int off = 1; off < n; off <<= 1) {
    T ov = (T)0;
    int of = 0;
    if (k + off < n) {
      ov = sh.a[k + off];
      of = sh.f[k + off];
    }
    __syncthreads();
    if (!cf) {
      cv = ov;
      cf = of;
    }
    sh.a[k] = cv;
    sh.f[k] = cf;
    __syncthreads();
  }
  return cf ? cv : (T)0;
}

// graupel N0 / slope with the top-down running minimum (_graupel_psd)
template <typename T>
__device__ __forceinline__ void graupel_psd(T rg, T temp, bool l_qr, T mvd_r,
                                            bool valid, Shared<T>& sh,
                                            T& ilamg, T& n0_g) {
  const int k = threadIdx.x;
  const int k0 = block_max((valid && temp >= (T)270.65) ? k : 0, sh);
  T xslw1 = (k > k0 && l_qr && mvd_r > (T)100.0e-6)
                ? (T)4.01 + log10_(mx(mvd_r, (T)1e-12))
                : (T)0.01;
  T ygra1 = (T)4.31 + log10_(mx(rg, (T)5.0e-5));
  T zans1 = (T)3.1 + ((T)100.0 / ((T)300.0 * xslw1 * ygra1 /
                                      ((T)10.0 / xslw1 + (T)1.0 +
                                       (T)0.25 * ygra1) +
                                  (T)30.0 + (T)10.0 * ygra1));
  T n0_exp = clampT(exp10_(zans1), (T)GONV_MIN, (T)GONV_MAX);
  n0_exp = suffix_min(n0_exp, valid, sh);
  T lam_exp = powc(n0_exp * (T)AM_G * (T)CGG_1 / rg, OGE1);
  T lamg = lam_exp * (T)LAMG_FAC;
  ilamg = (T)1 / lamg;
  n0_g = n0_exp / ((T)CGG_2 * lam_exp) * powc(lamg, CGE_2);
}

// one species' substepped upwind sweep (solver._cfl + solver._sweep)
template <typename T, bool NUM>
__device__ __forceinline__ void sweep(T vt_cfl, T vts_mass, T vts_num,
                                      T& ten_m, T& ten_n, T& dm, T& dn,
                                      T floor_m, T floor_n, T gate, T orho,
                                      T odzq, T dt, bool valid, int nz,
                                      Shared<T>& sh, T& ppt) {
  const int k = threadIdx.x;
  const int top = nz - 1;
  const bool vt_mask = valid && vt_cfl > (T)1.0e-3;
  int ksed = block_max(vt_mask ? k : 0, sh);
  if (ksed == top) ksed = top - 1;
  const int nstep = block_max(
      vt_mask ? trunc_int(dt * vt_cfl * odzq + (T)1.0, (T)0, (T)1073741824.0)
              : 0,
      sh);
  const int n_loop = nstep > 1 ? nstep : 1;
  const T onstep = (T)1 / (T)n_loop;
  const bool upd = (k == top) || (k <= ksed);
  T acc = (T)0;
  for (int n = 0; n < n_loop; ++n) {
    T sed_m = vts_mass * dm * gate;
    T sed_n = NUM ? vts_num * dn * gate : (T)0;
    sh.a[k] = sed_m;
    if (NUM) sh.b[k] = sed_n;
    __syncthreads();
    T up_m = (k + 1 < nz) ? sh.a[k + 1] : sh.a[nz - 1] * (T)0;
    T up_n = (T)0;
    if (NUM) up_n = (k + 1 < nz) ? sh.b[k + 1] : sh.b[nz - 1] * (T)0;
    __syncthreads();
    T dflx_m = up_m - sed_m;
    if (upd) {
      ten_m = ten_m + dflx_m * odzq * onstep * orho;
      dm = mx(dm + dflx_m * odzq * dt * onstep, floor_m);
    }
    if (NUM) {
      T dflx_n = up_n - sed_n;
      if (upd) {
        ten_n = ten_n + dflx_n * odzq * onstep * orho;
        dn = mx(dn + dflx_n * odzq * dt * onstep, floor_n);
      }
    }
    if (k == 0 && dm > (T)(R1 * 10.0)) acc = acc + sed_m * dt * onstep;
  }
  ppt = acc;
}

// diag channel order (solver.DIAG_KEYS): the 33 P8_RATES, then prr_gml,
// prv_rev, pnr_rev
enum Diag {
  D_prr_wau, D_prr_rcw, D_pnr_wau, D_pnr_rcr, D_pri_inu, D_pri_ide,
  D_prs_ide, D_prs_sde, D_prg_gde, D_pri_wfz, D_prs_scw, D_prg_scw,
  D_prg_gcw, D_pri_ihm, D_pri_rfz, D_prs_iau, D_prs_sci, D_pri_rci,
  D_pni_inu, D_pni_ihm, D_pni_wfz, D_pni_rfz, D_pni_ide, D_pni_iau,
  D_pni_sci, D_pni_rci, D_prr_sml, D_pnr_rcs, D_pnr_rcg, D_pnr_rci,
  D_pnr_sml, D_pnr_gml, D_pnr_rfz, D_prr_gml, D_prv_rev, D_pnr_rev,
  N_DIAG
};

// input channel order: ColumnState, pres, dzq, tv_keys(cfg)
enum In {
  I_t, I_qv, I_qc, I_qi, I_qr, I_qs, I_qg, I_ni, I_nr, I_nc, I_nwfa, I_nifa,
  I_pres, I_dzq, I_ef_rw, I_ef_sw, I_tide, I_prr_rcs, I_prs_rcs, I_prg_rcs,
  I_pnr_rcs, I_prg_rcg, I_prr_rcg, I_pnr_rcg, I_prg_rfz, I_pri_rfz,
  I_pni_rfz, I_pnr_rfz, I_pri_wfz, I_pni_wfz, I_prs_iau, I_pni_iau
};

template <typename T, bool WARM, bool RATES>
__global__ void __launch_bounds__(kMaxThreads)
    fused_step_kernel(const T* __restrict__ x, T* __restrict__ y,
                      T* __restrict__ ppt_out, int ncol, int nz,
                      int l_sediment, double nt_c_d, double dt_d,
                      double ifdry_d) {
  __shared__ Shared<T> sh;
  const int col = blockIdx.x;
  const int k = threadIdx.x;
  const bool valid = k < nz;
  const int kl = valid ? k : nz - 1;  // padding threads mirror the top
  const size_t plane = (size_t)ncol * nz;
  const size_t off = (size_t)col * nz + kl;
  auto in = [&](int ch) -> T { return x[ch * plane + off]; };

  const T dt = (T)dt_d;
  const T odt = (T)1 / dt;
  const T odts = odt;
  const T nt_c = (T)nt_c_d;
  const T ifdry = (T)ifdry_d;

  const T t1d = in(I_t);
  const T qv1d = in(I_qv);
  const T pres = in(I_pres);
  const T dzq = in(I_dzq);
  const T nwfa1d = in(I_nwfa);
  const T nifa1d = in(I_nifa);
  T qc1d = in(I_qc), qi1d = in(I_qi), qr1d = in(I_qr);
  T qs1d = in(I_qs), qg1d = in(I_qg);
  T ni1d = in(I_ni), nr1d = in(I_nr), nc1d = in(I_nc);

  // ======================= _prologue (phases 2-7) =========================
  const T temp0 = t1d;
  const T qv0 = mx(qv1d, (T)1.0e-10);
  const T rho0 = (T)0.622 * pres / ((T)R_GAS * temp0 * (qv0 + (T)0.622));

  // cloud water (f90:1395-1418); non-aerosol nc = Nt_c
  const bool l_qc0 = qc1d > (T)R1;
  qc1d = l_qc0 ? qc1d : (T)0;
  nc1d = l_qc0 ? nc1d : (T)0;
  const T rc0 = l_qc0 ? qc1d * rho0 : (T)R1;
  const T nc0 = l_qc0 ? nt_c : (T)2.0;

  // cloud ice (f90:1420-1445)
  const bool l_qi0 = qi1d > (T)R1;
  qi1d = l_qi0 ? qi1d : (T)0;
  ni1d = l_qi0 ? ni1d : (T)0;
  const T ri0 = l_qi0 ? qi1d * rho0 : (T)R1;
  T ni0;
  {
    T ni_a = mx(ni1d * rho0, (T)R2);
    T ni_fix = mn((T)(CIG_1 * OIG2) * ri0 / (T)AM_I * (T)P_ICE_25,
                  (T)499.0e3);
    T ni1 = (ni1d * rho0 <= (T)R2) ? ni_fix : ni_a;
    T lami = powc((T)(AM_I * CIG_2 * OIG1) * ni1 / ri0, OBMI);
    T xdi = (T)(BM_I + MU_I + 1.0) / lami;
    T ni2 = xdi < (T)5.0e-6
                ? mn((T)(CIG_1 * OIG2) * ri0 / (T)AM_I * (T)P_ICE_5,
                     (T)499.0e3)
                : (xdi > (T)300.0e-6
                       ? (T)(CIG_1 * OIG2) * ri0 / (T)AM_I * (T)P_ICE_300
                       : ni1);
    ni0 = l_qi0 ? ni2 : (T)R2;
  }

  // rain (f90:1447-1474)
  const bool l_qr0 = qr1d > (T)R1;
  qr1d = l_qr0 ? qr1d : (T)0;
  nr1d = l_qr0 ? nr1d : (T)0;
  const T rr0 = l_qr0 ? qr1d * rho0 : (T)R1;
  T nr0, mvd_r0;
  {
    T nr_a = mx(nr1d * rho0, (T)R2);
    T nr1 = (nr1d * rho0 <= (T)R2) ? nr_from_mvd(rr0, 1.0e-3) : nr_a;
    T lamr = powc((T)(AM_R * CRG_3 * ORG2) * nr1 / rr0, OBMR);
    T mvd0 = (T)(3.0 + MU_R + 0.672) / lamr;
    T nr2 = mvd0 > (T)2.5e-3
                ? nr_from_mvd(rr0, 2.5e-3)
                : (mvd0 < (T)(D0R * 0.75) ? nr_from_mvd(rr0, D0R * 0.75)
                                          : nr1);
    nr0 = l_qr0 ? nr2 : (T)R2;
    mvd_r0 = l_qr0 ? clampT(mvd0, (T)(D0R * 0.75), (T)2.5e-3) : (T)D0C;
  }

  // snow / graupel (f90:1475-1492)
  const bool l_qs0 = qs1d > (T)R1;
  qs1d = l_qs0 ? qs1d : (T)0;
  const T rs0 = l_qs0 ? qs1d * rho0 : (T)R1;
  const bool l_qg0 = qg1d > (T)R1;
  qg1d = l_qg0 ? qg1d : (T)0;
  const T rg0 = l_qg0 ? qg1d * rho0 : (T)R1;

  // phase 3: thermodynamics (f90:1503-1533)
  const T tempc0 = temp0 - (T)273.15;
  const T rhof0 = sqrt((T)RHO_NOT / rho0);
  const T rhof20 = sqrt(rhof0);
  const T qvs0 = rslf(pres, temp0);
  const T delqvs = mx(rslf(pres, (T)273.15) - qv0, (T)0);
  const T qvsi = tempc0 <= (T)0 ? rsif(pres, temp0) : qvs0;
  T ssatw0 = qv0 / qvs0 - (T)1;
  T ssati = qv0 / qvsi - (T)1;
  ssatw0 = fabs(ssatw0) < (T)EPS ? (T)0 : ssatw0;
  ssati = fabs(ssati) < (T)EPS ? (T)0 : ssati;
  const T diffu0 =
      (T)2.11e-5 * powc(temp0 / (T)273.15, 1.94) * ((T)101325.0 / pres);
  const T visco0 =
      tempc0 >= (T)0
          ? ((T)1.718 + (T)0.0049 * tempc0) * (T)1.0e-5
          : ((T)1.718 + (T)0.0049 * tempc0 - (T)1.2e-5 * ipow(tempc0, 2)) *
                (T)1.0e-5;
  const T ocp0 = (T)1 / ((T)CP * ((T)1 + (T)0.887 * qv0));
  const T vsc20 = sqrt(rho0 / visco0);
  const T lvap0 = (T)LVAP0 + (T)(2106.0 - 4218.0) * tempc0;
  const T tcond0 = ((T)5.69 + (T)0.0168 * tempc0) * (T)1.0e-5 * (T)418.936;

  // phases 5-6: snow moments, graupel PSD (f90:1545-1656)
  T smo0 = 0, smo1 = 0, smob = 0, smoc = 0, smoe = 0, smof = 0;
  T ilamg = 1, n0_g = 0;
  if (!WARM) {
    T tc0 = mn(temp0 - (T)273.15, (T)-0.1);
    T smob_r = rs0 * (T)OAMS;
    T lg = log(mx(smob_r, (T)1e-35)) * (T)INV_LN10_SNOW;
    smob = l_qs0 ? smob_r : (T)0;
    smo0 = l_qs0 ? field_moment(lg, tc0, FM0_M, FM0_M3) : (T)0;
    smo1 = l_qs0 ? field_moment(lg, tc0, FM1_M, FM1_M3) : (T)0;
    smoc = l_qs0 ? field_moment(lg, tc0, FMC_M, FMC_M3) : (T)0;
    smoe = l_qs0 ? field_moment(lg, tc0, FME_M, FME_M3) : (T)0;
    smof = l_qs0 ? field_moment(lg, tc0, FMF_M, FMF_M3) : (T)0;
  }
  if (!WARM) graupel_psd(rg0, temp0, l_qr0, mvd_r0, valid, sh, ilamg, n0_g);

  // phase 7: rain PSD (f90:1661-1666)
  T ilamr0, mvd_r, n0_r0;
  {
    T lamr = powc((T)(AM_R * CRG_3 * ORG2) * nr0 / rr0, OBMR);
    ilamr0 = (T)1 / lamr;
    mvd_r = (T)(3.0 + MU_R + 0.672) / lamr;
    n0_r0 = nr0 * (T)ORG2 * powc(lamr, CRE_2);
  }

  // cloud mvd (f90:1688-1694)
  T nu_c_f, xdc, mvd_c, dc_g;
  {
    int nu = trunc_int(mn(fnint((T)1000.0e6 / nc0) + (T)2, (T)15), (T)0,
                       (T)15);
    const T ccg2_n = (T)NUC_COEF[nu][1], ccg3_n = (T)NUC_COEF[nu][2];
    const T ocg1_n = (T)NUC_COEF[nu][3], ocg2_n = (T)NUC_COEF[nu][4];
    nu_c_f = (T)nu;
    xdc = mx(powc(rc0 / ((T)AM_R * nc0), OBMR) * (T)1.0e6, (T)(D0C * 1.0e6));
    T lamc = powc(nc0 * (T)AM_R * ccg2_n * ocg1_n / rc0, OBMR);
    mvd_c = l_qc0 ? ((T)3.0 + nu_c_f + (T)0.672) / lamc : (T)D0C;
    dc_g = powc(ccg3_n * ocg2_n, OBMR) / lamc * (T)1.0e6;
  }
  T xds = 0, ilami = 0, xdi = 0, oxmi = 0;
  if (!WARM) {
    xds = l_qs0 ? smoc / mx(smob, (T)1e-30) : (T)0;
    T lami = powc((T)(AM_I * CIG_2 * OIG1) * ni0 / ri0, OBMI);
    ilami = (T)1 / lami;
    xdi = mx((T)(BM_I + MU_I + 1.0) * ilami, (T)D0I);
    T xmi = (T)AM_I * powc(xdi, BM_I);
    oxmi = (T)1 / xmi;
  }

  // table-stage channels
  const T ef_rw = in(I_ef_rw);
  T ef_sw = 0, tide = 0;
  T prr_rcs = 0, prs_rcs = 0, prg_rcs = 0, pnr_rcs = 0;
  T prg_rcg = 0, prr_rcg = 0, pnr_rcg = 0;
  T prg_rfz = 0, pri_rfz = 0, pni_rfz = 0, pnr_rfz = 0;
  T pri_wfz = 0, pni_wfz = 0, prs_iau = 0, pni_iau = 0;
  if (!WARM) {
    ef_sw = in(I_ef_sw); tide = in(I_tide);
    prr_rcs = in(I_prr_rcs); prs_rcs = in(I_prs_rcs);
    prg_rcs = in(I_prg_rcs); pnr_rcs = in(I_pnr_rcs);
    prg_rcg = in(I_prg_rcg); prr_rcg = in(I_prr_rcg);
    pnr_rcg = in(I_pnr_rcg);
    prg_rfz = in(I_prg_rfz); pri_rfz = in(I_pri_rfz);
    pni_rfz = in(I_pni_rfz); pnr_rfz = in(I_pnr_rfz);
    pri_wfz = in(I_pri_wfz); pni_wfz = in(I_pni_wfz);
    prs_iau = in(I_prs_iau); pni_iau = in(I_pni_iau);
  }

  // ============ rates_and_tendencies (phases 8-11, f90:1676-2569) ==========
  const T temp = temp0, qv = qv0, rho = rho0;
  const T rc = rc0, nc = nc0, ri = ri0, ni = ni0, rr = rr0, nr = nr0;
  const T rs = rs0, rg = rg0;
  const T tempc = temp - (T)273.15;
  const bool l_qc = qc1d > (T)R1, l_qi = qi1d > (T)R1, l_qr = qr1d > (T)R1;
  const bool l_qs = qs1d > (T)R1, l_qg = qg1d > (T)R1;

  // phase 8: warm rain
  const T ef_rr =
      (T)1 - exp(mn((T)2300.0 * (mvd_r - (T)1950.0e-6), (T)50.0));
  const T pnr_rcr =
      (l_qr && mvd_r > (T)D0R) ? ef_rr * (T)2.0 * nr * rr : (T)0;
  const bool au = rc > (T)0.01e-3;
  const T dc_b = powc(
      relu(ipow(xdc, 3) * ipow(dc_g, 3) - ipow(xdc, 6)), 1.0 / 6.0);
  const T zeta1 = relu((T)6.25e-6 * xdc * ipow(dc_b, 3) - (T)0.4);
  const T zeta = (T)0.027 * rc * zeta1;
  const T taud = relu((T)0.5 * dc_b - (T)7.5) + (T)R1;
  const T tau = (T)3.72 / (rc * taud);
  T prr_wau = au ? mn(rc * odts, zeta / tau) : (T)0;
  const T pnr_wau =
      au ? prr_wau / ((T)AM_R * nu_c_f * (T)D0R_CUBED) : (T)0;
  const T pnc_wau =
      au ? mn(nc * odts, prr_wau / ((T)AM_R * ipow(mvd_c, 3))) : (T)0;

  const bool rcw = l_qr && mvd_r > (T)D0R && mvd_c > (T)D0C;
  T lamr = (T)1 / ilamr0;
  const T geo_r = powc(lamr + (T)FV_R, -CRE_9);
  T prr_rcw =
      rcw ? mn(rc * odts, rhof0 * (T)T1_QR_QC * ef_rw * rc * n0_r0 * geo_r)
          : (T)0;
  const T pnc_rcw =
      rcw ? mn(nc * odts, rhof0 * (T)T1_QR_QC * ef_rw * nc * n0_r0 * geo_r)
          : (T)0;

  // phase 9: ice-phase process rates
  T pnc_scw = 0, pnc_gcw = 0;
  T pri_inu = 0, pni_inu = 0, pri_ihm = 0, pni_ihm = 0;
  T pri_ide = 0, pni_ide = 0, prs_ide = 0;
  T pri_rci = 0, pni_rci = 0, prr_rci = 0, pnr_rci = 0, prg_rci = 0;
  T pni_sci = 0, prs_sci = 0;
  T prs_sde = 0, prs_scw = 0, prs_ihm = 0;
  T prg_scw = 0, prg_gde = 0, prg_gcw = 0, prg_ihm = 0;
  T prr_sml = 0, pnr_sml = 0, prr_gml = 0, pnr_gml = 0;
  T vts_boost = (T)1.5;
  if (!WARM) {
    const bool t_lt_0 = temp < (T)T_0;
    vts_boost = t_lt_0 ? (T)1 : (T)1.5;
    T t1_subl, rvs_i;
    subl_prefactor(temp, qvsi, rho, diffu0, tcond0, ssati, (T)LSUB,
                   (T)(-2.0 * LSUB), 4.0 * PI, t1_subl, rvs_i);

    // snow collecting cloud water (f90:1902-1913)
    const bool scw = l_qc && mvd_c > (T)D0C && xds > (T)D0S;
    prs_scw = scw ? rhof0 * (T)T1_QS_QC * ef_sw * rc * smoe : (T)0;
    pnc_scw = scw ? mn(nc * odts, rhof0 * (T)T1_QS_QC * ef_sw * nc * smoe)
                  : (T)0;

    // graupel collecting cloud water (f90:1915-1935)
    const T xdg = (T)(BM_G + MU_G + 1.0) * ilamg;
    const T g_bvg = powc(ilamg, BV_G);
    const T g_cge9 = g_bvg * powc(ilamg, 3.0);
    const T g_cge11 = sqrt(g_bvg * powc(ilamg, 5.0));
    const T vtg_loc = rhof0 * (T)AV_G * (T)CGG_6 * (T)OGG3 * g_bvg;
    const T stoke_g =
        mvd_c * mvd_c * vtg_loc * (T)RHO_W / ((T)9.0 * visco0 * xdg);
    const T ef_gw = stoke_g >= (T)0.4
                        ? (stoke_g <= (T)10.0
                               ? (T)0.55 * log10_((T)2.51 * stoke_g)
                               : (T)0.77)
                        : (T)0;
    const bool gcw =
        l_qc && mvd_c > (T)D0C && rg >= (T)RG1 && xdg > (T)D0G;
    const T geo_g = g_cge9;
    prg_gcw =
        gcw ? rhof0 * (T)T1_QG_QC * ef_gw * rc * n0_g * geo_g : (T)0;
    pnc_gcw = gcw ? mn(nc * odts, rhof0 * (T)T1_QG_QC * ef_gw * nc * n0_g *
                                      geo_g)
                  : (T)0;

    // below 0C (f90:2025-2231)
    const T rate_max_i = (qv - qvsi) * rho * odts * (T)0.999;
    const bool inu = t_lt_0 && ((ssati >= (T)0.25) ||
                                ((ssatw0 > (T)EPS) && (temp < (T)253.15)));
    const T xnc_inu =
        mn((T)TNO * exp((T)ATO * ((T)T_0 - temp)), (T)250.0e3);
    const T xni_now = ni + (pni_rfz + pni_wfz) * dt;
    const T pni_inu0 =
        (T)0.5 * (xnc_inu - xni_now + fabs(xnc_inu - xni_now)) * odts;
    pri_inu = inu ? mn(rate_max_i, (T)XM0I * pni_inu0) : (T)0;
    pni_inu = inu ? pri_inu / (T)XM0I : (T)0;

    // cloud-ice deposition/sublimation (f90:2115-2133)
    const T ide0 = (T)C_CUBE * t1_subl * diffu0 * ssati * rvs_i * (T)OIG1 *
                   (T)CIG_5 * ni * ilami;
    const T ide_neg = mx(mx(-ri * odts, ide0), rate_max_i);
    const T pni_ide_neg = mx(-ni * odts, ide_neg * oxmi);
    const T ide_pos = mn(ide0, rate_max_i);
    const bool ice_on = t_lt_0 && l_qi;
    pri_ide = ice_on ? (ide0 < (T)0 ? ide_neg : tide * ide_pos) : (T)0;
    pni_ide = (ice_on && ide0 < (T)0) ? pni_ide_neg : (T)0;
    prs_ide = (ice_on && ide0 >= (T)0) ? ((T)1 - tide) * ide_pos : (T)0;

    // snow deposition/sublimation (f90:2151-2164)
    const T c_snow =
        clampT((T)C_SQRD + (tempc + (T)1.5) * (T)(C_CUBE - C_SQRD) /
                               (T)(-30.0 + 1.5),
               (T)C_SQRD, (T)C_CUBE);
    const T sde0 = c_snow * t1_subl * diffu0 * ssati * rvs_i *
                   ((T)T1_QS_SD * smo1 + (T)T2_QS_SD * rhof20 * vsc20 * smof);
    const T prs_sde_cold = sde0 < (T)0
                               ? mx(mx(-rs * odts, sde0), rate_max_i)
                               : mn(sde0, rate_max_i);
    prs_sde = (t_lt_0 && l_qs) ? prs_sde_cold : (T)0;

    // graupel sublimation (f90:2166-2175)
    const T gde0 = (T)C_CUBE * t1_subl * diffu0 * ssati * rvs_i * n0_g *
                   ((T)T1_QG_SD * powc(ilamg, CGE_10) +
                    (T)T2_QG_SD * vsc20 * rhof20 * g_cge11);
    const T gde_lim = gde0 < (T)0 ? mx(mx(-rg * odts, gde0), rate_max_i)
                                  : mn(gde0, rate_max_i);
    prg_gde = (t_lt_0 && l_qg && ssati < (T)(-EPS)) ? gde_lim : (T)0;

    // snow collecting cloud ice (f90:2177-2187)
    const bool sci_on = ice_on && rs >= (T)RS1;
    prs_sci = sci_on ? (T)T1_QS_QI * rhof0 * (T)EF_SI * ri * smoe : (T)0;
    pni_sci = sci_on ? prs_sci * oxmi : (T)0;

    // rain collecting cloud ice (f90:2189-2201)
    const bool rci_on = ice_on && rr >= (T)RR1 && mvd_r > (T)4.0 * xdi;
    pri_rci = rci_on
                  ? rhof0 * (T)T1_QR_QI * (T)EF_RI * ri * n0_r0 * geo_r
                  : (T)0;
    pnr_rci = rci_on
                  ? rhof0 * (T)T1_QR_QI * (T)EF_RI * ni * n0_r0 * geo_r
                  : (T)0;
    pni_rci = rci_on ? pri_rci * oxmi : (T)0;
    prr_rci = rci_on ? mn(rr * odts, rhof0 * (T)T2_QR_QI * (T)EF_RI * ni *
                                         n0_r0 *
                                         powc(lamr + (T)FV_R, -CRE_8))
                     : (T)0;
    prg_rci = rci_on ? pri_rci + prr_rci : (T)0;

    // Hallett-Mossop (f90:2204-2218)
    const bool hm_on = t_lt_0 && prg_gcw > (T)EPS && tempc > (T)-8.0;
    const T tf = (tempc >= (T)-5.0 && tempc < (T)-3.0)
                     ? (T)0.5 * ((T)-3.0 - tempc)
                     : ((tempc > (T)-8.0 && tempc < (T)-5.0)
                            ? (T)0.33333333 * ((T)8.0 + tempc)
                            : (T)0);
    pni_ihm = hm_on ? (T)3.5e8 * tf * prg_gcw : (T)0;
    pri_ihm = hm_on ? (T)XM0I * pni_ihm : (T)0;
    const T hm_den = mx(prs_scw + prg_gcw, (T)1e-30);
    prs_ihm = hm_on ? prs_scw / hm_den * pri_ihm : (T)0;
    prg_ihm = hm_on ? prg_gcw / hm_den * pri_ihm : (T)0;

    // rimed snow -> graupel (f90:2220-2231)
    const bool conv =
        t_lt_0 && prs_scw > (T)2.0 * prs_sde && prs_sde > (T)EPS;
    const T r_frac = mn(prs_scw / mx(prs_sde, (T)1e-30), (T)30.0);
    const T g_frac = mn((T)0.15 + (r_frac - (T)2.0) * (T)0.028, (T)0.95);
    vts_boost = conv ? mn((T)1.1 + (r_frac - (T)2.0) * (T)0.016, (T)1.5)
                     : vts_boost;
    prg_scw = conv ? g_frac * prs_scw : (T)0;
    prs_scw = conv ? ((T)1 - g_frac) * prs_scw : prs_scw;

    // melting branch (f90:2235-2281)
    const bool melt = !t_lt_0;
    const T sml0 = (tempc * tcond0 - (T)LVAP0 * diffu0 * delqvs) *
                   ((T)T1_QS_ME * smo1 + (T)T2_QS_ME * rhof20 * vsc20 * smof);
    const T sml = mn(rs * odts, mx(sml0 + (T)(4218.0 * OLFUS) * tempc *
                                              (prr_rcs + prs_scw),
                                   (T)0));
    prr_sml = (melt && l_qs) ? sml : (T)0;
    pnr_sml = (melt && l_qs)
                  ? mn(smo0 * odts, smo0 / mx(rs, (T)R1) * prr_sml *
                                        exp10_((T)-0.25 * tempc))
                  : (T)0;
    prs_sde = (melt && l_qs && ssati < (T)0)
                  ? mx(-rs * odts,
                       (T)C_CUBE * t1_subl * diffu0 * ssati * rvs_i *
                           ((T)T1_QS_SD * smo1 +
                            (T)T2_QS_SD * rhof20 * vsc20 * smof))
                  : prs_sde;
    const T gml0 = (tempc * tcond0 - (T)LVAP0 * diffu0 * delqvs) * n0_g *
                   ((T)T1_QG_ME * powc(ilamg, CGE_10) +
                    (T)T2_QG_ME * rhof20 * vsc20 * g_cge11);
    prr_gml = (melt && l_qg) ? mn(rg * odts, mx(gml0, (T)0)) : (T)0;
    pnr_gml = (melt && l_qg) ? n0_g * (T)CGG_2 * powc(ilamg, CGE_2) /
                                   mx(rg, (T)R1) * prr_gml *
                                   exp10_((T)-0.5 * tempc)
                             : (T)0;
    prg_gde = (melt && l_qg && ssati < (T)0) ? mx(-rg * odts, gde0)
                                             : prg_gde;
    if (dt_d > 120.0 && melt) {
      prr_rcw = prr_rcw + prs_scw + prg_gcw;
      prs_scw = (T)0;
      prg_gcw = (T)0;
    }
  }

  // phase 10: conservation ratio-clamps (f90:2291-2387)
  {
    T sump = pri_inu + pri_ide + prs_ide + prs_sde + prg_gde;
    T rate_max = (qv - qvsi) * odts * (T)0.999;
    bool bad = ((sump > (T)EPS) && (sump > rate_max)) ||
               ((sump < (T)(-EPS)) && (sump < rate_max));
    T ratio = rate_max / (bad ? sump : (T)1);
    if (bad) {
      pri_inu = pri_inu * ratio; pri_ide = pri_ide * ratio;
      pni_ide = pni_ide * ratio; prs_ide = prs_ide * ratio;
      prs_sde = prs_sde * ratio; prg_gde = prg_gde * ratio;
    }
    sump = -prr_wau - pri_wfz - prr_rcw - prs_scw - prg_scw - prg_gcw;
    rate_max = -rc * odts;
    bad = (sump < rate_max) && l_qc;
    ratio = rate_max / (bad ? sump : (T)1);
    if (bad) {
      prr_wau = prr_wau * ratio; pri_wfz = pri_wfz * ratio;
      prr_rcw = prr_rcw * ratio; prs_scw = prs_scw * ratio;
      prg_scw = prg_scw * ratio; prg_gcw = prg_gcw * ratio;
    }
    sump = pri_ide - prs_iau - prs_sci - pri_rci;
    rate_max = -ri * odts;
    bad = (sump < rate_max) && l_qi;
    ratio = rate_max / (bad ? sump : (T)1);
    if (bad) {
      pri_ide = pri_ide * ratio; prs_iau = prs_iau * ratio;
      prs_sci = prs_sci * ratio; pri_rci = pri_rci * ratio;
    }
    sump = -prg_rfz - pri_rfz - prr_rci + prr_rcs + prr_rcg;
    rate_max = -rr * odts;
    bad = (sump < rate_max) && l_qr;
    ratio = rate_max / (bad ? sump : (T)1);
    if (bad) {
      prg_rfz = prg_rfz * ratio; pri_rfz = pri_rfz * ratio;
      prr_rci = prr_rci * ratio; prr_rcs = prr_rcs * ratio;
      prr_rcg = prr_rcg * ratio;
    }
    sump = prs_sde - prs_ihm - prr_sml + prs_rcs;
    rate_max = -rs * odts;
    bad = (sump < rate_max) && l_qs;
    ratio = rate_max / (bad ? sump : (T)1);
    if (bad) {
      prs_sde = prs_sde * ratio; prs_ihm = prs_ihm * ratio;
      prr_sml = prr_sml * ratio; prs_rcs = prs_rcs * ratio;
    }
    sump = prg_gde - prg_ihm - prr_gml + prg_rcg;
    rate_max = -rg * odts;
    bad = (sump < rate_max) && l_qg;
    ratio = rate_max / (bad ? sump : (T)1);
    if (bad) {
      prg_gde = prg_gde * ratio; prg_ihm = prg_ihm * ratio;
      prr_gml = prr_gml * ratio; prg_rcg = prg_rcg * ratio;
    }
    // symmetry re-enforcement (f90:2375-2385)
    pri_ihm = prs_ihm + prg_ihm;
    T pair = mn(fabs(prr_rcg), fabs(prg_rcg));
    prr_rcg = pair * sgn(prr_rcg);
    prg_rcg = -prr_rcg;
    const bool warm_lvl = temp > (T)T_0;
    pair = mn(fabs(prr_rcs), fabs(prs_rcs));
    prr_rcs = warm_lvl ? pair * sgn(prr_rcs) : prr_rcs;
    prs_rcs = warm_lvl ? -prr_rcs : prs_rcs;
  }

  // phase 11: tendency assembly + number clamps (f90:2393-2569)
  T tten, qvten, qcten, ncten, qiten, niten, qrten, nrten, qsten, qgten;
  T nwfaten = (T)0;
  const T nifaten = (T)0;
  {
    const T orho = (T)1 / rho;
    const T lfus2 = (T)LSUB - lvap0;
    qvten = (-pri_inu - pri_ide - prs_ide - prs_sde - prg_gde) * orho;
    qcten = (-prr_wau - pri_wfz - prr_rcw - prs_scw - prg_scw - prg_gcw) *
            orho;
    ncten = (-pnc_wau - pnc_rcw - pni_wfz - pnc_scw - pnc_gcw) * orho;

    T xrc = mx((qc1d + qcten * dt) * rho, (T)R1);
    T xnc = mx((nc1d + ncten * dt) * rho, (T)2.0);
    int nu = trunc_int(mn(fnint((T)1000.0e6 / xnc) + (T)2, (T)15), (T)0,
                       (T)15);
    const T ccg1_n = (T)NUC_COEF[nu][0], ccg2_n = (T)NUC_COEF[nu][1];
    const T ocg1_n = (T)NUC_COEF[nu][3], ocg2_n = (T)NUC_COEF[nu][4];
    const T cce2_n = (T)NUC_COEF[nu][5];
    T lamc = powc(xnc * (T)AM_R * ccg2_n * ocg1_n / rc, OBMR);
    T xdc2 = ((T)BM_R + (T)nu + (T)1.0) / lamc;
    T lamc_lo = cce2_n / (T)D0C;
    T lamc_hi = cce2_n / (T)(D0R * 2.0);
    T xnc_lo = ccg1_n * ocg2_n * xrc / (T)AM_R * powc(lamc_lo, BM_R);
    T xnc_hi = ccg1_n * ocg2_n * xrc / (T)AM_R * powc(lamc_hi, BM_R);
    ncten = xrc > (T)R1
                ? (xdc2 < (T)D0C
                       ? (xnc_lo - nc1d * rho) * odts * orho
                       : (xdc2 > (T)(D0R * 2.0)
                              ? (xnc_hi - nc1d * rho) * odts * orho
                              : ncten))
                : -nc1d * odts;
    xnc = mx((nc1d + ncten * dt) * rho, (T)0);
    ncten = xnc > (T)NT_C_MAX ? ((T)NT_C_MAX - nc1d * rho) * odts * orho
                              : ncten;

    qiten = (pri_inu + pri_ihm + pri_wfz + pri_rfz + pri_ide - prs_iau -
             prs_sci - pri_rci) * orho;
    niten = (pni_inu + pni_ihm + pni_wfz + pni_rfz + pni_ide - pni_iau -
             pni_sci - pni_rci) * orho;

    T xri = mx((qi1d + qiten * dt) * rho, (T)R1);
    T xni = mx((ni1d + niten * dt) * rho, (T)R2);
    T lami = powc((T)(AM_I * CIG_2 * OIG1) * xni / xri, OBMI);
    T xdi2 = (T)(BM_I + MU_I + 1.0) / lami;
    T xni_lo =
        mn((T)(CIG_1 * OIG2) * xri / (T)AM_I * (T)P_ICE_5, (T)499.0e3);
    T xni_hi = (T)(CIG_1 * OIG2) * xri / (T)AM_I * (T)P_ICE_300;
    niten = xri > (T)R1
                ? (xdi2 < (T)5.0e-6
                       ? (xni_lo - ni1d * rho) * odts * orho
                       : (xdi2 > (T)300.0e-6
                              ? (xni_hi - ni1d * rho) * odts * orho
                              : niten))
                : -ni1d * odts;
    xni = mx((ni1d + niten * dt) * rho, (T)0);
    niten = xni > (T)499.0e3 ? ((T)499.0e3 - ni1d * rho) * odts * orho
                             : niten;

    qrten = (prr_wau + prr_rcw + prr_sml + prr_gml + prr_rcs + prr_rcg -
             prg_rfz - pri_rfz - prr_rci) * orho;
    nrten = (pnr_wau + pnr_sml + pnr_gml -
             (pnr_rfz + pnr_rcr + pnr_rcg + pnr_rcs + pnr_rci)) * orho;

    T xrr = mx((qr1d + qrten * dt) * rho, (T)R1);
    T xnr = mx((nr1d + nrten * dt) * rho, (T)R2);
    T lamr_b = powc((T)(AM_R * CRG_3 * ORG2) * xnr / xrr, OBMR);
    T mvd_b = (T)(3.0 + MU_R + 0.672) / lamr_b;
    T xnr_hi = nr_from_mvd(xrr, 2.5e-3);
    T xnr_lo = nr_from_mvd(xrr, D0R * 0.75);
    const bool has_rain_after = (qr1d + qrten * dt) * rho > (T)R1;
    nrten = has_rain_after
                ? (mvd_b > (T)2.5e-3
                       ? (xnr_hi - nr1d * rho) * odts * orho
                       : (mvd_b < (T)(D0R * 0.75)
                              ? (xnr_lo - nr1d * rho) * odts * orho
                              : nrten))
                : -nr1d * odts;
    qrten = has_rain_after ? qrten : -qr1d * odts;
    mvd_r = has_rain_after ? clampT(mvd_b, (T)(D0R * 0.75), (T)2.5e-3)
                           : mvd_r;

    qsten = (prs_iau + prs_sde + prs_sci + prs_scw + prs_rcs + prs_ide -
             prs_ihm - prr_sml) * orho;
    qgten = (prg_scw + prg_rfz + prg_gde + prg_rcg + prg_gcw + prg_rci +
             prg_rcs - prg_ihm - prr_gml) * orho;

    const T tten_cold =
        ((T)LSUB * ocp0 * (pri_inu + pri_ide + prs_ide + prs_sde + prg_gde) +
         lfus2 * ocp0 * (pri_wfz + pri_rfz + prg_rfz + prs_scw + prg_scw +
                         prg_gcw + prg_rcs + prs_rcs + prr_rci + prg_rcg)) *
        orho * ifdry;
    const T tten_warm =
        ((T)LFUS * ocp0 * (-prr_sml - prr_gml - prr_rcg - prr_rcs) +
         (T)LSUB * ocp0 * (prs_sde + prg_gde)) *
        orho * ifdry;
    tten = temp < (T)T_0 ? tten_cold : tten_warm;
  }

  if (RATES && valid) {
    T* d = y + 12 * plane + off;
    d[D_prr_wau * plane] = prr_wau; d[D_prr_rcw * plane] = prr_rcw;
    d[D_pnr_wau * plane] = pnr_wau; d[D_pnr_rcr * plane] = pnr_rcr;
    d[D_pri_inu * plane] = pri_inu; d[D_pri_ide * plane] = pri_ide;
    d[D_prs_ide * plane] = prs_ide; d[D_prs_sde * plane] = prs_sde;
    d[D_prg_gde * plane] = prg_gde; d[D_pri_wfz * plane] = pri_wfz;
    d[D_prs_scw * plane] = prs_scw; d[D_prg_scw * plane] = prg_scw;
    d[D_prg_gcw * plane] = prg_gcw; d[D_pri_ihm * plane] = pri_ihm;
    d[D_pri_rfz * plane] = pri_rfz; d[D_prs_iau * plane] = prs_iau;
    d[D_prs_sci * plane] = prs_sci; d[D_pri_rci * plane] = pri_rci;
    d[D_pni_inu * plane] = pni_inu; d[D_pni_ihm * plane] = pni_ihm;
    d[D_pni_wfz * plane] = pni_wfz; d[D_pni_rfz * plane] = pni_rfz;
    d[D_pni_ide * plane] = pni_ide; d[D_pni_iau * plane] = pni_iau;
    d[D_pni_sci * plane] = pni_sci; d[D_pni_rci * plane] = pni_rci;
    d[D_prr_sml * plane] = prr_sml; d[D_pnr_rcs * plane] = pnr_rcs;
    d[D_pnr_rcg * plane] = pnr_rcg; d[D_pnr_rci * plane] = pnr_rci;
    d[D_pnr_sml * plane] = pnr_sml; d[D_pnr_gml * plane] = pnr_gml;
    d[D_pnr_rfz * plane] = pnr_rfz; d[D_prr_gml * plane] = prr_gml;
  }

  // ================= _post_rates (phases 12-20, f90:2574-3686) ============
  // phase 12: provisional state at t+dt
  T temp2 = t1d + dt * tten;
  T tempc2 = temp2 - (T)273.15;
  T qv2 = mx(qv1d + dt * qvten, (T)1.0e-10);
  T rho2 = (T)0.622 * pres / ((T)R_GAS * temp2 * (qv2 + (T)0.622));
  T qvs2 = rslf(pres, temp2);
  T ssatw2 = qv2 / qvs2 - (T)1;
  ssatw2 = fabs(ssatw2) < (T)EPS ? (T)0 : ssatw2;
  T lvap2 = (T)LVAP0 + (T)(2106.0 - 4218.0) * tempc2;
  T ocp2 = (T)1 / ((T)CP * ((T)1 + (T)0.887 * qv2));
  const T otemp2 = (T)1 / temp2;
  const T lvt2 = lvap2 * lvap2 * ocp2 * (T)ORV * otemp2 * otemp2;

  const bool l_qc2 = (qc1d + qcten * dt) > (T)R1;
  T rc2 = l_qc2 ? (qc1d + qcten * dt) * rho2 : (T)R1;
  T nc2 = l_qc2 ? nt_c : (T)2.0;
  const bool l_qi2 = (qi1d + qiten * dt) > (T)R1;
  T ri2 = l_qi2 ? (qi1d + qiten * dt) * rho2 : (T)R1;
  T ni2 = l_qi2 ? mx((ni1d + niten * dt) * rho2, (T)R2) : (T)R2;
  const bool l_qr2 = (qr1d + qrten * dt) > (T)R1;
  T rr2 = l_qr2 ? (qr1d + qrten * dt) * rho2 : (T)R1;
  T nr2;
  {
    T nr_a = mx((nr1d + nrten * dt) * rho2, (T)R2);
    T lamr_a = powc((T)(AM_R * CRG_3 * ORG2) * nr_a / rr2, OBMR);
    T mvd0 = (T)(3.0 + MU_R + 0.672) / lamr_a;
    T nr_b = mvd0 > (T)2.5e-3
                 ? nr_from_mvd(rr2, 2.5e-3)
                 : (mvd0 < (T)(D0R * 0.75) ? nr_from_mvd(rr2, D0R * 0.75)
                                           : nr_a);
    nr2 = l_qr2 ? nr_b : (T)R2;
    mvd_r = l_qr2 ? clampT(mvd0, (T)(D0R * 0.75), (T)2.5e-3) : mvd_r;
  }
  const bool l_qs2 = (qs1d + qsten * dt) > (T)R1;
  T rs2 = l_qs2 ? (qs1d + qsten * dt) * rho2 : (T)R1;
  const bool l_qg2 = (qg1d + qgten * dt) > (T)R1;
  T rg2 = l_qg2 ? (qg1d + qgten * dt) * rho2 : (T)R1;

  // phase 13: recompute snow moments / graupel / rain PSD
  if (!WARM) {
    T tc0 = mn(temp2 - (T)273.15, (T)-0.1);
    T smob_r = rs2 * (T)OAMS;
    T lg = log(mx(smob_r, (T)1e-35)) * (T)INV_LN10_SNOW;
    T sm_b = l_qs2 ? smob_r : (T)0;
    T sm_c = l_qs2 ? field_moment(lg, tc0, FMC_M, FMC_M3) : (T)0;
    smob = l_qs2 ? sm_b : smob;
    smoc = l_qs2 ? sm_c : smoc;
    graupel_psd(rg2, temp2, l_qr2, mvd_r, valid, sh, ilamg, n0_g);
  }
  T ilamr2, n0_r2;
  {
    T lamr_a = powc((T)(AM_R * CRG_3 * ORG2) * nr2 / rr2, OBMR);
    ilamr2 = (T)1 / lamr_a;
    n0_r2 = nr2 * (T)ORG2 * powc(lamr_a, CRE_2);
  }

  // phase 14: saturation adjustment + droplet nucleation
  T orho2 = (T)1 / rho2;
  const bool sat_mask =
      (ssatw2 > (T)EPS) || ((ssatw2 < (T)(-EPS)) && l_qc2);
  T clap = (qv2 - qvs2) / ((T)1 + lvt2 * qvs2);
  for (int it = 0; it < 3; ++it) {
    T ex = exp(clampT(lvt2 * clap, (T)-50.0, (T)50.0));
    T fcd = qvs2 * ex - qv2 + clap;
    T dfcd = qvs2 * lvt2 * ex + (T)1;
    clap = clap - fcd / dfcd;
  }
  const T xrc3 = rc2 + clap * rho2;
  const T prw_vcd_pos = clap * odt;
  const T pnc_wcd_pos =
      clap > (T)EPS
          ? (T)0.5 * (nt_c - nc2 + fabs(nt_c - nc2)) * odts * orho2
          : (T)0;
  T prw_vcd = xrc3 > (T)R1 ? prw_vcd_pos : -rc2 * orho2 * odt;
  T pnc_wcd = xrc3 > (T)R1 ? pnc_wcd_pos : -nc2 * orho2 * odt;
  prw_vcd = sat_mask ? prw_vcd : (T)0;
  pnc_wcd = sat_mask ? pnc_wcd : (T)0;
  qvten = qvten - prw_vcd;
  qcten = qcten + prw_vcd;
  ncten = ncten + pnc_wcd;
  nwfaten = nwfaten - pnc_wcd;
  tten = tten + lvap2 * ocp2 * prw_vcd * ifdry;
  {
    T rc_n = mx((qc1d + dt * qcten) * rho2, (T)R1);
    T qv_n = mx(qv1d + dt * qvten, (T)1.0e-10);
    T temp_n = t1d + dt * tten;
    rc2 = sat_mask ? rc_n : rc2;
    nc2 = sat_mask ? nt_c : nc2;
    qv2 = sat_mask ? qv_n : qv2;
    temp2 = sat_mask ? temp_n : temp2;
    rho2 = sat_mask
               ? (T)0.622 * pres / ((T)R_GAS * temp2 * (qv2 + (T)0.622))
               : rho2;
    qvs2 = sat_mask ? rslf(pres, temp2) : qvs2;
    ssatw2 = sat_mask ? qv2 / qvs2 - (T)1 : ssatw2;
  }

  // phase 15: rain evaporation (f90:2880-2960)
  const bool rev_mask = (ssatw2 < (T)(-EPS)) && l_qr2 && !(prw_vcd > (T)0);
  T prv_rev, pnr_rev;
  {
    tempc2 = temp2 - (T)273.15;
    orho2 = (T)1 / rho2;
    T rhof2_c = sqrt(sqrt((T)RHO_NOT * orho2));
    T diffu_c =
        (T)2.11e-5 * powc(temp2 / (T)273.15, 1.94) * ((T)101325.0 / pres);
    T visco_c =
        tempc2 >= (T)0
            ? ((T)1.718 + (T)0.0049 * tempc2) * (T)1.0e-5
            : ((T)1.718 + (T)0.0049 * tempc2 -
               (T)1.2e-5 * ipow(tempc2, 2)) * (T)1.0e-5;
    T vsc2_c = sqrt(rho2 / visco_c);
    T lvap_c = (T)LVAP0 + (T)(2106.0 - 4218.0) * tempc2;
    T tcond_c = ((T)5.69 + (T)0.0168 * tempc2) * (T)1.0e-5 * (T)418.936;
    T ocp_c = (T)1 / ((T)CP * ((T)1 + (T)0.887 * qv2));
    lvap2 = rev_mask ? lvap_c : lvap2;
    ocp2 = rev_mask ? ocp_c : ocp2;
    T t1_evap, rvs_w;
    subl_prefactor(temp2, qvs2, rho2, diffu_c, tcond_c,
                   mn(ssatw2, (T)-1.0e-9), lvap_c, (T)-2.0 * lvap_c,
                   2.0 * PI, t1_evap, rvs_w);
    T lamr_e = (T)1 / ilamr2;
    const bool quick =
        (qv2 / qvs2 < (T)0.95) && (rr2 * orho2 <= (T)1.0e-8);
    T rev0 = t1_evap * diffu_c * (-ssatw2) * n0_r2 * rvs_w *
             ((T)T1_QR_EV * powc(ilamr2, CRE_10) +
              (T)T2_QR_EV * vsc2_c * rhof2_c *
                  powc(lamr_e + (T)(0.5 * FV_R), -CRE_11));
    T rate_max = mn(rr2 * orho2 * odts, (qvs2 - qv2) * odts);
    T rev1 = mn(rate_max, rev0 * orho2);
    T eva_factor = prr_gml > (T)0
                       ? mn((T)0.01 + (T)0.98 * (tempc2 / (T)20.0), (T)1)
                       : (T)1;
    prv_rev = rev_mask ? (quick ? rr2 * orho2 * odts : rev1 * eva_factor)
                       : (T)0;
    pnr_rev = rev_mask ? mn(nr2 * (T)0.99 * orho2 * odts,
                            prv_rev * nr2 / mx(rr2, (T)R1))
                       : (T)0;
    qrten = qrten - prv_rev;
    qvten = qvten + prv_rev;
    nrten = nrten - pnr_rev;
    nwfaten = nwfaten + pnr_rev;
    tten = tten - lvap2 * ocp2 * prv_rev * ifdry;
    rr2 = rev_mask ? mx((qr1d + dt * qrten) * rho2, (T)R1) : rr2;
    qv2 = rev_mask ? mx(qv1d + dt * qvten, (T)1.0e-10) : qv2;
    nr2 = rev_mask ? mx((nr1d + dt * nrten) * rho2, (T)R2) : nr2;
    temp2 = rev_mask ? t1d + dt * tten : temp2;
    rho2 = rev_mask
               ? (T)0.622 * pres / ((T)R_GAS * temp2 * (qv2 + (T)0.622))
               : rho2;
  }

  // phases 17+18: terminal velocities + substepped sedimentation
  const T odzq = (T)1 / dzq;
  const T orho3 = (T)1 / rho2;
  const T rhof3 = sqrt((T)RHO_NOT / rho2);
  T pptrain, pptice = 0, pptsnow = 0, pptgraul = 0;
  T vtrk;
  {
    const bool valid_r = valid && rr2 > (T)R1;
    T lamr_s = powc((T)(AM_R * CRG_3 * ORG2) * nr2 / rr2, OBMR);
    T vtr_m = rhof3 * (T)AV_R * (T)CRG_6 * (T)ORG3 * powc(lamr_s, CRE_3) *
              powc(lamr_s + (T)FV_R, -CRE_6);
    T vtr_n = rhof3 * (T)AV_R * (T)CRG_7 / (T)CRG_12 *
              powc(lamr_s, CRE_12) * powc(lamr_s + (T)FV_R, -CRE_7);
    vtrk = fill_down(vtr_m, valid_r, sh);
    T vtnrk = fill_down(vtr_n, valid_r, sh);
    T vmax_r = mx(vtrk, vtnrk);
    sweep<T, true>(vmax_r, vtrk, vtnrk, qrten, nrten, rr2, nr2, (T)R1,
                   (T)R2, (T)1, orho3, odzq, dt, valid, nz, sh, pptrain);
  }
  if (!WARM) {
    const T gate = l_sediment ? (T)1 : (T)0;
    {
      const bool valid_i = valid && ri2 > (T)R1;
      T lami = powc((T)(AM_I * CIG_2 * OIG1) * ni2 / ri2, OBMI);
      T ilami2 = (T)1 / lami;
      T vti_m = rhof3 * (T)AV_I * (T)CIG_3 * (T)OIG2 * powc(ilami2, BV_I);
      T vti_n = rhof3 * (T)AV_I * (T)CIG_6 / (T)CIG_7 * powc(ilami2, BV_I);
      T vtik = fill_down(vti_m, valid_i, sh);
      T vtnik = fill_down(vti_n, valid_i, sh);
      sweep<T, true>(vtik, vtik, vtnik, qiten, niten, ri2, ni2, (T)R1,
                     (T)R2, gate, orho3, odzq, dt, valid, nz, sh, pptice);
    }
    {
      const bool valid_s = valid && rs2 > (T)R1;
      T xds2 = smoc / mx(smob, (T)1e-30);
      T mrat = (T)1 / mx(xds2, (T)1e-30);
      T ils1 = (T)1 / (mrat * (T)LAM0 + (T)FV_S);
      T ils2 = (T)1 / (mrat * (T)LAM1 + (T)FV_S);
      T t1v = (T)(KAP0 * CSG_4) * powc(ils1, CSE_4);
      T t2v = (T)KAP1 * powc(mrat, MU_S) * (T)CSG_10 * powc(ils2, CSE_10);
      ils1 = (T)1 / (mrat * (T)LAM0);
      ils2 = (T)1 / (mrat * (T)LAM1);
      T t3v = (T)(KAP0 * CSG_1) * powc(ils1, CSE_1);
      T t4v = (T)KAP1 * powc(mrat, MU_S) * (T)CSG_7 * powc(ils2, CSE_7);
      T vts = rhof3 * (T)AV_S * (t1v + t2v) / (t3v + t4v);
      T vts_melt = mx(vts * vts_boost,
                      vts * ((vtrk - vts * vts_boost) / (temp2 - (T)T_0)));
      T vts_eff = temp2 > (T)(T_0 + 0.1) ? vts_melt : vts * vts_boost;
      T vtsk = fill_down(vts_eff, valid_s, sh);
      T dummy_t = 0, dummy_n = 0;
      sweep<T, false>(vtsk, vtsk, (T)0, qsten, dummy_t, rs2, dummy_n, (T)R1,
                      (T)R1, gate, orho3, odzq, dt, valid, nz, sh, pptsnow);
    }
    {
      const bool valid_g = valid && rg2 > (T)R1;
      T vtg = rhof3 * (T)AV_G * (T)CGG_6 * (T)OGG3 * powc(ilamg, BV_G);
      T vtg_eff = temp2 > (T)T_0 ? mx(vtg, vtrk) : vtg;
      T vtgk = fill_down(vtg_eff, valid_g, sh);
      T dummy_t = 0, dummy_n = 0;
      sweep<T, false>(vtgk, vtgk, (T)0, qgten, dummy_t, rg2, dummy_n, (T)R1,
                      (T)R1, gate, orho3, odzq, dt, valid, nz, sh, pptgraul);
    }
  }

  // phase 19: instant melt / instant freeze (f90:3584-3606)
  if (!WARM) {
    T xri = mx(qi1d + qiten * dt, (T)0);
    bool melt_i = (temp2 > (T)T_0) && (xri > (T)0);
    qcten = qcten + (melt_i ? xri * odt : (T)0);
    ncten = ncten + (melt_i ? ni1d * odt : (T)0);
    qiten = qiten - (melt_i ? xri * odt : (T)0);
    niten = melt_i ? -ni1d * odt : niten;
    tten = tten - (melt_i ? (T)LFUS * ocp2 * xri * odt * ifdry : (T)0);

    T xrc2 = mx(qc1d + qcten * dt, (T)0);
    bool frz_c = (temp2 < (T)HGFR) && (xrc2 > (T)0);
    T lfus2 = (T)LSUB - lvap2;
    T xnc2 = nc1d + ncten * dt;
    qiten = qiten + (frz_c ? xrc2 * odt : (T)0);
    niten = niten + (frz_c ? xnc2 * odt : (T)0);
    qcten = qcten - (frz_c ? xrc2 * odt : (T)0);
    ncten = ncten - (frz_c ? xnc2 * odt : (T)0);
    tten = tten + (frz_c ? lfus2 * ocp2 * xrc2 * odt * ifdry : (T)0);
  }

  // phase 20: apply tendencies, final PSD renorm (f90:3623-3686)
  T t_out = t1d + tten * dt;
  T qv_out = mx(qv1d + qvten * dt, (T)1.0e-10);
  T qc_out = qc1d + qcten * dt;
  T nc_out = mx(nc1d + ncten * dt, (T)2.0 / rho2);
  T nwfa_out = mn(mx(nwfa1d + nwfaten * dt, (T)11.1e6 / rho2),
                  (T)9999.0e6 / rho2);
  T nifa_out = mn(mx(nifa1d + nifaten * dt, (T)(NA_IN1 * 0.01)),
                  (T)9999.0e6 / rho2);
  {
    const bool has_c = qc_out > (T)R1;
    int nu = trunc_int(
        mn(fnint((T)1000.0e6 / mx(nc_out * rho2, (T)1.0)) + (T)2, (T)15),
        (T)0, (T)15);
    const T ccg1_n = (T)NUC_COEF[nu][0], ccg2_n = (T)NUC_COEF[nu][1];
    const T ocg1_n = (T)NUC_COEF[nu][3], ocg2_n = (T)NUC_COEF[nu][4];
    const T cce2_n = (T)NUC_COEF[nu][5];
    T lamc = powc((T)AM_R * ccg2_n * ocg1_n * nc_out / mx(qc_out, (T)R1),
                  OBMR);
    T xdc3 = ((T)BM_R + (T)nu + (T)1.0) / lamc;
    lamc = xdc3 < (T)D0C
               ? cce2_n / (T)D0C
               : (xdc3 > (T)(D0R * 2.0) ? cce2_n / (T)(D0R * 2.0) : lamc);
    T nc_renorm = mn(ccg1_n * ocg2_n * qc_out / (T)AM_R * powc(lamc, BM_R),
                     (T)NT_C_MAX / rho2);
    qc_out = has_c ? qc_out : (T)0;
    nc_out = has_c ? nc_renorm : (T)0;
  }
  T qi_out = qi1d + qiten * dt;
  T ni_out = mx(ni1d + niten * dt, (T)R2 / rho2);
  {
    const bool has_i = qi_out > (T)R1;
    T lami = powc((T)(AM_I * CIG_2 * OIG1) * ni_out / mx(qi_out, (T)R1),
                  OBMI);
    T xdi3 = (T)(BM_I + MU_I + 1.0) / lami;
    lami = xdi3 < (T)5.0e-6
               ? (T)(CIE_2 / 5.0e-6)
               : (xdi3 > (T)300.0e-6 ? (T)(CIE_2 / 300.0e-6) : lami);
    T ni_renorm = mn((T)(CIG_1 * OIG2) * qi_out / (T)AM_I * powc(lami, BM_I),
                     (T)499.0e3 / rho2);
    qi_out = has_i ? qi_out : (T)0;
    ni_out = has_i ? ni_renorm : (T)0;
  }
  T qr_out = qr1d + qrten * dt;
  T nr_out = mx(nr1d + nrten * dt, (T)R2 / rho2);
  {
    const bool has_r = qr_out > (T)R1;
    T lamr_f = powc((T)(AM_R * CRG_3 * ORG2) * nr_out / mx(qr_out, (T)R1),
                    OBMR);
    T mvd_f = clampT((T)(3.0 + MU_R + 0.672) / lamr_f, (T)(D0R * 0.75),
                     (T)2.5e-3);
    lamr_f = (T)(3.0 + MU_R + 0.672) / mvd_f;
    T nr_renorm =
        (T)(CRG_2 * ORG3) * qr_out * powc(lamr_f, BM_R) / (T)AM_R;
    qr_out = has_r ? qr_out : (T)0;
    nr_out = has_r ? nr_renorm : (T)0;
  }
  T qs_out = qs1d + qsten * dt;
  qs_out = qs_out > (T)R1 ? qs_out : (T)0;
  T qg_out = qg1d + qgten * dt;
  qg_out = qg_out > (T)R1 ? qg_out : (T)0;

  if (valid) {
    T* o = y + off;
    o[I_t * plane] = t_out;
    o[I_qv * plane] = qv_out;
    o[I_qc * plane] = qc_out;
    o[I_qi * plane] = qi_out;
    o[I_qr * plane] = qr_out;
    o[I_qs * plane] = qs_out;
    o[I_qg * plane] = qg_out;
    o[I_ni * plane] = ni_out;
    o[I_nr * plane] = nr_out;
    o[I_nc * plane] = nc_out;
    o[I_nwfa * plane] = nwfa_out;
    o[I_nifa * plane] = nifa_out;
    if (RATES) {
      T* d = y + 12 * plane + off;
      d[D_prv_rev * plane] = prv_rev;
      d[D_pnr_rev * plane] = pnr_rev;
    }
  }
  if (k == 0) {
    ppt_out[0 * (size_t)ncol + col] = pptrain;
    ppt_out[1 * (size_t)ncol + col] = pptsnow;
    ppt_out[2 * (size_t)ncol + col] = pptgraul;
    ppt_out[3 * (size_t)ncol + col] = pptice;
  }
}

template <typename T>
int launch(const T* x, T* y, T* ppt, int ncol, int nz, int iiwarm,
           int want_rates, int l_sediment, double nt_c, double dt,
           double ifdry, void* stream) {
  if (nz < 2 || nz > kMaxThreads || ncol < 1) return (int)cudaErrorInvalidValue;
  const int threads = (nz + 31) / 32 * 32;
  const dim3 grid(ncol), block(threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (iiwarm) {
    if (want_rates)
      fused_step_kernel<T, true, true><<<grid, block, 0, s>>>(
          x, y, ppt, ncol, nz, l_sediment, nt_c, dt, ifdry);
    else
      fused_step_kernel<T, true, false><<<grid, block, 0, s>>>(
          x, y, ppt, ncol, nz, l_sediment, nt_c, dt, ifdry);
  } else {
    if (want_rates)
      fused_step_kernel<T, false, true><<<grid, block, 0, s>>>(
          x, y, ppt, ncol, nz, l_sediment, nt_c, dt, ifdry);
    else
      fused_step_kernel<T, false, false><<<grid, block, 0, s>>>(
          x, y, ppt, ncol, nz, l_sediment, nt_c, dt, ifdry);
  }
  return (int)cudaGetLastError();
}

}  // namespace

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
