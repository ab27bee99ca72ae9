// Thompson09 microphysics for one cell of a column, as device stage
// functions shared by the kernels of this directory:
//
//   table_stage.cu  prologue -> lookup indices -> table gathers and the
//                   rates that consume them (the tv channels)
//   fused_step.cu   prologue -> rates -> post   (non-aerosol, phases 2-20)
//   fused_rates.cu  prologue -> rates, store p8 (aerosol, phases 2-11)
//   fused_post.cu   prologue, load p8 and the phase-14 lookups -> post
//                   (aerosol, phases 12-20)
//   lookup_stage.cu the phase-14 lookups between fused_rates.cu and
//                   fused_post.cu (aerosol; rslf, powc, subl_prefactor
//                   and decade_index below, one thread a cell)
//   fused_kid_step.cu  advection, Exner map, prologue -> rates -> post
//   advect.cu       the driver step's advection and provisional state
//                   (only the MUSCL helpers below: vanleer, face_value)
//
// The stages transcribe kid_tpu_torch/micro/solver.py expression by
// expression, in the same association order: ``prologue`` is
// ``_prologue`` (phases 2-7), ``rates`` is ``rates_and_tendencies``
// (phases 8-11) and ``post`` is ``_post_rates`` (phases 12-20).  Every
// literal and constant is cast to scalar_t (T) where it meets a tensor
// value; leading products of constants are folded in double first, as
// Python folds them before they meet a tensor.  The AERO template flag
// adds the aerosol-aware branches; with AERO false the arithmetic is the
// non-aerosol kernel's, bit for bit.
//
// Mapping (every kernel but advect.cu, whose own notes give its tiles):
// one thread block per column, one thread per level (blockDim = nz
// rounded up to 32, so at most 8 warps); padding
// threads mirror the top level and store nothing.  Elementwise phases run
// per thread in registers.  The vertical structures are warp-level: the
// graupel-N0 suffix minimum and the fall-speed fill-down scan inside each
// warp with __shfl_down_sync (5 steps, no barrier) and then combine with
// the totals of the warps above (one barrier); k0/ksed/nstep are
// __reduce_max_sync per warp and a max over the warps' slots (one
// barrier); each sedimentation substep takes the flux of the level above
// from the next lane, lane 31 from the next warp through a slot (one
// barrier).  The slots are double-buffered (Vert), so no exchange needs a
// second barrier: a mixed-phase column passes 2 + 2 + 6 + 8 = 18 barriers
// outside the substeps and one per substep, where the log-doubling scans
// in shared memory before took some 150 and two per substep.  Each
// column runs its own substep count.  Every helper only selects, takes a
// NaN-propagating min/max or copies, so the results are bit for bit those
// of the earlier layout (tests/test_torch_vertical.py models both).
//
// Block size and registers: every kernel is instantiated per block size
// (128 threads for nz <= 128, 256 above) with a register budget of blocks
// of 128 threads per SM, per kernel and per (dtype, warm/mixed), chosen
// on the card with kernel_budget.py: MIN_BLOCKS_* for fused_step.cu and
// fused_kid_step.cu (f32 mixed 5: 96 registers), RATES_MIN_BLOCKS_* for
// fused_rates.cu (5: 96), POST_MIN_BLOCKS_* for fused_post.cu (8: 64),
// TABLE_MIN_BLOCKS_* for table_stage.cu and ADVECT_MIN_BLOCKS_* for
// advect.cu (f32 10: 5 of its blocks of 256 threads).
// The aerosol kernels also skip, warp by warp, the chains whose values
// their masks discard (``guard``) and plan powc at compile time (POWC).
// Nothing but the exchange slots (and fused_kid_step's raw column) lives
// in shared memory: keeping post()'s Late values there instead of in
// registers was slower in f32.  Bytes bound every kernel at ~0.05 ms on
// (8192, 120) f32; on an NVIDIA H100 80GB HBM3 at 700 W they take 0.54
// (fused_step), 0.67 (fused_kid_step), 0.24 (fused_rates) and 0.18 ms
// (fused_post) (PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kid_constants.h"  // generated by cuda_build.py

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

constexpr double kBig = 1073741824.0;  // index.py's _BIG, 2**30

__device__ __forceinline__ int clip(long long v, int lo, int hi) {
  return (int)(v < lo ? lo : (v > hi ? hi : v));
}

// index.py::decade_index: the 0-based decade/mantissa index, log10 and
// pow(10, n) as torch computes them, then the mantissa repair (the table
// stage's indices and the lookup stage's tnc_wev index)
template <typename T>
__device__ __forceinline__ int decade_index(T r, double n2, int ntb) {
  r = mx(r, (T)1e-38);
  long long n = trunc_int(floor(log10(r)), (T)-kBig, (T)kBig);
  T pow10 = pow((T)10.0, (T)n);
  const T m0 = r / pow10;
  if (m0 < (T)1.0) {
    n = n - 1;
    pow10 = pow10 / (T)10.0;
  } else if (m0 >= (T)10.0) {
    n = n + 1;
    pow10 = pow10 * (T)10.0;
  }
  const T m = r / pow10;
  return clip(trunc_int(m, (T)-kBig, (T)kBig) + 9 * (n - (long long)n2), 1,
              ntb) - 1;
}

// The driver's MUSCL transport (kid_tpu_torch/driver/advection.py), shared
// by fused_kid_step.cu (z only) and advect.cu (z and x).  Each helper takes
// the division it divides with: the compiler's IEEE division by default,
// or advect.cu's branch-free one, which gives the same quotients where it
// says it is exact.
struct IeeeDiv {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a / b;
  }
};

// van Leer limiter phi(r) = (r + |r|) / (1 + |r|)
template <typename T, typename Div = IeeeDiv>
__device__ __forceinline__ T vanleer(T r, Div div = {}) {
  return div(r + fabs(r), (T)1.0 + fabs(r));
}

// the upwind MUSCL value at the face between cells qm1 and q0, from the
// four cells qm2, qm1, q0, qp1 around it and the face's mass flux ``vel``
// (advection._muscl_face_values: both one-sided ratios share the
// denominator of the face's own difference).  The plain version computes
// the left and the right value and selects one by the sign of ``vel``;
// only the selected one is computed here, with the same operations, so
// the face takes two divisions, not four, and the same bits.
template <typename T, typename Div = IeeeDiv>
__device__ __forceinline__ T muscl_face(T qm2, T qm1, T q0, T qp1, T vel,
                                        Div div = {}) {
  const T eps = (T)1e-30;
  const bool up = vel >= (T)0.0;
  const T d_mid = q0 - qm1;                   // q_j - q_{j-1}
  const T d_out = up ? qm1 - qm2 : qp1 - q0;  // q_{j-1} - q_{j-2}, or
                                              // q_{j+1} - q_j
  const T den = fabs(d_mid) > eps ? d_mid : eps;
  const T slope = vanleer(div(d_out, den), div) * d_mid;
  return up ? qm1 + (T)0.5 * slope : q0 - (T)0.5 * slope;
}

// the value at interior z-face j (1 <= j <= nz-1, between levels j-1 and
// j) of the column ``s``, which is padded by repeating its end levels
template <typename T, typename Div = IeeeDiv>
__device__ __forceinline__ T face_value(const T* s, int j, int nz, T vel,
                                        Div div = {}) {
  return muscl_face(s[j >= 2 ? j - 2 : 0], s[j - 1], s[j],
                    s[j + 1 < nz ? j + 1 : nz - 1], vel, div);
}

// The guards.  A chain whose value no output reads outside ``mask`` runs
// as ``T v = 0; if (guard<AERO>(mask)) v = chain;`` (each marked ``//
// guard: <name>``), and the select that reads it is kept as it was, so
// the results are those of the unguarded chain bit for bit, while a warp
// with no lane in the mask branches around the chain.  solver.py passes
// each guarded value through ``guarded(name, mask, value)``, and
// tests/test_torch_guards.py proves there that no output reads it outside
// the mask.  Only the aerosol split's kernels (AERO) carry them: for
// fused_step.cu and fused_kid_step.cu every guard is ``if (true)`` and
// they compile as before.  A guard never encloses a vertical helper.
template <bool ON> __device__ __forceinline__ bool guard(bool mask) {
  return !ON || mask;
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

// powc with its branches on p taken by the compiler.  nvcc leaves powc's
// tests of p (the fraction of |p| against 1/2, 1/3, ...) in the SASS as
// double adds and compares at run time; POWC(x, p), for a constant p,
// plans the same chain in constexpr code, so the arithmetic on x is
// powc's, bit for bit.  fused_rates.cu and fused_post.cu define
// KID_FOLD_POWC before including this file; the other kernels compile
// POWC as powc.
__host__ __device__ constexpr double abs_c(double x) {
  return x < 0 ? -x : x;
}
// powc's choice for the fraction f of |p|: 0 none, 1 sqrt, 2 cbrt, 3
// cbrt squared, 4 fourth root, 5 three quarters, 6 sixth root, 7 pow
__host__ __device__ constexpr int powc_frac(double f) {
  return abs_c(f) < 1e-12                ? 0
         : abs_c(f - 0.5) < 1e-12        ? 1
         : abs_c(f - 1.0 / 3.0) < 1e-12  ? 2
         : abs_c(f - 2.0 / 3.0) < 1e-12  ? 3
         : abs_c(f - 0.25) < 1e-12       ? 4
         : abs_c(f - 0.75) < 1e-12       ? 5
         : abs_c(f - 1.0 / 6.0) < 1e-12  ? 6
                                         : 7;
}
// -1 for p == 0, else (int)|p| | fraction << 16 | (p < 0) << 20
__host__ __device__ constexpr int powc_plan(double p) {
  return p == 0.0 ? -1
                  : (int)abs_c(p) |
                        powc_frac(abs_c(p) - (int)abs_c(p)) << 16 |
                        (p < 0 ? 1 << 20 : 0);
}
template <int PLAN, typename T>
__device__ __forceinline__ T powc_planned(T x, double p) {
  constexpr int k = PLAN & 0xffff, frac = (PLAN >> 16) & 15;
  if constexpr (PLAN == -1) {
    return (T)1;
  } else if constexpr (frac == 7) {
    return pow(x, (T)p);
  } else {
    T extra = (T)0;
    if constexpr (frac == 1) {
      extra = sqrt(x);
    } else if constexpr (frac == 2) {
      extra = cbrt_(x);
    } else if constexpr (frac == 3) {
      T cr = cbrt_(x);
      extra = cr * cr;
    } else if constexpr (frac == 4) {
      extra = sqrt(sqrt(x));
    } else if constexpr (frac == 5) {
      T s = sqrt(x);
      extra = s * sqrt(s);
    } else if constexpr (frac == 6) {
      extra = sqrt(cbrt_(x));
    }
    T out;
    if constexpr (frac == 0) out = ipow(x, k);
    else if constexpr (k == 0) out = extra;
    else out = ipow(x, k) * extra;
    if constexpr ((PLAN >> 20) & 1) out = (T)1 / out;
    return out;
  }
}
#ifdef KID_FOLD_POWC
#define POWC(x, p) powc_planned<powc_plan(p)>(x, p)
#else
#define POWC(x, p) powc(x, p)
#endif

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
// aerosol functions (solver's aerosol.py)

enum Species { kRain, kSnow, kGraupel };

// Slinn/Wang scavenging efficiency (aerosol.eff_aero) for an aerosol of
// diameter da with Cunningham slip correction cc (SLIP_WFA for 0.04e-6,
// SLIP_IFA for 0.8e-6: aerosol.slip_correction, folded in double by
// cuda_build.py, where nvcc left a double exp per call in the f32 code)
template <typename T, Species SP>
__device__ __forceinline__ T eff_aero(T d, double da, double cc, T visc,
                                      T rhoa, T temp) {
  T vt;
  if (SP == kRain)
    vt = (T)-0.1021 + (T)4.932e3 * d - (T)0.9551e6 * d * d +
         (T)0.07934e9 * ipow(d, 3) - (T)0.002362e12 * ipow(d, 4);
  else if (SP == kSnow)
    vt = (T)AV_S * POWC(d, BV_S);
  else
    vt = (T)AV_G * POWC(d, BV_G);
  const double boltzman = 1.3806503e-23;
  const T diff =
      (T)boltzman * temp * (T)cc / ((T)(3.0 * PI) * visc * (T)da);
  const T re = (T)0.5 * rhoa * d * vt / visc;
  const T sc = visc / (rhoa * diff);
  const T st = (T)(da * da) * vt * (T)1000.0 / ((T)9.0 * visc * d);
  const T aval = (T)1.0 + log((T)1.0 + re);
  const T st2 = ((T)1.2 + (T)(1.0 / 12.0) * aval) / ((T)1.0 + aval);
  T eff = (T)4.0 / (re * sc) *
              ((T)1.0 + (T)0.4 * sqrt(re) * POWC(sc, 1.0 / 3.0) +
               (T)0.16 * sqrt(re) * sqrt(sc)) +
          (T)(4.0 * da) / d *
              ((T)0.02 + (T)da / d * ((T)1.0 + (T)2.0 * sqrt(re)));
  eff = eff + (st > st2 ? POWC(mx(st - st2, (T)0) /
                                   (st - st2 + (T)0.666667),
                               1.5)
                        : (T)0);
  return clampT(eff, (T)1.0e-5, (T)1.0);
}

// DeMott et al. (2010) dust ice-nucleation count (aerosol.ice_demott)
template <typename T>
__device__ __forceinline__ T ice_demott(T tempc, T rho, T nifa) {
  const double rho_not0 = 101325.0 / (287.05 * 273.15);
  const T nifa_cc = nifa * (T)rho_not0 * (T)1.0e-6 / rho;
  T xni = (T)5.94e-5 * pow(-tempc, (T)3.33) *
          pow(nifa_cc, ((T)-0.0264 * tempc) + (T)0.0033);
  xni = xni * rho / (T)rho_not0 * (T)1000.0;
  return mx(xni, (T)0);
}

// Koop et al. (2001) homogeneous aerosol freezing (aerosol.ice_koop)
template <typename T>
__device__ __forceinline__ T ice_koop(T temp, T qv, T qvs, T naero, T dt) {
  const T satw = qv / qvs;
  const T mu_diff = (T)210368.0 + (T)131.438 * temp - (T)3.32373e6 / temp -
                    (T)41729.1 * log(temp);
  const T a_w_i = exp(mu_diff / ((T)R_UNI * temp));
  const T delta_aw = satw - a_w_i;
  const T log_j = (T)-906.7 + (T)8502.0 * delta_aw -
                  (T)26924.0 * ipow(delta_aw, 2) +
                  (T)29180.0 * ipow(delta_aw, 3);
  const T j_rate = exp10_(mn(log_j, (T)20.0));
  const T prob_h = mn((T)1.0 - exp(-j_rate * (T)AR_VOLUME * dt), (T)1.0);
  const T xni = prob_h > (T)0 ? mn(prob_h * naero, (T)1000.0e3) : (T)0;
  return mx(xni, (T)0);
}

// ---------------------------------------------------------------------------
// block-wide vertical helpers (every thread of the block must call them)
//
// Level k is thread k: lane k % 32 of warp k / 32.  Inside a warp the
// levels above arrive by __shfl_down_sync; across warps each warp puts one
// value in a shared slot.  Every exchange writes one half of the slots,
// waits at one barrier and reads; the next exchange takes the other half,
// so the slots are never written while a slower warp may still read them
// and no second barrier is needed.

constexpr int kWarp = 32;
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int lane_id() { return threadIdx.x % kWarp; }
__device__ __forceinline__ int warp_id() { return threadIdx.x / kWarp; }
__device__ __forceinline__ int n_warps() { return blockDim.x / kWarp; }

template <typename T> struct Shared {
  T v[2][kMaxWarps];
  T w[2][kMaxWarps];
  int f[2][kMaxWarps];
};

// a thread's handle on its block's slots and the half that the next
// exchange takes (the same in every thread: all make the same exchanges)
template <typename T> struct Vert {
  Shared<T>& sh;
  int half;
  __device__ __forceinline__ int next() {
    const int h = half;
    half ^= 1;
    return h;
  }
};

// max over the block of a non-negative int: a max per warp, one slot per
// warp, one barrier
template <typename T>
__device__ __forceinline__ int block_max(int v, Vert<T>& vx) {
  const int m = __reduce_max_sync(kFullMask, v);
  int* s = vx.sh.f[vx.next()];
  if (lane_id() == 0) s[warp_id()] = m;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < n_warps(); ++w) r = max(r, s[w]);
  return r;
}

// suffix (top-down running) minimum over the valid levels.  mn(lower,
// upper) selects exactly (the lowest NaN, else the highest level among
// the equal minima), so any grouping that combines a lower range with the
// range above it gives the same bits: a 5-step scan inside each warp, then
// each warp's total above, combined after one barrier.
template <typename T>
__device__ __forceinline__ T suffix_min(T v, bool valid, Vert<T>& vx) {
  const int lane = lane_id(), warp = warp_id();
  const T inf = (T)INFINITY;
  T cur = valid ? v : inf;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const T o = __shfl_down_sync(kFullMask, cur, off);
    cur = mn(cur, lane + off < kWarp ? o : inf);
  }
  T* s = vx.sh.v[vx.next()];
  if (lane == 0) s[warp] = cur;
  __syncthreads();
  T above = inf;
  for (int w = n_warps() - 1; w > warp; --w) above = mn(s[w], above);
  return mn(cur, above);
}

// first valid value at or above each level, 0 where none (_fill_down):
// the (value, flag) pair of the lowest flagged level, scanned as
// suffix_min is
template <typename T>
__device__ __forceinline__ T fill_down(T v, bool flag, Vert<T>& vx) {
  const int lane = lane_id(), warp = warp_id();
  T cv = v;
  int cf = flag ? 1 : 0;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    T ov = __shfl_down_sync(kFullMask, cv, off);
    int of = __shfl_down_sync(kFullMask, cf, off);
    if (lane + off >= kWarp) {
      ov = (T)0;
      of = 0;
    }
    if (!cf) {
      cv = ov;
      cf = of;
    }
  }
  const int h = vx.next();
  if (lane == 0) {
    vx.sh.v[h][warp] = cv;
    vx.sh.f[h][warp] = cf;
  }
  __syncthreads();
  for (int w = warp + 1; !cf && w < n_warps(); ++w) {
    if (vx.sh.f[h][w]) {
      cv = vx.sh.v[h][w];
      cf = 1;
    }
  }
  return cf ? cv : (T)0;
}

// graupel N0 / slope with the top-down running minimum (_graupel_psd)
template <typename T>
__device__ __forceinline__ void graupel_psd(T rg, T temp, bool l_qr, T mvd_r,
                                            bool valid, Vert<T>& vx,
                                            T& ilamg, T& n0_g) {
  const int k = threadIdx.x;
  const int k0 = block_max((valid && temp >= (T)270.65) ? k : 0, vx);
  T xslw1 = (k > k0 && l_qr && mvd_r > (T)100.0e-6)
                ? (T)4.01 + log10_(mx(mvd_r, (T)1e-12))
                : (T)0.01;
  T ygra1 = (T)4.31 + log10_(mx(rg, (T)5.0e-5));
  T zans1 = (T)3.1 + ((T)100.0 / ((T)300.0 * xslw1 * ygra1 /
                                      ((T)10.0 / xslw1 + (T)1.0 +
                                       (T)0.25 * ygra1) +
                                  (T)30.0 + (T)10.0 * ygra1));
  T n0_exp = clampT(exp10_(zans1), (T)GONV_MIN, (T)GONV_MAX);
  n0_exp = suffix_min(n0_exp, valid, vx);
  T lam_exp = POWC(n0_exp * (T)AM_G * (T)CGG_1 / rg, OGE1);
  T lamg = lam_exp * (T)LAMG_FAC;
  ilamg = (T)1 / lamg;
  n0_g = n0_exp / ((T)CGG_2 * lam_exp) * POWC(lamg, CGE_2);
}

// one species' substepped upwind sweep (solver._cfl + solver._sweep).
// Each substep takes the flux of the level above from the next lane, and
// lane 31 from the next warp's lane 0 through a slot: one barrier a
// substep.  The top level's inflow is its own flux times 0, as the plain
// version's zero-padded shift (0, or NaN for a non-finite flux).
template <typename T, bool NUM>
__device__ __forceinline__ void sweep(T vt_cfl, T vts_mass, T vts_num,
                                      T& ten_m, T& ten_n, T& dm, T& dn,
                                      T floor_m, T floor_n, T gate, T orho,
                                      T odzq, T dt, bool valid, int nz,
                                      Vert<T>& vx, T& ppt) {
  const int k = threadIdx.x;
  const int lane = lane_id(), warp = warp_id();
  const int top = nz - 1;
  const bool vt_mask = valid && vt_cfl > (T)1.0e-3;
  int ksed = block_max(vt_mask ? k : 0, vx);
  if (ksed == top) ksed = top - 1;
  const int nstep = block_max(
      vt_mask ? trunc_int(dt * vt_cfl * odzq + (T)1.0, (T)0, (T)1073741824.0)
              : 0,
      vx);
  const int n_loop = nstep > 1 ? nstep : 1;
  const T onstep = (T)1 / (T)n_loop;
  const bool upd = (k == top) || (k <= ksed);
  T acc = (T)0;
  for (int n = 0; n < n_loop; ++n) {
    T sed_m = vts_mass * dm * gate;
    T sed_n = NUM ? vts_num * dn * gate : (T)0;
    T up_m = __shfl_down_sync(kFullMask, sed_m, 1);
    T up_n = NUM ? __shfl_down_sync(kFullMask, sed_n, 1) : (T)0;
    const int h = vx.next();
    if (lane == 0) {
      vx.sh.v[h][warp] = sed_m;
      if (NUM) vx.sh.w[h][warp] = sed_n;
    }
    __syncthreads();
    if (k + 1 >= nz) {
      up_m = sed_m * (T)0;
      if (NUM) up_n = sed_n * (T)0;
    } else if (lane == kWarp - 1) {
      up_m = vx.sh.v[h][warp + 1];
      if (NUM) up_n = vx.sh.w[h][warp + 1];
    }
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

// ---------------------------------------------------------------------------
// channel layouts (shared with the Python wrappers)

// state channels (ColumnState), then pres at 12 in every packed input
enum StateCh {
  I_t, I_qv, I_qc, I_qi, I_qr, I_qs, I_qg, I_ni, I_nr, I_nc, I_nwfa, I_nifa,
  I_pres, N_STATE = 12
};
// table-stage channels, in the order of solver.tv_keys(cfg)
enum TvCh {
  TV_ef_rw, TV_ef_sw, TV_tide, TV_prr_rcs, TV_prs_rcs, TV_prg_rcs,
  TV_pnr_rcs, TV_prg_rcg, TV_prr_rcg, TV_pnr_rcg, TV_prg_rfz, TV_pri_rfz,
  TV_pni_rfz, TV_pnr_rfz, TV_pri_wfz, TV_pni_wfz, TV_prs_iau, TV_pni_iau
};
// the p8 tendency channels (solver.P8_OUT)
enum P8Ch {
  P_tten, P_qvten, P_qcten, P_ncten, P_qiten, P_niten, P_qrten, P_nrten,
  P_qsten, P_qgten, P_nwfaten, P_nifaten, P_vts_boost, P_mvd_r, P_prr_gml,
  N_P8
};
// rate channels (solver.DIAG_KEYS): the 33 P8_RATES, then prr_gml,
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

// ---------------------------------------------------------------------------
// the stages

// scalar arguments of a step, as the wrappers pass them
template <typename T> struct Params {
  T dt, odt, odts, nt_c, ifdry;
  double dt_d;
  bool l_sediment, dusty, homog;
};
template <typename T>
__device__ __forceinline__ Params<T> make_params(double dt_d, double nt_c,
                                                 double ifdry, int l_sed,
                                                 int dusty, int homog) {
  Params<T> P;
  P.dt = (T)dt_d;
  P.odt = (T)1 / P.dt;
  P.odts = P.odt;
  P.nt_c = (T)nt_c;
  P.ifdry = (T)ifdry;
  P.dt_d = dt_d;
  P.l_sediment = l_sed != 0;
  P.dusty = dusty != 0;
  P.homog = homog != 0;
  return P;
}

// the raw state of one cell and its pressure
template <typename T> struct Cell {
  T t1d, qv1d, qc1d, qi1d, qr1d, qs1d, qg1d, ni1d, nr1d, nc1d, nwfa1d,
      nifa1d, pres;
};
template <typename T>
__device__ __forceinline__ Cell<T> load_cell(const T* __restrict__ x,
                                             size_t plane, size_t off) {
  Cell<T> s;
  s.t1d = x[I_t * plane + off];
  s.qv1d = x[I_qv * plane + off];
  s.qc1d = x[I_qc * plane + off];
  s.qi1d = x[I_qi * plane + off];
  s.qr1d = x[I_qr * plane + off];
  s.qs1d = x[I_qs * plane + off];
  s.qg1d = x[I_qg * plane + off];
  s.ni1d = x[I_ni * plane + off];
  s.nr1d = x[I_nr * plane + off];
  s.nc1d = x[I_nc * plane + off];
  s.nwfa1d = x[I_nwfa * plane + off];
  s.nifa1d = x[I_nifa * plane + off];
  s.pres = x[I_pres * plane + off];
  return s;
}

// the prologue's products (solver._prologue's ``pro``)
template <typename T> struct Pro {
  // phase 2: the zeroed state and the per-species densities
  T qc1d, nc1d, qi1d, ni1d, qr1d, nr1d, qs1d, qg1d;
  T temp0, qv0, rho0, rc0, nc0, ri0, ni0, rr0, nr0, rs0, rg0;
  T nwfa, nifa;
  bool l_qr0, l_qs0;
  // phase 3: thermodynamics
  T rhof0, rhof20, qvs0, delqvs, qvsi, ssatw0, ssati, diffu0, visco0, ocp0,
      vsc20, lvap0, tcond0;
  // phases 5-7: snow moments, graupel and rain PSDs
  T smo0, smo1, smob, smoc, smoe, smof, ilamg, n0_g;
  T mvd_r_ph2, ilamr0, mvd_r, n0_r0;  // mvd_r_ph2: phase 2's clamp
  // cloud and ice PSD shapes
  T nu_c_f, xdc, mvd_c, dc_g, xds, ilami, xdi, oxmi;
};

// phases 2-7 without the graupel PSD (elementwise: no barrier)
template <typename T, bool WARM, bool AERO>
__device__ __forceinline__ void prologue_cell(const Cell<T>& s,
                                              const Params<T>& P,
                                              Pro<T>& p) {
  const T nt_c = P.nt_c;
  T qc1d = s.qc1d, qi1d = s.qi1d, qr1d = s.qr1d;
  T qs1d = s.qs1d, qg1d = s.qg1d;
  T ni1d = s.ni1d, nr1d = s.nr1d, nc1d = s.nc1d;
  const T pres = s.pres;

  const T temp0 = s.t1d;
  const T qv0 = mx(s.qv1d, (T)1.0e-10);
  const T rho0 = (T)0.622 * pres / ((T)R_GAS * temp0 * (qv0 + (T)0.622));
  p.nwfa = p.nifa = (T)0;
  if (AERO) {
    p.nwfa = clampT(s.nwfa1d * rho0, (T)11.1e6, (T)9999.0e6);
    p.nifa = clampT(s.nifa1d * rho0, (T)(NA_IN1 * 0.01), (T)9999.0e6);
  }

  // cloud water (f90:1395-1418)
  const bool l_qc0 = qc1d > (T)R1;
  qc1d = l_qc0 ? qc1d : (T)0;
  nc1d = l_qc0 ? nc1d : (T)0;
  const T rc0 = l_qc0 ? qc1d * rho0 : (T)R1;
  T nc0;
  if (AERO) {
    // the droplet number of the state, clamped to the PSD limits
    T nc_cl = 0;
    if (guard<AERO>(l_qc0)) {  // guard: droplet_clamp
      const T nc_raw = mx(nc1d * rho0, (T)2.0);
      const int nu = trunc_int(
          mn(fnint((T)1000.0e6 / nc_raw) + (T)2, (T)15), (T)0, (T)15);
      const T ccg1_n = (T)NUC_COEF[nu][0], ccg2_n = (T)NUC_COEF[nu][1];
      const T ocg1_n = (T)NUC_COEF[nu][3], ocg2_n = (T)NUC_COEF[nu][4];
      const T cce2_n = (T)NUC_COEF[nu][5];
      T lamc = POWC(nc_raw * (T)AM_R * ccg2_n * ocg1_n / rc0, OBMR);
      const T xdc = ((T)BM_R + (T)nu + (T)1.0) / lamc;
      lamc = xdc < (T)D0C
                 ? cce2_n / (T)D0C
                 : (xdc > (T)(D0R * 2.0) ? cce2_n / (T)(D0R * 2.0) : lamc);
      nc_cl = mn(ccg1_n * ocg2_n * rc0 / (T)AM_R * POWC(lamc, BM_R),
                 (T)NT_C_MAX);
    }
    nc0 = l_qc0 ? nc_cl : (T)2.0;
  } else {
    nc0 = l_qc0 ? nt_c : (T)2.0;  // f90:1410
  }

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
    T lami = POWC((T)(AM_I * CIG_2 * OIG1) * ni1 / ri0, OBMI);
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
    T lamr = POWC((T)(AM_R * CRG_3 * ORG2) * nr1 / rr0, OBMR);
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
  p.rhof0 = sqrt((T)RHO_NOT / rho0);
  p.rhof20 = sqrt(p.rhof0);
  p.qvs0 = rslf(pres, temp0);
  p.delqvs = mx(rslf(pres, (T)273.15) - qv0, (T)0);
  p.qvsi = tempc0 <= (T)0 ? rsif(pres, temp0) : p.qvs0;
  T ssatw0 = qv0 / p.qvs0 - (T)1;
  T ssati = qv0 / p.qvsi - (T)1;
  p.ssatw0 = fabs(ssatw0) < (T)EPS ? (T)0 : ssatw0;
  p.ssati = fabs(ssati) < (T)EPS ? (T)0 : ssati;
  p.diffu0 =
      (T)2.11e-5 * POWC(temp0 / (T)273.15, 1.94) * ((T)101325.0 / pres);
  p.visco0 =
      tempc0 >= (T)0
          ? ((T)1.718 + (T)0.0049 * tempc0) * (T)1.0e-5
          : ((T)1.718 + (T)0.0049 * tempc0 - (T)1.2e-5 * ipow(tempc0, 2)) *
                (T)1.0e-5;
  p.ocp0 = (T)1 / ((T)CP * ((T)1 + (T)0.887 * qv0));
  p.vsc20 = sqrt(rho0 / p.visco0);
  p.lvap0 = (T)LVAP0 + (T)(2106.0 - 4218.0) * tempc0;
  p.tcond0 = ((T)5.69 + (T)0.0168 * tempc0) * (T)1.0e-5 * (T)418.936;

  // phase 5: snow moments (f90:1545-1628)
  p.smo0 = p.smo1 = p.smob = p.smoc = p.smoe = p.smof = (T)0;
  if (!WARM) {
    T tc0 = mn(temp0 - (T)273.15, (T)-0.1);
    T smob_r = rs0 * (T)OAMS;
    T lg = log(mx(smob_r, (T)1e-35)) * (T)INV_LN10_SNOW;
    p.smob = l_qs0 ? smob_r : (T)0;
    p.smo0 = l_qs0 ? field_moment(lg, tc0, FM0_M, FM0_M3) : (T)0;
    p.smo1 = l_qs0 ? field_moment(lg, tc0, FM1_M, FM1_M3) : (T)0;
    p.smoc = l_qs0 ? field_moment(lg, tc0, FMC_M, FMC_M3) : (T)0;
    p.smoe = l_qs0 ? field_moment(lg, tc0, FME_M, FME_M3) : (T)0;
    p.smof = l_qs0 ? field_moment(lg, tc0, FMF_M, FMF_M3) : (T)0;
  }
  p.ilamg = (T)1;
  p.n0_g = (T)0;

  // phase 7: rain PSD (f90:1661-1666)
  {
    T lamr = POWC((T)(AM_R * CRG_3 * ORG2) * nr0 / rr0, OBMR);
    p.ilamr0 = (T)1 / lamr;
    p.mvd_r = (T)(3.0 + MU_R + 0.672) / lamr;
    p.n0_r0 = nr0 * (T)ORG2 * POWC(lamr, CRE_2);
  }

  // cloud mvd (f90:1688-1694)
  {
    int nu = trunc_int(mn(fnint((T)1000.0e6 / nc0) + (T)2, (T)15), (T)0,
                       (T)15);
    const T ccg2_n = (T)NUC_COEF[nu][1], ccg3_n = (T)NUC_COEF[nu][2];
    const T ocg1_n = (T)NUC_COEF[nu][3], ocg2_n = (T)NUC_COEF[nu][4];
    p.nu_c_f = (T)nu;
    p.xdc = mx(POWC(rc0 / ((T)AM_R * nc0), OBMR) * (T)1.0e6,
               (T)(D0C * 1.0e6));
    T lamc = POWC(nc0 * (T)AM_R * ccg2_n * ocg1_n / rc0, OBMR);
    p.mvd_c = l_qc0 ? ((T)3.0 + p.nu_c_f + (T)0.672) / lamc : (T)D0C;
    p.dc_g = POWC(ccg3_n * ocg2_n, OBMR) / lamc * (T)1.0e6;
  }
  p.xds = p.ilami = p.xdi = p.oxmi = (T)0;
  if (!WARM) {
    p.xds = l_qs0 ? p.smoc / mx(p.smob, (T)1e-30) : (T)0;
    T lami = POWC((T)(AM_I * CIG_2 * OIG1) * ni0 / ri0, OBMI);
    p.ilami = (T)1 / lami;
    p.xdi = mx((T)(BM_I + MU_I + 1.0) * p.ilami, (T)D0I);
    T xmi = (T)AM_I * POWC(p.xdi, BM_I);
    p.oxmi = (T)1 / xmi;
  }

  p.qc1d = qc1d; p.nc1d = nc1d; p.qi1d = qi1d; p.ni1d = ni1d;
  p.qr1d = qr1d; p.nr1d = nr1d; p.qs1d = qs1d; p.qg1d = qg1d;
  p.temp0 = temp0; p.qv0 = qv0; p.rho0 = rho0;
  p.rc0 = rc0; p.nc0 = nc0; p.ri0 = ri0; p.ni0 = ni0;
  p.rr0 = rr0; p.nr0 = nr0; p.rs0 = rs0; p.rg0 = rg0;
  p.l_qr0 = l_qr0; p.l_qs0 = l_qs0;
  p.mvd_r_ph2 = mvd_r0;
}

// phases 2-7 (solver._prologue); every thread of the block must call it
template <typename T, bool WARM, bool AERO>
__device__ __forceinline__ void prologue(const Cell<T>& s, const Params<T>& P,
                                         bool valid, Vert<T>& vx,
                                         Pro<T>& p) {
  prologue_cell<T, WARM, AERO>(s, P, p);
  // phase 6: graupel PSD with the running-minimum N0 (f90:1633-1656)
  if (!WARM)
    graupel_psd(p.rg0, p.temp0, p.l_qr0, p.mvd_r_ph2, valid, vx, p.ilamg,
                p.n0_g);
}

// the p8 tendencies (solver.P8_OUT)
template <typename T> struct P8 {
  T tten, qvten, qcten, ncten, qiten, niten, qrten, nrten, qsten, qgten,
      nwfaten, nifaten, vts_boost, mvd_r, prr_gml;
};

// phases 8-11 (solver.rates_and_tendencies): the process rates, the
// conservation clamps and the tendencies.  ``tv`` points at the cell's
// first table-stage channel; with RATES the 33 P8_RATES go to d[D_* *
// plane] (d may be null otherwise).
template <typename T, bool WARM, bool RATES, bool AERO>
__device__ __forceinline__ void rates(const Pro<T>& p,
                                      const T* __restrict__ tv, size_t plane,
                                      const Params<T>& P, bool valid,
                                      P8<T>& o, T* __restrict__ d) {
  const T dt = P.dt, odts = P.odts, ifdry = P.ifdry;
  const T qc1d = p.qc1d, nc1d = p.nc1d, qi1d = p.qi1d, ni1d = p.ni1d;
  const T qr1d = p.qr1d, nr1d = p.nr1d, qs1d = p.qs1d, qg1d = p.qg1d;
  const T rhof0 = p.rhof0, rhof20 = p.rhof20, qvsi = p.qvsi;
  const T ssatw0 = p.ssatw0, ssati = p.ssati, diffu0 = p.diffu0;
  const T visco0 = p.visco0, ocp0 = p.ocp0, vsc20 = p.vsc20;
  const T lvap0 = p.lvap0, tcond0 = p.tcond0, delqvs = p.delqvs;
  const T smo0 = p.smo0, smo1 = p.smo1, smoe = p.smoe, smof = p.smof;
  const T ilamg = p.ilamg, n0_g = p.n0_g, ilamr0 = p.ilamr0, n0_r0 = p.n0_r0;
  const T nu_c_f = p.nu_c_f, xdc = p.xdc, mvd_c = p.mvd_c, dc_g = p.dc_g;
  const T xds = p.xds, ilami = p.ilami, xdi = p.xdi, oxmi = p.oxmi;
  const T nwfa = p.nwfa, nifa = p.nifa;
  T mvd_r = p.mvd_r;

  // table-stage channels
  const T ef_rw = tv[TV_ef_rw * plane];
  T ef_sw = 0, tide = 0;
  T prr_rcs = 0, prs_rcs = 0, prg_rcs = 0, pnr_rcs = 0;
  T prg_rcg = 0, prr_rcg = 0, pnr_rcg = 0;
  T prg_rfz = 0, pri_rfz = 0, pni_rfz = 0, pnr_rfz = 0;
  T pri_wfz = 0, pni_wfz = 0, prs_iau = 0, pni_iau = 0;
  if (!WARM) {
    ef_sw = tv[TV_ef_sw * plane]; tide = tv[TV_tide * plane];
    prr_rcs = tv[TV_prr_rcs * plane]; prs_rcs = tv[TV_prs_rcs * plane];
    prg_rcs = tv[TV_prg_rcs * plane]; pnr_rcs = tv[TV_pnr_rcs * plane];
    prg_rcg = tv[TV_prg_rcg * plane]; prr_rcg = tv[TV_prr_rcg * plane];
    pnr_rcg = tv[TV_pnr_rcg * plane];
    prg_rfz = tv[TV_prg_rfz * plane]; pri_rfz = tv[TV_pri_rfz * plane];
    pni_rfz = tv[TV_pni_rfz * plane]; pnr_rfz = tv[TV_pnr_rfz * plane];
    pri_wfz = tv[TV_pri_wfz * plane]; pni_wfz = tv[TV_pni_wfz * plane];
    prs_iau = tv[TV_prs_iau * plane]; pni_iau = tv[TV_pni_iau * plane];
  }

  const T temp = p.temp0, qv = p.qv0, rho = p.rho0;
  const T rc = p.rc0, nc = p.nc0, ri = p.ri0, ni = p.ni0, rr = p.rr0;
  const T nr = p.nr0, rs = p.rs0, rg = p.rg0;
  const T tempc = temp - (T)273.15;
  const bool l_qc = qc1d > (T)R1, l_qi = qi1d > (T)R1, l_qr = qr1d > (T)R1;
  const bool l_qs = qs1d > (T)R1, l_qg = qg1d > (T)R1;

  // phase 8: warm rain
  const T ef_rr =
      (T)1 - exp(mn((T)2300.0 * (mvd_r - (T)1950.0e-6), (T)50.0));
  const T pnr_rcr =
      (l_qr && mvd_r > (T)D0R) ? ef_rr * (T)2.0 * nr * rr : (T)0;
  const bool au = rc > (T)0.01e-3;
  const T dc_b = POWC(
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
  const T geo_r = POWC(lamr + (T)FV_R, -CRE_9);
  T prr_rcw =
      rcw ? mn(rc * odts, rhof0 * (T)T1_QR_QC * ef_rw * rc * n0_r0 * geo_r)
          : (T)0;
  const T pnc_rcw =
      rcw ? mn(nc * odts, rhof0 * (T)T1_QR_QC * ef_rw * nc * n0_r0 * geo_r)
          : (T)0;

  // rain collecting aerosols, wet scavenging (f90:1728-1740)
  T pna_rca = 0, pnd_rcd = 0, pna_sca = 0, pnd_scd = 0;
  T pna_gca = 0, pnd_gcd = 0;
  if (AERO) {
    const bool rca_on = l_qr && mvd_r > (T)D0R;
    T ef_ra = 0, ef_rd = 0;
    if (guard<AERO>(rca_on)) {  // guard: rain_aero
      ef_ra = eff_aero<T, kRain>(mvd_r, 0.04e-6, SLIP_WFA, visco0, rho,
                                 temp);
      ef_rd = eff_aero<T, kRain>(mvd_r, 0.8e-6, SLIP_IFA, visco0, rho,
                                 temp);
    }
    pna_rca = rca_on ? mn(nwfa * odts, rhof0 * (T)T1_QR_QC * ef_ra * nwfa *
                                           n0_r0 * geo_r)
                     : (T)0;
    pnd_rcd = rca_on ? mn(nifa * odts, rhof0 * (T)T1_QR_QC * ef_rd * nifa *
                                           n0_r0 * geo_r)
                     : (T)0;
  }

  // phase 9: ice-phase process rates
  T pnc_scw = 0, pnc_gcw = 0;
  T pri_inu = 0, pni_inu = 0, pri_ihm = 0, pni_ihm = 0;
  T pri_iha = 0, pni_iha = 0;
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
    const T g_bvg = POWC(ilamg, BV_G);
    const T g_cge9 = g_bvg * POWC(ilamg, 3.0);
    const T g_cge11 = sqrt(g_bvg * POWC(ilamg, 5.0));
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

    // snow/graupel collecting aerosols, wet scavenging (f90:1937-1959)
    if (AERO) {
      const bool sca_on = rs > (T)RS1;
      T ef_sa = 0, ef_sd = 0;
      if (guard<AERO>(sca_on)) {  // guard: snow_aero
        const T xds_s = p.smoc / mx(p.smob, (T)1e-30);
        ef_sa = eff_aero<T, kSnow>(xds_s, 0.04e-6, SLIP_WFA, visco0, rho,
                                   temp);
        ef_sd = eff_aero<T, kSnow>(xds_s, 0.8e-6, SLIP_IFA, visco0, rho,
                                   temp);
      }
      pna_sca = sca_on ? mn(nwfa * odts,
                            rhof0 * (T)T1_QS_QC * ef_sa * nwfa * smoe)
                       : (T)0;
      pnd_scd = sca_on ? mn(nifa * odts,
                            rhof0 * (T)T1_QS_QC * ef_sd * nifa * smoe)
                       : (T)0;
      const bool gca_on = rg > (T)RG1;
      T ef_ga = 0, ef_gd = 0;
      if (guard<AERO>(gca_on)) {  // guard: graupel_aero
        ef_ga = eff_aero<T, kGraupel>(xdg, 0.04e-6, SLIP_WFA, visco0, rho,
                                      temp);
        ef_gd = eff_aero<T, kGraupel>(xdg, 0.8e-6, SLIP_IFA, visco0, rho,
                                      temp);
      }
      pna_gca = gca_on ? mn(nwfa * odts, rhof0 * (T)T1_QG_QC * ef_ga * nwfa *
                                             n0_g * geo_g)
                       : (T)0;
      pnd_gcd = gca_on ? mn(nifa * odts, rhof0 * (T)T1_QG_QC * ef_gd * nifa *
                                             n0_g * geo_g)
                       : (T)0;
    }

    // below 0C (f90:2025-2231)
    const T rate_max_i = (qv - qvsi) * rho * odts * (T)0.999;
    // deposition-condensation ice nucleation: DeMott (2010) when dusty and
    // aerosol-aware, else the Cooper curve (f90:2088-2101)
    const bool inu = t_lt_0 && ((ssati >= (T)0.25) ||
                                ((ssatw0 > (T)EPS) && (temp < (T)253.15)));
    T xnc_inu;
    if (AERO && P.dusty) {
      xnc_inu = (T)0;
      if (guard<AERO>(inu))  // guard: demott
        xnc_inu = ice_demott(tempc, rho, nifa);
    } else {
      xnc_inu = mn((T)TNO * exp((T)ATO * ((T)T_0 - temp)), (T)250.0e3);
    }
    const T xni_now = ni + (pni_rfz + pni_wfz) * dt;
    const T pni_inu0 =
        (T)0.5 * (xnc_inu - xni_now + fabs(xnc_inu - xni_now)) * odts;
    pri_inu = inu ? mn(rate_max_i, (T)XM0I * pni_inu0) : (T)0;
    pni_inu = inu ? pri_inu / (T)XM0I : (T)0;

    // Koop (2001) homogeneous freezing of deliquesced aerosols
    // (f90:2103-2111)
    if (AERO && P.homog) {
      const T xni_koop = smo0 + ni + (pni_rfz + pni_wfz + pni_inu) * dt;
      const bool iha_on = t_lt_0 && xni_koop <= (T)500.0e3 &&
                          temp < (T)238.0 && ssati >= (T)0.4;
      T xnc_iha = 0;
      if (guard<AERO>(iha_on))  // guard: koop
        xnc_iha = ice_koop(temp, qv, p.qvs0, nwfa, dt);
      const T pni_iha0 = xnc_iha * odts;
      pri_iha = iha_on ? mn(rate_max_i, (T)(XM0I * 0.1) * pni_iha0) : (T)0;
      pni_iha = iha_on ? pri_iha / (T)(XM0I * 0.1) : (T)0;
    }

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
                   ((T)T1_QG_SD * POWC(ilamg, CGE_10) +
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
                                         POWC(lamr + (T)FV_R, -CRE_8))
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
                   ((T)T1_QG_ME * POWC(ilamg, CGE_10) +
                    (T)T2_QG_ME * rhof20 * vsc20 * g_cge11);
    prr_gml = (melt && l_qg) ? mn(rg * odts, mx(gml0, (T)0)) : (T)0;
    pnr_gml = (melt && l_qg) ? n0_g * (T)CGG_2 * POWC(ilamg, CGE_2) /
                                   mx(rg, (T)R1) * prr_gml *
                                   exp10_((T)-0.5 * tempc)
                             : (T)0;
    prg_gde = (melt && l_qg && ssati < (T)0) ? mx(-rg * odts, gde0)
                                             : prg_gde;
    if (P.dt_d > 120.0 && melt) {
      prr_rcw = prr_rcw + prs_scw + prg_gcw;
      prs_scw = (T)0;
      prg_gcw = (T)0;
    }
  }

  // phase 10: conservation ratio-clamps (f90:2291-2387)
  {
    T sump = pri_inu + pri_ide + prs_ide + prs_sde + prg_gde;
    if (AERO) sump = sump + pri_iha;
    T rate_max = (qv - qvsi) * odts * (T)0.999;
    bool bad = ((sump > (T)EPS) && (sump > rate_max)) ||
               ((sump < (T)(-EPS)) && (sump < rate_max));
    T ratio = rate_max / (bad ? sump : (T)1);
    if (bad) {
      pri_inu = pri_inu * ratio; pri_ide = pri_ide * ratio;
      pni_ide = pni_ide * ratio; prs_ide = prs_ide * ratio;
      prs_sde = prs_sde * ratio; prg_gde = prg_gde * ratio;
      if (AERO) pri_iha = pri_iha * ratio;
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

  // phase 11: tendency assembly + number clamps (f90:2393-2569); the
  // aerosol terms enter each sum where the plain version adds them
  T tten, qvten, qcten, ncten, qiten, niten, qrten, nrten, qsten, qgten;
  T nwfaten = (T)0, nifaten = (T)0;
  {
    const T orho = (T)1 / rho;
    const T lfus2 = (T)LSUB - lvap0;
    T qv_sum = -pri_inu;
    if (AERO) qv_sum = qv_sum - pri_iha;
    qvten = (qv_sum - pri_ide - prs_ide - prs_sde - prg_gde) * orho;
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
    T lamc = POWC(xnc * (T)AM_R * ccg2_n * ocg1_n / rc, OBMR);
    T xdc2 = ((T)BM_R + (T)nu + (T)1.0) / lamc;
    T lamc_lo = cce2_n / (T)D0C;
    T lamc_hi = cce2_n / (T)(D0R * 2.0);
    T xnc_lo = ccg1_n * ocg2_n * xrc / (T)AM_R * POWC(lamc_lo, BM_R);
    T xnc_hi = ccg1_n * ocg2_n * xrc / (T)AM_R * POWC(lamc_hi, BM_R);
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

    T qi_sum = pri_inu, ni_sum = pni_inu;
    if (AERO) {
      qi_sum = qi_sum + pri_iha;
      ni_sum = ni_sum + pni_iha;
    }
    qiten = (qi_sum + pri_ihm + pri_wfz + pri_rfz + pri_ide - prs_iau -
             prs_sci - pri_rci) * orho;
    niten = (ni_sum + pni_ihm + pni_wfz + pni_rfz + pni_ide - pni_iau -
             pni_sci - pni_rci) * orho;

    T xri = mx((qi1d + qiten * dt) * rho, (T)R1);
    T xni = mx((ni1d + niten * dt) * rho, (T)R2);
    T lami = POWC((T)(AM_I * CIG_2 * OIG1) * xni / xri, OBMI);
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
    T lamr_b = POWC((T)(AM_R * CRG_3 * ORG2) * xnr / xrr, OBMR);
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

    T dep_sum = pri_inu + pri_ide + prs_ide + prs_sde + prg_gde;
    if (AERO) dep_sum = dep_sum + pri_iha;
    const T tten_cold =
        ((T)LSUB * ocp0 * dep_sum +
         lfus2 * ocp0 * (pri_wfz + pri_rfz + prg_rfz + prs_scw + prg_scw +
                         prg_gcw + prg_rcs + prs_rcs + prr_rci + prg_rcg)) *
        orho * ifdry;
    const T tten_warm =
        ((T)LFUS * ocp0 * (-prr_sml - prr_gml - prr_rcg - prr_rcs) +
         (T)LSUB * ocp0 * (prs_sde + prg_gde)) *
        orho * ifdry;
    tten = temp < (T)T_0 ? tten_cold : tten_warm;

    // aerosol tendencies (f90:2398-2408)
    if (AERO) {
      nwfaten = -(pna_rca + pna_sca + pna_gca + pni_iha) * orho;
      if (P.dusty) nifaten = (-(pnd_rcd + pnd_scd + pnd_gcd) - pni_inu) * orho;
    }
  }

  if (RATES && valid) {
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
    d[D_pnr_rfz * plane] = pnr_rfz;
  }
  o.tten = tten; o.qvten = qvten; o.qcten = qcten; o.ncten = ncten;
  o.qiten = qiten; o.niten = niten; o.qrten = qrten; o.nrten = nrten;
  o.qsten = qsten; o.qgten = qgten; o.nwfaten = nwfaten;
  o.nifaten = nifaten; o.vts_boost = vts_boost; o.mvd_r = mvd_r;
  o.prr_gml = prr_gml;
}

// what post() reads of the raw cell, of phase 2's zeroed state and the
// level depth, in one struct (set right after the prologue); the card
// ran fused_kid_step 1.4% and f64 fused_step 4% faster with it than with
// the cell, the state and dzq as separate arguments (PERF.md)
template <typename T> struct Late {
  T t1d, qv1d, pres, nwfa1d, nifa1d, dzq;
  T qc1d, nc1d, qi1d, ni1d, qr1d, nr1d, qs1d, qg1d;
};
template <typename T>
__device__ __forceinline__ void set_late(Late<T>& l, const Cell<T>& s,
                                         const Pro<T>& p, T dzq) {
  l.t1d = s.t1d; l.qv1d = s.qv1d; l.pres = s.pres;
  l.nwfa1d = s.nwfa1d; l.nifa1d = s.nifa1d; l.dzq = dzq;
  l.qc1d = p.qc1d; l.nc1d = p.nc1d; l.qi1d = p.qi1d; l.ni1d = p.ni1d;
  l.qr1d = p.qr1d; l.nr1d = p.nr1d; l.qs1d = p.qs1d; l.qg1d = p.qg1d;
}

// what phases 12-20 return for one cell
template <typename T> struct Out {
  T t, qv, qc, qi, qr, qs, qg, ni, nr, nc, nwfa, nifa;
  T pptrain, pptsnow, pptgraul, pptice;  // meaningful at level 0
  T prv_rev, pnr_rev;
};

// phases 12-20 (solver._post_rates) from the raw cell, the zeroed state
// and the level depth ``l``, the prologue's snow moments ``p`` (and its
// graupel PSD, recomputed here for mixed phase), the p8 tendencies ``q``
// and, with AERO, the phase-14 lookups ``xnc_act`` and ``wev``.  Every
// thread of the block must call it.
template <typename T, bool WARM, bool AERO>
__device__ __forceinline__ void post(const Late<T>& l, const Pro<T>& p,
                                     P8<T> q, T xnc_act_in, T wev,
                                     const Params<T>& P, bool valid, int nz,
                                     Vert<T>& vx, Out<T>& out) {
  const T dt = P.dt, odt = P.odt, odts = P.odts, nt_c = P.nt_c;
  const T ifdry = P.ifdry;
  const T &t1d = l.t1d, &qv1d = l.qv1d, &pres = l.pres;
  const T &nwfa1d = l.nwfa1d, &nifa1d = l.nifa1d, &dzq = l.dzq;
  const T &qc1d = l.qc1d, &nc1d = l.nc1d, &qi1d = l.qi1d, &ni1d = l.ni1d;
  const T &qr1d = l.qr1d, &nr1d = l.nr1d, &qs1d = l.qs1d, &qg1d = l.qg1d;
  T smob = p.smob, smoc = p.smoc, ilamg = p.ilamg, n0_g = p.n0_g;
  T tten = q.tten, qvten = q.qvten, qcten = q.qcten, ncten = q.ncten;
  T qiten = q.qiten, niten = q.niten, qrten = q.qrten, nrten = q.nrten;
  T qsten = q.qsten, qgten = q.qgten, nwfaten = q.nwfaten;
  const T nifaten = q.nifaten, vts_boost = q.vts_boost, prr_gml = q.prr_gml;
  T mvd_r = q.mvd_r;

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
  T nc2;
  if (AERO)
    nc2 = l_qc2 ? mx((nc1d + ncten * dt) * rho2, (T)2.0) : (T)2.0;
  else
    nc2 = l_qc2 ? nt_c : (T)2.0;  // f90:2602
  const bool l_qi2 = (qi1d + qiten * dt) > (T)R1;
  T ri2 = l_qi2 ? (qi1d + qiten * dt) * rho2 : (T)R1;
  T ni2 = l_qi2 ? mx((ni1d + niten * dt) * rho2, (T)R2) : (T)R2;
  const bool l_qr2 = (qr1d + qrten * dt) > (T)R1;
  T rr2 = l_qr2 ? (qr1d + qrten * dt) * rho2 : (T)R1;
  T nr2;
  {
    T nr_a = mx((nr1d + nrten * dt) * rho2, (T)R2);
    T lamr_a = POWC((T)(AM_R * CRG_3 * ORG2) * nr_a / rr2, OBMR);
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
    graupel_psd(rg2, temp2, l_qr2, mvd_r, valid, vx, ilamg, n0_g);
  }
  T ilamr2, n0_r2;
  {
    T lamr_a = POWC((T)(AM_R * CRG_3 * ORG2) * nr2 / rr2, OBMR);
    ilamr2 = (T)1 / lamr_a;
    n0_r2 = nr2 * (T)ORG2 * POWC(lamr_a, CRE_2);
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
  T prw_vcd_pos = clap * odt;
  // CCN activation (f90:2795-2801); non-aerosol: Nt_c
  const T xnc_act = AERO ? xnc_act_in : nt_c;
  T pnc_wcd_pos =
      clap > (T)EPS
          ? (T)0.5 * (xnc_act - nc2 + fabs(xnc_act - nc2)) * odts * orho2
          : (T)0;
  if (AERO) {
    // evaporate the drops smaller than Dc_star (f90:2804-2851)
    const bool evap_br = (clap < (T)(-EPS)) && (ssatw2 < (T)-1.0e-6);
    pnc_wcd_pos = evap_br ? mx(-nc2 * (T)0.99 * orho2 * odt,
                               -wev * orho2 * odt)
                          : pnc_wcd_pos;
    prw_vcd_pos = evap_br ? mx(-rc2 * (T)0.99 * orho2 * odt, prw_vcd_pos)
                          : prw_vcd_pos;
  }
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
    T nc_n = AERO ? mx((nc1d + dt * ncten) * rho2, (T)2.0) : nt_c;
    T qv_n = mx(qv1d + dt * qvten, (T)1.0e-10);
    T temp_n = t1d + dt * tten;
    rc2 = sat_mask ? rc_n : rc2;
    nc2 = sat_mask ? nc_n : nc2;
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
    // lvap2 and ocp2 change under rev_mask only; quick is read there only
    bool quick = false;
    T rev0 = 0;
    if (guard<AERO>(rev_mask)) {  // guard: rain_evap
      T rhof2_c = sqrt(sqrt((T)RHO_NOT * orho2));
      T diffu_c =
          (T)2.11e-5 * POWC(temp2 / (T)273.15, 1.94) * ((T)101325.0 / pres);
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
      quick = (qv2 / qvs2 < (T)0.95) && (rr2 * orho2 <= (T)1.0e-8);
      rev0 = t1_evap * diffu_c * (-ssatw2) * n0_r2 * rvs_w *
             ((T)T1_QR_EV * POWC(ilamr2, CRE_10) +
              (T)T2_QR_EV * vsc2_c * rhof2_c *
                  POWC(lamr_e + (T)(0.5 * FV_R), -CRE_11));
    }
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
    // fill_down reads a value only where its flag holds
    T vtr_m = 0, vtr_n = 0;
    if (guard<AERO>(valid_r)) {  // guard: rain_fall
      T lamr_s = POWC((T)(AM_R * CRG_3 * ORG2) * nr2 / rr2, OBMR);
      vtr_m = rhof3 * (T)AV_R * (T)CRG_6 * (T)ORG3 * POWC(lamr_s, CRE_3) *
              POWC(lamr_s + (T)FV_R, -CRE_6);
      vtr_n = rhof3 * (T)AV_R * (T)CRG_7 / (T)CRG_12 *
              POWC(lamr_s, CRE_12) * POWC(lamr_s + (T)FV_R, -CRE_7);
    }
    vtrk = fill_down(vtr_m, valid_r, vx);
    T vtnrk = fill_down(vtr_n, valid_r, vx);
    T vmax_r = mx(vtrk, vtnrk);
    sweep<T, true>(vmax_r, vtrk, vtnrk, qrten, nrten, rr2, nr2, (T)R1,
                   (T)R2, (T)1, orho3, odzq, dt, valid, nz, vx, pptrain);
  }
  if (!WARM) {
    const T gate = P.l_sediment ? (T)1 : (T)0;
    {
      const bool valid_i = valid && ri2 > (T)R1;
      T vti_m = 0, vti_n = 0;
      if (guard<AERO>(valid_i)) {  // guard: ice_fall
        T lami = POWC((T)(AM_I * CIG_2 * OIG1) * ni2 / ri2, OBMI);
        T ilami2 = (T)1 / lami;
        vti_m = rhof3 * (T)AV_I * (T)CIG_3 * (T)OIG2 * POWC(ilami2, BV_I);
        vti_n = rhof3 * (T)AV_I * (T)CIG_6 / (T)CIG_7 * POWC(ilami2, BV_I);
      }
      T vtik = fill_down(vti_m, valid_i, vx);
      T vtnik = fill_down(vti_n, valid_i, vx);
      sweep<T, true>(vtik, vtik, vtnik, qiten, niten, ri2, ni2, (T)R1,
                     (T)R2, gate, orho3, odzq, dt, valid, nz, vx, pptice);
    }
    {
      const bool valid_s = valid && rs2 > (T)R1;
      T vts_eff = 0;
      if (guard<AERO>(valid_s)) {  // guard: snow_fall
        T xds2 = smoc / mx(smob, (T)1e-30);
        T mrat = (T)1 / mx(xds2, (T)1e-30);
        T ils1 = (T)1 / (mrat * (T)LAM0 + (T)FV_S);
        T ils2 = (T)1 / (mrat * (T)LAM1 + (T)FV_S);
        T t1v = (T)(KAP0 * CSG_4) * POWC(ils1, CSE_4);
        T t2v = (T)KAP1 * POWC(mrat, MU_S) * (T)CSG_10 * POWC(ils2, CSE_10);
        ils1 = (T)1 / (mrat * (T)LAM0);
        ils2 = (T)1 / (mrat * (T)LAM1);
        T t3v = (T)(KAP0 * CSG_1) * POWC(ils1, CSE_1);
        T t4v = (T)KAP1 * POWC(mrat, MU_S) * (T)CSG_7 * POWC(ils2, CSE_7);
        T vts = rhof3 * (T)AV_S * (t1v + t2v) / (t3v + t4v);
        T vts_melt = mx(vts * vts_boost,
                        vts * ((vtrk - vts * vts_boost) / (temp2 - (T)T_0)));
        vts_eff = temp2 > (T)(T_0 + 0.1) ? vts_melt : vts * vts_boost;
      }
      T vtsk = fill_down(vts_eff, valid_s, vx);
      T dummy_t = 0, dummy_n = 0;
      sweep<T, false>(vtsk, vtsk, (T)0, qsten, dummy_t, rs2, dummy_n, (T)R1,
                      (T)R1, gate, orho3, odzq, dt, valid, nz, vx, pptsnow);
    }
    {
      const bool valid_g = valid && rg2 > (T)R1;
      T vtg_eff = 0;
      if (guard<AERO>(valid_g)) {  // guard: graupel_fall
        T vtg = rhof3 * (T)AV_G * (T)CGG_6 * (T)OGG3 * POWC(ilamg, BV_G);
        vtg_eff = temp2 > (T)T_0 ? mx(vtg, vtrk) : vtg;
      }
      T vtgk = fill_down(vtg_eff, valid_g, vx);
      T dummy_t = 0, dummy_n = 0;
      sweep<T, false>(vtgk, vtgk, (T)0, qgten, dummy_t, rg2, dummy_n, (T)R1,
                      (T)R1, gate, orho3, odzq, dt, valid, nz, vx, pptgraul);
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
    T lamc = POWC((T)AM_R * ccg2_n * ocg1_n * nc_out / mx(qc_out, (T)R1),
                  OBMR);
    T xdc3 = ((T)BM_R + (T)nu + (T)1.0) / lamc;
    lamc = xdc3 < (T)D0C
               ? cce2_n / (T)D0C
               : (xdc3 > (T)(D0R * 2.0) ? cce2_n / (T)(D0R * 2.0) : lamc);
    T nc_renorm = mn(ccg1_n * ocg2_n * qc_out / (T)AM_R * POWC(lamc, BM_R),
                     (T)NT_C_MAX / rho2);
    qc_out = has_c ? qc_out : (T)0;
    nc_out = has_c ? nc_renorm : (T)0;
  }
  T qi_out = qi1d + qiten * dt;
  T ni_out = mx(ni1d + niten * dt, (T)R2 / rho2);
  {
    const bool has_i = qi_out > (T)R1;
    T lami = POWC((T)(AM_I * CIG_2 * OIG1) * ni_out / mx(qi_out, (T)R1),
                  OBMI);
    T xdi3 = (T)(BM_I + MU_I + 1.0) / lami;
    lami = xdi3 < (T)5.0e-6
               ? (T)(CIE_2 / 5.0e-6)
               : (xdi3 > (T)300.0e-6 ? (T)(CIE_2 / 300.0e-6) : lami);
    T ni_renorm = mn((T)(CIG_1 * OIG2) * qi_out / (T)AM_I * POWC(lami, BM_I),
                     (T)499.0e3 / rho2);
    qi_out = has_i ? qi_out : (T)0;
    ni_out = has_i ? ni_renorm : (T)0;
  }
  T qr_out = qr1d + qrten * dt;
  T nr_out = mx(nr1d + nrten * dt, (T)R2 / rho2);
  {
    const bool has_r = qr_out > (T)R1;
    T lamr_f = POWC((T)(AM_R * CRG_3 * ORG2) * nr_out / mx(qr_out, (T)R1),
                    OBMR);
    T mvd_f = clampT((T)(3.0 + MU_R + 0.672) / lamr_f, (T)(D0R * 0.75),
                     (T)2.5e-3);
    lamr_f = (T)(3.0 + MU_R + 0.672) / mvd_f;
    T nr_renorm =
        (T)(CRG_2 * ORG3) * qr_out * POWC(lamr_f, BM_R) / (T)AM_R;
    qr_out = has_r ? qr_out : (T)0;
    nr_out = has_r ? nr_renorm : (T)0;
  }
  T qs_out = qs1d + qsten * dt;
  qs_out = qs_out > (T)R1 ? qs_out : (T)0;
  T qg_out = qg1d + qgten * dt;
  qg_out = qg_out > (T)R1 ? qg_out : (T)0;

  out.t = t_out; out.qv = qv_out; out.qc = qc_out; out.qi = qi_out;
  out.qr = qr_out; out.qs = qs_out; out.qg = qg_out; out.ni = ni_out;
  out.nr = nr_out; out.nc = nc_out; out.nwfa = nwfa_out;
  out.nifa = nifa_out;
  out.pptrain = pptrain; out.pptsnow = pptsnow; out.pptgraul = pptgraul;
  out.pptice = pptice;
  out.prv_rev = prv_rev; out.pnr_rev = pnr_rev;
}

// store the 12 state channels of ``o`` at y (ColumnState order), and the
// column's precip from level 0
template <typename T>
__device__ __forceinline__ void store_out(const Out<T>& o, T* __restrict__ y,
                                          T* __restrict__ ppt, size_t plane,
                                          size_t off, int ncol, int col,
                                          bool valid) {
  if (valid) {
    T* s = y + off;
    s[I_t * plane] = o.t; s[I_qv * plane] = o.qv; s[I_qc * plane] = o.qc;
    s[I_qi * plane] = o.qi; s[I_qr * plane] = o.qr; s[I_qs * plane] = o.qs;
    s[I_qg * plane] = o.qg; s[I_ni * plane] = o.ni; s[I_nr * plane] = o.nr;
    s[I_nc * plane] = o.nc; s[I_nwfa * plane] = o.nwfa;
    s[I_nifa * plane] = o.nifa;
  }
  if (threadIdx.x == 0) {
    ppt[0 * (size_t)ncol + col] = o.pptrain;
    ppt[1 * (size_t)ncol + col] = o.pptsnow;
    ppt[2 * (size_t)ncol + col] = o.pptgraul;
    ppt[3 * (size_t)ncol + col] = o.pptice;
  }
}

// threads of a column's block: nz rounded up to whole warps
inline int block_threads(int nz) {
  return (nz + 31) / 32 * 32;
}

// The register budgets: how many blocks of 128 threads must fit on an SM,
// by dtype and warm/mixed, for fused_step.cu and fused_kid_step.cu
// (MIN_BLOCKS_*), fused_rates.cu (RATES_MIN_BLOCKS_*), fused_post.cu
// (POST_MIN_BLOCKS_*), table_stage.cu (TABLE_MIN_BLOCKS_*) and advect.cu
// (ADVECT_MIN_BLOCKS_*, whose blocks have up to 256 threads).  Chosen on
// the card (PERF.md); kernel_budget.py rebuilds with -D to time others.
#ifndef MIN_BLOCKS_F32_MIXED
#define MIN_BLOCKS_F32_MIXED 5
#endif
#ifndef MIN_BLOCKS_F32_WARM
#define MIN_BLOCKS_F32_WARM 8
#endif
#ifndef MIN_BLOCKS_F64_MIXED
#define MIN_BLOCKS_F64_MIXED 3
#endif
#ifndef MIN_BLOCKS_F64_WARM
#define MIN_BLOCKS_F64_WARM 4
#endif
#ifndef RATES_MIN_BLOCKS_F32_MIXED
#define RATES_MIN_BLOCKS_F32_MIXED 5
#endif
#ifndef RATES_MIN_BLOCKS_F32_WARM
#define RATES_MIN_BLOCKS_F32_WARM 8
#endif
#ifndef RATES_MIN_BLOCKS_F64_MIXED
#define RATES_MIN_BLOCKS_F64_MIXED 3
#endif
#ifndef RATES_MIN_BLOCKS_F64_WARM
#define RATES_MIN_BLOCKS_F64_WARM 4
#endif
#ifndef POST_MIN_BLOCKS_F32_MIXED
#define POST_MIN_BLOCKS_F32_MIXED 8
#endif
#ifndef POST_MIN_BLOCKS_F32_WARM
#define POST_MIN_BLOCKS_F32_WARM 8
#endif
#ifndef POST_MIN_BLOCKS_F64_MIXED
#define POST_MIN_BLOCKS_F64_MIXED 4
#endif
#ifndef POST_MIN_BLOCKS_F64_WARM
#define POST_MIN_BLOCKS_F64_WARM 4
#endif
#ifndef TABLE_MIN_BLOCKS_F32_MIXED
#define TABLE_MIN_BLOCKS_F32_MIXED 6
#endif
#ifndef TABLE_MIN_BLOCKS_F32_WARM
#define TABLE_MIN_BLOCKS_F32_WARM 8
#endif
#ifndef TABLE_MIN_BLOCKS_F64_MIXED
#define TABLE_MIN_BLOCKS_F64_MIXED 4
#endif
#ifndef TABLE_MIN_BLOCKS_F64_WARM
#define TABLE_MIN_BLOCKS_F64_WARM 4
#endif
#ifndef LOOKUP_MIN_BLOCKS_F32_MIXED
#define LOOKUP_MIN_BLOCKS_F32_MIXED 8
#endif
#ifndef LOOKUP_MIN_BLOCKS_F32_WARM
#define LOOKUP_MIN_BLOCKS_F32_WARM 8
#endif
#ifndef LOOKUP_MIN_BLOCKS_F64_MIXED
#define LOOKUP_MIN_BLOCKS_F64_MIXED 4
#endif
#ifndef LOOKUP_MIN_BLOCKS_F64_WARM
#define LOOKUP_MIN_BLOCKS_F64_WARM 4
#endif
#ifndef ADVECT_MIN_BLOCKS_F32_MIXED
#define ADVECT_MIN_BLOCKS_F32_MIXED 10
#endif
#ifndef ADVECT_MIN_BLOCKS_F32_WARM
#define ADVECT_MIN_BLOCKS_F32_WARM 10
#endif
#ifndef ADVECT_MIN_BLOCKS_F64_MIXED
#define ADVECT_MIN_BLOCKS_F64_MIXED 6
#endif
#ifndef ADVECT_MIN_BLOCKS_F64_WARM
#define ADVECT_MIN_BLOCKS_F64_WARM 6
#endif
// the budget of one (dtype, warm/mixed) among a kernel's four
template <typename T, bool WARM>
constexpr int pick_budget(int f32_mixed, int f32_warm, int f64_mixed,
                          int f64_warm) {
  return sizeof(T) == 4 ? (WARM ? f32_warm : f32_mixed)
                        : (WARM ? f64_warm : f64_mixed);
}
template <typename T, bool WARM>
constexpr int kMinBlocks =
    pick_budget<T, WARM>(MIN_BLOCKS_F32_MIXED, MIN_BLOCKS_F32_WARM,
                         MIN_BLOCKS_F64_MIXED, MIN_BLOCKS_F64_WARM);
template <typename T, bool WARM>
constexpr int kRatesMinBlocks = pick_budget<T, WARM>(
    RATES_MIN_BLOCKS_F32_MIXED, RATES_MIN_BLOCKS_F32_WARM,
    RATES_MIN_BLOCKS_F64_MIXED, RATES_MIN_BLOCKS_F64_WARM);
template <typename T, bool WARM>
constexpr int kPostMinBlocks = pick_budget<T, WARM>(
    POST_MIN_BLOCKS_F32_MIXED, POST_MIN_BLOCKS_F32_WARM,
    POST_MIN_BLOCKS_F64_MIXED, POST_MIN_BLOCKS_F64_WARM);
template <typename T, bool WARM>
constexpr int kTableMinBlocks = pick_budget<T, WARM>(
    TABLE_MIN_BLOCKS_F32_MIXED, TABLE_MIN_BLOCKS_F32_WARM,
    TABLE_MIN_BLOCKS_F64_MIXED, TABLE_MIN_BLOCKS_F64_WARM);
// lookup_stage.cu's: warm and mixed configurations run the same
// arithmetic, each its own instantiation
template <typename T, bool WARM>
constexpr int kLookupMinBlocks = pick_budget<T, WARM>(
    LOOKUP_MIN_BLOCKS_F32_MIXED, LOOKUP_MIN_BLOCKS_F32_WARM,
    LOOKUP_MIN_BLOCKS_F64_MIXED, LOOKUP_MIN_BLOCKS_F64_WARM);
// advect.cu's: warm is its set of 5 tracers, mixed those of 9 and 12
template <typename T, bool WARM>
constexpr int kAdvectMinBlocks = pick_budget<T, WARM>(
    ADVECT_MIN_BLOCKS_F32_MIXED, ADVECT_MIN_BLOCKS_F32_WARM,
    ADVECT_MIN_BLOCKS_F64_MIXED, ADVECT_MIN_BLOCKS_F64_WARM);

// the second argument of __launch_bounds__(block, ...) for a kernel that
// must fit ``per128`` blocks of 128 threads on an SM: the same register
// budget per thread at either block size
__host__ __device__ constexpr int min_blocks(int per128, int block) {
  return per128 * 128 / block > 1 ? per128 * 128 / block : 1;
}

// launch a kernel instantiation on one block per column; returns the
// cudaError_t of the launch
template <typename Kernel, typename... Args>
int launch_columns(Kernel kernel, int ncol, int nz, void* stream,
                   Args... args) {
  if (nz < 2 || nz > kMaxThreads || ncol < 1)
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3(ncol), dim3(block_threads(nz)), 0, (cudaStream_t)stream>>>(
      args...);
  return (int)cudaGetLastError();
}

// what the card gives a kernel instantiation launched for nz levels: row =
// {registers per thread, local (spill) bytes per thread, static shared
// bytes per block, active blocks per SM}; returns the cudaError_t
template <typename Kernel>
int kernel_resources(Kernel kernel, int nz, int* row) {
  if (nz < 2 || nz > kMaxThreads) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, (const void*)kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    block_threads(nz), 0);
  row[0] = a.numRegs;
  row[1] = (int)a.localSizeBytes;
  row[2] = (int)a.sharedSizeBytes;
  row[3] = blocks;
  return (int)e;
}

}  // namespace
