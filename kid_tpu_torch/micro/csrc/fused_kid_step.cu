// The whole 1-D KiD driver step as one CUDA kernel for Hopper (sm_90a):
// vertical MUSCL advection and the divergence closure of the 12 KidState
// channels, the provisional state q + (adv + div)*dt, theta -> T, phases
// 2-20 of the Thompson09 microphysics and T -> theta.
//
// Replaces kid_tpu/micro/pallas_step.py::fused_kid_step (the Pallas TPU
// kernel of the opt-in fused driver).  Its plain PyTorch version is
// kid_tpu_torch/micro/fused_kid_step.py::fused_kid_step_ref; the advection
// below, with thompson.cuh's face_value (which advect.cu shares),
// transcribes kid_tpu_torch/driver/advection.py in the same association
// order, and the microphysics is the prologue -> rates -> post of
// thompson.cuh that fused_step.cu runs.
//
// Boundary: the raw state in KidState order (theta, qv, qc, qr, nr, qi, ni,
// qs, qg, nc, nwfa, nifa) and the 18 table-stage channels (1 warm) go in,
// with a (5, nz + 1) profile input (the rho0*w face pattern, pres, exner,
// rho0, dz); the new state in KidState order (+36 rate profiles) and 4
// per-column precip values come out.  The table-stage channels are built by
// the caller from its own provisional state, as the reference does.
//
// Mapping: one thread block per column, one thread per level, with the
// block sizes, register budget and warp-level helpers of fused_step.cu.
// The column's 12 raw channels are staged in shared memory (12 x BLOCK
// values) because the MUSCL face values at level k read levels k-2 ..
// k+2.  Each level computes the flux of its bottom face only; the flux of
// its top face, the bottom face of the level above, comes from the next
// lane by __shfl_down_sync, and lane 31 reads the next warp's lane 0 from
// a slot after one barrier.  So every face value and its four divisions
// are computed once, with the same expression as the plain version, and
// the fluxes are bit for bit those of computing both faces per level.
//
// Bound at (ncol, nz) = (8192, 120) f32 without rates: 30 input + 12 output
// channels of 3.93 MB (+ precip and the profiles) is ~165 MB, >= ~49 us at
// 3.35 TB/s; bytes bound it.  No fast math (-fmad=false).  On an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md): 0.86 ms/launch when each level
// computed both of its faces at 4 blocks/SM, 0.79 with each face once,
// 0.67 with the 5-block budget (96 registers, 64 spill bytes).

#include "thompson.cuh"

namespace {

// the driver's state channels (kid_tpu_torch/driver/loop.py::KidState)
enum KidCh {
  K_theta, K_qv, K_qc, K_qr, K_nr, K_qi, K_ni, K_qs, K_qg, K_nc, K_nwfa,
  K_nifa, N_KID
};
// rows of the profile input, each nz + 1 long
enum ProfRow { R_wpat, R_pres, R_exner, R_rho0, R_dz };

template <typename T, bool WARM, bool RATES, int BLOCK>
__global__ void __launch_bounds__(BLOCK,
                                  min_blocks(kMinBlocks<T, WARM>, BLOCK))
    fused_kid_step_kernel(const T* __restrict__ x, const T* __restrict__ prof,
                          T* __restrict__ y, T* __restrict__ ppt, int ncol,
                          int nz, int l_sediment, double nt_c, double dt,
                          double ifdry, const T* __restrict__ mmod) {
  __shared__ Shared<T> sh;
  __shared__ T raw[N_KID][BLOCK];
  __shared__ T face[N_KID][kMaxWarps];
  Vert<T> vx{sh, 0};
  const int col = blockIdx.x;
  const int lane = lane_id(), warp = warp_id();
  const bool valid = (int)threadIdx.x < nz;
  const int kl = valid ? threadIdx.x : nz - 1;  // padding mirrors the top
  const size_t plane = (size_t)ncol * nz;
  const size_t off = (size_t)col * nz + kl;
  const Params<T> P = make_params<T>(dt, nt_c, ifdry, l_sediment, 0, 0);
  const T* pr = prof + kl;
  const int np1 = nz + 1;

  if (valid) {
#pragma unroll
    for (int c = 0; c < N_KID; ++c) raw[c][kl] = x[c * plane + off];
  }
  __syncthreads();

  // face fluxes rho0*w of this level's bottom (kl) and top (kl+1) faces;
  // the end faces of the column carry no flux
  const T m = *mmod;
  const T w_lo = m * pr[R_wpat * np1];
  const T w_hi = m * pr[R_wpat * np1 + 1];
  const T f_lo = kl == 0 ? (T)0 : w_lo;
  const T f_hi = kl + 1 == nz ? (T)0 : w_hi;
  const T rd = pr[R_rho0 * np1] * pr[R_dz * np1];
  // each level computes the tracer flux of its bottom face; its top face
  // is the bottom face of the level above, from the next lane (lane 31:
  // from the next warp's lane 0, through shared memory)
  T flux_lo[N_KID], flux_up[N_KID];
#pragma unroll
  for (int c = 0; c < N_KID; ++c) {
    flux_lo[c] = kl == 0 ? (T)0 : w_lo * face_value(raw[c], kl, nz, w_lo);
    flux_up[c] = __shfl_down_sync(kFullMask, flux_lo[c], 1);
    if (lane == 0) face[c][warp] = flux_lo[c];
  }
  __syncthreads();
  T prov[N_KID];
#pragma unroll
  for (int c = 0; c < N_KID; ++c) {
    const T q = raw[c][kl];
    const T flux_hi = kl + 1 == nz ? (T)0
                      : lane == kWarp - 1 ? face[c][warp + 1]
                                          : flux_up[c];
    const T adv = -(flux_hi - flux_lo[c]) / rd;
    const T dvg = q * (f_hi - f_lo) / rd;
    const T ten = adv + dvg;
    prov[c] = q + ten * P.dt;
  }

  // the provisional state as the microphysics' cell (theta -> T)
  const T exner = pr[R_exner * np1];
  Cell<T> s;
  s.t1d = prov[K_theta] * exner;
  s.qv1d = prov[K_qv]; s.qc1d = prov[K_qc]; s.qi1d = prov[K_qi];
  s.qr1d = prov[K_qr]; s.qs1d = prov[K_qs]; s.qg1d = prov[K_qg];
  s.ni1d = prov[K_ni]; s.nr1d = prov[K_nr]; s.nc1d = prov[K_nc];
  s.nwfa1d = prov[K_nwfa]; s.nifa1d = prov[K_nifa];
  s.pres = pr[R_pres * np1];
  const T dzq = pr[R_dz * np1];

  Pro<T> p;
  prologue<T, WARM, false>(s, P, valid, vx, p);
  Late<T> l;
  set_late(l, s, p, dzq);
  P8<T> q;
  T* d = RATES ? y + N_KID * plane + off : nullptr;
  rates<T, WARM, RATES, false>(p, x + N_KID * plane + off, plane, P, valid,
                               q, d);
  if (RATES && valid) d[D_prr_gml * plane] = q.prr_gml;
  Out<T> o;
  post<T, WARM, false>(l, p, q, (T)0, (T)0, P, valid, nz, vx, o);

  if (valid) {
    T* n = y + off;
    n[K_theta * plane] = o.t / exner;
    n[K_qv * plane] = o.qv; n[K_qc * plane] = o.qc; n[K_qr * plane] = o.qr;
    n[K_nr * plane] = o.nr; n[K_qi * plane] = o.qi; n[K_ni * plane] = o.ni;
    n[K_qs * plane] = o.qs; n[K_qg * plane] = o.qg; n[K_nc * plane] = o.nc;
    n[K_nwfa * plane] = o.nwfa; n[K_nifa * plane] = o.nifa;
  }
  if (threadIdx.x == 0) {
    ppt[0 * (size_t)ncol + col] = o.pptrain;
    ppt[1 * (size_t)ncol + col] = o.pptsnow;
    ppt[2 * (size_t)ncol + col] = o.pptgraul;
    ppt[3 * (size_t)ncol + col] = o.pptice;
  }
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
    return want_rates ? f(fused_kid_step_kernel<T, true, true, BLOCK>)
                      : f(fused_kid_step_kernel<T, true, false, BLOCK>);
  return want_rates ? f(fused_kid_step_kernel<T, false, true, BLOCK>)
                    : f(fused_kid_step_kernel<T, false, false, BLOCK>);
}
template <typename T, typename F>
int with_kernel(int nz, int iiwarm, int want_rates, F f) {
  return nz <= 128 ? with_block<T, 128>(iiwarm, want_rates, f)
                   : with_block<T, kMaxThreads>(iiwarm, want_rates, f);
}

template <typename T>
int launch(const T* x, const T* prof, T* y, T* ppt, int ncol, int nz,
           int iiwarm, int want_rates, int l_sediment, double nt_c, double dt,
           double ifdry, const T* mmod, void* stream) {
  return with_kernel<T>(nz, iiwarm, want_rates, [&](auto kernel) {
    return launch_columns(kernel, ncol, nz, stream, x, prof, y, ppt, ncol,
                          nz, l_sediment, nt_c, dt, ifdry, mmod);
  });
}

}  // namespace

// the resources of the instantiation launched for (nz, dtype, iiwarm,
// want_rates): see kernel_resources in thompson.cuh
extern "C" int kid_fused_kid_step_resources(int nz, int f64, int iiwarm,
                                            int want_rates, int* row) {
  auto f = [&](auto kernel) { return kernel_resources(kernel, nz, row); };
  return f64 ? with_kernel<double>(nz, iiwarm, want_rates, f)
             : with_kernel<float>(nz, iiwarm, want_rates, f);
}

// C interface, loaded with ctypes by kid_tpu_torch/micro/fused_kid_step.py.
// x: (12 + ntv, ncol, nz), prof: (5, nz + 1), y: (12 [+36], ncol, nz),
// ppt: (4, ncol), all contiguous on the card; mmod points to m(t), one
// value of the state's dtype on the card (read by the kernel, so a CUDA
// graph that captures the launch reads each replay's m).  Returns the
// cudaError_t of the launch.
extern "C" int kid_fused_kid_step_f32(const float* x, const float* prof,
                                      float* y, float* ppt, int ncol, int nz,
                                      int iiwarm, int want_rates,
                                      int l_sediment, double nt_c, double dt,
                                      double ifdry, const float* mmod,
                                      void* stream) {
  return launch<float>(x, prof, y, ppt, ncol, nz, iiwarm, want_rates,
                       l_sediment, nt_c, dt, ifdry, mmod, stream);
}

extern "C" int kid_fused_kid_step_f64(const double* x, const double* prof,
                                      double* y, double* ppt, int ncol,
                                      int nz, int iiwarm, int want_rates,
                                      int l_sediment, double nt_c, double dt,
                                      double ifdry, const double* mmod,
                                      void* stream) {
  return launch<double>(x, prof, y, ppt, ncol, nz, iiwarm, want_rates,
                        l_sediment, nt_c, dt, ifdry, mmod, stream);
}
