"""KiD time loop: prescribed-flow advection -> microphysics -> update
(twin of ``kid_tpu/driver/loop.py``, 1-D and 2-D cases).

The adapter contract of mphys_thompson09n.f90:28-310 is kept:

  * microphysics sees the provisional state ``x + (adv + div)*dt``
    (mphys_thompson09n.f90:60-93);
  * theta <-> T through the fixed Exner profile (:60-61);
  * the microphysics output becomes the new state (the final update
    ``x + (adv + div + mphys)*dt`` telescopes, :198-245).

The loop is a Python loop over steps.  The time modulation m(t) is computed
on the host from the step index, in the state's dtype as the reference
rounds it, and the per-step precip and profile streams are written into
device tensors, so a step never waits for the device.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as c
from ..device import check_on, resolve_device
from ..micro import ColumnState, batched_microphysics
from ..micro import solver as S
from ..micro.solver import device_tables
from ..tables.cache import get_tables
from .advection import (advective_tendency_x_padded, advective_tendency_z,
                        divergence_tendency_z)
from .cases import Case

# The opt-in fused driver step (micro/fused_kid_step.py) for 1-D,
# non-aerosol cases: set to "1" to turn it on.
FUSED_DRIVER_ENV = "KID_TPU_TORCH_FUSED_DRIVER"


class KidState(NamedTuple):
    """Driver prognostics, all (nx, nz).  nc/nwfa/nifa are carried like
    the other tracers; in non-aerosol mode the solver forces nc itself and
    nothing reads nwfa, which drifts inertly (see the reference package)."""

    theta: torch.Tensor
    qv: torch.Tensor
    qc: torch.Tensor
    qr: torch.Tensor
    nr: torch.Tensor
    qi: torch.Tensor
    ni: torch.Tensor
    qs: torch.Tensor
    qg: torch.Tensor
    nc: torch.Tensor
    nwfa: torch.Tensor
    nifa: torch.Tensor


class StepOutputs(NamedTuple):
    """Per-step diagnostic streams, stacked over a leading time axis."""

    ppt_rain: torch.Tensor      # (n_steps, nx) surface precip per step
    ppt_snow: torch.Tensor
    ppt_graupel: torch.Tensor
    ppt_ice: torch.Tensor
    profiles: dict              # name -> (n_steps, nx, nz)


# the wrapper's microphysics-tendency back-outs (mphys_thompson09n.f90:
# 198-245): (micro_out - provisional)/dt
MPHYS_TENDENCY_NAMES = (
    "dtheta_mphys", "dqv_mphys", "dqc_mphys", "dqr_mphys", "dnr_mphys",
    "dqi_mphys", "dni_mphys", "dqs_mphys", "dqg_mphys")

# the solver's 36 per-level process-rate streams
# (module_mp_thompson09n.f90:2963-3124); keys of the solver diag dict
RATE_NAMES = (
    "prr_wau", "prr_rcw", "prv_rev", "pnr_wau", "pnr_rev", "pnr_rcr",
    "pri_inu", "pri_ide", "prs_ide", "prs_sde", "prg_gde", "pri_wfz",
    "prs_scw", "prg_scw", "prg_gcw", "pri_ihm", "pri_rfz", "prs_iau",
    "prs_sci", "pri_rci", "pni_inu", "pni_ihm", "pni_wfz", "pni_rfz",
    "pni_ide", "pni_iau", "pni_sci", "pni_rci", "prr_sml", "prr_gml",
    "pnr_rcs", "pnr_rcg", "pnr_rci", "pnr_sml", "pnr_gml", "pnr_rfz")

ALL_PROFILE_NAMES = KidState._fields + RATE_NAMES + MPHYS_TENDENCY_NAMES


def resolve_profile_names(profile_diags) -> tuple:
    """``False``/``()`` -> no streams; ``True`` -> every stream; a tuple
    of names selects those streams."""
    if profile_diags is True:
        return ALL_PROFILE_NAMES
    if not profile_diags:
        return ()
    names = tuple(profile_diags)
    unknown = [n for n in names if n not in ALL_PROFILE_NAMES]
    if unknown:
        raise ValueError(f"unknown diagnostic streams: {unknown}")
    return names


def initial_state(case: Case, dtype=torch.float64, device="cuda") -> KidState:
    """The case's initial sounding on ``device``, dry and cloud-free."""
    dev = resolve_device(device)
    grid = case.grid()
    shape = (case.nx, case.nz)
    nc0 = case.micro.nt_c / grid.rho0
    nwfa0 = (case.nwfa_init(grid.z) if case.nwfa_init is not None
             else 11.1e6 / grid.rho0)
    nifa0 = (case.nifa_init(grid.z) if case.nifa_init is not None
             else c.NA_IN1 * 0.01 / grid.rho0)

    def bcast(p):
        return torch.as_tensor(np.broadcast_to(p, shape).copy(),
                               dtype=dtype).to(dev)

    z = torch.zeros(shape, dtype=dtype, device=dev)
    return KidState(
        theta=bcast(case.theta_init(grid.z)), qv=bcast(case.qv_init(grid.z)),
        qc=z, qr=z, nr=z, qi=z, ni=z, qs=z, qg=z,
        nc=bcast(nc0), nwfa=bcast(nwfa0), nifa=bcast(nifa0))


def advected_fields(cfg) -> tuple:
    """The tracers the kinematic shell advects: the 9 scheme fields
    (mphys_thompson09n.f90:198-245), without the identically-zero ice
    species in warm-only cases; nc/nwfa/nifa only in aerosol mode."""
    if cfg.is_aerosol_aware:
        return KidState._fields
    if cfg.iiwarm:
        return ("theta", "qv", "qc", "qr", "nr")
    return ("theta", "qv", "qc", "qr", "nr", "qi", "ni", "qs", "qg")


def make_step(case: Case, tables, dtype, device, w_pat, u_pat_faces, pres2,
              pad_x, profile_names: tuple):
    """The per-step function (advect -> microphysics -> update).

    Args:
      w_pat:       (nx, nz+1) rho0*w z-face pattern.
      u_pat_faces: (nx+1, nz) rho0*u' x-face pattern; None for 1-D cases.
      pres2:       (nx, nz) pressure.
      pad_x:       callable (n_adv, nx, nz) -> (n_adv, nx+4, nz) adding 2
                   ghost columns per side; unused for 1-D cases.
      profile_names: from ``resolve_profile_names``.
    Returns ``step(state, istep) -> (new state, (4, nx) precip, profiles)``.
    """
    dev = resolve_device(device)
    grid = case.grid()

    def prof(a):
        return torch.as_tensor(a, dtype=dtype).to(dev)

    dz = prof(grid.dz)
    rho0 = prof(grid.rho0)
    rho_face = torch.cat([rho0[:1], 0.5 * (rho0[1:] + rho0[:-1]),
                          rho0[-1:]])
    exner = prof(grid.exner)[None, :]
    dzq2 = torch.broadcast_to(dz, pres2.shape)
    dt = case.dt
    odt = 1.0 / dt
    cfg = case.micro
    one_d = case.is_1d
    want_rates = any(n in RATE_NAMES for n in profile_names)
    # The fused driver step (advection of all 12 channels, provisional
    # state, Exner map and phases 2-20 in one kernel) is opt-in, as in the
    # reference, which measured it slower than the default there.  It
    # advects in z only, so 2-D cases never take it.  The table stage
    # still reads this step's provisional state, built from
    # ``advected_fields`` only, so nc/nwfa/nifa differ from the default
    # path's (ROADMAP.md, Queue 3).
    fused_driver = (one_d and not cfg.is_aerosol_aware
                    and os.environ.get(FUSED_DRIVER_ENV, "0") == "1")
    if fused_driver:     # imported here: the module imports this one
        from ..micro.fused_kid_step import fused_kid_step
    adv_fields = advected_fields(cfg)
    adv_idx = tuple(KidState._fields.index(f) for f in adv_fields)

    def step(st: KidState, istep: int):
        m = case.time_modulation(istep, dtype)
        w_face = m * w_pat                       # rho0*w at z-faces
        q = torch.stack([st[i] for i in adv_idx])
        # 1-D: flux form plus the divergence closure; 2-D: the
        # stream-function fluxes are non-divergent, so x-advection instead
        ten = advective_tendency_z(q, w_face, rho0, dz)
        if one_d:
            ten = ten + divergence_tendency_z(q, w_face, rho0, dz)
        else:
            u_face = case.u0 * rho0[None, :] + m * u_pat_faces
            ten = ten + advective_tendency_x_padded(pad_x(q), u_face, rho0,
                                                    case.dx)
        prov = q + ten * dt
        w_cent = None                  # cell-centred w, for activation
        if cfg.is_aerosol_aware:
            w_vel = w_face / rho_face
            w_cent = 0.5 * (w_vel[:, 1:] + w_vel[:, :-1])
        prov_named = dict(st._asdict())
        prov_named.update(zip(adv_fields, prov))
        micro_in = ColumnState(
            t=prov_named["theta"] * exner, qv=prov_named["qv"],
            qc=prov_named["qc"], qi=prov_named["qi"], qr=prov_named["qr"],
            qs=prov_named["qs"], qg=prov_named["qg"], ni=prov_named["ni"],
            nr=prov_named["nr"], nc=prov_named["nc"],
            nwfa=prov_named["nwfa"], nifa=prov_named["nifa"])
        if fused_driver:
            # the provisional state above feeds only the table stage; the
            # kernel derives its own from the raw state
            pro, idx = S._prologue(micro_in, pres2, cfg)
            tv = S._table_stage(pro, idx, tables, cfg, float(dt))
            new, ppt, diag = fused_kid_step(
                st, w_pat[0], m, tv, pres2[0], exner, rho0, dz, cfg,
                float(dt), want_rates)
        else:
            out, ppt, diag = batched_microphysics(
                micro_in, pres2, w_cent, dzq2, dt, tables, cfg,
                want_rates=want_rates, device=dev)
            new = KidState(
                theta=out.t / exner, qv=out.qv, qc=out.qc, qr=out.qr,
                nr=out.nr, qi=out.qi, ni=out.ni, qs=out.qs, qg=out.qg,
                nc=out.nc, nwfa=out.nwfa, nifa=out.nifa)
        new_named = new._asdict()
        profs = {}
        for name in profile_names:
            if name in diag:
                profs[name] = diag[name]
            elif name in new_named:
                profs[name] = new_named[name]
            else:
                f = name[1:-len("_mphys")]
                profs[name] = (new_named[f] - prov_named[f]) * odt
        return new, torch.stack([ppt.rain, ppt.snow, ppt.graupel,
                                 ppt.ice]), profs

    return step


def simulate(state0: KidState, tables, case: Case, n_steps: int,
             profile_diags=False, istep0: int = 0, device="cuda"):
    """Run ``n_steps`` of a case from ``state0``; returns
    (final KidState, StepOutputs).  ``istep0`` is the number of steps
    already taken, so a run can be chunked over several calls.  Every
    tensor must lie on ``device``; raises without a GPU unless
    ``device="cpu"``."""
    grid = case.grid()
    u_pat = None if case.is_1d else case.rhou_pattern(grid)

    def pad_x(q):        # periodic: wrap 2 columns from each end
        return torch.cat([q[:, -2:], q, q[:, :2]], 1)

    return run_steps(state0, tables, case, n_steps, profile_diags, istep0,
                     device, case.rhow_pattern(grid), u_pat, pad_x)


def run_steps(state0: KidState, tables, case: Case, n_steps: int,
              profile_diags, istep0: int, device, w_pat, u_pat_faces,
              pad_x):
    """The time loop of ``simulate`` over the columns that ``state0``
    holds, which may be a block of the case's columns: ``w_pat`` (ncol,
    nz+1) and ``u_pat_faces`` (ncol+1, nz; None for 1-D cases) are those
    columns' rows of the case's flow patterns, as numpy arrays, and
    ``pad_x`` fills their ghost columns (see ``make_step``)."""
    dev = resolve_device(device)
    for t in state0:
        check_on(t, dev)
    grid = case.grid()
    dtype = state0.qv.dtype
    shape = tuple(state0.qv.shape)

    def pattern(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    pres2 = torch.broadcast_to(pattern(grid.pres), shape)
    u_pat = None if u_pat_faces is None else pattern(u_pat_faces)
    names = resolve_profile_names(profile_diags)
    step = make_step(case, tables, dtype, dev, pattern(w_pat), u_pat, pres2,
                     pad_x, names)
    ppt = torch.empty((n_steps, 4, shape[0]), dtype=dtype, device=dev)
    profiles = {n: torch.empty((n_steps,) + shape, dtype=dtype, device=dev)
                for n in names}
    st = state0
    for i in range(n_steps):
        st, p, profs = step(st, istep0 + i)
        ppt[i] = p
        for n, v in profs.items():
            profiles[n][i] = v
    return st, StepOutputs(ppt_rain=ppt[:, 0], ppt_snow=ppt[:, 1],
                           ppt_graupel=ppt[:, 2], ppt_ice=ppt[:, 3],
                           profiles=profiles)


def run_case(case: Case, dtype=torch.float64, n_steps=None,
             profile_diags=False, device="cuda"):
    """Tables + initial state + ``simulate`` on ``device``."""
    dev = resolve_device(device)
    tables = device_tables(get_tables(iiwarm=case.micro.iiwarm), dtype,
                           device=dev)
    state0 = initial_state(case, dtype, dev)
    n = case.n_steps if n_steps is None else n_steps
    return simulate(state0, tables, case, n, profile_diags, device=dev)
