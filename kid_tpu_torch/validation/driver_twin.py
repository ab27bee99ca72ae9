"""Driver-level oracle twin: the KiD time loop with the oracle microphysics
(the port's counterpart of ``kid_tpu/validation/driver_twin.py``).

The per-step contract of ``driver.loop.make_step`` replayed on the host:
the same prescribed-flow advection tendencies (the driver's own
``driver/advection.py``, in torch float64 on the CPU), the same
provisional state ``x + (adv + div)*dt`` (mphys_thompson09n.f90:60-93),
the same theta/T/pressure mapping (:60-61), with the microphysics
advanced column by column by the NumPy float64 transliteration
``oracle.mp_thompson_oracle``.  Held against ``driver.loop.simulate``,
it isolates the column solver's difference over a whole case.  2-D cases
add the periodic stream-function x-advection, padded as the reference
twin pads it.

m(t) is taken as the reference twin takes it (``twin_modulation``), in
Python floats, which is not the compiled driver's rounding
(``Case.time_modulation``): in float64 the two differ in the last bit at
some steps of every case.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..driver.advection import (advective_tendency_x_padded,
                                advective_tendency_z, divergence_tendency_z)
from ..driver.cases import Case
from ..driver.loop import KidState, advected_fields, initial_state
from .oracle import mp_thompson_oracle

PPT = ("rain", "snow", "graupel", "ice")
# (driver field, oracle output key) of the fields the solver returns
_OUT_KEYS = (("qv", "qv1d"), ("qc", "qc1d"), ("qr", "qr1d"), ("nr", "nr1d"),
             ("qi", "qi1d"), ("ni", "ni1d"), ("qs", "qs1d"), ("qg", "qg1d"),
             ("nc", "nc1d"), ("nwfa", "nwfa1d"), ("nifa", "nifa1d"))


def twin_modulation(case: Case, istep: int) -> float:
    """m(t) at step ``istep`` as the reference twin evaluates it
    (``driver_twin.py:82-83``): ``t = istep * dt`` in Python floats, then
    ``sin(pi * t / t1)`` while ``t < t1`` (else 0), or ``min(t / t1, 1)``
    for the ramp."""
    t = istep * case.dt
    if case.modulation == "pulse":
        return math.sin(math.pi * t / case.t1) if t < case.t1 else 0.0
    return min(t / case.t1, 1.0)


def oracle_simulate(case: Case, n_steps: int, tables_host,
                    want_means: bool = False):
    """``n_steps`` of ``case`` from its initial sounding with the oracle
    microphysics, on the CPU in float64 only.

    Returns (final fields: name -> (nx, nz) float64 array, surface precip
    series: species -> (n_steps,) for 1-D cases and (n_steps, nx) for
    2-D cases); with ``want_means`` also the time-mean (nx, nz) profile
    of every field over the run."""
    grid = case.grid()
    cfg = case.micro
    dt = case.dt
    nx, nz = case.nx, case.nz
    one_d = case.is_1d
    exner = np.asarray(grid.exner, np.float64)
    pres = np.asarray(grid.pres, np.float64)
    rho0 = np.asarray(grid.rho0, np.float64)
    rho_face = np.concatenate([rho0[:1], 0.5 * (rho0[1:] + rho0[:-1]),
                               rho0[-1:]])
    dzq = np.asarray(grid.dz, np.float64)

    def put(a):
        return torch.tensor(np.asarray(a, np.float64))

    rho0_t, dz_t = put(rho0), put(grid.dz)
    w_pat = put(case.rhow_pattern(grid))                  # (nx, nz+1)
    u_pat = None if one_d else put(case.rhou_pattern(grid))

    st0 = initial_state(case, torch.float64, "cpu")
    fields = {f: getattr(st0, f).numpy().copy() for f in KidState._fields}
    shape = (n_steps,) if one_d else (n_steps, nx)
    ppt = {k: np.zeros(shape) for k in PPT}
    mean_acc = {f: np.zeros((nx, nz)) for f in KidState._fields}
    adv_fields = advected_fields(cfg)

    for istep in range(n_steps):
        m = twin_modulation(case, istep)
        w_face = m * w_pat
        q = torch.as_tensor(np.stack([fields[f] for f in adv_fields]))
        ten = advective_tendency_z(q, w_face, rho0_t, dz_t)
        if one_d:
            ten = ten + divergence_tendency_z(q, w_face, rho0_t, dz_t)
        else:
            u_face = case.u0 * rho0_t[None, :] + m * u_pat
            qpad = torch.cat([q[:, -2:], q, q[:, :2]], 1)
            ten = ten + advective_tendency_x_padded(qpad, u_face, rho0_t,
                                                    case.dx)
        ten = ten.numpy()
        prov = dict(fields)
        for i, f in enumerate(adv_fields):
            prov[f] = fields[f] + ten[i] * dt

        w_vel = w_face.numpy() / rho_face                  # (nx, nz+1)
        w_cent = 0.5 * (w_vel[:, 1:] + w_vel[:, :-1])

        new = {f: np.empty((nx, nz)) for f in KidState._fields}
        for i in range(nx):
            out = mp_thompson_oracle(
                prov["qv"][i], prov["qc"][i], prov["qi"][i], prov["qr"][i],
                prov["qs"][i], prov["qg"][i], prov["ni"][i], prov["nr"][i],
                prov["nc"][i], prov["nwfa"][i], prov["nifa"][i],
                prov["theta"][i] * exner, pres, w_cent[i], dzq, dt,
                tables_host, iiwarm=cfg.iiwarm, l_sediment=cfg.l_sediment,
                set_nc=cfg.set_nc, is_aerosol_aware=cfg.is_aerosol_aware,
                ifdry=1 if cfg.ifdry else 0, dusty_ice=cfg.dusty_ice,
                homog_ice=cfg.homog_ice)
            new["theta"][i] = out["t1d"] / exner
            for f, k in _OUT_KEYS:
                new[f][i] = np.asarray(out[k], np.float64)
            loc = istep if one_d else (istep, i)
            for k, key in zip(PPT, ("pptrain", "pptsnow", "pptgraul",
                                    "pptice")):
                ppt[k][loc] = out[key]
        fields = new
        for f in KidState._fields:
            mean_acc[f] += new[f]

    if want_means:
        means = {f: a / max(n_steps, 1) for f, a in mean_acc.items()}
        return fields, ppt, means
    return fields, ppt
