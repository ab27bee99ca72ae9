"""PSD-moment diagnostics: radiation effective radii and 10-cm radar
reflectivity (twin of ``kid_tpu/diag/moments.py``).

Reference: calc_effectRad (module_mp_thompson09n.f90:4834-4935) and
calc_refl10cm (:4946-5244).  Rank-polymorphic torch ops over (..., nz), on
whatever device their inputs lie.  The reference's wet-melting Blahak soak
integration is disabled in the KiD build (nrbins=0 at :204, code commented
:5159-5189), so dBZ comes from the dry Rayleigh terms, as there.
"""
from __future__ import annotations

import functools

import torch

from .. import constants as c
from ..micro.fastmath import log10
from ..micro.solver import (CGE, CGG, CIG, CRE, CRG, _cummin_rev,
                            _field_moment, _rain_psd)

# Gamma(nu+4)/Gamma(nu+1) for nu = 1..15 (f90 g_ratio), indexed by nu-1
G_RATIO = (24.0, 60.0, 120.0, 210.0, 336.0, 504.0, 720.0, 990.0, 1320.0,
           1716.0, 2184.0, 2730.0, 3360.0, 4080.0, 4896.0)


@functools.lru_cache(maxsize=8)
def _g_ratio(dtype, device):
    """``G_RATIO`` on ``device``, made once, so that a captured call copies
    nothing from the host."""
    return torch.tensor(G_RATIO, dtype=dtype, device=device)


def effective_radii(t, p, qv, qc, nc, qi, ni, qs, nt_c: float,
                    is_aerosol_aware: bool = False):
    """Effective radii of cloud/ice/snow (f90:4834-4935).

    Returns (re_cloud, re_ice, re_snow) in meters, clamped to the
    reference's [2.49,50]/[4.99,125]/[9.99,999] micron windows.
    """
    rho = 0.622 * p / (c.R_GAS * t * (qv + 0.622))
    rc = torch.clamp(qc * rho, min=c.R1)
    nc_ = torch.clamp(nc * rho, min=c.R2)
    if not is_aerosol_aware:
        nc_ = torch.full_like(nc_, nt_c)
    ri = torch.clamp(qi * rho, min=c.R1)
    ni_ = torch.clamp(ni * rho, min=c.R2)
    rs = torch.clamp(qs * rho, min=c.R1)

    # cloud (f90:4872-4885): nu_c from number, g_ratio table
    inu = torch.where(nc_ < 100.0, 15.0, torch.where(
        nc_ > 1.0e10, 2.0,
        torch.clamp(torch.floor(1000.0e6 / nc_ + 0.5) + 2.0, max=15.0)))
    gr = _g_ratio(nc_.dtype, nc_.device)[
        torch.clamp(inu, 2.0, 15.0).long() - 1]
    lamc = torch.pow(nc_ * c.AM_R * gr / rc, c.OBMR)
    # active floor 2.51 um (f90:4884), inactive default 2.49 um (the value
    # the WRF driver presets before the CYCLE'd levels)
    re_qc = torch.clamp(0.5 * (3.0 + inu) / lamc, 2.51e-6, 50.0e-6)
    re_qc = torch.where((rc > c.R1) & (nc_ > c.R2), re_qc, 2.49e-6)

    # ice (f90:4887-4893)
    lami = torch.pow(c.AM_I * CIG[2] * c.OIG1 * ni_ / ri, c.OBMI)
    re_qi = torch.clamp(0.5 * (3.0 + c.MU_I) / lami, 5.01e-6, 125.0e-6)
    re_qi = torch.where((ri > c.R1) & (ni_ > c.R2), re_qi, 4.99e-6)

    # snow via Field moments (f90:4895-4932)
    tc0 = torch.clamp(t - 273.15, max=-0.1)
    smob = rs * c.OAMS
    smoc = _field_moment(log10(torch.clamp(smob, min=1e-35)), tc0,
                         float(c.CSE[1]))
    re_qs = torch.clamp(0.5 * smoc / torch.clamp(smob, min=1e-30),
                        10.0e-6, 999.0e-6)
    re_qs = torch.where(rs > c.R1, re_qs, 9.99e-6)
    return re_qc, re_qi, re_qs


def refl_10cm(qv, qc, qr, nr, qs, qg, t, p, iiwarm: bool = False):
    """10-cm Rayleigh radar reflectivity [dBZ] (f90:4946-5244)."""
    temp = t
    qv_ = torch.clamp(qv, min=1.0e-10)
    rho = 0.622 * p / (c.R_GAS * temp * (qv_ + 0.622))

    l_qr = qr > c.R1
    rr = torch.where(l_qr, qr * rho, c.R1)
    nr_ = torch.where(l_qr, torch.clamp(nr * rho, min=c.R2), c.R1)
    ilamr, mvd_r, n0_r = _rain_psd(rr, torch.clamp(nr_, min=c.R2))
    mvd_r = torch.where(l_qr, mvd_r, 50.0e-6)

    l_qs = qs > c.R2
    rs = torch.where(l_qs, qs * rho, c.R1)
    l_qg = qg > c.R2
    rg = torch.where(l_qg, qg * rho, c.R1)

    # snow moments incl. the bm_s*2 reflectivity moment (f90:5033-5081)
    tc0 = torch.clamp(temp - 273.15, max=-0.1)
    smob = rs * c.OAMS
    smoz = _field_moment(log10(torch.clamp(smob, min=1e-35)), tc0,
                         float(c.CSE[3]))

    # graupel N0 scan: the reflectivity variant keys on temp < 270.65
    # (f90:5089), not on the solver's k > k_0; kept as the reference has it
    cold = (temp < 270.65) & l_qr & (mvd_r > 100.0e-6)
    xslw1 = torch.where(cold, 4.01 + log10(mvd_r), 0.01)
    ygra1 = 4.31 + log10(torch.clamp(rg, min=5.0e-5))
    zans1 = 3.1 + (100.0 / (300.0 * xslw1 * ygra1
                            / (10.0 / xslw1 + 1.0 + 0.25 * ygra1)
                            + 30.0 + 10.0 * ygra1))
    n0_exp = torch.clamp(torch.pow(10.0, zans1), c.GONV_MIN, c.GONV_MAX)
    n0_exp = _cummin_rev(n0_exp)
    lam_exp = torch.pow(n0_exp * c.AM_G * CGG[1] / rg, c.OGE1)
    lamg = lam_exp * (CGG[3] * c.OGG2 * c.OGG1) ** c.OBMG
    ilamg = 1.0 / lamg
    n0_g = n0_exp / (CGG[2] * lam_exp) * torch.pow(lamg, CGE[2])

    ze_rain = torch.where(
        l_qr, n0_r * CRG[4] * torch.pow(ilamr, CRE[4]), 1.0e-22)
    ze_snow = torch.where(
        l_qs, (0.176 / 0.93) * (6.0 / c.PI) ** 2
        * (c.AM_S / 900.0) ** 2 * smoz, 1.0e-22)
    ze_graupel = torch.where(
        l_qg, (0.176 / 0.93) * (6.0 / c.PI) ** 2 * (c.AM_G / 900.0) ** 2
        * n0_g * CGG[4] * torch.pow(ilamg, CGE[4]), 1.0e-22)
    return 10.0 * log10((ze_rain + ze_snow + ze_graupel) * 1.0e18)
