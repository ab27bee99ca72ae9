"""Aerosol-aware microphysics functions in PyTorch (twin of
``kid_tpu/micro/aerosol.py``).

Reference: module_mp_thompson09n.f90:4354-4390 (Eff_aero), :4451-4526
(activ_ncloud), :4720-4756 (iceDeMott), :4764-4789 (iceKoop), :4794-4823
(delta_p).  The arithmetic keeps the reference package's order: constant
powers through ``fastmath.powc``, integer powers through ``fastmath.ipow``
(binary squaring, as JAX's ``x ** k``), and a general power with a tensor
exponent as ``torch.pow``.  ``activ_ncloud`` fetches its four bilinear
corners by plain indexing where the reference used a one-hot product; both
are exact selections of the same table cells.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import constants as c
from .fastmath import exp10, ipow, powc


def slip_correction(da: float) -> float:
    """Cunningham slip correction of an aerosol of diameter ``da`` (m), in
    Python floats; the CUDA kernels read it as a constant of the header
    that ``cuda_build.constants_header`` generates."""
    mean_path = 0.0256e-6
    return 1.0 + 2.0 * mean_path / da * (1.257
                                         + 0.4 * math.exp(-0.55 * da
                                                          / mean_path))


def eff_aero(d, da, visc, rhoa, temp, species: str):
    """Slinn/Wang aerosol-scavenging collision efficiency (f90:4354-4390);
    ``species`` in {'r', 's', 'g'} picks the collector fall-speed law."""
    if species == "r":
        vt = (-0.1021 + 4.932e3 * d - 0.9551e6 * d * d
              + 0.07934e9 * ipow(d, 3) - 0.002362e12 * ipow(d, 4))
    elif species == "s":
        vt = c.AV_S * powc(d, c.BV_S)
    elif species == "g":
        vt = c.AV_G * powc(d, c.BV_G)
    else:
        raise ValueError(species)
    boltzman = 1.3806503e-23
    cc = slip_correction(da)
    diff = boltzman * temp * cc / (3.0 * c.PI * visc * da)
    re = 0.5 * rhoa * d * vt / visc
    sc = visc / (rhoa * diff)
    st = da * da * vt * 1000.0 / (9.0 * visc * d)
    aval = 1.0 + torch.log(1.0 + re)
    st2 = (1.2 + 1.0 / 12.0 * aval) / (1.0 + aval)
    eff = (4.0 / (re * sc) * (1.0 + 0.4 * torch.sqrt(re)
                              * powc(sc, 1.0 / 3.0)
                              + 0.16 * torch.sqrt(re) * torch.sqrt(sc))
           + 4.0 * da / d * (0.02 + da / d * (1.0 + 2.0 * torch.sqrt(re))))
    eff = eff + torch.where(
        st > st2, powc(torch.clamp(st - st2, min=0.0)
                       / (st - st2 + 0.666667), 1.5), 0.0)
    return torch.clamp(eff, 1.0e-5, 1.0)


_TA_NA = np.asarray(c.TA_NA, np.float64)
_TA_WW = np.asarray(c.TA_WW, np.float64)
_LOG_TA_NA = np.log(_TA_NA)
_LOG_TA_WW = np.log(_TA_WW)


@functools.lru_cache(maxsize=8)
def _axes(dtype, device):
    """The activation table's na and w axes on ``device``: float64 for the
    bin search, their logs in ``dtype``.  Made once, so that a step copies
    nothing from the host (a CUDA graph cannot capture such a copy)."""
    return (torch.as_tensor(_TA_NA, device=device),
            torch.as_tensor(_TA_WW, device=device),
            torch.as_tensor(_LOG_TA_NA, dtype=dtype, device=device),
            torch.as_tensor(_LOG_TA_WW, dtype=dtype, device=device))


def activ_ncloud(tt, ww, nccn, tnccn_corners):
    """CCN activation by bilinear log-interpolation into the activation
    table's (l=2, m=1) plane (f90:4451-4526); ``tnccn_corners`` is the
    (7*9*7, 4) corner matrix of ``solver._tnccn_corners``.  With the
    variant's table of ones this returns ``nccn``."""
    dtype, dev = nccn.dtype, nccn.device
    n_local = torch.clamp(nccn * 1.0e-6, float(c.TA_NA[0]) + 1.0,
                          float(c.TA_NA[-1]) - 1.0)
    w_local = torch.clamp(ww, float(c.TA_WW[0]) + 0.001,
                          float(c.TA_WW[-1]) - 1.0)
    ta_na, ta_ww, log_na, log_ww = _axes(dtype, dev)
    # bin search in float64, where every value of either type is exact
    i = torch.clamp(torch.searchsorted(ta_na, n_local.double(), right=True),
                    1, len(_TA_NA) - 1)
    j = torch.clamp(torch.searchsorted(ta_ww, w_local.double(), right=True),
                    1, len(_TA_WW) - 1)
    k = torch.clamp(torch.round((tt - float(c.TA_TK[0])) * 0.1)
                    .to(torch.int64) + 1, 1, len(c.TA_TK)) - 1
    nj, nk = len(_TA_WW), len(c.TA_TK)
    a, b, cc, dd = tnccn_corners[(i * nj + j) * nk + k].unbind(-1)
    x1, x2 = log_na[i - 1], log_na[i]
    y1, y2 = log_ww[j - 1], log_ww[j]
    t = (torch.log(n_local) - x1) / (x2 - x1)
    u = (torch.log(w_local) - y1) / (y2 - y1)
    frac = ((1.0 - t) * (1.0 - u) * a + t * (1.0 - u) * b + t * u * cc
            + (1.0 - t) * u * dd)
    return nccn * frac


def ice_demott(tempc, qv, qvs, qvsi, rho, nifa):
    """DeMott et al. (2010) dust ice-nucleation count (f90:4720-4756)."""
    rho_not0 = 101325.0 / (287.05 * 273.15)
    nifa_cc = nifa * rho_not0 * 1.0e-6 / rho
    xni = (5.94e-5 * torch.pow(-tempc, 3.33)
           * torch.pow(nifa_cc, (-0.0264 * tempc) + 0.0033))
    xni = xni * rho / rho_not0 * 1000.0
    return torch.clamp(xni, min=0.0)


def ice_koop(temp, qv, qvs, naero, dt):
    """Koop et al. (2001) homogeneous aerosol freezing, J-rate reduced
    100x (f90:4764-4789)."""
    satw = qv / qvs
    mu_diff = (210368.0 + 131.438 * temp - 3.32373e6 / temp
               - 41729.1 * torch.log(temp))
    a_w_i = torch.exp(mu_diff / (c.R_UNI * temp))
    delta_aw = satw - a_w_i
    log_j = (-906.7 + 8502.0 * delta_aw - 26924.0 * ipow(delta_aw, 2)
             + 29180.0 * ipow(delta_aw, 3))
    j_rate = exp10(torch.clamp(log_j, max=20.0))
    prob_h = torch.clamp(1.0 - torch.exp(-j_rate * c.AR_VOLUME * dt),
                         max=1.0)
    xni = torch.where(prob_h > 0.0,
                      torch.clamp(prob_h * naero, max=1000.0e3), 0.0)
    return torch.clamp(xni, min=0.0)


def delta_p(yy, y1, y2, aa, bb):
    """Phillips et al. (2008) cubic-interpolation helper (f90:4794-4823)."""
    a_ = 6.0 * (aa - bb) / ipow(y2 - y1, 3)
    b_ = aa + a_ * ipow(y1, 3) / 6.0 - a_ * y1 * y1 * y2 * 0.5
    a0, a1 = b_, a_ * y1 * y2
    a2, a3 = -a_ * (y1 + y2) * 0.5, a_ / 3.0
    dab = torch.where(yy <= y1, aa,
                      torch.where(yy >= y2, bb,
                                  a0 + a1 * yy + a2 * ipow(yy, 2)
                                  + a3 * ipow(yy, 3)))
    return torch.clamp(dab, aa, bb)
