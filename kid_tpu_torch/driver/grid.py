"""Vertical grid and basic-state thermodynamics for the KiD shell.

The reference KiD shell (absent from the checkout; interface reconstructed
from mphys_thompson09n.f90:11-17,60-63) owns a fixed Exner-pressure profile:
``p = p0 * exner**(1/r_on_cp)`` and ``T = theta * exner``.  Here the Exner
profile is diagnosed hydrostatically from the initial theta profile once at
setup and held fixed, as KiD does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

P0 = 1.0e5               # KiD physconst p0
R_ON_CP = 287.04 / 1004.0
G = 9.81
CP = 1004.0


class Grid(NamedTuple):
    """Static (numpy, host-side) description of the column grid."""

    z: np.ndarray        # cell-center heights (nz,)
    dz: np.ndarray       # layer thickness (nz,)
    exner: np.ndarray    # Exner function at centers (nz,)
    pres: np.ndarray     # pressure [Pa] (nz,)
    rho0: np.ndarray     # basic-state dry density (nz,)


def make_grid(nz: int, ztop: float, theta_prof: np.ndarray,
              psfc: float = P0) -> Grid:
    """Uniform grid with a hydrostatic Exner profile for ``theta_prof``."""
    dz = np.full(nz, ztop / nz)
    z = (np.arange(nz) + 0.5) * dz
    # exner at surface from psfc, integrate d(exner)/dz = -g/(cp*theta)
    exner = np.zeros(nz)
    ex_sfc = (psfc / P0) ** R_ON_CP
    ex = ex_sfc - G / (CP * theta_prof[0]) * z[0]
    exner[0] = ex
    for k in range(1, nz):
        th_mid = 0.5 * (theta_prof[k - 1] + theta_prof[k])
        exner[k] = exner[k - 1] - G / (CP * th_mid) * (z[k] - z[k - 1])
    pres = P0 * exner ** (1.0 / R_ON_CP)
    temp = theta_prof * exner
    rho0 = pres / (287.04 * temp)
    return Grid(z=z, dz=dz, exner=exner, pres=pres, rho0=rho0)
