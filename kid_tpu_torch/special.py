"""Saturation mixing ratios and special functions (twin of
``kid_tpu/special.py``).

Reference: module_mp_thompson09n.f90:4530-4717.  The gamma family is used
only at init (host side, scipy); the Flatau saturation polynomials run on
the device as torch code with the same Horner nesting.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import special as _sps

# Flatau et al. 1992 liquid saturation polynomial (f90:4661-4669).
_RSLF_C = (0.611583699e03, 0.444606896e02, 0.143177157e01, 0.264224321e-1,
           0.299291081e-3, 0.203154182e-5, 0.702620698e-8, 0.379534310e-11,
           -0.321582393e-13)

# Flatau ice saturation polynomial (f90:4696-4704).
_RSIF_C = (0.609868993e03, 0.499320233e02, 0.184672631e01, 0.402737184e-1,
           0.565392987e-3, 0.521693933e-5, 0.307839583e-7, 0.105785160e-9,
           0.161444444e-12)


def _poly8(x, c):
    # Horner evaluation, matching the Fortran nesting exactly (f90:4674).
    acc = c[8]
    for k in range(7, -1, -1):
        acc = c[k] + x * acc
    return acc


def _sat(p, t, coef):
    x = torch.clamp(t - 273.16, min=-80.0)
    es = torch.minimum(_poly8(x, coef), p * 0.15)
    return 0.622 * es / (p - es)


def rslf(p, t):
    """Liquid saturation vapor mixing ratio (f90:4656-4686), with the
    ``ESL <= 0.15 p`` guard at f90:4675."""
    return _sat(p, t, _RSLF_C)


def rsif(p, t):
    """Ice saturation vapor mixing ratio (f90:4691-4717)."""
    return _sat(p, t, _RSIF_C)


def _sat_np(p, t, coef):
    x = np.maximum(-80.0, np.asarray(t, np.float64) - 273.16)
    acc = np.float64(coef[8])
    for k in range(7, -1, -1):
        acc = coef[k] + x * acc
    es = np.minimum(acc, np.asarray(p, np.float64) * 0.15)
    return 0.622 * es / (p - es)


def rslf_np(p, t):
    """NumPy float64 twin of :func:`rslf`."""
    return _sat_np(p, t, _RSLF_C)


def rsif_np(p, t):
    """NumPy float64 twin of :func:`rsif`."""
    return _sat_np(p, t, _RSIF_C)


def gammp(a, x):
    """Regularized lower incomplete gamma P(a,x) (f90:4623-4641)."""
    return _sps.gammainc(a, x)


def gammln(x):
    """ln Gamma(x) (f90:4598-4620)."""
    return _sps.gammaln(x)


def wgamma(y):
    """Gamma(y) = exp(GAMMLN) (f90:4644-4651)."""
    return np.exp(_sps.gammaln(y))
