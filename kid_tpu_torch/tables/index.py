"""Lookup-table index functions (twin of ``kid_tpu/tables/index.py``).

The reference finds the decade of a value with a NINT(log10)+-1 search
(module_mp_thompson09n.f90:1762-1881) and forms ``idx = INT(r/10**n) +
9*(n-n2)``.  Float->int conversions truncate toward zero like the
reference's ``astype(int32)``; each argument is clamped to a range that
covers the final clip first, so an out-of-range float never reaches the
cast (XLA saturates there, a C cast is undefined).  Indices are int64, the
type torch indexing takes.
"""
from __future__ import annotations

import math

import torch

_BIG = 2.0 ** 30


def trunc_int(x, lo: float = -_BIG, hi: float = _BIG):
    """C truncation toward zero of ``x`` clamped to [lo, hi], as int64."""
    return torch.clamp(x, lo, hi).to(torch.int64)


def fnint(x):
    """Fortran NINT: round half away from zero (float result)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def decade_index(r, n2: int, ntb: int):
    """0-based decade/mantissa index into a 1..9-per-decade axis
    (f90:1762-1774): for r in [10^n, 10^(n+1)), 1-based idx =
    INT(r/10^n) + 9*(n - n2), clamped to [1, ntb].  The caller masks the
    ``r <= axis[0]`` case (the reference returns 1 there)."""
    r = torch.clamp(r, min=1e-38)
    n = trunc_int(torch.floor(torch.log10(r)))
    pow10 = torch.pow(torch.full_like(r, 10.0), n.to(r.dtype))
    m = r / pow10
    # repair fp edge cases so 1 <= m < 10 exactly as the Fortran search
    n = torch.where(m < 1.0, n - 1, torch.where(m >= 10.0, n + 1, n))
    pow10 = torch.where(m < 1.0, pow10 / 10.0,
                        torch.where(m >= 10.0, pow10 * 10.0, pow10))
    m = r / pow10
    idx = trunc_int(m) + 9 * (n - n2)
    return torch.clamp(idx, 1, ntb) - 1


def log_bin_index(x, bin0: float, bin_last: float, nbins: int):
    """0-based index into log-spaced bins (f90:1717):
    ``MIN(nbins, 1 + INT(nbins*log(x/D(1))/log(D(n)/D(1))))``."""
    scale = float(nbins) / math.log(bin_last / bin0)
    idx = 1 + trunc_int(scale * torch.log(x / bin0), -2.0, nbins + 2.0)
    return torch.clamp(idx, 1, nbins) - 1


def tnc_index(nc, t_nc1: float, nic1: int, nbc: int):
    """0-based cloud-droplet-number index (f90:1777-1778)."""
    idx = fnint(1.0 + float(nbc) * torch.log(nc / t_nc1) / float(nic1))
    return torch.clamp(trunc_int(idx, -2.0, nbc + 2.0), 1, nbc) - 1
