"""Power helpers with a fixed operation order (twin of
``kid_tpu/micro/fastmath.py``).

``powc`` expands x**const into multiply/sqrt/cube-root chains for integer,
half-, quarter-, sixth- and third-integer exponents, with the cube root as
``exp(log(x)/3)``, exactly as the reference package does; ``ipow`` is the
binary-squaring order of an integer power (JAX's ``x ** k``); ``log10`` is
``log(x) * (1/ln 10)`` as ``jnp.log10`` computes it.  The CUDA kernel
(csrc/fused_step.cu) repeats the same chains, so the plain version and the
kernel differ only by the card's rounding.
"""
from __future__ import annotations

import torch

_LN10 = 2.302585092994046
_INV_LN10 = 0.4342944819032518


def exp10(x):
    """10**x as exp(x*ln10)."""
    return torch.exp(x * _LN10)


def log10(x):
    """log10(x) as log(x) * (1/ln 10)."""
    return torch.log(x) * _INV_LN10


def _cbrt(x):
    """Nonnegative cube root as exp(log(x)/3) (log(0) -> -inf -> 0)."""
    return torch.exp(torch.log(x) * (1.0 / 3.0))


def ipow(x, k: int):
    """x**k for a small non-negative integer k by binary squaring."""
    if k == 0:
        return torch.ones_like(x)
    acc = None
    base = x
    while k:
        if k & 1:
            acc = base if acc is None else acc * base
        k >>= 1
        if k:
            base = base * base
    return acc


def powc(x, p):
    """x**p for a constant p (see the module docstring)."""
    p = float(p)
    if p == 0.0:
        return torch.ones_like(x)
    a = abs(p)
    k = int(a)
    f = a - k
    if abs(f) < 1e-12:
        extra = None
    elif abs(f - 0.5) < 1e-12:
        extra = torch.sqrt(x)
    elif abs(f - 1.0 / 3.0) < 1e-12:
        extra = _cbrt(x)
    elif abs(f - 2.0 / 3.0) < 1e-12:
        cr = _cbrt(x)
        extra = cr * cr
    elif abs(f - 0.25) < 1e-12:
        extra = torch.sqrt(torch.sqrt(x))
    elif abs(f - 0.75) < 1e-12:
        s = torch.sqrt(x)
        extra = s * torch.sqrt(s)
    elif abs(f - 1.0 / 6.0) < 1e-12:
        extra = torch.sqrt(_cbrt(x))
    else:
        return torch.pow(x, p)
    ip = ipow(x, k) if k else None
    out = ip if extra is None else (extra if ip is None else ip * extra)
    if p < 0:
        out = 1.0 / out
    return out
