"""Column state tuples (twin of ``kid_tpu/micro/state.py``).

The reference passes 15 parallel (kts:kte) arrays into ``mp_thompson``
(module_mp_thompson09n.f90:1156-1162); here they are NamedTuples of
(ncol, nz) tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ColumnState(NamedTuple):
    """Prognostic column state (mixing ratios kg/kg, numbers #/kg, T in K)."""

    t: torch.Tensor      # temperature [K]
    qv: torch.Tensor     # water vapor
    qc: torch.Tensor     # cloud water
    qi: torch.Tensor     # cloud ice
    qr: torch.Tensor     # rain
    qs: torch.Tensor     # snow
    qg: torch.Tensor     # graupel
    ni: torch.Tensor     # ice number
    nr: torch.Tensor     # rain number
    nc: torch.Tensor     # cloud droplet number
    nwfa: torch.Tensor   # water-friendly aerosol number
    nifa: torch.Tensor   # ice-friendly aerosol number


class Precip(NamedTuple):
    """Per-call surface precipitation depths (module_mp_thompson09n.f90:
    3391-3577), one value per column."""

    rain: torch.Tensor
    snow: torch.Tensor
    graupel: torch.Tensor
    ice: torch.Tensor
