"""Typed, hashable configuration (twin of ``kid_tpu/config.py``).

The reference scatters configuration over KiD namelists, compile-time flags
and module-level logicals (module_mp_thompson09n.f90:22,28-33,
mphys_thompson09n.f90:11-17); here it is one frozen dataclass.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MicroConfig:
    """Microphysics configuration (same fields as the reference package).

      - ``iiwarm``      warm-only switch (module_mp_thompson09n.f90:22).
      - ``set_nc``      prescribed droplet number per cc; Nt_c = set_nc*1e6.
      - ``l_sediment``  gates ice/snow/graupel sedimentation, never rain
                        (module_mp_thompson09n.f90:3449,3506,3555).
      - ``is_aerosol_aware`` / ``dusty_ice`` / ``homog_ice`` / ``ifdry``
                        module-level logicals (f90:28-33).
      - ``dtype``       compute dtype name ("float32" or "float64").
      - ``max_sed_substeps`` kept for field parity; unused by the solver.
    """

    iiwarm: bool = False
    set_nc: float = 100.0
    l_sediment: bool = True
    is_aerosol_aware: bool = False
    dusty_ice: bool = True
    homog_ice: bool = True
    ifdry: int = 0
    dtype: str = "float32"
    max_sed_substeps: int = 64

    @property
    def nt_c(self) -> float:
        return self.set_nc * 1.0e6


WARM1 = MicroConfig(iiwarm=True)
MIXED1 = MicroConfig(iiwarm=False)
