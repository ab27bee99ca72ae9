"""Diagnostics registry, the ``save_dg`` equivalent (a copy of
``kid_tpu/diag/registry.py`` that takes the port's tensors).

The reference streams ~36 per-level process rates and per-species surface
precip through KiD's ``save_dg`` overloads into netCDF
(module_mp_thompson09n.f90:2963-3124; mphys_thompson09n.f90:155-192,
248-308).  Here the time loop returns stacked per-step streams, and this
registry attaches names, units and dims and persists them (npz or classic
NetCDF).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class Stream:
    name: str
    units: str
    dims: str          # "time", "time,z", "time,z,x", ...
    data: np.ndarray


class DiagRegistry:
    """Named diagnostic streams with units/dims, mirrorring save_dg."""

    def __init__(self):
        self._streams: Dict[str, Stream] = {}

    def save(self, data, name: str, units: str = "", dims: str = "time"):
        self._streams[name] = Stream(name, units, dims,
                                     np.asarray(data))

    def __getitem__(self, name: str) -> np.ndarray:
        return self._streams[name].data

    def names(self):
        return sorted(self._streams)

    def to_npz(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        meta = {k: {"units": s.units, "dims": s.dims}
                for k, s in self._streams.items()}
        np.savez_compressed(path, __meta__=json.dumps(meta),
                            **{k: s.data for k, s in self._streams.items()})

    def to_netcdf(self, path: str):
        """Classic NetCDF-3 sink (KiD's native diagnostics format; pure
        NumPy writer, readable by scipy/xarray/ncdump)."""
        from .netcdf import registry_to_netcdf
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        registry_to_netcdf(self, path)

    @classmethod
    def from_npz(cls, path: str) -> "DiagRegistry":
        reg = cls()
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            for k, m in meta.items():
                reg._streams[k] = Stream(k, m["units"], m["dims"], z[k])
        return reg


def _numpy(a) -> np.ndarray:
    """``a`` as a numpy array; a tensor is moved to the host first."""
    return a.detach().cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def registry_from_run(case_name: str, streams, nx: int,
                      h_names=("cloud", "rain", "ice", "snow", "graupel"),
                      mom_units: str = "kg/kg") -> DiagRegistry:
    """Build the standard KiD diagnostic registry from a simulate() output
    (``StepOutputs`` of tensors on any device).

    Mirrors the wrapper's save_dg calls: per-species surface precip series
    named ``surface_ppt_for_<species>`` plus ``total_surface_ppt``
    (mphys_thompson09n.f90:155-182)."""
    reg = DiagRegistry()
    u = mom_units + " m"
    ppts = {"rain": streams.ppt_rain, "ice": streams.ppt_ice,
            "snow": streams.ppt_snow, "graupel": streams.ppt_graupel}
    total = None
    for sp, arr in ppts.items():
        a = _numpy(arr)
        mean = a.mean(axis=-1) if a.ndim > 1 else a
        reg.save(mean, f"surface_ppt_for_{sp}", units=u, dims="time")
        if a.ndim > 1 and nx > 1:
            reg.save(a, f"surface_ppt_for_{sp}_x", units=u, dims="time,x")
        total = mean if total is None else total + mean
    reg.save(total, "total_surface_ppt", units=u, dims="time")
    for name, prof in streams.profiles.items():
        reg.save(_numpy(prof), name,
                 units="/kg/s" if name.startswith(("pr", "pn")) else "kg/kg",
                 dims="time,x,z" if nx > 1 else "time,z")
    reg.save(np.asarray([case_name], dtype="U32"), "case", dims="meta")
    return reg
