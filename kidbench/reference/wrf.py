"""The reference of one WRF/MPAS-shaped microphysics call
(``mp_gt_driver``, module_mp_thompson09n.f90:806-1143) on columns taken
out of (i, k, j) tiles: T from theta and Exner (f90:937), the
non-aerosol number fills (f90:957-964), the oracle column solver, the
negative-vapour repair (f90:1095-1106) and the precip accumulators
(f90:979-993)."""
from __future__ import annotations

import numpy as np

from . import constants as c

IN_FIELDS = ("qv", "qc", "qr", "qi", "qs", "qg", "ni", "nr", "th")
ACCUMULATORS = ("rainnc", "snownc", "graupelnc")


def column_args(col: dict, dt: float, scheme: dict):
    """The oracle's arguments for one column of the call's inputs:
    ``col`` maps each (i, k, j) input to the column's (k,) float64
    profile, ``tile[name][i, :, j]``, and each (i, j) one to its value."""
    t = col["th"] * col["pii"]
    rho = 0.622 * col["p"] / (287.04 * t * (col["qv"] + 0.622))
    f = {k: col[k] for k in IN_FIELDS[:-1]}
    f.update(nc=scheme["set_nc"] * 1.0e6 / rho, nwfa=11.1e6 / rho,
             nifa=c.NA_IN1 * 0.01 / rho)
    return (f, t, col["p"], col["w"], col["dz"], dt, scheme)


def repair_qv(qv: np.ndarray) -> np.ndarray:
    """Negative vapour replaced by the mean of its neighbour levels,
    floored at 1e-7."""
    up = np.concatenate([qv[1:], qv[-1:]])
    dn = np.concatenate([qv[:1], qv[:-1]])
    return np.where(qv < 0.0, np.maximum(0.5 * (up + dn), 1.0e-7), qv)


def call_outputs(col: dict, out: dict) -> dict:
    """The call's outputs at the column whose inputs are ``col`` (as
    ``column_args`` takes them) from the oracle's ``out``: name -> (k,)
    profile or value."""
    res = {k: np.asarray(out[f"{k}1d"], np.float64)
           for k in IN_FIELDS[1:-1]}
    res["qv"] = repair_qv(np.asarray(out["qv1d"], np.float64))
    res["th"] = np.asarray(out["t1d"], np.float64) / col["pii"]
    ra, sn, gr, ic = (out[k] for k in ("pptrain", "pptsnow", "pptgraul",
                                       "pptice"))
    res["rainnc"] = col["rainnc"] + (ra + sn + gr + ic)
    res["snownc"] = col["snownc"] + sn + ic
    res["graupelnc"] = col["graupelnc"] + gr
    return res
