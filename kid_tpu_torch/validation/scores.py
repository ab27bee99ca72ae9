"""Scores of a driver run against saved float64 anchors, in NumPy.

The port's own copy of the formulas and budgets of the reference's
validation scripts (``validate_cases.py::score_against_oracle`` and
``integrated_scores``, ``validate_2d.py::_closure``, the pass rule of
``validate_2d_f32.py``), which import JAX.  The anchors are the
``validation_finals/*.npz`` files those scripts wrote: final fields,
``ppt_rain`` (the domain series) and ``tmean_<field>`` time means.
"""
from __future__ import annotations

import numpy as np

# the prognostics the reference wrapper round-trips
# (mphys_thompson09n.f90:198-245); nc/nwfa/nifa are extras
TARGET_FIELDS = ("theta", "qv", "qc", "qr", "nr", "qi", "ni", "qs", "qg")
WATER_FIELDS = ("qv", "qc", "qr", "qi", "qs", "qg")

# float32 budgets of the reference's validation (validate_cases_f32.py
# :78-92): cumulative precip, final water paths, time-mean profiles
F32_BUDGET = 2.5e-2
PPT_BUDGET = {"aerosol1d": 5e-2}
PPT_BUDGET_DEFAULT = 2e-2
PATH_BUDGET = 2.5e-2
TMEAN_BUDGET = 4e-2
# water-budget closure: the scheme's documented non-conservation
# (presence floors, the qv floor, the sedimentation gate; validate_2d.py:65)
CONS_TOL = 1e-2


def _f64(a):
    return np.asarray(a, np.float64)


def score_against_oracle(final_fields, ppt_rain_series, anchor, rtol,
                         rtol_extras):
    """Per-field max errors of ``final_fields`` against ``anchor``'s
    finals, each relative to the anchor field's largest magnitude, and of
    the cumulative rain series; ``pass`` holds the targets to ``rtol``
    and nc/nwfa/nifa to ``rtol_extras``."""
    entry = {"fields": {}}
    worst_target, worst_extra = 0.0, 0.0
    for f, a in final_fields.items():
        b = _f64(anchor[f])
        rel = float(np.abs(_f64(a) - b).max() / (np.abs(b).max() + 1e-30))
        entry["fields"][f] = rel
        if f in TARGET_FIELDS:
            worst_target = max(worst_target, rel)
        else:
            worst_extra = max(worst_extra, rel)
    pj = _f64(ppt_rain_series).cumsum()
    po = _f64(anchor["ppt_rain"]).cumsum()
    entry["cum_ppt_rain_rel"] = float(np.abs(pj - po).max()
                                      / (np.abs(po).max() + 1e-30))
    entry["worst_target_field_rel"] = worst_target
    entry["worst_aerosol_extra_rel"] = worst_extra
    entry["pass"] = bool(worst_target <= rtol
                         and entry["cum_ppt_rain_rel"] <= rtol
                         and worst_extra <= rtol_extras)
    return entry


def integrated_scores(final_fields, anchor, rho0, dz, tmean_driver=None):
    """Final column water paths (vapor, liquid, ice: rho0*dz-weighted
    vertical integrals per column) and, with ``tmean_driver``, the worst
    time-mean profile over the target fields, each relative to the
    anchor's own scale."""
    wz = _f64(rho0) * _f64(dz)

    def path(fields, keys):
        return sum((_f64(fields[k]) * wz).sum(-1) for k in keys)

    entry = {}
    vapor = np.abs(path(anchor, ("qv",))).max()
    for name, keys in (("wvp", ("qv",)), ("lwp", ("qc", "qr")),
                       ("iwp", ("qi", "qs", "qg"))):
        po = path(anchor, keys)
        # a tiny ice path is floored against the vapor path
        scale = np.abs(po).max() + vapor * 1e-6 + 1e-30
        entry[f"final_{name}_rel"] = float(
            np.abs(path(final_fields, keys) - po).max() / scale)
    if tmean_driver is not None and "tmean_qv" in anchor:
        entry["tmean_prof_worst_rel"] = max(
            float(np.abs(_f64(tmean_driver[f]) - _f64(anchor[f"tmean_{f}"]))
                  .max() / (np.abs(_f64(anchor[f"tmean_{f}"])).max()
                            + 1e-30))
            for f in TARGET_FIELDS)
    return entry


def closure(rho0, dz, fields0, fields_f, ppt_total):
    """Relative water-budget residual (w0 - w_final - precip) / w0 of the
    domain's water mass sum(rho0*dz*(qv+qc+qr+qi+qs+qg)) against the
    accumulated surface precip ``ppt_total`` [kg/m^2 summed over
    columns]."""
    wz = _f64(rho0) * _f64(dz)

    def water(d):
        return float((sum(_f64(d[f]) for f in WATER_FIELDS) * wz).sum())

    w0 = water(fields0)
    return (w0 - water(fields_f) - float(ppt_total)) / w0


def score_2d_f32(name, rho0, dz, fields0, final_fields, ppt, tmean,
                 anchor):
    """A float32 2-D run against its float64 anchor, with the pass rule of
    the reference's f32 2-D validation: cumulative domain precip, final
    water paths, time-mean profiles and the water-budget closure.

    ``ppt``: species -> (n_steps, nx) surface precip per step;
    ``tmean``: field -> time-mean (nx, nz) profile."""
    entry = score_against_oracle(final_fields, _f64(ppt["rain"]).sum(1),
                                 anchor, F32_BUDGET, F32_BUDGET)
    entry.update(integrated_scores(final_fields, anchor, rho0, dz, tmean))
    entry["closure"] = closure(rho0, dz, fields0, final_fields,
                               sum(_f64(v).sum() for v in ppt.values()))
    entry["pass"] = bool(
        entry["cum_ppt_rain_rel"] <= PPT_BUDGET.get(name, PPT_BUDGET_DEFAULT)
        and entry["final_wvp_rel"] <= PATH_BUDGET
        and entry["final_lwp_rel"] <= PATH_BUDGET
        and entry["final_iwp_rel"] <= PATH_BUDGET
        and entry["tmean_prof_worst_rel"] <= TMEAN_BUDGET
        and abs(entry["closure"]) <= CONS_TOL)
    return entry
