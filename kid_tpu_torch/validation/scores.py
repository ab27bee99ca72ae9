"""Scores of a driver run against saved float64 anchors, in NumPy.

The port's own copy of the formulas and budgets of the reference's
validation scripts (``validate_cases.py::score_against_oracle`` and
``integrated_scores``, the pass rule and the f32 ensemble spread of
``validate_cases_f32.py``, ``validate_2d.py::_closure``, the pass rule of
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

# float64 targets of the reference's case validation (validate_cases.py
# :50-60): the target fields and the cumulative rain, and nc/nwfa/nifa,
# each relative to the anchor's own scale
RTOL = 1e-4
RTOL_AEROSOL_EXTRAS = 1e-3

# float32 budgets of the reference's validation (validate_cases_f32.py
# :78-92): cumulative precip, final water paths, time-mean profiles, with
# the per-case budgets of deep1's final paths and aerosol1d's time means
F32_BUDGET = 2.5e-2
PPT_BUDGET = {"aerosol1d": 5e-2}
PPT_BUDGET_DEFAULT = 2e-2
PATH_BUDGET = 2.5e-2
PATH_BUDGET_CASE = {"deep1": 1e-1}
TMEAN_BUDGET = 4e-2
TMEAN_BUDGET_CASE = {"aerosol1d": 1e-1}
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


def score_1d_f32(name, rho0, dz, final_fields, ppt_rain, tmean, anchor):
    """A float32 1-D run against its float64 anchor, with the fixed-budget
    pass rule of the reference's f32 case validation: cumulative precip,
    final water paths and time-mean profiles, with the case's own budgets
    where it has them.  The final-field maxima are reported, not gated.

    ``ppt_rain``: the (n_steps,) surface rain series of the column;
    ``tmean``: field -> time-mean profile."""
    entry = score_against_oracle(final_fields, ppt_rain, anchor, F32_BUDGET,
                                 F32_BUDGET)
    entry.update(integrated_scores(final_fields, anchor, rho0, dz, tmean))
    path = PATH_BUDGET_CASE.get(name, PATH_BUDGET)
    entry["pass"] = bool(
        entry["cum_ppt_rain_rel"] <= PPT_BUDGET.get(name, PPT_BUDGET_DEFAULT)
        and entry["final_wvp_rel"] <= path
        and entry["final_lwp_rel"] <= path
        and entry["final_iwp_rel"] <= path
        and entry["tmean_prof_worst_rel"]
        <= TMEAN_BUDGET_CASE.get(name, TMEAN_BUDGET))
    return entry


def ensemble_spread(final_a, final_b):
    """The chaos yardstick of the reference's f32 validation
    (validate_cases_f32.py:130-150): the worst over the target fields of
    max|a - b| / max|a| between a run and the same run from a
    1e-7-perturbed qv."""
    return max(float(np.abs(_f64(final_a[f]) - _f64(final_b[f])).max()
                     / (np.abs(_f64(final_a[f])).max() + 1e-30))
               for f in TARGET_FIELDS)


def worst_cell(final_fields, anchor, fields) -> dict:
    """Where the worst of ``fields`` is: the field, its column and level
    of largest |final - anchor| (relative to the anchor's largest
    magnitude), and the two values there."""
    best = None
    for f in fields:
        a, b = _f64(final_fields[f]), _f64(anchor[f])
        d = np.abs(a - b)
        rel = float(d.max() / (np.abs(b).max() + 1e-30))
        if best is None or rel > best["rel"]:
            col, lev = np.unravel_index(int(d.argmax()), d.shape)
            best = {"field": f, "rel": rel, "column": int(col),
                    "level": int(lev), "got": float(a[col, lev]),
                    "want": float(b[col, lev])}
    return best


def budgets_1d() -> dict:
    """The fixed f32 pass budgets of the 1-D cases, by quantity, as the
    reference's record lists them."""
    return {"cum_ppt_rel": {"default": PPT_BUDGET_DEFAULT, **PPT_BUDGET},
            "final_water_path_rel": {"default": PATH_BUDGET,
                                     **PATH_BUDGET_CASE},
            "tmean_prof_rel": {"default": TMEAN_BUDGET, **TMEAN_BUDGET_CASE}}


def budgets_2d() -> dict:
    """The fixed f32 pass budgets of the 2-D cases."""
    return {"cum_ppt_rel": PPT_BUDGET_DEFAULT,
            "final_water_path_rel": PATH_BUDGET,
            "tmean_prof_rel": TMEAN_BUDGET, "closure": CONS_TOL}


def worst_step(ppt_rain_series, anchor_series) -> int:
    """The step (0-based) at which the cumulative rain series is farthest
    from the anchor's."""
    return int(np.abs(_f64(ppt_rain_series).cumsum()
                      - _f64(anchor_series).cumsum()).argmax())

