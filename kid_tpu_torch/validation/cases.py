"""Full-length validation of the five 1-D cases against the committed
float64 oracle finals (the port's counterpart of ``validate_cases.py`` and
``validate_cases_f32.py``).

    python -m kid_tpu_torch.validation.cases --dtype float32 --out v.json
    python -m kid_tpu_torch.validation.cases --device cpu --cases mixed1 \\
        --steps 20 --dtype float64
    python -m kid_tpu_torch.validation.cases --device cpu --cases mixed1 \\
        --steps 20 --dtype float64 --write-finals finals_dir

Each case of ``RUNS`` runs at its own length through ``simulate`` and is
scored against ``validation_finals/<case>.npz``: the oracle twin's float64
finals, rain series and time means, which ``validate_cases.py`` wrote from
the JAX package's twin.  With ``--write-finals DIR`` the port's own twin
(``driver_twin.oracle_simulate``, the NumPy oracle on the host) first
runs each case for the same steps and writes ``DIR/<case>.npz`` in that
layout (``write_finals``), and the case is scored against it; the
committed files are written only if DIR names their directory.  In
float64 the target fields and the cumulative rain must hold to
``scores.RTOL`` and nc/nwfa/nifa to ``scores.RTOL_AEROSOL_EXTRAS``; in
float32 the fixed budgets on the integrated quantities hold
(``scores.score_1d_f32``), and the chaos member (the same run from a
1e-7-perturbed qv) gives the ensemble spread as evidence.  Each entry
also says where its worst target and extra field are (column, level,
the two values) and at which step the cumulative rain is farthest.
``run_ref_precision_model`` is the reference's own precision design, a
float64 driver whose state is rounded to float32 every step.  Prints one
line per case and a JSON summary; exits 1 if a case fails.  ``--out``
writes the whole report; ``--record PATH`` merges the cases into the
JSON record at PATH in the reference's blocks (``record``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import records
from ..device import resolve_device
from ..driver.cases import CASES
from ..driver.loop import (BLOCKS, KidState, initial_state, make_step,
                           simulate)
from ..micro import cuda_build
from ..micro.solver import device_tables
from ..tables.cache import get_tables
from . import scores
from .driver_twin import oracle_simulate

# case -> steps (validate_cases.py:61)
RUNS = {"warm1": 3600, "warm1_recon": 3600, "mixed1": 1800, "deep1": 1800,
        "aerosol1d": 900}
FINALS_DIR = Path(__file__).resolve().parents[2] / "validation_finals"
QV_PERTURBATION = 1.0e-7


def load_anchor(name: str, finals_dir=FINALS_DIR) -> dict:
    """The oracle's float64 anchor of a case, as a dict of arrays."""
    with np.load(Path(finals_dir) / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


def write_finals(name: str, n_steps: int, finals_dir) -> Path:
    """``n_steps`` of case ``name`` through the oracle twin, written as
    ``finals_dir/<name>.npz`` in ``validate_cases.py``'s layout: the rain
    series ``ppt_rain``, the final fields and their time means
    ``tmean_<field>``.  Returns the path."""
    case = CASES[name]
    fo, ppt, means = oracle_simulate(
        case, n_steps, get_tables(iiwarm=case.micro.iiwarm),
        want_means=True)
    path = Path(finals_dir) / f"{name}.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, ppt_rain=ppt["rain"],
             **{f: fo[f] for f in KidState._fields},
             **{f"tmean_{f}": means[f] for f in KidState._fields})
    return path


def _host(t) -> np.ndarray:
    return t.double().cpu().numpy()


def run(case, dtype, n_steps: int, device="cuda", perturb_qv=False,
        profile=True):
    """``n_steps`` of ``case`` from its initial sounding (with qv times
    1 + 1e-7 for ``perturb_qv``); returns (final fields, rain series of
    column 0, time-mean profiles or None, kernel launches), as numpy."""
    dev = resolve_device(device)
    tables = device_tables(get_tables(iiwarm=case.micro.iiwarm), dtype, dev)
    st = initial_state(case, dtype, dev)
    if perturb_qv:
        st = st._replace(qv=st.qv * torch.tensor(1.0 + QV_PERTURBATION,
                                                 dtype=dtype))
    cuda_build.reset_launch_counts()
    final, streams = simulate(st, tables, case, n_steps,
                              KidState._fields if profile else False,
                              device=dev)
    launches = cuda_build.launch_counts()
    tmean = ({f: _host(v).mean(0) for f, v in streams.profiles.items()}
             if profile else None)
    return ({f: _host(getattr(final, f)) for f in KidState._fields},
            _host(streams.ppt_rain)[:, 0], tmean, launches)


def run_ref_precision_model(case, n_steps: int, device="cuda"):
    """The reference's own precision design, float32 state with float64
    process arithmetic (module_mp_thompson09n.f90:1181-1213), emulated as
    the float64 driver with its state rounded to float32 after every
    step (validate_cases.py:121); 1-D cases.  Returns (final fields, rain
    series of column 0), as numpy."""
    dev = resolve_device(device)
    dtype = torch.float64
    tables = device_tables(get_tables(iiwarm=case.micro.iiwarm), dtype, dev)
    st = initial_state(case, dtype, dev)
    fl = BLOCKS.get(case, dtype, st.qv.device).flow
    step = make_step(case, tables, dtype, dev, fl.w_pat, None, fl.pres2,
                     None, ())
    m = torch.from_numpy(case.modulation_table(0, n_steps, dtype)).to(dev)
    rain = torch.empty(n_steps, dtype=dtype, device=dev)
    for i in range(n_steps):
        st, ppt, _ = step(st, m[i])
        st = KidState(*[x.float().double() for x in st])
        rain[i] = ppt[0, 0]
    return ({f: _host(getattr(st, f)) for f in KidState._fields},
            _host(rain))


def validate_case(name: str, dtype=torch.float32, device="cuda",
                  n_steps=None, chaos=False, ref_precision=False,
                  finals_dir=FINALS_DIR) -> dict:
    """One case run and scored against its anchor in ``finals_dir`` (see
    the module docstring); ``chaos`` adds the perturbed member's spread,
    ``ref_precision`` the reference precision model's scores.  The
    entry's ``pass`` is the dtype's rule."""
    case = CASES[name]
    n = RUNS[name] if n_steps is None else n_steps
    anchor = load_anchor(name, finals_dir)
    # a short run's rain is held to the anchor's first steps; its final
    # fields are still the anchor's at full length
    anchor["ppt_rain"] = anchor["ppt_rain"][:n]
    grid = case.grid()
    t0 = time.perf_counter()
    final, rain, tmean, launches = run(case, dtype, n, device)
    if dtype == torch.float64:
        entry = scores.score_against_oracle(final, rain, anchor, scores.RTOL,
                                            scores.RTOL_AEROSOL_EXTRAS)
        entry.update(scores.integrated_scores(final, anchor, grid.rho0,
                                              grid.dz, tmean))
    else:
        entry = scores.score_1d_f32(name, grid.rho0, grid.dz, final, rain,
                                    tmean, anchor)
    extras = [f for f in KidState._fields if f not in scores.TARGET_FIELDS]
    entry.update(n_steps=n, dtype=str(dtype)[6:], launches=launches,
                 run_seconds=time.perf_counter() - t0,
                 worst_target_at={**scores.worst_cell(
                     final, anchor, scores.TARGET_FIELDS), "step": n},
                 worst_extra_at={**scores.worst_cell(final, anchor, extras),
                                 "step": n},
                 cum_ppt_worst_step=scores.worst_step(rain,
                                                      anchor["ppt_rain"]))
    if chaos:
        final_p, rain_p, _, _ = run(case, dtype, n, device, perturb_qv=True,
                                    profile=False)
        entry["ensemble_spread_worst_target_rel"] = scores.ensemble_spread(
            final, final_p)
        pent = scores.score_against_oracle(final_p, rain_p, anchor,
                                           scores.RTOL,
                                           scores.RTOL_AEROSOL_EXTRAS)
        entry["perturbed_1em7_worst_target_rel"] = \
            pent["worst_target_field_rel"]
        entry["perturbed_1em7_cum_ppt_rel"] = pent["cum_ppt_rain_rel"]
    if ref_precision:
        final_r, rain_r = run_ref_precision_model(case, n, device)
        rent = scores.score_against_oracle(final_r, rain_r, anchor,
                                           scores.RTOL,
                                           scores.RTOL_AEROSOL_EXTRAS)
        entry["ref_precision_model_worst_target_rel"] = \
            rent["worst_target_field_rel"]
        entry["ref_precision_model_cum_ppt_rel"] = rent["cum_ppt_rain_rel"]
        for k, v in scores.integrated_scores(final_r, anchor, grid.rho0,
                                             grid.dz).items():
            entry[f"ref_precision_model_{k}"] = v
    entry["seconds"] = time.perf_counter() - t0
    return entry


def record(path, dtype, device, cases: dict) -> dict:
    """Merge ``cases`` (name -> ``validate_case`` entry) into the JSON
    record at ``path`` as the reference's scripts wrote their blocks of
    ``VALIDATION_r05.json``: float64 as ``fp64`` (with ``rtol`` and
    ``fp64_all_pass``), float32 as ``f32_<device type>`` (with its
    budgets and ``f32_<device type>_all_pass``).  Cases already in the
    block and not in ``cases`` stay."""
    prev = records.read(path)
    if dtype == torch.float64:
        rows = {**prev.get("fp64", {}), **cases}
        blocks = {"fp64": rows, "rtol": scores.RTOL,
                  "rtol_aerosol_extras": scores.RTOL_AEROSOL_EXTRAS,
                  "fp64_all_pass": all(e["pass"] for e in rows.values())}
    else:
        key = f"f32_{device.type}"
        rows = {**prev.get(key, {}).get("cases", {}), **cases}
        blocks = {key: {"pass_budgets": scores.budgets_1d(),
                        "evidence_scale_field_rel": scores.F32_BUDGET,
                        "backend": device.type, "cases": rows},
                  f"{key}_all_pass": all(e["pass"] for e in rows.values())}
    return records.merge(path, blocks, device)


def summary_line(name: str, e: dict) -> str:
    line = (f"{name} {e['dtype']} {e['n_steps']} steps: cumulative rain "
            f"{e['cum_ppt_rain_rel']:.3e}, water paths wvp "
            f"{e['final_wvp_rel']:.3e} lwp {e['final_lwp_rel']:.3e} iwp "
            f"{e['final_iwp_rel']:.3e}, time means "
            f"{e['tmean_prof_worst_rel']:.3e}, worst final field "
            f"{e['worst_target_field_rel']:.3e}, extras "
            f"{e['worst_aerosol_extra_rel']:.3e}")
    if "ensemble_spread_worst_target_rel" in e:
        line += (f", chaos member spread "
                 f"{e['ensemble_spread_worst_target_rel']:.3e}")
    return line + f"; pass={e['pass']} ({e['seconds']:.1f} s)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kid_tpu_torch.validation.cases",
        description="The 1-D cases against the float64 oracle finals.")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--cases", default=",".join(RUNS),
                    help="comma-separated (default: all five)")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps of every case (default: its full length)")
    ap.add_argument("--chaos", default="",
                    help="comma-separated cases that also run the "
                         "perturbed member, or 'all'")
    ap.add_argument("--ref-precision", action="store_true",
                    help="also run the reference precision model")
    ap.add_argument("--write-finals", default=None, metavar="DIR",
                    help="run the port's oracle twin for each case first, "
                         "write DIR/<case>.npz and score against it")
    ap.add_argument("--out", default=None, help="JSON report path")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="merge the cases into this JSON record's fp64 or "
                         "f32_<device> block (record())")
    args = ap.parse_args(argv)
    names = [c for c in args.cases.split(",") if c]
    chaos = set(names if args.chaos == "all" else args.chaos.split(","))
    dtype = getattr(torch, args.dtype)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"validation: {e}", file=sys.stderr)
        return 2
    report = {"dtype": args.dtype, "device": str(dev), "cases": {}}
    if dev.type == "cuda":
        report["card"] = torch.cuda.get_device_name(dev)
    for name in names:
        finals_dir = FINALS_DIR
        if args.write_finals:
            t0 = time.perf_counter()
            finals_dir = args.write_finals
            path = write_finals(name, RUNS[name] if args.steps is None
                                else args.steps, finals_dir)
            print(f"{name}: the oracle twin's finals written to {path} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        e = validate_case(name, dtype, dev, args.steps, name in chaos,
                          args.ref_precision, finals_dir)
        report["cases"][name] = e
        print(summary_line(name, e), flush=True)
    report["all_pass"] = all(e["pass"] for e in report["cases"].values())
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    if args.record:
        record(args.record, dtype, dev, report["cases"])
    print(json.dumps({"dtype": args.dtype, "device": report["device"],
                      "all_pass": report["all_pass"]}))
    return 0 if report["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
