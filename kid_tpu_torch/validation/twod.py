"""Validation of the 2-D cases against the committed float64 driver
anchors (the port's counterpart of ``validate_2d.py`` and
``validate_2d_f32.py``).

    python -m kid_tpu_torch.validation.twod --out v2d.json
    python -m kid_tpu_torch.validation.twod --device cpu --steps 30 \\
        --no-conservation
    python -m kid_tpu_torch.validation.twod --twin [--device cpu]

cumulus2d and orographic2d run at their own size and length in float32
through ``simulate``, and cumulus2d once more on ``RANKS`` ranks through
``dist.launch.run_sharded``; each is scored with ``scores.score_2d_f32``
against ``validation_finals/<case>_2dfp64.npz`` (cumulative domain precip,
final water paths, time-mean profiles, the water-budget closure), and the
sharded run must equal the single-process one bit for bit.  The float64
water-budget closure of both cases at full length is held to
``scores.CONS_TOL``.  ``--twin`` runs the oracle-twin rows instead
(``twin_equivalence``, ``validate_2d.py:83-111``): both cases at
``TWIN_NX`` columns for ``TWIN_STEPS`` steps (or ``--steps``) through the
float64 driver and through the port's oracle twin on the host.  Prints
one line per row and a JSON summary; exits 1 if a row fails.  ``--out``
writes the whole report; ``--record PATH`` merges the rows into the JSON
record at PATH in the reference's blocks (``f32_<device>_2d``,
``twod_conservation``, ``twod_oracle_twin``, ``twod_all_pass``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import records
from ..device import resolve_device
from ..dist import launch
from ..driver.cases import CUMULUS2D, OROGRAPHIC2D
from ..driver.loop import KidState, initial_state, simulate
from ..micro import cuda_build
from ..micro.solver import device_tables
from ..tables.cache import get_tables
from . import scores
from .cases import FINALS_DIR
from .driver_twin import oracle_simulate

PPT = ("rain", "snow", "graupel", "ice")
RANKS = 2                # of the sharded cumulus2d row
# the oracle-twin rows' width and length (validate_2d.py:158-159)
TWIN_NX, TWIN_STEPS = 16, 200


def _host(t) -> np.ndarray:
    return t.double().cpu().numpy()


def run_2d(case, dtype=torch.float32, device="cuda", n_steps=None) -> dict:
    """``case`` from its initial sounding in one process, with every
    state stream; returns numpy: ``fields0``, ``final``, ``ppt`` (species
    -> (n_steps, nx)), ``tmean`` (field -> (nx, nz)), and the kernel
    ``launches``."""
    dev = resolve_device(device)
    n = case.n_steps if n_steps is None else n_steps
    tables = device_tables(get_tables(iiwarm=case.micro.iiwarm), dtype, dev)
    st0 = initial_state(case, dtype, dev)
    cuda_build.reset_launch_counts()
    final, streams = simulate(st0, tables, case, n, KidState._fields,
                              device=dev)
    return dict(
        fields0={f: _host(v) for f, v in st0._asdict().items()},
        final={f: _host(getattr(final, f)) for f in KidState._fields},
        ppt={k: _host(getattr(streams, f"ppt_{k}")) for k in PPT},
        tmean={f: _host(v).mean(0) for f, v in streams.profiles.items()},
        launches=cuda_build.launch_counts())


def run_2d_sharded(case, n_ranks: int, dtype=torch.float32, device="cuda",
                   n_steps=None) -> dict:
    """``run_2d`` on ``n_ranks`` ranks (``dist.launch.default_layout``
    on ``device``'s kind; on a card each rank replays a CUDA graph of its
    step); ``launches`` adds up every rank's, and ``ranks`` holds each
    rank's numbers."""
    n = case.n_steps if n_steps is None else n_steps
    devices, backend = launch.default_layout(n_ranks, device)
    r = launch.run_sharded(case, n_ranks, n, dtype, devices, backend,
                           profile_diags=KidState._fields)
    st0 = initial_state(case, dtype, "cpu")
    return dict(
        fields0={f: _host(v) for f, v in st0._asdict().items()},
        final={f: np.asarray(v, np.float64) for f, v in r.fields.items()},
        ppt={k: np.asarray(r.ppt[f"ppt_{k}"], np.float64) for k in PPT},
        tmean={f: np.asarray(v, np.float64).mean(0)
               for f, v in r.profiles.items()},
        launches={k: sum(x["launches"][k] for x in r.ranks)
                  for k in r.ranks[0]["launches"]},
        ranks=r.ranks)


def score(case, result: dict) -> dict:
    """``result`` of ``run_2d`` against the case's float64 anchor."""
    with np.load(FINALS_DIR / f"{case.name}_2dfp64.npz") as z:
        anchor = {k: z[k] for k in z.files}
    n = len(result["ppt"]["rain"])
    anchor["ppt_rain"] = anchor["ppt_rain"][:n]   # a short run's prefix
    grid = case.grid()
    entry = scores.score_2d_f32(case.name, grid.rho0, grid.dz,
                                result["fields0"], result["final"],
                                result["ppt"], result["tmean"], anchor)
    extras = [f for f in KidState._fields if f not in scores.TARGET_FIELDS]
    for key, fields in (("worst_target_at", scores.TARGET_FIELDS),
                        ("worst_extra_at", extras)):
        entry[key] = {**scores.worst_cell(result["final"], anchor, fields),
                      "step": n}
    return entry


def record(path, device, blocks: dict) -> dict:
    """Merge ``blocks`` into the JSON record at ``path`` (as the
    reference's 2-D scripts wrote theirs into ``VALIDATION_r05.json``),
    with ``twod_all_pass`` over the record's ``twod_oracle_twin`` and
    ``twod_conservation`` blocks as they then stand."""
    merged = {**records.read(path), **blocks}
    blocks["twod_all_pass"] = all(
        e["pass"] for k in ("twod_oracle_twin", "twod_conservation")
        for e in merged.get(k, {}).values())
    return records.merge(path, blocks, device)


def same_bits(a: dict, b: dict) -> bool:
    """The final fields and the precip series of two runs are equal bit
    for bit."""
    return (all(np.array_equal(a["final"][f], b["final"][f])
                for f in KidState._fields)
            and all(np.array_equal(a["ppt"][k], b["ppt"][k]) for k in PPT))


def conservation(case, device="cuda", n_steps=None) -> dict:
    """The float64 water-budget closure of ``case`` (validate_2d.py:114):
    the domain's water change against the accumulated surface precip,
    held to ``scores.CONS_TOL``."""
    t0 = time.perf_counter()
    r = run_2d(case, torch.float64, device, n_steps)
    grid = case.grid()
    c = scores.closure(grid.rho0, grid.dz, r["fields0"], r["final"],
                       sum(v.sum() for v in r["ppt"].values()))
    return {"relative_closure_error": c,
            "pass": bool(abs(c) <= scores.CONS_TOL),
            "n_steps": len(r["ppt"]["rain"]),
            "seconds": time.perf_counter() - t0}


def twin_equivalence(case, n_steps: int, device="cuda") -> dict:
    """``case`` (at its own width: narrow it first) through the float64
    driver on ``device`` and through the oracle twin on the host
    (validate_2d.py:83-111): the driver's finals and domain rain series
    against the twin's at ``scores.RTOL`` (nc/nwfa/nifa at
    ``scores.RTOL_AEROSOL_EXTRAS``), and the two water-budget closures,
    which must match (``closure_match``: within 1e-8 + 1e-3 of the twin's):
    the scheme's non-conservation is the oracle's own."""
    t0 = time.perf_counter()
    r = run_2d(case, torch.float64, device, n_steps)
    fo, ppt_o = oracle_simulate(case, n_steps,
                                get_tables(iiwarm=case.micro.iiwarm))
    entry = scores.score_against_oracle(
        r["final"], r["ppt"]["rain"].sum(1),
        {**fo, "ppt_rain": ppt_o["rain"].sum(1)}, scores.RTOL,
        scores.RTOL_AEROSOL_EXTRAS)
    grid = case.grid()
    cj = scores.closure(grid.rho0, grid.dz, r["fields0"], r["final"],
                        sum(v.sum() for v in r["ppt"].values()))
    co = scores.closure(grid.rho0, grid.dz, r["fields0"], fo,
                        sum(v.sum() for v in ppt_o.values()))
    entry.update(closure_driver=cj, closure_oracle_twin=co,
                 closure_match=bool(abs(cj - co) <= 1e-8 + 1e-3 * abs(co)),
                 n_steps=n_steps, nx=case.nx, launches=r["launches"])
    entry["pass"] = entry["pass"] and entry["closure_match"]
    entry["seconds"] = time.perf_counter() - t0
    return entry


def twin_line(name: str, e: dict) -> str:
    return (f"{name} twin nx={e['nx']} x{e['n_steps']}: worst final field "
            f"{e['worst_target_field_rel']:.3e}, extras "
            f"{e['worst_aerosol_extra_rel']:.3e}, cumulative precip "
            f"{e['cum_ppt_rain_rel']:.3e}, closure driver "
            f"{e['closure_driver']:.6e} twin {e['closure_oracle_twin']:.6e} "
            f"match={e['closure_match']}; pass={e['pass']} "
            f"({e['seconds']:.1f} s)")


def line(name: str, e: dict) -> str:
    return (f"{name}: cumulative precip {e['cum_ppt_rain_rel']:.3e}, water "
            f"paths wvp {e['final_wvp_rel']:.3e} lwp "
            f"{e['final_lwp_rel']:.3e} iwp {e['final_iwp_rel']:.3e}, time "
            f"means {e['tmean_prof_worst_rel']:.3e}, closure "
            f"{e['closure']:.3e}, worst final field "
            f"{e['worst_target_field_rel']:.3e} (not gated); "
            f"pass={e['pass']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kid_tpu_torch.validation.twod",
        description="The 2-D cases against the float64 driver anchors.")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps of every run (default: the case length)")
    ap.add_argument("--no-conservation", action="store_true",
                    help="skip the float64 closure runs")
    ap.add_argument("--twin", action="store_true",
                    help=f"run the oracle-twin rows instead (nx={TWIN_NX}, "
                         f"{TWIN_STEPS} steps unless --steps)")
    ap.add_argument("--out", default=None, help="JSON report path")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="merge the rows into this JSON record: "
                         "f32_<device>_2d and twod_conservation, or "
                         "twod_oracle_twin with --twin (record())")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"validation: {e}", file=sys.stderr)
        return 2
    if args.twin:
        return twin_main(dev, args.steps or TWIN_STEPS, args.out,
                         args.record)
    report = {"device": str(dev), "rows": {}, "conservation": {}}
    single = {}
    for case in (CUMULUS2D, OROGRAPHIC2D):
        t0 = time.perf_counter()
        single[case.name] = r = run_2d(case, torch.float32, dev, args.steps)
        e = score(case, r)
        e.update(launches=r["launches"], seconds=time.perf_counter() - t0)
        report["rows"][case.name] = e
        print(line(case.name, e), flush=True)
    t0 = time.perf_counter()
    r = run_2d_sharded(CUMULUS2D, RANKS, torch.float32, dev, args.steps)
    e = score(CUMULUS2D, r)
    e["bitwise_equal_to_single_process"] = same_bits(r, single["cumulus2d"])
    e["pass"] = e["pass"] and e["bitwise_equal_to_single_process"]
    e.update(ranks=r["ranks"], seconds=time.perf_counter() - t0)
    report["rows"]["cumulus2d_sharded"] = e
    print(line("cumulus2d_sharded", e) + f", bit for bit the single-"
          f"process run: {e['bitwise_equal_to_single_process']}", flush=True)
    if not args.no_conservation:
        for case in (CUMULUS2D, OROGRAPHIC2D):
            c = conservation(case, dev, args.steps)
            report["conservation"][case.name] = c
            print(f"{case.name} float64 closure "
                  f"{c['relative_closure_error']:.3e} (limit "
                  f"{scores.CONS_TOL:g}); pass={c['pass']}", flush=True)
    report["all_pass"] = all(
        e["pass"] for d in (report["rows"], report["conservation"])
        for e in d.values())
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    if args.record:
        key = f"f32_{dev.type}_2d"
        blocks = {key: {"pass_budgets": scores.budgets_2d(),
                        "backend": dev.type, "cases": report["rows"]},
                  f"{key}_all_pass": all(e["pass"] for e in
                                         report["rows"].values())}
        if report["conservation"]:
            blocks["twod_conservation"] = report["conservation"]
        record(args.record, dev, blocks)
    print(json.dumps({"device": report["device"],
                      "all_pass": report["all_pass"]}))
    return 0 if report["all_pass"] else 1


def twin_main(dev, n_steps: int, out, record_path=None) -> int:
    """The oracle-twin rows of ``main --twin``."""
    report = {"device": str(dev), "twin": {}}
    for case in (CUMULUS2D, OROGRAPHIC2D):
        e = twin_equivalence(dataclasses.replace(case, nx=TWIN_NX),
                             n_steps, dev)
        report["twin"][case.name] = e
        print(twin_line(case.name, e), flush=True)
    report["all_pass"] = all(e["pass"] for e in report["twin"].values())
    if out:
        Path(out).write_text(json.dumps(report, indent=1))
    if record_path:
        record(record_path, dev, {"twod_oracle_twin": report["twin"]})
    print(json.dumps({"device": report["device"],
                      "all_pass": report["all_pass"]}))
    return 0 if report["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
