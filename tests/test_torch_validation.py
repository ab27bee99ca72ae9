"""PyTorch port's validation and bench entry points, on the CPU.

The port's scores and budgets (``kid_tpu_torch/validation/scores.py``)
against the reference's validation scripts on the same seeded inputs:
``validate_cases.py`` and ``validate_2d.py`` are imported (they change
JAX's settings only in ``main()``); ``validate_cases_f32.py`` and
``validate_2d_f32.py`` change them when imported, so their budgets are
read from their source.  Then ``validation.cases`` and
``validation.twod`` on short runs against the committed finals, the
reference precision model against the JAX package's, the port's float64
driver against the oracle twin (``kid_tpu/validation/driver_twin.py``)
at the tolerances of ``tests/test_driver_twin.py``, and ``bench`` at a
tiny size on the CPU.  The ``--record`` flags merge their blocks into
one JSON record and keep the others; ``baseline`` holds the reference's
anchors (its C source, its seeded oracle column, its constant).
"""
from __future__ import annotations

import ast
import dataclasses
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import validate_2d as R2
import validate_cases as R
from kid_tpu.driver import cases as jcases
from kid_tpu.tables.cache import get_tables as j_get_tables
from kid_tpu.validation.driver_twin import oracle_simulate
from kid_tpu_torch import baseline, bench
from kid_tpu_torch.dist import launch
from kid_tpu_torch.driver import cases as tcases
from kid_tpu_torch.driver.loop import KidState, run_case
from kid_tpu_torch.validation import cases as V
from kid_tpu_torch.validation import scores as S
from kid_tpu_torch.validation import twod
from test_torch_solver import assert_equiv

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIELDS = KidState._fields


def _constants(script: str) -> dict:
    """The module-level constants of a root script, read from its source."""
    out = {}
    for node in ast.parse((ROOT / script).read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", "")
            if name.isupper():
                try:
                    out[name] = ast.literal_eval(node.value)
                except ValueError:
                    pass
    return out


def test_budgets_equal_the_reference_scripts():
    f32 = _constants("validate_cases_f32.py")
    for k in ("F32_BUDGET", "PPT_BUDGET", "PPT_BUDGET_DEFAULT", "PATH_BUDGET",
              "PATH_BUDGET_CASE", "TMEAN_BUDGET", "TMEAN_BUDGET_CASE"):
        assert getattr(S, k) == f32[k], k
    assert (S.RTOL, S.RTOL_AEROSOL_EXTRAS) == (R.RTOL, R.RTOL_AEROSOL_EXTRAS)
    assert S.TARGET_FIELDS == R.TARGET_FIELDS
    assert (S.CONS_TOL, S.WATER_FIELDS) == (R2.CONS_TOL, R2.WATER_FIELDS)
    assert V.RUNS == {c.name: n for c, n in R.RUNS}
    # validate_2d_f32.py takes its budgets from validate_cases_f32.py
    src = (ROOT / "validate_2d_f32.py").read_text()
    assert "from validate_cases_f32 import (F32_BUDGET, PATH_BUDGET," in src


def _seeded_pair(name, rel, seed=0, n_steps=40):
    """A case's (nx, nz) fields, rain series and time means as an anchor,
    and a copy perturbed by seeded noise of relative size ``rel``."""
    case = jcases.CASES[name]
    rng = np.random.default_rng(seed)
    shape = (case.nx, case.nz)
    anchor = {f: rng.random(shape) * 10.0 ** rng.uniform(-6, 2)
              for f in FIELDS}
    anchor["ppt_rain"] = rng.random(n_steps) * 1e-4
    anchor.update({f"tmean_{f}": rng.random(shape) for f in FIELDS})

    def noisy(a):
        return a * (1.0 + rel * rng.standard_normal(a.shape))

    run = {f: noisy(anchor[f]) for f in FIELDS}
    return (case, anchor, run, noisy(anchor["ppt_rain"]),
            {f: noisy(anchor[f"tmean_{f}"]) for f in FIELDS})


def _same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _same(got[k], v)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("name,rel", [("mixed1", 1e-5), ("deep1", 3e-3),
                                      ("aerosol1d", 3e-2)])
def test_scores_equal_the_reference_scores(name, rel):
    case, anchor, run, rain, tmean = _seeded_pair(name, rel)
    grid = tcases.CASES[name].grid()
    for rtol, extras in ((R.RTOL, R.RTOL_AEROSOL_EXTRAS), (2.5e-2, 2.5e-2)):
        _same(S.score_against_oracle(run, rain, anchor, rtol, extras),
              R.score_against_oracle(run, rain, anchor, rtol, extras))
    _same(S.integrated_scores(run, anchor, grid.rho0, grid.dz, tmean),
          R.integrated_scores(run, anchor, case, tmean_driver=tmean))
    ppt = {k: rain * (i + 1) for i, k in enumerate(
        ("rain", "snow", "graupel", "ice"))}
    want = R2._closure(case, anchor, run, ppt)
    got = S.closure(grid.rho0, grid.dz, anchor, run,
                    sum(v.sum() for v in ppt.values()))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _reference_1d_f32_pass(name, e, f32):
    """validate_cases_f32.py's pass rule (main(), inline there)."""
    path = f32["PATH_BUDGET_CASE"].get(name, f32["PATH_BUDGET"])
    return bool(
        e["cum_ppt_rain_rel"] <= f32["PPT_BUDGET"].get(
            name, f32["PPT_BUDGET_DEFAULT"])
        and e["final_wvp_rel"] <= path and e["final_lwp_rel"] <= path
        and e["final_iwp_rel"] <= path
        and e["tmean_prof_worst_rel"] <= f32["TMEAN_BUDGET_CASE"].get(
            name, f32["TMEAN_BUDGET"]))


@pytest.mark.parametrize("name", list(V.RUNS))
def test_f32_pass_rule_and_spread_equal_the_reference(name):
    f32 = _constants("validate_cases_f32.py")
    grid = tcases.CASES[name].grid()
    passed = set()
    for i, rel in enumerate((1e-4, 1e-2, 3e-2, 6e-2, 2e-1)):
        _, anchor, run, rain, tmean = _seeded_pair(name, rel, seed=i)
        e = S.score_1d_f32(name, grid.rho0, grid.dz, run, rain, tmean,
                           anchor)
        assert e["pass"] == _reference_1d_f32_pass(name, e, f32), rel
        passed.add(e["pass"])
        # the chaos yardstick of validate_cases_f32.py:130-150
        spread = 0.0
        for f in R.TARGET_FIELDS:
            a, b = run[f], anchor[f]
            spread = max(spread, float(np.abs(a - b).max()
                                       / (np.abs(a).max() + 1e-30)))
        assert S.ensemble_spread(run, anchor) == spread
    assert passed == {True, False}


def test_validate_case_short_float64_run():
    e = V.validate_case("mixed1", torch.float64, "cpu", n_steps=10,
                        chaos=True)
    assert e["n_steps"] == 10 and e["dtype"] == "float64"
    assert set(e["fields"]) == set(FIELDS)
    values = [*e["fields"].values(), e["cum_ppt_rain_rel"],
              e["final_wvp_rel"], e["final_lwp_rel"], e["final_iwp_rel"],
              e["tmean_prof_worst_rel"]]
    assert np.isfinite(values).all()
    # the rain series is held to the anchor's first 10 steps
    assert e["cum_ppt_rain_rel"] <= S.RTOL
    # the finals are the anchor's at 1800 steps, so they fail
    assert e["pass"] is False
    # a 1e-7 perturbation of qv stays near 1e-7 over 10 steps
    assert 0.0 < e["ensemble_spread_worst_target_rel"] < 1e-5
    assert e["launches"] == dict.fromkeys(e["launches"], 0)     # the CPU
    # the anchor scored against itself: zero, and a pass
    anchor = V.load_anchor("mixed1")
    grid = tcases.MIXED1.grid()
    tmean = {f: anchor[f"tmean_{f}"] for f in FIELDS}
    self_score = S.score_1d_f32("mixed1", grid.rho0, grid.dz, anchor,
                                anchor["ppt_rain"], tmean, anchor)
    assert self_score["pass"] and self_score["worst_target_field_rel"] == 0


def test_validation_main_writes_its_report(tmp_path):
    out = tmp_path / "v.json"
    rc = V.main(["--device", "cpu", "--cases", "warm1_recon,aerosol1d",
                 "--steps", "3", "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 1 and report["all_pass"] is False      # 3 steps of 3600
    assert set(report["cases"]) == {"warm1_recon", "aerosol1d"}
    assert report["cases"]["aerosol1d"]["dtype"] == "float32"


def test_ref_precision_model_matches_jax():
    """``run_ref_precision_model`` against validate_cases.py's."""
    case = jcases.WARM1_RECON
    n = 12
    jfinal, jstreams = R.run_ref_precision_model(case, n)
    final, rain = V.run_ref_precision_model(tcases.WARM1_RECON, n, "cpu")
    assert_equiv(final, {f: np.asarray(getattr(jfinal, f)) for f in FIELDS})
    np.testing.assert_allclose(rain, np.asarray(jstreams.ppt_rain)[:, 0],
                               rtol=1e-8, atol=1e-20)
    for f in FIELDS:      # the state is float32 values after every step
        assert np.array_equal(final[f], final[f].astype(np.float32)), f


@pytest.mark.parametrize("name", ["mixed1", "aerosol1d"])
def test_driver_matches_oracle_twin(name):
    """tests/test_driver_twin.py:27 for the port: fields to 1e-5 of their
    scale, the rain series to rtol 1e-4, 10 steps in float64."""
    n = 10
    final, streams = run_case(tcases.CASES[name], torch.float64,
                              n_steps=n, device="cpu")
    jcase = jcases.CASES[name]
    fo, ppt = oracle_simulate(jcase, n, j_get_tables(iiwarm=jcase.micro.iiwarm))
    for f in FIELDS:
        b = fo[f]
        np.testing.assert_allclose(getattr(final, f).numpy(), b, rtol=0,
                                   atol=1e-5 * (np.abs(b).max() + 1e-30),
                                   err_msg=f"field {f}")
    np.testing.assert_allclose(streams.ppt_rain.numpy()[:, 0], ppt["rain"],
                               rtol=1e-4, atol=1e-18)


def test_twod_short_run_and_sharded_row():
    case = dataclasses.replace(tcases.CUMULUS2D, nx=16)
    one = twod.run_2d(case, torch.float32, "cpu", n_steps=6)
    two = twod.run_2d_sharded(case, 2, torch.float32, "cpu", n_steps=6)
    assert twod.same_bits(one, two)
    assert two["launches"] == dict.fromkeys(two["launches"], 0)
    assert [r["exchange_calls"] for r in two["ranks"]] == [6, 6]
    e = twod.score(tcases.CUMULUS2D, twod.run_2d(tcases.CUMULUS2D,
                                                 torch.float32, "cpu",
                                                 n_steps=6))
    assert np.isfinite(e["closure"]) and abs(e["closure"]) < S.CONS_TOL
    c = twod.conservation(case, "cpu", n_steps=6)
    assert c["pass"] and c["n_steps"] == 6


def test_bench_prints_one_json_line(capsys):
    assert bench.main(["--device", "cpu", "--ncol", "2", "--spin", "2",
                       "--steps", "2", "--synthetic-steps", "1",
                       "--flagship-nx", "128", "--flagship-spin", "1",
                       "--flagship-steps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["metric"] == "column_steps_per_sec_mixed1_case_nz120"
    assert r["backend"] == "cpu" and r["device"] == "cpu"
    for k in ("value", "warm1_case", "warm1_recon_case", "aerosol1d_case",
              "synthetic_mixed_phase_r03_metric",
              "synthetic_mixed_phase_eager"):
        assert np.isfinite(r[k]) and r[k] > 0, k
    assert r["flagship_2d"]["nx"] == 128 and r["flagship_2d"]["nz"] == 60
    assert r["vs_baseline"] == r["value"] / 1.0e4


def test_entry_points_default_to_the_card(monkeypatch):
    for fn in (V.validate_case, V.run, V.run_ref_precision_model,
               twod.run_2d, twod.run_2d_sharded, twod.conservation,
               bench.case_throughput, bench.synthetic_throughput,
               bench.flagship):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda", fn.__name__
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (V.main, twod.main, bench.main, launch.main, baseline.main):
        assert main([]) == 2, main.__module__
    with pytest.raises(RuntimeError, match="device='cpu'"):
        V.validate_case("mixed1", n_steps=1)


def test_record_merges_its_blocks_and_keeps_the_others(tmp_path):
    out = tmp_path / "v.json"
    out.write_text(json.dumps({"chaos_envelope": {"cases": {}},
                               "fp64": {"deep1": {"pass": False}}}))
    rc = V.main(["--device", "cpu", "--cases", "mixed1", "--steps", "20",
                 "--dtype", "float64", "--write-finals", str(tmp_path),
                 "--record", str(out)])
    assert rc == 0 and (tmp_path / "mixed1.npz").exists()
    r = json.loads(out.read_text())
    assert r["chaos_envelope"] == {"cases": {}}                 # kept
    assert set(r["fp64"]) == {"deep1", "mixed1"}                # merged
    e = r["fp64"]["mixed1"]
    assert e["pass"] is True and e["n_steps"] == 20
    assert e["worst_target_field_rel"] <= S.RTOL
    assert set(e["fields"]) == set(FIELDS)
    assert e["worst_target_at"]["field"] in S.TARGET_FIELDS
    assert e["worst_target_at"]["step"] == 20
    assert r["rtol"] == S.RTOL and r["fp64_all_pass"] is False  # deep1
    assert set(r["runs"]) == {"fp64", "rtol", "rtol_aerosol_extras",
                              "fp64_all_pass"}
    assert r["hardware"]["device"] == "cpu" and r["source_sha256"]
    # float32 goes to its own block, with the reference's budgets
    V.record(out, torch.float32, torch.device("cpu"),
             {"warm1": {"pass": True}})
    r = json.loads(out.read_text())
    assert r["f32_cpu"]["cases"] == {"warm1": {"pass": True}}
    assert r["f32_cpu"]["pass_budgets"]["cum_ppt_rel"] == {
        "default": 2e-2, "aerosol1d": 5e-2}
    assert r["f32_cpu_all_pass"] is True and "fp64" in r
    # the 2-D twin rows, and twod_all_pass over the record's 2-D blocks
    assert twod.main(["--twin", "--device", "cpu", "--steps", "2",
                      "--record", str(out)]) == 0
    r = json.loads(out.read_text())
    assert set(r["twod_oracle_twin"]) == {"cumulus2d", "orographic2d"}
    assert r["twod_all_pass"] is True and "f32_cpu" in r
    twod.record(out, torch.device("cpu"),
                {"twod_conservation": {"cumulus2d": {"pass": False}}})
    r = json.loads(out.read_text())
    assert r["twod_all_pass"] is False and "twod_oracle_twin" in r


def test_baseline_holds_the_reference_anchors(tmp_path):
    tree = ast.parse((ROOT / "bench_baseline.py").read_text())
    src = next(ast.literal_eval(n.value) for n in tree.body
               if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", "") == "_C_SRC")
    assert baseline._C_SRC == src
    assert bench.BASELINE_COL_STEPS_PER_SEC is \
        baseline.BASELINE_COL_STEPS_PER_SEC
    assert bench.BASELINE_COL_STEPS_PER_SEC == _constants(
        "bench_baseline.py")["BASELINE_COL_STEPS_PER_SEC"] == 1.0e4
    from test_oracle import _profile
    for seed, warm in ((3, False), (5, True)):
        want, got = _profile(120, seed, warm), baseline.profile(120, seed,
                                                                warm)
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    out = tmp_path / "b.json"
    out.write_text(json.dumps({"bench": {"vs_baseline": 100.0}}))
    assert baseline.main(["--device", "cpu", "--record", str(out)]) == 0
    r = json.loads(out.read_text())
    assert r["bench"] == {"vs_baseline": 100.0}
    b = r["baseline"]
    assert b["anchor_a_ns_per_cell"] > 0
    assert b["anchor_a_col_steps_per_sec"] == pytest.approx(
        1e9 / (b["anchor_a_ns_per_cell"] * 120))
    assert b["anchor_b_oracle_col_steps_per_sec"] > 0
    assert b["baseline_col_steps_per_sec"] == 1.0e4



def test_committed_records_hold_their_contract():
    """The port's records at the root, as the card wrote them: every
    sharded row bit for bit one process, the weak rows on 1, 2 and 4
    cards, the five 1-D cases at full length in float64 through the
    card's kernels, the chaos envelope of three cases in both classes,
    each file with its hardware and one source digest."""
    rec = {name: json.loads((ROOT / f"{name}_h100.json").read_text())
           for name in ("SCALING", "VALIDATION", "MULTIPROC", "BENCH")}
    assert len({r["source_sha256"] for r in rec.values()}) == 1
    for r in rec.values():
        assert "H100" in r["hardware"]["device"] and r["hardware"]["cards"]
    sc = rec["SCALING"]
    mesh = sc["nccl_mesh"]
    assert len(sc["hardware"]["cards"]) == 4 and mesh["bitwise_equal"]
    weak = mesh["weak_scaling"]["rows"]
    assert {n: r["nx"] for n, r in weak.items()} == {
        "1": 32768, "2": 65536, "4": 131072}
    for row in (*weak.values(), *mesh["strong_scaling"]["rows"].values()):
        assert row["bitwise_equal_to_one_process"], row["ranks"]
        if row["ranks"] > 1:
            assert row["backend"] == "nccl"
            assert set(row["placement"]) == {"step"}
    for e in sc["exchange_in_graph"].values():
        assert e["nccl_kernels_per_step"] == 1.0
        assert e["host_exchange_calls_per_step"] == 0.0
    v = rec["VALIDATION"]
    assert {k: e["n_steps"] for k, e in v["fp64"].items()} == V.RUNS
    for name, e in v["fp64"].items():
        kernels = ({"fused_rates", "fused_post"} if name == "aerosol1d"
                   else {"fused_step"})
        assert e["dtype"] == "float64" and e["launches"] == {
            k: e["n_steps"] * (k in kernels) for k in e["launches"]}, name
        assert e["pass"] == (e["worst_target_field_rel"] <= S.RTOL
                             and e["cum_ppt_rain_rel"] <= S.RTOL
                             and e["worst_aerosol_extra_rel"]
                             <= S.RTOL_AEROSOL_EXTRAS), name
    assert set(v["f32_cuda"]["cases"]) == set(V.RUNS)
    assert set(v["f32_cuda_2d"]["cases"]) == {"cumulus2d", "orographic2d",
                                              "cumulus2d_sharded"}
    assert v["f32_cuda_2d"]["cases"]["cumulus2d_sharded"][
        "bitwise_equal_to_single_process"]
    assert set(v["twod_oracle_twin"]) == set(v["twod_conservation"]) == {
        "cumulus2d", "orographic2d"}
    env = v["chaos_envelope"]["cases"]
    assert set(env) == {"aerosol1d", "mixed1", "warm1"}
    for name, e in env.items():
        assert e["n_steps"] == tcases.CASES[name].n_steps
        assert e["dtype"] == "float32"
        for kind in ("white_noise", "persistent_bias"):
            assert e[kind]["members"] == 3 and e[kind]["eps"] == 1e-7
    mp = rec["MULTIPROC"]
    assert mp["bitwise_identical"] and mp["n_steps"] == 900
    assert mp["dtype"] == "float64" and mp["ranks"] == [1, 4]
    assert len(mp["layouts"][1]["devices"]) == 4
    b = rec["BENCH"]
    assert b["bench"]["vs_baseline"] == b["bench"]["value"] / 1.0e4
    # the scaling record's throughput target names the bench run it read
    t = sc["targets"]["throughput_vs_baseline_10x"]
    assert t["vs_baseline"] == b["bench"]["vs_baseline"]
    assert {k: t[k] for k in ("commit", "source_sha256", "at")} == {
        k: b["runs"]["bench"][k] for k in ("commit", "source_sha256", "at")}
    assert b["baseline"]["baseline_col_steps_per_sec"] == 1.0e4
