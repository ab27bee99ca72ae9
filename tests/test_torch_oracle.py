"""The port's oracle arbiter against the reference's, on the CPU.

  * ``kid_tpu_torch/validation/oracle.py`` gives the reference oracle's
    bits on every output (rates and sedimentation record included) on the
    synthetic columns of ``tests/test_oracle.py``: mixed, warm, aerosol,
    cold nucleation and chained steps;
  * the port's ``driver_twin.oracle_simulate`` gives the reference twin's
    bits in the finals, the four precip series and the time means:
    mixed1 and aerosol1d for 10 steps, cumulus2d and orographic2d at 4
    columns for 5 steps;
  * its m(t) is the reference twin's at every step of five cases;
  * ``validation.cases --write-finals`` writes the reference's layout, and
    ``validation.twod.twin_equivalence`` passes, closures included;
  * ``solver.vmapped_microphysics`` equals the port's
    ``batched_microphysics`` bit for bit, and the reference's
    ``vmapped_microphysics`` (warm) within the solver parity model of
    ``test_torch_solver.assert_equiv``.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kid_tpu.config import MicroConfig as JMicroConfig
from kid_tpu.driver import cases as jcases
from kid_tpu.micro import solver as JS
from kid_tpu.micro.state import ColumnState as JState
from kid_tpu.tables.cache import get_tables as j_get_tables
from kid_tpu.validation import driver_twin as jtwin
from kid_tpu.validation import oracle as joracle
from kid_tpu_torch.config import MicroConfig
from kid_tpu_torch.driver import cases as tcases
from kid_tpu_torch.micro import solver as S
from kid_tpu_torch.micro.state import ColumnState
from kid_tpu_torch.tables.cache import get_tables
from kid_tpu_torch.validation import cases as V
from kid_tpu_torch.validation import driver_twin as ttwin
from kid_tpu_torch.validation import oracle as toracle
from kid_tpu_torch.validation import twod
from test_oracle import NZ, ORACLE_KEYS, _profile
from test_torch_solver import _make_batch, assert_equiv

torch.set_num_threads(2)

DT = 10.0


def _assert_same_bits(got, want, where=""):
    """``got`` and ``want`` (nested dicts, sequences, arrays and scalars)
    hold the same keys and the same bits."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same_bits(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same_bits(a, b, f"{where}[{i}]")
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.dtype != object and a.tobytes() == b.tobytes(), where


def _cold_profile():
    """tests/test_oracle.py::test_aerosol_cold_nucleation's column."""
    nz = 32
    t = np.linspace(236.0, 215.0, nz)
    p = np.linspace(40000.0, 15000.0, nz)
    qvsi = np.array([joracle.rsif(pp, tt) for pp, tt in zip(p, t)])
    return dict(
        t=t, p=p, qv=1.5 * qvsi, qc=np.zeros(nz), qr=np.zeros(nz),
        qi=np.full(nz, 2e-6), qs=np.zeros(nz), qg=np.zeros(nz),
        ni=np.full(nz, 1e3), nr=np.zeros(nz), nc=np.full(nz, 5e7),
        nwfa=np.full(nz, 300e6), nifa=np.full(nz, 5e6),
        dz=np.full(nz, 300.0), w=np.full(nz, 0.2))


def _aerosol_profile(seed):
    """tests/test_oracle.py::test_single_step_aerosol's column."""
    prof = _profile(NZ, seed)
    rng = np.random.default_rng(seed + 100)
    prof["w"] = np.abs(rng.normal(0.5, 0.5, NZ))
    prof["nwfa"] = np.full(NZ, 500.0e6) / (0.622 * prof["p"] / (
        287.04 * prof["t"] * (prof["qv"] + 0.622)))
    prof["nifa"] = np.full(NZ, 2.0e6)
    prof["nc"] = np.where(prof["qc"] > 0, 150.0e6, 10.0e6) / 1.1
    return prof


# column -> (profile, iiwarm, aerosol-aware, chained steps)
COLUMNS = {
    **{f"mixed seed {s}": (lambda s=s: _profile(NZ, s), False, False, 1)
       for s in (0, 1, 2, 3)},
    **{f"warm seed {s}": (lambda s=s: _profile(NZ, s, warm=True), True,
                          False, 1) for s in (0, 5)},
    **{f"aerosol seed {s}": (lambda s=s: _aerosol_profile(s), False, True,
                             1) for s in (3, 11)},
    "aerosol cold nucleation": (_cold_profile, False, True, 1),
    "mixed, 5 chained steps": (lambda: _profile(NZ, 7), False, False, 5),
}


def _oracle(fn, prof, tables, iiwarm, aerosol):
    return fn(prof["qv"], prof["qc"], prof["qi"], prof["qr"], prof["qs"],
              prof["qg"], prof["ni"], prof["nr"], prof["nc"], prof["nwfa"],
              prof["nifa"], prof["t"], prof["p"], prof["w"], prof["dz"], DT,
              tables, iiwarm=iiwarm, is_aerosol_aware=aerosol)


@pytest.mark.parametrize("column", list(COLUMNS))
def test_oracle_gives_the_reference_bits(column):
    make, iiwarm, aerosol, n = COLUMNS[column]
    j_prof, t_prof = make(), make()
    j_tab, t_tab = j_get_tables(iiwarm=iiwarm), get_tables(iiwarm=iiwarm)
    for step in range(n):
        want = _oracle(joracle.mp_thompson_oracle, j_prof, j_tab, iiwarm,
                       aerosol)
        got = _oracle(toracle.mp_thompson_oracle, t_prof, t_tab, iiwarm,
                      aerosol)
        _assert_same_bits(got, want, f"step {step}")
        for prof, out in ((j_prof, want), (t_prof, got)):
            for f, k in ORACLE_KEYS.items():      # each fed its own output
                prof[f] = np.asarray(out[k], np.float64)
    if column == "aerosol cold nucleation":
        assert max(got["rates"]["pri_iha"].max(),
                   got["rates"]["pri_inu"].max()) > 0.0


# case -> (columns (None: the case's own), steps)
TWIN_RUNS = {"mixed1": (None, 10), "aerosol1d": (None, 10),
             "cumulus2d": (4, 5), "orographic2d": (4, 5)}


def _narrow(cases, name, nx):
    case = cases.CASES[name]
    return case if nx is None else dataclasses.replace(case, nx=nx)


@pytest.mark.parametrize("name", list(TWIN_RUNS))
def test_twin_gives_the_reference_twin_bits(name):
    nx, n = TWIN_RUNS[name]
    jcase, tcase = _narrow(jcases, name, nx), _narrow(tcases, name, nx)
    iiwarm = tcase.micro.iiwarm
    want = jtwin.oracle_simulate(jcase, n, j_get_tables(iiwarm=iiwarm),
                                 want_means=True)
    got = ttwin.oracle_simulate(tcase, n, get_tables(iiwarm=iiwarm),
                                want_means=True)
    _assert_same_bits(got, want)
    fields, ppt, _ = got
    assert ppt["rain"].shape == ((n,) if nx is None else (n, nx))
    assert set(fields) == set(V.KidState._fields)


@pytest.mark.parametrize("name", ["mixed1", "aerosol1d", "warm1",
                                  "cumulus2d", "orographic2d"])
def test_twin_modulation_is_the_reference_twins(name):
    jcase, tcase = jcases.CASES[name], tcases.CASES[name]
    for i in range(tcase.n_steps):
        want = float(np.asarray(jcase.time_modulation(i * jcase.dt)))
        assert ttwin.twin_modulation(tcase, i) == want, i


def test_write_finals_writes_the_reference_layout(tmp_path, capsys):
    assert V.main(["--device", "cpu", "--cases", "mixed1", "--steps", "3",
                   "--dtype", "float64", "--write-finals",
                   str(tmp_path)]) == 0
    with np.load(tmp_path / "mixed1.npz") as z:
        got = {k: z[k] for k in z.files}
    with np.load(V.FINALS_DIR / "mixed1.npz") as z:
        assert list(got) == z.files
    assert got["ppt_rain"].shape == (3,) and got["qv"].shape == (1, 120)
    fo, ppt, means = ttwin.oracle_simulate(
        tcases.MIXED1, 3, get_tables(iiwarm=False), want_means=True)
    _assert_same_bits(got, {"ppt_rain": ppt["rain"], **fo,
                            **{f"tmean_{f}": v for f, v in means.items()}})
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["all_pass"] is True


@pytest.mark.parametrize("name", ["cumulus2d", "orographic2d"])
def test_twod_twin_equivalence_passes(name):
    e = twod.twin_equivalence(_narrow(tcases, name, 4), 5, "cpu")
    assert e["pass"] and e["closure_match"]
    assert e["worst_target_field_rel"] <= twod.scores.RTOL
    assert e["n_steps"] == 5 and e["nx"] == 4
    assert e["launches"] == dict.fromkeys(e["launches"], 0)


def test_twod_main_runs_the_twin_rows(capsys):
    assert twod.main(["--device", "cpu", "--twin", "--steps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[:3] for ln in lines[:2]] == [
        ["cumulus2d", "twin", f"nx={twod.TWIN_NX}"],
        ["orographic2d", "twin", f"nx={twod.TWIN_NX}"]]
    assert json.loads(lines[-1])["all_pass"] is True


VMAP_CFGS = {"mixed": dict(iiwarm=False), "warm": dict(iiwarm=True),
             "aerosol": dict(iiwarm=False, is_aerosol_aware=True)}


def _vmap_inputs(seed=0):
    state, pres, dzq = _make_batch(4, 48, seed)
    w = np.random.default_rng(seed + 1).uniform(0.0, 2.0, (4, 48))
    return state, pres, w, dzq


def _flat(res):
    st, ppt, diag = res
    out = {f"state {f}": getattr(st, f) for f in st._fields}
    out.update({f"ppt {f}": getattr(ppt, f) for f in ppt._fields})
    out.update({f"rate {k}": v for k, v in diag.items()})
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


@pytest.mark.parametrize("cfg", list(VMAP_CFGS))
def test_vmapped_equals_batched(cfg):
    state, pres, w, dzq = _vmap_inputs()
    st = ColumnState(**{k: torch.tensor(v) for k, v in state.items()})
    args = (st, torch.tensor(pres), torch.tensor(w), torch.tensor(dzq), DT,
            S.device_tables(get_tables(iiwarm=VMAP_CFGS[cfg]["iiwarm"]),
                            torch.float64, "cpu"),
            MicroConfig(**VMAP_CFGS[cfg]))
    got = _flat(S.vmapped_microphysics(*args, device="cpu"))
    want = _flat(S.batched_microphysics(*args, device="cpu"))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    if cfg != "warm":
        return
    # the reference's vmap cross-check on the same columns: the JAX
    # solver and the port's agree to the parity model's 1e-8 noise, not
    # bit for bit (XLA's and torch's elementwise programs differ)
    jwant = JS.vmapped_microphysics(
        JState(**{k: jnp.asarray(v) for k, v in state.items()}),
        jnp.asarray(pres), jnp.asarray(w), jnp.asarray(dzq), DT,
        JS.device_tables(j_get_tables(iiwarm=True), jnp.float64),
        JMicroConfig(iiwarm=True, dtype="float64"))
    jflat = _flat(jwant)
    assert set(jflat) == set(got)
    assert_equiv(got, jflat)
