"""PyTorch port's moment diagnostics, WRF-shaped adapter and validation
scores, on the CPU.

``effective_radii`` and ``refl_10cm`` against ``kid_tpu.diag.moments`` on
the scenarios of ``tests/test_diag.py`` and on a seeded (ncol, nz) batch
with warm and cold layers (float64, rtol 1e-10; dBZ also atol 1e-10 dB
where it crosses zero); ``mp_driver_3d`` against
``kid_tpu.driver.wrf_adapter.mp_driver_3d`` on the warm tile of
``tests/test_diag.py`` and on a seeded mixed-phase tile (the
``test_torch_solver.assert_equiv`` model); the negative-vapor repair; the
adapter's device rule; and ``validation/scores.py`` against values
computed here by hand on a perturbed copy of a float64 anchor.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kid_tpu.config import MicroConfig as JMicroConfig
from kid_tpu.diag import moments as jmom
from kid_tpu.driver import cases as jcases
from kid_tpu.driver.wrf_adapter import mp_driver_3d as j_mp_driver_3d
from kid_tpu.micro.solver import device_tables as j_device_tables
from kid_tpu.tables.cache import get_tables as j_get_tables
from kid_tpu_torch.config import MicroConfig
from kid_tpu_torch.convert import tables_from_numpy
from kid_tpu_torch.diag import moments as tmom
from kid_tpu_torch.driver import cases as tcases
from kid_tpu_torch.driver import wrf_adapter as W
from kid_tpu_torch.validation import scores
from test_torch_driver import _seeded_state
from test_torch_solver import assert_equiv

torch.set_num_threads(2)

FINALS = Path(__file__).resolve().parents[1] / "validation_finals"
WINDOWS = ((2.49e-6, 50.0e-6), (4.99e-6, 125.0e-6), (9.99e-6, 999.0e-6))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float64))


def _thermo_cols(nz=8):
    return (np.linspace(258.0, 288.0, nz), np.linspace(60000.0, 95000.0, nz),
            np.full(nz, 5e-3))


def _seeded_batch(ncol=40, nz=50, seed=0):
    """Columns from 300 K at the surface to 215 K aloft (warm and cold
    layers), with seeded hydrometeors, zeros among them, and cloud numbers
    across the g_ratio branches."""
    rng = np.random.default_rng(seed)
    zc = (np.arange(nz) + 0.5) * (12000.0 / nz)
    shape = (ncol, nz)
    t = np.maximum(300.0 - 0.007 * zc, 215.0)[None, :] + rng.normal(
        0.0, 1.5, shape)
    p = np.broadcast_to(101325.0 * np.exp(-zc / 8500.0), shape).copy()
    qv = 0.015 * np.exp(-zc / 2500.0)[None, :] * rng.uniform(0.5, 1.2, shape)

    def sparse(amp):
        return np.where(rng.random(shape) < 0.7,
                        amp * 10.0 ** rng.uniform(-4.0, 0.0, shape), 0.0)

    return dict(t=t, p=p, qv=qv, qc=sparse(1e-3), qr=sparse(2e-3),
                qi=sparse(2e-4), qs=sparse(1e-3), qg=sparse(2e-3),
                nc=10.0 ** rng.uniform(-0.5, 10.5, shape),
                ni=10.0 ** rng.uniform(1.0, 6.0, shape),
                nr=10.0 ** rng.uniform(2.0, 6.0, shape))


def _radii_scenarios():
    t, p, qv = _thermo_cols()
    nz = t.shape[0]
    full = (t, p, qv, np.full(nz, 0.5e-3), np.zeros(nz), np.full(nz, 0.1e-3),
            np.full(nz, 10.0e3), np.full(nz, 0.2e-3))
    zero = (t, p, qv) + (np.zeros(nz),) * 5
    b = _seeded_batch()
    batch = tuple(b[k] for k in ("t", "p", "qv", "qc", "nc", "qi", "ni",
                                 "qs"))
    return {"test_diag": full, "zero condensate": zero, "seeded": batch}


@pytest.mark.parametrize("aerosol", [False, True], ids=["fixed_nc", "aero"])
@pytest.mark.parametrize("scenario", ["test_diag", "zero condensate",
                                      "seeded"])
def test_effective_radii_match_jax(scenario, aerosol):
    args = _radii_scenarios()[scenario]
    want = jmom.effective_radii(*map(_j, args), 100.0e6, aerosol)
    got = tmom.effective_radii(*map(_t, args), 100.0e6, aerosol)
    for g, w, (lo, hi) in zip(got, want, WINDOWS):
        g = g.numpy()
        assert g.shape == args[0].shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10, atol=0)
        assert (g >= lo).all() and (g <= hi).all()
    if scenario == "seeded":        # every branch of every species taken
        re_c, re_i, re_s = (g.numpy() for g in got)
        assert len(np.unique(re_c)) > 10 and (re_c == 2.49e-6).any()
        assert (re_i == 4.99e-6).any() and (re_i > 5.01e-6).any()
        assert (re_s == 9.99e-6).any() and (re_s > 10.0e-6).any()


def _refl_scenarios():
    nz = 4
    zero = np.zeros(nz)
    rain = (np.full(nz, 8e-3), zero, None, np.full(nz, 5.0e3), zero, zero,
            np.full(nz, 285.0), np.full(nz, 90000.0))
    lo, hi = list(rain), list(rain)
    lo[2], hi[2] = np.full(nz, 0.5e-3), np.full(nz, 2.0e-3)
    dry = list(rain)
    dry[2], dry[3] = zero, zero
    snow = (np.full(3, 2e-3), np.zeros(3), np.zeros(3), np.zeros(3),
            np.full(3, 1.0e-3), np.zeros(3), np.full(3, 263.0),
            np.full(3, 70000.0))
    b = _seeded_batch(seed=1)
    batch = tuple(b[k] for k in ("qv", "qc", "qr", "nr", "qs", "qg", "t",
                                 "p"))
    return {"rain low": tuple(lo), "rain high": tuple(hi),
            "dry": tuple(dry), "snow": snow, "seeded": batch}


@pytest.mark.parametrize("scenario", ["rain low", "rain high", "dry", "snow",
                                      "seeded"])
def test_refl_10cm_matches_jax(scenario):
    args = _refl_scenarios()[scenario]
    want = np.asarray(jmom.refl_10cm(*map(_j, args)))
    got = tmom.refl_10cm(*map(_t, args)).numpy()
    assert got.shape == args[0].shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    if scenario == "seeded":
        t, qr = args[6], args[2]
        assert np.isfinite(got).all()
        # the graupel N0 scan's cold branch is taken
        assert ((t < 270.65) & (qr > 1e-4)).any()


def _warm_tile():
    """The tile of tests/test_diag.py::test_wrf_adapter_accumulators_and_
    negqv: 2 x 16 x 3, a rain shaft aloft, accumulators at 0.25."""
    ni_, nk, nj = 2, 16, 3
    z = np.linspace(100.0, 3100.0, nk)
    p = np.broadcast_to(101325.0 * np.exp(-z / 8000.0)[None, :, None],
                        (ni_, nk, nj)).copy()
    t = np.broadcast_to((293.0 - 0.0065 * z)[None, :, None],
                        (ni_, nk, nj)).copy()
    pii = (p / 101325.0) ** (287.04 / 1004.0)
    qr = np.zeros((ni_, nk, nj))
    qr[:, 4:10, :] = 1.5e-3
    zero = np.zeros((ni_, nk, nj))
    fields = (np.full((ni_, nk, nj), 8e-3), zero, qr, zero, zero, zero, zero,
              np.where(qr > 0, 1.0e4, 0.0), t / pii, pii, p, zero,
              np.full((ni_, nk, nj), z[1] - z[0]))
    acc = (np.full((ni_, nj), 0.25), np.zeros((ni_, nj)),
           np.zeros((ni_, nj)))
    return fields, 20.0, acc, True


def _mixed_tile(ni_=3, nj=4):
    """mixed1's sounding with the seeded hydrometeor layers of
    ``test_torch_driver``, as an (i, k, j) tile with seeded w and nonzero
    accumulators."""
    case = dataclasses.replace(jcases.MIXED1, nx=ni_ * nj)
    grid = case.grid()
    st = _seeded_state(case, seed=2)
    rng = np.random.default_rng(5)

    def ikj(cols):
        cols = np.broadcast_to(cols, (ni_ * nj, case.nz))
        return np.moveaxis(cols.reshape(ni_, nj, case.nz), -1, 1).copy()

    fields = tuple(ikj(st[k]) for k in ("qv", "qc", "qr", "qi", "qs", "qg",
                                        "ni", "nr", "theta"))
    fields += (ikj(grid.exner), ikj(grid.pres),
               ikj(rng.uniform(-1.0, 3.0, (ni_ * nj, case.nz))),
               ikj(grid.dz))
    acc = tuple(rng.uniform(0.0, 2.0, (ni_, nj)) for _ in range(3))
    return fields, case.dt, acc, False


@pytest.mark.parametrize("tile", ["warm", "mixed"])
def test_mp_driver_3d_matches_jax(tile):
    fields, dt, acc, warm = _warm_tile() if tile == "warm" else _mixed_tile()
    jtabs = j_device_tables(j_get_tables(iiwarm=warm), jnp.float64)
    want = j_mp_driver_3d(*map(_j, fields), dt, *map(_j, acc), jtabs,
                          JMicroConfig(iiwarm=warm), want_eff_rad=True)
    ttabs = tables_from_numpy(j_get_tables(iiwarm=warm), torch.float64,
                              "cpu")
    got = W.mp_driver_3d(*map(_t, fields), dt, *map(_t, acc), ttabs,
                         MicroConfig(iiwarm=warm), want_eff_rad=True,
                         device="cpu")
    (gf, gp, ge), (wf, wp, we) = got, want
    assert isinstance(gp, W.WrfPrecip) and gp._fields == wp._fields
    assert set(gf) == set(wf) and set(ge) == set(we)
    for g, w in ((gf, wf), (gp._asdict(), wp._asdict()), (ge, we)):
        for k in w:
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            assert g[k].is_contiguous(), k
        assert_equiv({k: v.numpy() for k, v in g.items()},
                     {k: np.asarray(v) for k, v in w.items()})
    np.testing.assert_allclose(gp.rainnc.numpy(),
                               acc[0] + gp.rainncv.numpy(), rtol=1e-12)
    assert (gf["qv"].numpy() >= 0.0).all()
    if warm:                  # warm rain only: no frozen precip
        assert float(gp.sr.abs().max()) < 1e-9
        assert float(gp.snownc.abs().max()) == 0.0
    else:
        assert float(gp.rainncv.min()) > 0.0
        assert float(gf["qs"].max()) > 0.0 and float(gf["qg"].max()) > 0.0


def test_negative_qv_repair():
    """The repair on the row of tests/test_diag.py::
    test_wrf_adapter_negqv_repair_unit and on a row that reaches the
    floor, against the reference's formula."""
    row = np.array([[1e-3, -5e-4, 2e-3, -1.0, 3e-3],
                    [-1e-3, -2e-3, 1e-9, 4e-3, -5e-3]])
    got = W._repair_negative_qv(_t(row)).numpy()
    qv = _j(row)
    up = jnp.concatenate([qv[:, 1:], qv[:, -1:]], axis=1)
    dn = jnp.concatenate([qv[:, :1], qv[:, :-1]], axis=1)
    want = np.asarray(jnp.where(qv < 0.0,
                                jnp.maximum(1.0e-7, 0.5 * (up + dn)), qv))
    np.testing.assert_array_equal(got, want)
    assert got[0, 1] == pytest.approx(0.5 * (1e-3 + 2e-3))
    assert got[0, 3] == pytest.approx(0.5 * (2e-3 + 3e-3))
    assert got[0, 0] == 1e-3 and got[0, 2] == 2e-3 and got[0, 4] == 3e-3
    # an end level counts itself as its missing neighbor; a negative mean
    # takes the floor
    np.testing.assert_array_equal(got[1], [1.0e-7, 1.0e-7, 1e-9, 4e-3,
                                           1.0e-7])


def test_mp_driver_3d_needs_a_card_unless_cpu(monkeypatch):
    fields, dt, acc, _ = _warm_tile()
    tabs = tables_from_numpy(j_get_tables(iiwarm=True), torch.float64, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        W.mp_driver_3d(*map(_t, fields), dt, *map(_t, acc), tabs,
                       MicroConfig(iiwarm=True))


def _anchor_run():
    """cumulus2d's float64 anchor as a run that scores 0 against it: its
    finals and time means, its domain rain series spread evenly over the
    columns, and initial water that closes the budget with that rain."""
    anchor = dict(np.load(FINALS / "cumulus2d_2dfp64.npz"))
    grid = tcases.CUMULUS2D.grid()
    wz = grid.rho0 * grid.dz
    final = {f: anchor[f].copy() for f in scores.TARGET_FIELDS
             + ("nc", "nwfa", "nifa")}
    tmean = {f: anchor[f"tmean_{f}"].copy() for f in scores.TARGET_FIELDS}
    nx = final["qv"].shape[0]
    rain = np.repeat(anchor["ppt_rain"][:, None] / nx, nx, axis=1)
    fields0 = {f: anchor[f].copy() for f in scores.WATER_FIELDS}
    fields0["qv"] += rain.sum() / (nx * wz.sum())
    ppt = {"rain": rain, "snow": np.zeros_like(rain)}
    return anchor, (grid.rho0, grid.dz, fields0, final, ppt, tmean)


def test_scores_on_a_perturbed_anchor():
    anchor, run = _anchor_run()
    rho0, dz, fields0, final, ppt, tmean = run
    wz = rho0 * dz
    same = scores.score_2d_f32("cumulus2d", *run, anchor)
    assert same["pass"] and same["worst_target_field_rel"] == 0.0
    assert same["tmean_prof_worst_rel"] == 0.0
    assert abs(same["cum_ppt_rain_rel"]) < 1e-12
    assert abs(same["closure"]) < 1e-12

    final["qv"][3, 7] *= 1.0 + 2e-3
    final["qc"][10] *= 0.99
    final["nwfa"] *= 1.5
    tmean["qr"][:, 5] *= 1.03
    total = anchor["ppt_rain"].sum()
    ppt["rain"][100, 0] += 0.01 * total
    entry = scores.score_2d_f32("cumulus2d", *run, anchor)
    # by hand
    assert entry["fields"]["qv"] == pytest.approx(
        2e-3 * anchor["qv"][3, 7] / anchor["qv"].max(), rel=1e-9)
    assert entry["fields"]["qc"] == pytest.approx(
        0.01 * anchor["qc"][10].max() / anchor["qc"].max(), rel=1e-9)
    assert entry["fields"]["theta"] == 0.0
    assert entry["worst_aerosol_extra_rel"] == pytest.approx(0.5, rel=1e-9)
    assert entry["cum_ppt_rain_rel"] == pytest.approx(
        0.01 * total / anchor["ppt_rain"].cumsum().max(), rel=1e-9)
    vapor = (anchor["qv"] * wz).sum(-1)
    assert entry["final_wvp_rel"] == pytest.approx(
        2e-3 * anchor["qv"][3, 7] * wz[7] / (vapor.max() * (1.0 + 1e-6)),
        rel=1e-9)
    lwp = ((anchor["qc"] + anchor["qr"]) * wz).sum(-1)
    assert entry["final_lwp_rel"] == pytest.approx(
        0.01 * (anchor["qc"][10] * wz).sum() / (lwp.max()
                                                + 1e-6 * vapor.max()),
        rel=1e-9)
    assert entry["final_iwp_rel"] == 0.0
    assert entry["tmean_prof_worst_rel"] == pytest.approx(
        0.03 * anchor["tmean_qr"][:, 5].max() / anchor["tmean_qr"].max(),
        rel=1e-9)
    w0 = (sum(fields0[f] for f in scores.WATER_FIELDS) * wz).sum()
    wf = (sum(final[f] for f in scores.WATER_FIELDS) * wz).sum()
    assert entry["closure"] == pytest.approx(
        (w0 - wf - total * 1.01) / w0, rel=1e-9)
    assert entry["pass"]              # all inside their budgets

    # each budget alone fails the run
    for poke, budget in (
            (lambda: tmean["qr"].__imul__(1.05), scores.TMEAN_BUDGET),
            (lambda: ppt["rain"].__imul__(1.03), scores.PPT_BUDGET_DEFAULT),
            (lambda: final["qr"].__imul__(1.2), scores.PATH_BUDGET),
            (lambda: fields0["qv"].__imul__(1.02), scores.CONS_TOL)):
        _, run = _anchor_run()
        rho0, dz, fields0, final, ppt, tmean = run
        poke()
        e = scores.score_2d_f32("cumulus2d", *run, anchor)
        assert not e["pass"], budget
