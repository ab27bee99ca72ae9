"""PyTorch port's 2-D KiD path against the JAX package, on the CPU.

The periodic MUSCL x-advection against ``kid_tpu.driver.advection`` on
seeded inputs (float64, rtol 1e-13) and its invariants; cumulus2d
(warm) and orographic2d (mixed phase) at nx=16 from the seeded state of
``test_torch_driver`` at istep0=150, 10 steps, against the JAX package's
``simulate`` (the ``test_torch_solver.assert_equiv`` model, precip rtol
1e-8); cumulus2d from its initial state against the oracle twin
(``kid_tpu/validation/driver_twin.py``) at the tolerances of
``tests/test_driver_twin.py``; and the fused driver switch, which 2-D
cases ignore.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kid_tpu.driver import advection as jadv
from kid_tpu.driver import cases as jcases
from kid_tpu.driver.loop import KidState as JKidState
from kid_tpu.driver.loop import simulate as j_simulate
from kid_tpu.micro.solver import device_tables as j_device_tables
from kid_tpu.tables.cache import get_tables as j_get_tables
from kid_tpu.validation.driver_twin import oracle_simulate
from kid_tpu_torch.convert import tables_from_numpy
from kid_tpu_torch.driver import advection as tadv
from kid_tpu_torch.driver import cases as tcases
from kid_tpu_torch.driver.loop import (FUSED_DRIVER_ENV, KidState,
                                       initial_state, simulate)
from kid_tpu_torch.micro import fused_kid_step as FK
from test_torch_driver import _seeded_state
from test_torch_solver import assert_equiv

torch.set_num_threads(2)

NX2D, N_STEPS, ISTEP0 = 16, 10, 150
N_TWIN = 24
PPT = ("ppt_rain", "ppt_snow", "ppt_graupel", "ppt_ice")


def _flow(name, nx=NX2D, m=0.7):
    """The case's density and dx, with a face flux u0*rho0 + m*rho0*u'."""
    case = dataclasses.replace(tcases.CASES[name], nx=nx)
    grid = case.grid()
    u_face = case.u0 * grid.rho0[None, :] + m * case.rhou_pattern(grid)
    return case, grid, u_face


def _seeded_tracers(nx, nz, seed=0, n_adv=3):
    rng = np.random.default_rng(seed)
    return rng.random((n_adv, nx, nz)) * np.exp(-rng.random((1, 1, nz)))


@pytest.mark.parametrize("name", ["cumulus2d", "orographic2d"])
def test_advective_tendency_x_matches_jax(name):
    case, grid, u_face = _flow(name)
    q = _seeded_tracers(case.nx, case.nz)
    qpad = np.concatenate([q[:, -2:], q, q[:, :2]], axis=1)
    rho0 = grid.rho0
    got = tadv.advective_tendency_x_padded(
        torch.as_tensor(qpad), torch.as_tensor(u_face),
        torch.as_tensor(rho0), case.dx).numpy()
    want = np.asarray(jadv.advective_tendency_x_padded(
        jnp.asarray(qpad), jnp.asarray(u_face), jnp.asarray(rho0), case.dx))
    assert got.shape == want.shape == q.shape
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-30)
    got1 = tadv.advective_tendency_x(torch.as_tensor(q[1]),
                                     torch.as_tensor(u_face),
                                     torch.as_tensor(rho0), case.dx).numpy()
    want1 = np.asarray(jadv.advective_tendency_x(
        jnp.asarray(q[1]), jnp.asarray(u_face), jnp.asarray(rho0), case.dx))
    np.testing.assert_allclose(got1, want1, rtol=1e-13, atol=1e-30)
    np.testing.assert_array_equal(got1, got[1])


@pytest.mark.parametrize("name", ["cumulus2d", "orographic2d"])
def test_uniform_tracer_keeps_its_value(name):
    """The x flux of an x-uniform wind moves a uniform tracer nowhere, and
    with the circulation the x and z tendencies of a uniform tracer cancel
    (the stream-function fluxes are non-divergent)."""
    case, grid, u_face = _flow(name)
    rho0 = torch.as_tensor(grid.rho0)
    q = torch.full((case.nx, case.nz), 0.37, dtype=torch.float64)
    background = torch.as_tensor(np.broadcast_to(
        case.u0 * grid.rho0, (case.nx + 1, case.nz)).copy())
    assert torch.equal(tadv.advective_tendency_x(q, background, rho0,
                                                 case.dx),
                       torch.zeros_like(q))
    m = 0.7
    ten_x = tadv.advective_tendency_x(q, torch.as_tensor(u_face), rho0,
                                      case.dx)
    w_face = m * torch.as_tensor(case.rhow_pattern(grid))
    ten_z = tadv.advective_tendency_z(q, w_face, rho0,
                                      torch.as_tensor(grid.dz))
    assert float(ten_x.abs().max()) > 1e-6
    scale = float(ten_x.abs().max())
    assert float((ten_x + ten_z).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("name", ["cumulus2d", "orographic2d"])
def test_x_tendency_conserves_mass(name):
    case, grid, u_face = _flow(name)
    q = torch.as_tensor(_seeded_tracers(case.nx, case.nz, seed=3)[0])
    rho0 = torch.as_tensor(grid.rho0)
    ten = tadv.advective_tendency_x(q, torch.as_tensor(u_face), rho0,
                                    case.dx)
    mass = rho0[None, :] * ten
    # per level, over the periodic domain: sum(rho0 * ten) is 0 to rounding
    assert float(mass.sum(0).abs().max()) <= 1e-13 * float(
        mass.abs().sum(0).max())


def _run_both_2d(name, names=("qc", "qr", "dqv_mphys")):
    jcase = dataclasses.replace(jcases.CASES[name], nx=NX2D)
    tcase = dataclasses.replace(tcases.CASES[name], nx=NX2D)
    st = _seeded_state(jcase)
    jtabs = j_device_tables(j_get_tables(iiwarm=jcase.micro.iiwarm),
                            jnp.float64)
    jst = JKidState(**{k: jnp.asarray(v) for k, v in st.items()})
    want = j_simulate(jst, jtabs, jcase, N_STEPS, names, ISTEP0)
    ttabs = tables_from_numpy(j_get_tables(iiwarm=tcase.micro.iiwarm),
                              torch.float64, "cpu")
    st0 = KidState(**{k: torch.as_tensor(v) for k, v in st.items()})
    got = simulate(st0, ttabs, tcase, N_STEPS, names, ISTEP0, device="cpu")
    return got, want


@pytest.mark.parametrize("name", ["cumulus2d", "orographic2d"])
def test_2d_simulate_matches_jax(name):
    (gst, gout), (wst, wout) = _run_both_2d(name)
    assert_equiv({f: getattr(gst, f).numpy() for f in KidState._fields},
                 {f: np.asarray(getattr(wst, f)) for f in KidState._fields})
    for k in PPT:
        g, w = getattr(gout, k).numpy(), np.asarray(getattr(wout, k))
        assert g.shape == w.shape == (N_STEPS, NX2D), k
        np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-20, err_msg=k)
    assert set(gout.profiles) == set(wout.profiles)
    for k, v in wout.profiles.items():
        assert_equiv({k: gout.profiles[k].numpy()}, {k: np.asarray(v)})
    # the columns differ: the circulation reached the microphysics
    assert float(gst.qc.std(0).max()) > 0.0
    assert float(gout.ppt_rain.sum()) > 0.0


def test_cumulus2d_matches_oracle_twin():
    jcase = dataclasses.replace(jcases.CUMULUS2D, nx=NX2D)
    tcase = dataclasses.replace(tcases.CUMULUS2D, nx=NX2D)
    host = j_get_tables(iiwarm=True)
    fo, ppt = oracle_simulate(jcase, N_TWIN, host)
    final, streams = simulate(
        initial_state(tcase, torch.float64, "cpu"),
        tables_from_numpy(host, torch.float64, "cpu"), tcase, N_TWIN,
        device="cpu")
    for f in KidState._fields:
        a = getattr(final, f).numpy()
        b = fo[f]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * (np.abs(b).max() + 1e-30),
                                   err_msg=f"field {f}")
    assert float(final.qc.max()) > 1e-5          # cloud formed
    np.testing.assert_allclose(streams.ppt_rain.numpy(), ppt["rain"],
                               rtol=1e-4, atol=1e-18)


@pytest.mark.parametrize("name", ["cumulus2d", "orographic2d"])
def test_fused_driver_switch_ignored_for_2d(name, monkeypatch):
    case = dataclasses.replace(tcases.CASES[name], nx=8)
    tabs = tables_from_numpy(j_get_tables(iiwarm=case.micro.iiwarm),
                             torch.float64, "cpu")
    st0 = KidState(**{k: torch.as_tensor(v) for k, v in _seeded_state(
        dataclasses.replace(jcases.CASES[name], nx=8)).items()})

    def run():
        return simulate(st0, tabs, case, 2, ("qr",), ISTEP0, device="cpu")

    want_st, want_out = run()
    monkeypatch.setenv(FUSED_DRIVER_ENV, "1")

    def refuse(*args):
        raise AssertionError("fused_kid_step called for a 2-D case")

    monkeypatch.setattr(FK, "fused_kid_step", refuse)
    got_st, got_out = run()
    for f in KidState._fields:
        assert torch.equal(getattr(got_st, f), getattr(want_st, f)), f
    for k in PPT:
        assert torch.equal(getattr(got_out, k), getattr(want_out, k)), k
    assert torch.equal(got_out.profiles["qr"], want_out.profiles["qr"])


@pytest.mark.parametrize("name", ["cumulus2d", "orographic2d"])
def test_tiled_circulation_repeats_the_case(name):
    """A 2-D case widened by whole circulation cells (``cell_nx``) repeats
    the case's flow in every cell, and its columns follow the case's to
    the assert_equiv model; widened without cells, the circulation
    stretches and its x-CFL number passes 1."""
    case = tcases.CASES[name]
    tiled = dataclasses.replace(case, nx=4 * case.nx, cell_nx=case.nx)
    grid = case.grid()
    for pat in ("rhow_pattern", "rhou_pattern"):
        one = getattr(case, pat)(grid)
        many = getattr(tiled, pat)(grid)
        scale = np.abs(one).max()
        for k in range(4):
            np.testing.assert_allclose(
                many[k * case.nx:k * case.nx + one.shape[0]], one, rtol=0,
                atol=1e-12 * scale, err_msg=pat)

    def cfl(c):
        u = c.rhou_pattern(grid) / grid.rho0[None, :] + c.u0
        return float(np.abs(u).max()) * c.dt / c.dx

    assert cfl(tiled) == pytest.approx(cfl(case), rel=1e-9)
    assert cfl(case) < 0.5 < 1.0 < cfl(dataclasses.replace(case, nx=8192))
    with pytest.raises(ValueError, match="whole cells"):
        dataclasses.replace(case, nx=100, cell_nx=case.nx).rhou_pattern(grid)
    n = 6
    st1, out1 = simulate(initial_state(case, torch.float64, "cpu"),
                         _tables(case), case, n, device="cpu")
    st4, out4 = simulate(initial_state(tiled, torch.float64, "cpu"),
                         _tables(case), tiled, n, device="cpu")
    for k in range(4):
        cols = slice(k * case.nx, (k + 1) * case.nx)
        assert_equiv({f: getattr(st4, f)[cols].numpy()
                      for f in KidState._fields},
                     {f: getattr(st1, f).numpy() for f in KidState._fields})
        np.testing.assert_allclose(out4.ppt_rain[:, cols].numpy(),
                                   out1.ppt_rain.numpy(), rtol=1e-8,
                                   atol=1e-20)


def _tables(case):
    return tables_from_numpy(j_get_tables(iiwarm=case.micro.iiwarm),
                             torch.float64, "cpu")
