"""PyTorch port's fused 1-D driver step against the JAX package, on the CPU.

``fused_kid_step_ref`` (the plain version of ``csrc/fused_kid_step.cu``)
against ``kid_tpu``'s ``fused_kid_step`` kernel in interpret mode, on the
seeded states of ``test_torch_driver`` (nx=4, step 150, inside the updraft
pulse) with the table-stage channels built from the driver's provisional
state, float64, at noise 1e-10 on the
``test_torch_solver.assert_equiv`` model (precip rtol 1e-10); then
``simulate`` with the switch on against the JAX package's fused driver
(``KID_TPU_PALLAS=1 KID_TPU_PALLAS_DRIVER=1``) at the tolerances of
``test_torch_driver._check``.  The fused step advects all 12 channels, the
default step only the scheme fields: the nine scheme fields agree bit for
bit and nwfa does not.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kid_tpu.driver import cases as jcases
from kid_tpu.driver.loop import KidState as JKidState
from kid_tpu.micro.pallas_step import fused_kid_step as j_fused_kid_step
from kid_tpu.tables.cache import get_tables as j_get_tables
from kid_tpu_torch.convert import tables_from_numpy
from kid_tpu_torch.driver import cases as tcases
from kid_tpu_torch.driver.advection import (advective_tendency_z,
                                            divergence_tendency_z)
from kid_tpu_torch.driver.loop import (FUSED_DRIVER_ENV, KidState,
                                       advected_fields, simulate)
from kid_tpu_torch.micro import fused_kid_step as FK
from kid_tpu_torch.micro import solver as S
from kid_tpu_torch.micro.state import ColumnState
from test_torch_driver import (ISTEP0, N_STEPS, NX, _check, _run_both,
                               _seeded_state)
from test_torch_solver import assert_equiv

torch.set_num_threads(2)

SCHEME = ("theta", "qv", "qc", "qr", "nr", "qi", "ni", "qs", "qg")
PPT = ("ppt_rain", "ppt_snow", "ppt_graupel", "ppt_ice")


@functools.lru_cache(maxsize=None)
def _step_inputs(name):
    """The seeded state, m(t) at step ISTEP0 and the table-stage channels
    that the driver builds from its provisional state (which advects
    ``advected_fields`` only), as numpy; the channels are inputs of both
    packages' kernels alike, so the port's plain functions build them."""
    jcase = dataclasses.replace(jcases.CASES[name], nx=NX)
    grid, cfg = jcase.grid(), jcase.micro
    st = _seeded_state(jcase)
    m = tcases.CASES[name].time_modulation(ISTEP0, torch.float64)
    w_face = m * torch.as_tensor(np.array(jcase.rhow_pattern(grid)))
    rho0, dz = torch.as_tensor(grid.rho0), torch.as_tensor(grid.dz)
    prov = {k: torch.as_tensor(v) for k, v in st.items()}
    for f in advected_fields(cfg):
        q = prov[f]
        ten = (advective_tendency_z(q, w_face, rho0, dz)
               + divergence_tendency_z(q, w_face, rho0, dz))
        prov[f] = q + ten * jcase.dt
    prov["t"] = prov.pop("theta") * torch.as_tensor(grid.exner)[None, :]
    micro_in = ColumnState(**{f: prov[f] for f in ColumnState._fields})
    pres2 = torch.as_tensor(grid.pres).expand(NX, -1)
    tabs = tables_from_numpy(j_get_tables(iiwarm=cfg.iiwarm), torch.float64,
                             "cpu")
    pro, idx = S._prologue(micro_in, pres2, cfg)
    tv = S._table_stage(pro, idx, tabs, cfg, jcase.dt)
    return jcase, st, m, {k: v.numpy() for k, v in tv.items()}


@pytest.mark.parametrize("want_rates", [True, False], ids=["rates", "plain"])
@pytest.mark.parametrize("name", ["mixed1", "warm1_recon"])
def test_fused_kid_step_ref_matches_jax_kernel(name, want_rates):
    jcase, st, m, tv = _step_inputs(name)
    grid, cfg = jcase.grid(), jcase.micro
    profs = (grid.pres, grid.exner, grid.rho0, grid.dz)
    w_pat = np.array(jcase.rhow_pattern(grid)[0])
    want = j_fused_kid_step(
        JKidState(**{k: jnp.asarray(v) for k, v in st.items()}), w_pat, m,
        {k: jnp.asarray(v) for k, v in tv.items()}, *profs, cfg, jcase.dt,
        want_rates, interpret=True)
    got = FK.fused_kid_step(
        KidState(**{k: torch.as_tensor(v) for k, v in st.items()}),
        torch.as_tensor(w_pat), torch.tensor(m, dtype=torch.float64),
        {k: torch.as_tensor(v) for k, v in tv.items()},
        *[torch.as_tensor(a) for a in profs], cfg, jcase.dt, want_rates)
    assert isinstance(got[0], KidState)
    assert_equiv({f: getattr(got[0], f).numpy() for f in KidState._fields},
                 {f: np.asarray(getattr(want[0], f))
                  for f in KidState._fields}, noise=1e-10)
    for g, w in zip(got[1], want[1]):
        assert g.shape == (NX,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-20)
    assert set(got[2]) == set(want[2])
    assert len(got[2]) == (36 if want_rates else 0)
    if want_rates:
        assert_equiv({k: v.numpy() for k, v in got[2].items()},
                     {k: np.asarray(v) for k, v in want[2].items()},
                     noise=1e-10)


@pytest.fixture
def fused_env(monkeypatch):
    """The fused driver on in both packages.  The JAX package reads its
    switches when ``simulate`` is traced, so its compiled steps are
    dropped before and after."""
    monkeypatch.setenv(FUSED_DRIVER_ENV, "1")
    monkeypatch.setenv("KID_TPU_PALLAS", "1")
    monkeypatch.setenv("KID_TPU_PALLAS_DRIVER", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name", ["mixed1", "warm1_recon"])
def test_fused_driver_simulate_matches_jax(name, fused_env, monkeypatch):
    calls = []
    ref = FK.fused_kid_step
    monkeypatch.setattr(FK, "fused_kid_step",
                        lambda *a: calls.append(1) or ref(*a))
    got, want, _ = _run_both(name, profile_diags=True)
    assert len(calls) == N_STEPS
    assert len(got[1].profiles) == 12 + 36 + 9
    _check(got, want)


def _port_run(name, names=("qr", "nwfa", "prr_wau", "dqv_mphys"),
              n_steps=N_STEPS):
    tcase = dataclasses.replace(tcases.CASES[name], nx=NX)
    jcase = dataclasses.replace(jcases.CASES[name], nx=NX)
    st0 = KidState(**{k: torch.as_tensor(v)
                      for k, v in _seeded_state(jcase).items()})
    tabs = tables_from_numpy(j_get_tables(iiwarm=tcase.micro.iiwarm),
                             torch.float64, "cpu")
    return simulate(st0, tabs, tcase, n_steps, names, ISTEP0, device="cpu")


def test_fused_driver_scheme_fields_equal_default_path(monkeypatch):
    """The fused step advects nc, nwfa and nifa too; nothing of the
    non-aerosol scheme reads them, so the scheme fields, the precip and the
    back-outs are the default path's bit for bit while nwfa drifts."""
    default_st, default_out = _port_run("mixed1")
    monkeypatch.setenv(FUSED_DRIVER_ENV, "1")
    fused_st, fused_out = _port_run("mixed1")
    for f in SCHEME:
        assert torch.equal(getattr(fused_st, f), getattr(default_st, f)), f
    for k in PPT:
        assert torch.equal(getattr(fused_out, k), getattr(default_out, k)), k
    for k in ("qr", "prr_wau", "dqv_mphys"):
        assert torch.equal(fused_out.profiles[k], default_out.profiles[k]), k
    assert not torch.equal(fused_st.nwfa, default_st.nwfa)
    assert not torch.equal(fused_out.profiles["nwfa"],
                           default_out.profiles["nwfa"])


def test_fused_driver_switch_ignored_for_aerosol_case(monkeypatch):
    want_st, want_out = _port_run("aerosol1d", n_steps=2)
    monkeypatch.setenv(FUSED_DRIVER_ENV, "1")

    def refuse(*args):
        raise AssertionError("fused_kid_step called for an aerosol case")

    monkeypatch.setattr(FK, "fused_kid_step", refuse)
    got_st, got_out = _port_run("aerosol1d", n_steps=2)
    for f in KidState._fields:
        assert torch.equal(getattr(got_st, f), getattr(want_st, f)), f
    for k in PPT:
        assert torch.equal(getattr(got_out, k), getattr(want_out, k)), k


def test_pack_kid_inputs_layout():
    jcase, st, m, tv = _step_inputs("warm1_recon")
    grid, cfg = jcase.grid(), jcase.micro
    kst = KidState(**{k: torch.as_tensor(v) for k, v in st.items()})
    ttv = {k: torch.as_tensor(v) for k, v in tv.items()}
    w_pat = torch.as_tensor(np.array(jcase.rhow_pattern(grid)[0]))
    x, prof = FK.pack_kid_inputs(kst, ttv, w_pat, grid.pres, grid.exner,
                                 grid.rho0, grid.dz, cfg)
    nz = jcase.nz
    assert x.shape == (12 + 1, NX, nz) and x.is_contiguous()
    assert torch.equal(x[4], kst.nr) and torch.equal(x[12], ttv["ef_rw"])
    assert prof.shape == (5, nz + 1) and torch.equal(prof[0], w_pat)
    for i, a in enumerate((grid.pres, grid.exner, grid.rho0, grid.dz), 1):
        assert torch.equal(prof[i, :nz], torch.as_tensor(a))
        assert float(prof[i, nz]) == 0.0
    # a CPU tensor never reaches the launcher
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        FK.launch_kid_packed(x, prof, torch.tensor(m), cfg, jcase.dt, False)
    with pytest.raises(ValueError, match="non-aerosol"):
        FK.fused_kid_step(kst, w_pat, torch.tensor(m), ttv, grid.pres,
                          grid.exner, grid.rho0, grid.dz,
                          tcases.AEROSOL1D.micro, jcase.dt, False)
