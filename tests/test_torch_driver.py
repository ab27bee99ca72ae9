"""PyTorch port's KiD driver against the JAX package, on the CPU.

mixed1, warm1_recon, warm1 (nz=130), deep1 and aerosol1d at nx=4 run 10
steps from the same seeded state (hydrometeors added from a numpy seed) at
istep0=150, inside the updraft pulse, in float64 through both packages'
``simulate``; the
JAX side of aerosol1d runs its split kernels in interpret mode.  States and
profiles use the tolerance model of test_torch_solver.assert_equiv,
precip streams rtol 1e-8.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kid_tpu.driver import cases as jcases
from kid_tpu.driver.loop import initial_state as j_initial_state
from kid_tpu.driver.loop import simulate as j_simulate
from kid_tpu.micro.solver import device_tables as j_device_tables
from kid_tpu.tables.cache import get_tables as j_get_tables
from kid_tpu_torch.convert import state_from_numpy, tables_from_numpy
from kid_tpu_torch.driver import cases as tcases
from kid_tpu_torch.driver.loop import KidState, simulate
from test_torch_solver import assert_equiv

torch.set_num_threads(2)

NX, N_STEPS, ISTEP0 = 4, 10, 150


def _seeded_state(jcase, seed=0):
    """The case's initial sounding plus seeded cloud, rain and (mixed
    phase) ice, snow and graupel, as a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    st = {f: np.array(v) for f, v in
          j_initial_state(jcase, jnp.float64)._asdict().items()}
    z = jcase.grid().z
    top = jcase.ztop

    def layer(lo, hi, amp):
        prof = np.where((z > lo * top) & (z < hi * top), amp, 0.0)
        return prof[None, :] * (1.0 + 0.3 * rng.random((jcase.nx, 1)))

    st["qc"] = layer(0.1, 0.3, 5.0e-4)
    st["qr"] = layer(0.0, 0.25, 2.0e-4)
    st["nr"] = np.where(st["qr"] > 0, 1.0e5, 0.0)
    if not jcase.micro.iiwarm:
        st["qi"] = layer(0.5, 0.9, 3.0e-5)
        st["ni"] = np.where(st["qi"] > 0, 1.0e4, 0.0)
        st["qs"] = layer(0.4, 0.8, 1.0e-4)
        st["qg"] = layer(0.3, 0.6, 5.0e-5)
    return st


def _run_both(name, profile_diags=False):
    jcase = dataclasses.replace(jcases.CASES[name], nx=NX)
    tcase = dataclasses.replace(tcases.CASES[name], nx=NX)
    st = _seeded_state(jcase)
    jtabs = j_device_tables(j_get_tables(iiwarm=jcase.micro.iiwarm),
                            jnp.float64)
    jst = type(j_initial_state(jcase, jnp.float64))(
        **{k: jnp.asarray(v) for k, v in st.items()})
    want = j_simulate(jst, jtabs, jcase, N_STEPS, profile_diags, ISTEP0)
    ttabs = tables_from_numpy(j_get_tables(iiwarm=tcase.micro.iiwarm),
                              torch.float64, "cpu")
    got = simulate(state_from_numpy(jst, "cpu", torch.float64), ttabs, tcase,
                   N_STEPS, profile_diags, ISTEP0, device="cpu")
    return got, want, (st, ttabs, tcase)


def _check(got, want):
    (gst, gout), (wst, wout) = got, want
    assert isinstance(gst, KidState)
    assert_equiv({f: getattr(gst, f).numpy() for f in gst._fields},
                 {f: np.asarray(getattr(wst, f)) for f in wst._fields})
    for k in ("ppt_rain", "ppt_snow", "ppt_graupel", "ppt_ice"):
        g, w = getattr(gout, k).numpy(), np.asarray(getattr(wout, k))
        assert g.shape == w.shape == (N_STEPS, NX), k
        np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-20, err_msg=k)
    assert set(gout.profiles) == set(wout.profiles)
    for k in wout.profiles:
        g, w = gout.profiles[k].numpy(), np.asarray(wout.profiles[k])
        assert g.shape == w.shape, k
        assert_equiv({k: g}, {k: w})


@pytest.mark.parametrize("name", ["mixed1", "warm1_recon", "warm1", "deep1"])
def test_simulate_matches_jax(name):
    got, want, _ = _run_both(name)
    _check(got, want)
    assert float(got[1].ppt_rain.sum()) > 0.0


def test_aerosol1d_matches_jax_split_kernels(monkeypatch):
    """aerosol1d against the JAX package's kernel path (fused_rates ->
    aerosol_lookup_stage -> fused_post, in interpret mode), which reads
    the raw qc/nc in its lookups as the port does (ROADMAP.md Queue 3)."""
    monkeypatch.setenv("KID_TPU_PALLAS", "1")
    got, want, (st0, _, _) = _run_both("aerosol1d")
    _check(got, want)
    gst = got[0]
    for f in ("nwfa", "nifa", "nc"):
        assert not np.array_equal(getattr(gst, f).numpy(), st0[f]), f


def test_simulate_profiles_match_jax():
    got, want, _ = _run_both("mixed1", profile_diags=True)
    assert len(got[1].profiles) == 12 + 36 + 9
    _check(got, want)


def test_chunked_istep0_equals_one_run():
    tcase = dataclasses.replace(tcases.MIXED1, nx=NX)
    jcase = dataclasses.replace(jcases.MIXED1, nx=NX)
    st0 = KidState(**{k: torch.as_tensor(v) for k, v in
                      _seeded_state(jcase, seed=1).items()})
    tabs = tables_from_numpy(j_get_tables(iiwarm=False), torch.float64,
                             "cpu")
    names = ("qr", "prr_wau", "dqv_mphys")
    whole, w_out = simulate(st0, tabs, tcase, N_STEPS, names, ISTEP0,
                            device="cpu")
    part, p1 = simulate(st0, tabs, tcase, 4, names, ISTEP0, device="cpu")
    part, p2 = simulate(part, tabs, tcase, N_STEPS - 4, names, ISTEP0 + 4,
                        device="cpu")
    for f in KidState._fields:
        assert torch.equal(getattr(part, f), getattr(whole, f)), f
    for k in ("ppt_rain", "ppt_snow", "ppt_graupel", "ppt_ice"):
        assert torch.equal(torch.cat([getattr(p1, k), getattr(p2, k)]),
                           getattr(w_out, k)), k
    for k in names:
        assert torch.equal(torch.cat([p1.profiles[k], p2.profiles[k]]),
                           w_out.profiles[k]), k
