"""The frozen reference agrees with the program's own oracle, and its
KiD loop with the program's float64 loop on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from case_files import config_of
from kidbench.reference import kid, oracle as frozen
from kidbench.reference.tables import get_tables as frozen_tables
from kidbench.manifest import find_cell


def cold_column(nz: int):
    """A column from 262 K down to 212 K, 50% over ice saturation
    throughout, with a little of every species: DeMott's and Koop's
    nucleation fire in it."""
    z = (np.arange(nz) + 0.5) * 250.0
    p = 7.0e4 * np.exp(-z / 8000.0)
    t = 262.0 - 0.005 * z
    e_si = np.exp(9.550426 - 5723.265 / t + 3.53068 * np.log(t)
                  - 0.00728332 * t)
    qvsi = 0.622 * e_si / (p - e_si)
    cols = dict(qv1d=1.5 * qvsi, qc1d=np.where(z < 2000, 1e-4, 0.0),
                qi1d=np.where(z > 6000, 1e-6, 0.0), qr1d=np.zeros(nz),
                qs1d=np.where(z > 5000, 1e-5, 0.0),
                qg1d=np.where(z > 5000, 1e-6, 0.0),
                ni1d=np.where(z > 6000, 1e3, 0.0), nr1d=np.zeros(nz),
                nc1d=np.full(nz, 1e8), nwfa1d=np.full(nz, 3e8),
                nifa1d=np.full(nz, 1e6))
    return z, p, t, cols


@pytest.mark.parametrize("iiwarm,aerosol", [
    pytest.param(False, False, id="False"),
    pytest.param(True, False, id="True"),
    pytest.param(False, True, id="aerosol_aware")])
def test_frozen_oracle_agrees_with_the_port_oracle_on_a_column(iiwarm,
                                                               aerosol):
    from kid_tpu_torch.tables.cache import get_tables
    from kid_tpu_torch.validation import oracle as port
    nz = 40
    rng = np.random.default_rng(3)
    if aerosol:
        z, p, t, cols = cold_column(nz)
    else:
        z = (np.arange(nz) + 0.5) * 250.0
        p = 1.0e5 * np.exp(-z / 8000.0)
        t = 285.0 - 0.006 * z
        cols = dict(qv1d=0.01 * np.exp(-z / 2500.0),
                    qc1d=np.where(z < 3000, 5e-4, 0.0),
                    qi1d=np.where(z > 6000, 1e-5, 0.0) * (not iiwarm),
                    qr1d=np.where(z < 2000, 2e-4, 0.0),
                    qs1d=np.where(z > 5000, 1e-4, 0.0) * (not iiwarm),
                    qg1d=np.where(z > 5000, 5e-5, 0.0) * (not iiwarm),
                    ni1d=np.where(z > 6000, 1e4, 0.0) * (not iiwarm),
                    nr1d=np.where(z < 2000, 1e5, 0.0),
                    nc1d=np.full(nz, 1e8), nwfa1d=np.full(nz, 1e9),
                    nifa1d=np.full(nz, 1e6))
    cols = {k: v * (1 + 0.01 * rng.standard_normal(nz)) for k, v in
            cols.items()}
    args = (*cols.values(), t, p, np.zeros(nz), np.full(nz, 250.0), 10.0)
    modes = dict(iiwarm=iiwarm, is_aerosol_aware=aerosol, dusty_ice=True,
                 homog_ice=True)
    got = frozen.mp_thompson_oracle(*args, frozen_tables(iiwarm), **modes)
    want = port.mp_thompson_oracle(*args, get_tables(iiwarm=iiwarm),
                                   **modes)
    same(got, want, "out")
    if aerosol:
        # DeMott's count, not Cooper's, and Koop's freezing, both fired
        rates = got["rates"]
        assert rates["pni_iha"].max() > 0
        cooper = frozen.mp_thompson_oracle(
            *args, frozen_tables(iiwarm), **{**modes, "dusty_ice": False})
        assert np.any((rates["pni_inu"] > 0)
                      & (rates["pni_inu"] != cooper["rates"]["pni_inu"]))


def same(got, want, where):
    """Bit for bit, through nested dicts."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            same(got[k], want[k], f"{where}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=where)


@pytest.mark.parametrize("name,i0", [
    pytest.param(name, i0, id=name) for name, i0 in (
        ("mixed1.loop", 40), ("cumulus2d.loop", 40),
        # dicts written from the program's cases: aerosol1d once ice,
        # snow and graupel are there; warm1 at the updraft's peak
        ("aerosol1d", 150), ("warm1", 600))])
def test_reference_loop_follows_the_program_in_float64(name, i0):
    """A few steps of the configuration's case from its t = 0 state: the
    program in float64 on the CPU and the reference agree to rounding."""
    from kid_tpu_torch.driver.cases import CASES
    from kid_tpu_torch.driver.loop import KidState, simulate
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables
    cfg = dict(find_cell(name).cfg if "." in name
               else config_of(CASES[name]))
    cfg["nx"] = 64 if cfg["dx"] else 3
    ref = kid.KidCase(cfg)
    case = dataclasses.replace(CASES[cfg["program_case"]], nx=cfg["nx"],
                               cell_nx=cfg["cell_nx"])
    prof = ref.initial_profiles()
    state = KidState(*[torch.tensor(np.broadcast_to(prof[f], (
        ref.nx, ref.nz)).copy()) for f in kid.FIELDS])
    tables = device_tables(get_tables(iiwarm=ref.scheme["iiwarm"]),
                           torch.float64, "cpu")
    n = 2
    st, _ = simulate(state, tables, case, i0, device="cpu")
    out, streams = simulate(st, tables, case, n, istep0=i0, device="cpu")
    cols = np.arange(10, 10 + 6 + 4 * n) if not ref.one_d else np.arange(3)
    before = {f: getattr(st, f).numpy()[cols % ref.nx] for f in kid.FIELDS}
    got, kept, ppt = kid.advance(
        ref, kid.local_solver(frozen_tables(ref.scheme["iiwarm"])), before,
        cols, i0, n)
    for f in kid.FIELDS:
        want = getattr(out, f).numpy()[kept % ref.nx]
        np.testing.assert_allclose(got[f], want, rtol=1e-9, atol=1e-12,
                                   err_msg=f)
    np.testing.assert_allclose(
        ppt["rain"], streams.ppt_rain.numpy()[:, kept % ref.nx].sum(0),
        rtol=1e-9, atol=1e-15)
