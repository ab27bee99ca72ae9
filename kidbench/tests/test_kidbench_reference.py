"""The frozen reference agrees with the program's own oracle, and its
KiD loop with the program's float64 loop on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from kidbench.reference import kid, oracle as frozen
from kidbench.reference.tables import get_tables as frozen_tables
from kidbench.manifest import find_cell


@pytest.mark.parametrize("iiwarm", [False, True])
def test_frozen_oracle_agrees_with_the_port_oracle_on_a_column(iiwarm):
    from kid_tpu_torch.tables.cache import get_tables
    from kid_tpu_torch.validation import oracle as port
    nz = 40
    rng = np.random.default_rng(3)
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
    got = frozen.mp_thompson_oracle(*args, frozen_tables(iiwarm),
                                    iiwarm=iiwarm)
    want = port.mp_thompson_oracle(*args, get_tables(iiwarm=iiwarm),
                                   iiwarm=iiwarm)
    same(got, want, "out")


def same(got, want, where):
    """Bit for bit, through nested dicts."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            same(got[k], want[k], f"{where}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=where)


@pytest.mark.parametrize("name", ["mixed1.loop", "cumulus2d.loop"])
def test_reference_loop_follows_the_program_in_float64(name):
    """A few steps of the configuration's case from its t = 0 state: the
    program in float64 on the CPU and the reference agree to rounding."""
    from kid_tpu_torch.driver.cases import CASES
    from kid_tpu_torch.driver.loop import KidState, simulate
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables
    cfg = dict(find_cell(name).cfg)
    cfg["nx"] = 64 if cfg["dx"] else 3
    ref = kid.KidCase(cfg)
    case = dataclasses.replace(CASES[cfg["program_case"]], nx=cfg["nx"],
                               cell_nx=cfg["cell_nx"])
    prof = ref.initial_profiles()
    state = KidState(*[torch.tensor(np.broadcast_to(prof[f], (
        ref.nx, ref.nz)).copy()) for f in kid.FIELDS])
    tables = device_tables(get_tables(iiwarm=ref.scheme["iiwarm"]),
                           torch.float64, "cpu")
    n, i0 = 2, 40
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
